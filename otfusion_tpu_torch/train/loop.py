"""Epoch loops (port of ``otfusion_tpu.train.loop``: ``run_fusion_training``
and ``run_unimodal_training``, single device).

Fusion, per run: for ``per_epoch_attn`` the feature pass and the per-epoch
coupling before epoch 1; then per epoch train, eval, ``results.txt`` row,
``metrics.jsonl`` row (with the phase split and, for ``per_epoch_attn``,
the coupling log of the plan the epoch trained with), best checkpoint (+
``t_feature.npy`` for ``per_epoch_attn``), plateau LR step, latest
checkpoint, and the coupling for the next epoch. After the last epoch the
best weights are restored, ``Tv`` is recomputed from them and saved, and the
best model is evaluated once more. ``base`` solves its plan inside every
train step (kernel K2 on CUDA) and ``mmfusion`` has none, so neither builds
a coupling service or saves ``t_feature.npy``.

Unimodal: the same epoch rows and checkpoints with Adam and no LR schedule.

The confusion-matrix and t-SNE PNGs of the JAX loops are not written yet
(ROADMAP.md, open item: the PNG artifacts).
"""

from __future__ import annotations

import json
import os
import statistics
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from otfusion_tpu_torch.data.loader import (
    Loader,
    MultimodalLoader,
    _VolumeCache,
    feed_dtype_for,
    prefetch,
)
from otfusion_tpu_torch.metrics.classification import classification_metrics
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import ResNet3DClassifier
from otfusion_tpu_torch.train.coupling import CouplingService
from otfusion_tpu_torch.train.steps import (
    make_feature_extract_step,
    make_fusion_eval_step,
    make_fusion_train_step,
    make_unimodal_eval_step,
    make_unimodal_train_step,
)
from otfusion_tpu_torch.train.train_state import (
    ReduceLROnPlateau,
    make_optimizer,
    set_learning_rate,
)
from otfusion_tpu_torch.utils.reporting import ResultsWriter

CHECKPOINT_FILE = "checkpoint.pt"

# Steps in flight before their metrics are read: reading a loss waits for
# the device, so the host keeps this many steps queued ahead of the read.
_PIPELINE_LAG = 2

# Largest forward-only batch x voxel product the automatic eval / feature
# batch picks: 16 x 128^3 (explicit sizes are never capped).
_AUTO_FWD_VOXEL_BUDGET = 16 * 128**3


@dataclass
class EpochResult:
    train_loss: float
    train_acc: float
    val_loss: float
    val_acc: float
    metrics: Dict[str, float]


def _resolve_eval_batch(eval_batch_size, batch_size, target_shape=None,
                        flag="--eval-batch-size"):
    """Default 4x the train batch (forward-only passes hold no backward
    activations), capped by the voxel budget but never below the train
    batch; an explicit value is validated and used as given."""
    if eval_batch_size is not None and eval_batch_size < 1:
        raise ValueError(f"{flag} must be >= 1, got {eval_batch_size}")
    if eval_batch_size is not None:
        return eval_batch_size
    auto = 4 * batch_size
    if target_shape is not None:
        voxels = int(np.prod(target_shape))
        cap = max(1, _AUTO_FWD_VOXEL_BUDGET // max(1, voxels))
        auto = max(min(auto, cap), batch_size)
    return auto


class _PhaseClock:
    """Wall-clock split of one epoch into named phases."""

    def __init__(self):
        self.t0 = time.time()
        self._last = self.t0
        self.phases = {}

    def __call__(self, tag):
        now = time.time()
        self.phases[tag] = round(now - self._last, 3)
        self._last = now

    def elapsed(self):
        return time.time() - self.t0


class _StepTimer:
    """Per-step times: CUDA events on a GPU (read once, after the epoch),
    the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((start, ev))
        else:
            self.marks.append((start, time.perf_counter()))

    def median_ms(self) -> float:
        if not self.marks:
            return float("nan")
        if self.cuda:
            torch.cuda.synchronize()
            times = [a.elapsed_time(b) for a, b in self.marks]
        else:
            times = [(b - a) * 1e3 for a, b in self.marks]
        return statistics.median(times)


def _dtype_name(compute_dtype) -> str:
    return "bfloat16" if compute_dtype == torch.bfloat16 else "float32"


def _append_jsonl(path, record):
    """Append one JSON row; returns its byte offset for the rewrite."""
    with open(path, "a") as f:
        offset = f.tell()
        f.write(json.dumps(record, default=float) + "\n")
    return offset


def _rewrite_last_jsonl(path, record, offset):
    """Replace the row written at ``offset`` (the epoch's row is appended
    right after eval and completed after the checkpoint and coupling
    phases)."""
    with open(path, "r+") as f:
        f.seek(offset)
        f.truncate()
        f.write(json.dumps(record, default=float) + "\n")


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, model, meta: dict,
                    optimizer=None) -> None:
    os.makedirs(directory, exist_ok=True)
    _atomic_save({"model": model.state_dict(),
                  "optimizer": optimizer.state_dict() if optimizer else None,
                  "meta": meta}, os.path.join(directory, CHECKPOINT_FILE))


def restore_checkpoint(directory: str, model) -> dict:
    ckpt = torch.load(os.path.join(directory, CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    return ckpt["meta"]


def _save_tv(save_path, tv):
    path = os.path.join(save_path, "t_feature.npy")
    tmp = path + ".tmp.npy"
    np.save(tmp, tv.detach().float().cpu().numpy())
    os.replace(tmp, path)


def _run_train_epoch(train_step, loader, device, extra=()):
    """One pass of ``train_step(*batch, *extra)`` over ``loader`` (labels
    last in each batch); returns (mean loss, accuracy, median step ms)."""
    total_loss, total_correct, total_n = 0.0, 0, 0
    timer = _StepTimer(device)
    pending = deque()

    def _drain():
        nonlocal total_loss, total_correct, total_n
        met, n = pending.popleft()
        total_loss += float(met["loss"]) * n
        total_correct += int(met["correct"])
        total_n += n

    for batch in prefetch(iter(loader)):
        batch = [x.to(device, non_blocking=True) for x in batch]
        start = timer.start()
        met = train_step(*batch, *extra)
        timer.stop(start)
        pending.append((met, int(batch[-1].shape[0])))
        if len(pending) > _PIPELINE_LAG:
            _drain()
    while pending:
        _drain()
    return total_loss / total_n, total_correct / total_n, timer.median_ms()


def _run_eval_epoch(eval_step, loader, device, extra=(), collect=None):
    """One pass of ``eval_step(*batch, *extra)``; returns (mean loss,
    accuracy, preds, targets, the concatenated ``collect`` output or
    None)."""
    total_loss, total_correct, total_n = 0.0, 0, 0
    preds: List[int] = []
    targets: List[int] = []
    kept = []
    for batch in prefetch(iter(loader)):
        labels = batch[-1]
        out = eval_step(*[x.to(device, non_blocking=True) for x in batch],
                        *extra)
        n = int(labels.shape[0])
        total_loss += float(out["loss"]) * n
        total_correct += int(out["correct"])
        total_n += n
        preds.extend(out["preds"].tolist())
        targets.extend(labels.tolist())
        if collect:
            kept.append(out[collect].cpu().numpy())
    kept = np.concatenate(kept) if kept else None
    return total_loss / total_n, total_correct / total_n, preds, targets, kept


def _place(model, device: torch.device):
    """The model on ``device``; channels-last-3d on a GPU (cuDNN's fast
    3D-convolution layout)."""
    if device.type == "cuda":
        return model.to(device=device, memory_format=torch.channels_last_3d)
    return model.to(device)


def _write_json(path, payload) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def run_fusion_training(
    *,
    samples: Sequence,
    train_idx: Sequence[int],
    val_idx: Sequence[int],
    class_names: Dict[str, int],
    variant: str,
    model_depth: int,
    target_shape,
    batch_size: int,
    lr: float,
    epochs: int,
    seed: int,
    save_path: str,
    device: torch.device,
    class_names_b: Optional[Dict[str, int]] = None,
    augment: bool = False,
    projection_dropout: float = 0.3,
    max_jax_samples: int = 64,
    ot_epsilon: float = 5e-3,
    gw_max_iterations: int = 2000,
    sinkhorn_max_iterations: int = 2000,
    grad_accum: int = 1,
    feature_batch_size: Optional[int] = None,
    eval_batch_size: Optional[int] = None,
    mri_backbone: str = "",
    pet_backbone: str = "",
    s2d_stem: Optional[bool] = None,
    raw_plan: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    num_classes: int = 2,
    results_title: str = (
        "Multimodal MRI-PET with Optimal Transport - ADNI Dataset"
    ),
    config_lines: Optional[Dict[str, object]] = None,
    progress: bool = True,
    num_workers: int = 8,
    latest_every: int = 1,
) -> Dict[str, object]:
    if not len(val_idx) or not len(train_idx):
        raise ValueError(
            f"empty split: {len(train_idx)} train / {len(val_idx)} val "
            "samples — increase --val-fraction or the cohort size")
    os.makedirs(save_path, exist_ok=True)
    results_file = os.path.join(save_path, "results.txt")
    model_dir = os.path.join(save_path, "best_model")
    latest_dir = os.path.join(save_path, "latest")
    # A fresh run takes the space-to-depth stem unless told otherwise.
    s2d_stem = True if s2d_stem is None else bool(s2d_stem)

    cache = _VolumeCache(target_shape, num_workers=num_workers)
    train_samples = [samples[i] for i in train_idx]
    val_samples = [samples[i] for i in val_idx]
    feed = feed_dtype_for(compute_dtype)
    train_loader = MultimodalLoader(
        train_samples, target_shape, batch_size, shuffle=True,
        augment=augment, seed=seed, cache=cache, feed_dtype=feed)
    feat_loader = MultimodalLoader(
        train_samples, target_shape,
        _resolve_eval_batch(feature_batch_size, batch_size, target_shape,
                            flag="--feature-batch-size"),
        shuffle=False, cache=cache, feed_dtype=feed)
    val_loader = MultimodalLoader(
        val_samples, target_shape,
        _resolve_eval_batch(eval_batch_size, batch_size, target_shape),
        shuffle=False, cache=cache, feed_dtype=feed)

    torch.manual_seed(seed)
    model = MultimodalOTFusion(
        num_classes=num_classes, depth=model_depth,
        projection_dropout=projection_dropout, variant=variant,
        mri_backbone=mri_backbone, pet_backbone=pet_backbone,
        s2d_stem=s2d_stem, raw_plan=raw_plan)
    model = _place(model, device)
    _write_json(os.path.join(save_path, "model_config.json"), {
        "kind": "fusion", "variant": variant,
        "model_depth": model_depth,
        "target_shape": list(target_shape),
        "num_classes": num_classes,
        "projection_dropout": projection_dropout,
        "mri_backbone": mri_backbone,
        "pet_backbone": pet_backbone,
        "s2d_stem": s2d_stem, "raw_plan": raw_plan,
        "dtype": _dtype_name(compute_dtype),
        "class_names": class_names,
        "class_names_b": class_names_b,
    })

    optimizer = make_optimizer(model.parameters(), lr)
    train_step = make_fusion_train_step(
        model, optimizer, in_batch_fot=(variant == "base"),
        grad_accum=grad_accum, compute_dtype=compute_dtype)
    eval_step = make_fusion_eval_step(model, compute_dtype=compute_dtype)
    needs_tv = variant == "per_epoch_attn"
    svc = None
    if needs_tv:
        svc = CouplingService(
            make_feature_extract_step(model, compute_dtype=compute_dtype),
            n_labels=num_classes, device=device,
            max_samples_per_label=max_jax_samples, epsilon=ot_epsilon,
            gw_max_iterations=gw_max_iterations,
            sinkhorn_max_iterations=sinkhorn_max_iterations,
            fot_epsilon=ot_epsilon)

    writer = ResultsWriter(results_file, results_title, config_lines or {},
                           style="fusion")
    scheduler = ReduceLROnPlateau(lr, factor=0.5, patience=5)
    best_val_loss = float("inf")
    best_summary = None
    generator = torch.Generator(device=device).manual_seed(seed + 1)

    def compute_tv():
        return svc.compute(prefetch(iter(feat_loader)))

    tv = compute_tv() if needs_tv else None

    history = []
    jsonl_path = os.path.join(save_path, "metrics.jsonl")
    for epoch in range(1, epochs + 1):
        clock = _PhaseClock()
        train_loss, train_acc, step_ms = _run_train_epoch(
            train_step, train_loader, device, (tv, generator))
        clock("train")
        val_loss, val_acc, preds, targets, _ = _run_eval_epoch(
            eval_step, val_loader, device, (tv,))
        clock("eval")
        metrics = classification_metrics(targets, preds, num_classes)
        writer.epoch_row(epoch, train_loss, train_acc, val_loss, val_acc,
                         metrics)
        history.append(EpochResult(train_loss, train_acc, val_loss, val_acc,
                                   metrics))
        if progress:
            print(
                f"Epoch {epoch:03d} | train_loss={train_loss:.4f} "
                f"train_acc={train_acc:.4f} | val_loss={val_loss:.4f} "
                f"val_acc={val_acc:.4f} | f1={metrics['f1']:.4f} "
                f"({clock.elapsed():.1f}s)", flush=True)

        # The row logs the coupling this epoch trained with, captured
        # before the end-of-epoch solve replaces it.
        epoch_coupling_log = svc.last_log if svc else None

        def _epoch_record():
            return {
                "epoch": epoch, "train_loss": train_loss,
                "train_acc": train_acc, "val_loss": val_loss,
                "val_acc": val_acc, **metrics,
                "epoch_seconds": round(clock.elapsed(), 3),
                "phase_seconds": dict(clock.phases),
                "median_step_ms": step_ms,
                "coupling_log": epoch_coupling_log,
                "lr": scheduler.lr,
            }

        row_offset = _append_jsonl(jsonl_path, _epoch_record())

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            best_summary = {"epoch": epoch, "val_loss": val_loss,
                            "val_acc": val_acc, **metrics}
            save_checkpoint(model_dir, model, best_summary)
            if needs_tv:
                _save_tv(save_path, tv)

        set_learning_rate(optimizer, scheduler.step(val_loss))
        if epoch % max(1, latest_every) == 0 or epoch == epochs:
            save_checkpoint(
                latest_dir, model,
                {"epoch": epoch, "best_val_loss": best_val_loss,
                 "best_summary": best_summary, "lr": scheduler.lr,
                 "sched_best": scheduler.best,
                 "sched_bad_epochs": scheduler.bad_epochs},
                optimizer=optimizer)
        clock("checkpoint")

        if needs_tv and epoch < epochs:
            tv = compute_tv()
            clock("coupling")
        _rewrite_last_jsonl(jsonl_path, _epoch_record(), row_offset)

    writer.summary(best_val_loss, best_summary, model_dir)

    # Best model: restore, recompute the plan it serves with, evaluate.
    restore_checkpoint(model_dir, model)
    final_tv = compute_tv() if needs_tv else None
    _, _, preds, targets, logits = _run_eval_epoch(
        eval_step, val_loader, device, (final_tv,), collect="logits")
    if needs_tv:
        _save_tv(save_path, final_tv)

    return {
        "best_val_loss": best_val_loss,
        "best_summary": best_summary,
        "history": history,
        "model_dir": model_dir,
        "final_preds": preds,
        "final_targets": targets,
        "final_logits": logits,
    }


def run_unimodal_training(
    *,
    samples: Sequence,
    train_idx: Sequence[int],
    val_idx: Sequence[int],
    class_names: Dict[str, int],
    model_depth: int,
    target_shape,
    batch_size: int,
    lr: float,
    epochs: int,
    seed: int,
    save_path: str,
    device: torch.device,
    augment: bool = False,
    s2d_stem: Optional[bool] = None,
    grad_accum: int = 1,
    eval_batch_size: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    config_lines: Optional[Dict[str, object]] = None,
    num_workers: int = 8,
    latest_every: int = 1,
) -> Dict[str, object]:
    """Train ``ResNet3DClassifier`` on (path, label) samples with Adam and
    no LR schedule; per epoch train, eval, ``results.txt`` and
    ``metrics.jsonl`` rows, best and latest checkpoints. After the last
    epoch the best weights are restored and evaluated once more, with their
    pooled features. The reference's confusion-matrix and t-SNE PNGs are
    not written yet (ROADMAP §2 item 3)."""
    if not len(val_idx) or not len(train_idx):
        raise ValueError(
            f"empty split: {len(train_idx)} train / {len(val_idx)} val "
            "samples — increase --val-fraction or the cohort size")
    os.makedirs(save_path, exist_ok=True)
    results_file = os.path.join(save_path, "results.txt")
    model_dir = os.path.join(save_path, "best_model")
    latest_dir = os.path.join(save_path, "latest")
    num_classes = len(class_names)
    s2d_stem = True if s2d_stem is None else bool(s2d_stem)

    cache = _VolumeCache(target_shape, num_workers=num_workers)
    feed = feed_dtype_for(compute_dtype)
    train_loader = Loader(
        [samples[i] for i in train_idx], target_shape, batch_size,
        shuffle=True, augment=augment, seed=seed, cache=cache,
        feed_dtype=feed)
    val_loader = Loader(
        [samples[i] for i in val_idx], target_shape,
        _resolve_eval_batch(eval_batch_size, batch_size, target_shape),
        shuffle=False, cache=cache, feed_dtype=feed)

    torch.manual_seed(seed)
    model = _place(ResNet3DClassifier(depth=model_depth,
                                      num_classes=num_classes,
                                      s2d_stem=s2d_stem), device)
    _write_json(os.path.join(save_path, "model_config.json"), {
        "kind": "unimodal", "model_depth": model_depth,
        "target_shape": list(target_shape),
        "num_classes": num_classes, "s2d_stem": s2d_stem,
        "dtype": _dtype_name(compute_dtype),
        "class_names": class_names,
    })
    optimizer = make_optimizer(model.parameters(), lr, kind="adam")
    train_step = make_unimodal_train_step(model, optimizer,
                                          grad_accum=grad_accum,
                                          compute_dtype=compute_dtype)
    eval_step = make_unimodal_eval_step(model, compute_dtype=compute_dtype)

    writer = ResultsWriter(results_file,
                           "3D ResNet Training Results - ADNI MRI Dataset",
                           config_lines or {}, style="unimodal")
    best_val_loss = float("inf")
    best_summary = None
    history = []
    jsonl_path = os.path.join(save_path, "metrics.jsonl")
    for epoch in range(1, epochs + 1):
        clock = _PhaseClock()
        train_loss, train_acc, step_ms = _run_train_epoch(
            train_step, train_loader, device)
        clock("train")
        val_loss, val_acc, preds, targets, _ = _run_eval_epoch(
            eval_step, val_loader, device)
        clock("eval")
        metrics = classification_metrics(targets, preds, num_classes)
        writer.epoch_row(epoch, train_loss, train_acc, val_loss, val_acc,
                         metrics)
        history.append(EpochResult(train_loss, train_acc, val_loss, val_acc,
                                   metrics))
        print(
            f"Epoch {epoch:03d} | train_loss={train_loss:.4f} "
            f"train_acc={train_acc:.4f} | val_loss={val_loss:.4f} "
            f"val_acc={val_acc:.4f} | f1={metrics['f1']:.4f} "
            f"({clock.elapsed():.1f}s)", flush=True)

        def _epoch_record():
            return {
                "epoch": epoch, "train_loss": train_loss,
                "train_acc": train_acc, "val_loss": val_loss,
                "val_acc": val_acc, **metrics,
                "epoch_seconds": round(clock.elapsed(), 3),
                "phase_seconds": dict(clock.phases),
                "median_step_ms": step_ms,
            }

        row_offset = _append_jsonl(jsonl_path, _epoch_record())
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            best_summary = {"epoch": epoch, "val_loss": val_loss,
                            "val_acc": val_acc, **metrics}
            save_checkpoint(model_dir, model, best_summary)
        if epoch % max(1, latest_every) == 0 or epoch == epochs:
            save_checkpoint(
                latest_dir, model,
                {"epoch": epoch, "best_val_loss": best_val_loss,
                 "best_summary": best_summary},
                optimizer=optimizer)
        clock("checkpoint")
        _rewrite_last_jsonl(jsonl_path, _epoch_record(), row_offset)

    writer.summary(best_val_loss, best_summary, model_dir)

    restore_checkpoint(model_dir, model)
    _, _, preds, targets, feats = _run_eval_epoch(
        eval_step, val_loader, device, collect="features")
    return {
        "best_val_loss": best_val_loss,
        "best_summary": best_summary,
        "history": history,
        "model_dir": model_dir,
        "final_preds": preds,
        "final_targets": targets,
        "final_features": feats,
    }

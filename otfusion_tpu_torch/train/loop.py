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

Registry backbones (``mri_backbone`` / ``pet_backbone``) are built for
volumes of ``target_shape``, which sets their widths, so ``Tv`` is
(d_pet, d_mri); a pretrained ``.pth`` is grafted by its side's family.

Unimodal: the same epoch rows and checkpoints with Adam and no LR schedule.

Run lifecycle, as in JAX: checkpoints are written behind the next epoch's
work (``utils.checkpoint``) and flushed before the best-model restore;
``resume`` continues from ``latest/`` (model, optimiser, plateau scheduler,
epoch, best loss and summary), appending to ``results.txt`` and
``metrics.jsonl``; ``mri_pretrained``/``pet_pretrained`` graft backbones
before the optimiser is built; ``profile_dir`` takes a ``torch.profiler``
trace of epoch 1's train phase.

After the best model's final evaluation both loops write the JAX loops'
``confusion_matrix.png`` and ``tsne_best_val.png`` (``utils.plotting``):
the fusion loop the t-SNE of the validation logits for ``per_epoch_attn``
only, the unimodal loop that of the pooled features; the t-SNE runs on the
run's device.
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
from otfusion_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    flush_checkpoints,
    load_metadata,
    restore_backbone,
    restore_checkpoint,
    save_checkpoint,
)
from otfusion_tpu_torch.utils.plotting import (
    save_confusion_matrix_png,
    save_tsne_png,
)
from otfusion_tpu_torch.utils.reporting import ResultsWriter

# Steps in flight before their metrics are read: reading a loss waits for
# the device, so the host keeps this many steps queued ahead of the read.
_PIPELINE_LAG = 2

# Epoch e of a run seeded s draws dropout from seed STRIDE * (s + 1) + e, so
# the streams of nearby seeds and epochs never coincide.
_DROPOUT_SEED_STRIDE = 1_000_003

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


class StepTimer:
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


class _MaybeProfile:
    """A ``torch.profiler`` trace of epoch 1's train phase into
    ``profile_dir/epoch1.trace.json`` (Chrome trace format), when
    ``profile_dir`` is set."""

    def __init__(self, profile_dir, epoch, device: torch.device):
        self.active = profile_dir is not None and epoch == 1
        if self.active:
            self.path = os.path.join(profile_dir, "epoch1.trace.json")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)

    def __enter__(self):
        if self.active:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.active:
            self.prof.__exit__(*exc)
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
            print(f"Profile of the epoch's train phase: {self.path}")
        return False


def _resolve_stem(s2d_stem, resume, save_path):
    """Tri-state stem policy: ``None`` takes the space-to-depth stem for a
    fresh run and the stem recorded in ``model_config.json`` on a resume
    (optimiser moments cannot be rewritten between stem layouts); an
    explicit value is kept, and raises when it contradicts a resumed run's
    recorded stem."""
    recorded = None
    cfg_path = os.path.join(save_path, "model_config.json")
    if resume and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            recorded = bool(json.load(f).get("s2d_stem", False))
    elif resume and os.path.isdir(os.path.join(save_path, "latest")):
        recorded = False  # a run from before the manifest: plain stem
    if s2d_stem is None:
        return recorded if recorded is not None else True
    if recorded is not None and bool(s2d_stem) != recorded:
        raise ValueError(
            f"--resume run at {save_path} was trained with "
            f"s2d_stem={recorded}; the optimiser state cannot be "
            "rewritten between stem layouts — drop the stem flag to "
            "keep the recorded one")
    return bool(s2d_stem)


def _flush_before_restore() -> float:
    """Drain the write-behind checkpoints; returns (and logs) the seconds
    waited."""
    t0 = time.perf_counter()
    flush_checkpoints()
    waited = time.perf_counter() - t0
    print(f"Checkpoint writes flushed: waited {waited:.3f} s", flush=True)
    return waited


def _save_tv(save_path, tv):
    path = os.path.join(save_path, "t_feature.npy")
    tmp = path + ".tmp.npy"
    np.save(tmp, tv.detach().float().cpu().numpy())
    os.replace(tmp, path)


def _run_train_epoch(train_step, loader, device, extra=()):
    """One pass of ``train_step(*batch, *extra)`` over ``loader`` (labels
    last in each batch); returns (mean loss, accuracy, median step ms)."""
    total_loss, total_correct, total_n = 0.0, 0, 0
    timer = StepTimer(device)
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


def place_model(model, device: torch.device):
    """The model on ``device``; on a GPU its convolution weights in cuDNN's
    fast layouts (channels-last-3d for 3D convs, channels-last for 2D)."""
    model = model.to(device)
    if device.type == "cuda":
        for m in model.modules():
            if isinstance(m, torch.nn.Conv3d):
                m.to(memory_format=torch.channels_last_3d)
            elif isinstance(m, torch.nn.Conv2d):
                m.to(memory_format=torch.channels_last)
    return model


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
    mri_pretrained: Optional[str] = None,
    pet_pretrained: Optional[str] = None,
    remat: bool = False,
    profile_dir: Optional[str] = None,
    resume: bool = False,
) -> Dict[str, object]:
    if not len(val_idx) or not len(train_idx):
        raise ValueError(
            f"empty split: {len(train_idx)} train / {len(val_idx)} val "
            "samples — increase --val-fraction or the cohort size")
    os.makedirs(save_path, exist_ok=True)
    results_file = os.path.join(save_path, "results.txt")
    model_dir = os.path.join(save_path, "best_model")
    latest_dir = os.path.join(save_path, "latest")
    s2d_stem = _resolve_stem(s2d_stem, resume, save_path)

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
        s2d_stem=s2d_stem, raw_plan=raw_plan, remat=remat,
        mri_shape=target_shape, pet_shape=target_shape)
    model = place_model(model, device)
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

    grafted = {side: restore_backbone(model, source, f"{side}_backbone",
                                      backbone=spec)
               for side, source, spec in (
                   ("mri", mri_pretrained, mri_backbone),
                   ("pet", pet_pretrained, pet_backbone)) if source}

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
                           style="fusion", append=resume)
    scheduler = ReduceLROnPlateau(lr, factor=0.5, patience=5)
    best_val_loss = float("inf")
    best_summary = None
    generator = torch.Generator(device=device)
    start_epoch = 1
    if resume and checkpoint_exists(latest_dir):
        meta = load_metadata(latest_dir) or {}
        restore_checkpoint(latest_dir, model, optimizer)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_val_loss = float(meta.get("best_val_loss", float("inf")))
        best_summary = meta.get("best_summary")
        scheduler.lr = float(meta.get("lr", lr))
        scheduler.best = float(meta.get("sched_best", float("inf")))
        scheduler.bad_epochs = int(meta.get("sched_bad_epochs", 0))
        set_learning_rate(optimizer, scheduler.lr)
        print(f"Resumed from {latest_dir} at epoch {start_epoch}")

    def compute_tv():
        return svc.compute(prefetch(iter(feat_loader)))

    tv = compute_tv() if needs_tv else None

    history = []
    jsonl_path = os.path.join(save_path, "metrics.jsonl")
    for epoch in range(start_epoch, epochs + 1):
        clock = _PhaseClock()
        # the epoch's dropout stream depends on (seed, epoch) alone, as JAX
        # folds the epoch into its key: a resumed epoch draws the same masks
        generator.manual_seed(_DROPOUT_SEED_STRIDE * (seed + 1) + epoch)
        with _MaybeProfile(profile_dir, epoch, device):
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
    flush_seconds = _flush_before_restore()
    restore_checkpoint(model_dir, model)
    final_tv = compute_tv() if needs_tv else None
    _, _, preds, targets, logits = _run_eval_epoch(
        eval_step, val_loader, device, (final_tv,), collect="logits")
    save_confusion_matrix_png(targets, preds, class_names,
                              os.path.join(save_path, "confusion_matrix.png"))
    if (variant == "per_epoch_attn" and logits is not None
            and len(logits) > 3):
        save_tsne_png(logits, targets,
                      os.path.join(save_path, "tsne_best_val.png"),
                      device=device)
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
        "flush_seconds": flush_seconds,
        "grafted": grafted,
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
    profile_dir: Optional[str] = None,
    resume: bool = False,
) -> Dict[str, object]:
    """Train ``ResNet3DClassifier`` on (path, label) samples with Adam and
    no LR schedule; per epoch train, eval, ``results.txt`` and
    ``metrics.jsonl`` rows, best and latest checkpoints (``resume``
    continues from ``latest/``). After the last epoch the best weights are
    restored and evaluated once more, with their pooled features, and the
    confusion-matrix and t-SNE PNGs are written."""
    if not len(val_idx) or not len(train_idx):
        raise ValueError(
            f"empty split: {len(train_idx)} train / {len(val_idx)} val "
            "samples — increase --val-fraction or the cohort size")
    os.makedirs(save_path, exist_ok=True)
    results_file = os.path.join(save_path, "results.txt")
    model_dir = os.path.join(save_path, "best_model")
    latest_dir = os.path.join(save_path, "latest")
    num_classes = len(class_names)
    s2d_stem = _resolve_stem(s2d_stem, resume, save_path)

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
    model = place_model(ResNet3DClassifier(depth=model_depth,
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
                           config_lines or {}, style="unimodal",
                           append=resume)
    best_val_loss = float("inf")
    best_summary = None
    start_epoch = 1
    if resume and checkpoint_exists(latest_dir):
        meta = load_metadata(latest_dir) or {}
        restore_checkpoint(latest_dir, model, optimizer)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_val_loss = float(meta.get("best_val_loss", float("inf")))
        best_summary = meta.get("best_summary")
        print(f"Resumed from {latest_dir} at epoch {start_epoch}")
    history = []
    jsonl_path = os.path.join(save_path, "metrics.jsonl")
    for epoch in range(start_epoch, epochs + 1):
        clock = _PhaseClock()
        with _MaybeProfile(profile_dir, epoch, device):
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

    flush_seconds = _flush_before_restore()
    restore_checkpoint(model_dir, model)
    _, _, preds, targets, feats = _run_eval_epoch(
        eval_step, val_loader, device, collect="features")
    save_confusion_matrix_png(targets, preds, class_names,
                              os.path.join(save_path, "confusion_matrix.png"))
    if feats is not None and len(feats) > 3:
        save_tsne_png(feats, targets,
                      os.path.join(save_path, "tsne_best_val.png"),
                      title="t-SNE of Validation Predictions (Best 3D ResNet)",
                      device=device)
    return {
        "best_val_loss": best_val_loss,
        "best_summary": best_summary,
        "history": history,
        "model_dir": model_dir,
        "final_preds": preds,
        "final_targets": targets,
        "final_features": feats,
        "flush_seconds": flush_seconds,
    }

"""Prediction-only inference from a trained run directory (port of
``otfusion_tpu.cli.predict``).

Reads the serving manifest the trainers write (``model_config.json``), the
best checkpoint (``best_model/``) and, for the flagship, the final coupling
(``t_feature.npy``); predicts over a directory of (paired) NIfTI volumes;
writes ``predictions.csv`` (paths, the label the class folder gives, the
predicted label, per-class softmax probabilities) and prints the metrics
block. The backbones are built as ``model_config.json`` records them
(registry specs sized at its ``target_shape``). At load, ``--stem auto``
rewrites a plain stem of the default ResNet3D backbones onto the
space-to-depth stem (exact, ``models.resnet3d.s2d_stem_kernel``; never a
registry backbone's) and ``--fold-bn`` folds every eval-mode BatchNorm of
the conv backbones (ResNet3D, MedicalNet, Res2Net; Swin and UNETR have
none) into its conv (``utils.checkpoint.fold_state_for_serving``). Serving
launches no OT kernel: the flagship's attention reads the stored ``Tv``.

    python -m otfusion_tpu_torch.cli.predict --run-dir runs/flagship \\
        --data-dir datasets/ADNI/MRI-PET [--output predictions.csv]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from otfusion_tpu_torch.cli.common import resolve_device, resolve_dtype
from otfusion_tpu_torch.data.datasets import (
    MultimodalNiftiDataset,
    NiftiDataset,
)
from otfusion_tpu_torch.data.loader import (
    Loader,
    MultimodalLoader,
    _VolumeCache,
    feed_dtype_for,
    prefetch,
)
from otfusion_tpu_torch.metrics.classification import classification_metrics
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import (
    FoldableBackbone,
    ResNet3DClassifier,
)
from otfusion_tpu_torch.train.loop import StepTimer, place_model
from otfusion_tpu_torch.train.steps import (
    make_fusion_eval_step,
    make_unimodal_eval_step,
)
from otfusion_tpu_torch.utils.checkpoint import (
    fold_state_for_serving,
    restore_checkpoint,
    rewrite_stem_params,
)


def load_manifest(run_dir: str) -> dict:
    path = Path(run_dir) / "model_config.json"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found — predict needs the serving manifest the "
            "trainers write next to the checkpoint")
    with open(path) as f:
        return json.load(f)


def _second_modality_table(cfg: dict, data_dir: str, run_dir: str) -> dict:
    """The second modality's class folders: the manifest's
    ``class_names_b``, or, for a manifest without it, the MRI names with
    MRI -> PET when those folders exist; anything else raises rather than
    pair a modality with itself."""
    table_a = {k: int(v) for k, v in cfg["class_names"].items()}
    if cfg.get("class_names_b"):
        return {k: int(v) for k, v in cfg["class_names_b"].items()}
    table_b = {k.replace("MRI", "PET"): v for k, v in table_a.items()}
    missing = [name for name in table_b
               if not (Path(data_dir) / name).is_dir()]
    if missing or table_b.keys() == table_a.keys():
        raise FileNotFoundError(
            "legacy manifest has no class_names_b and the second-modality "
            "folders cannot be derived from class_names "
            f"{sorted(table_a)} (missing/underivable: "
            f"{missing or 'same names'}) under {data_dir} — add "
            f"\"class_names_b\" to {Path(run_dir) / 'model_config.json'} "
            "(the second-modality class-folder table the run was trained "
            "with)")
    return table_b


def _graft_s2d(trained, s2d_model, backbones) -> None:
    """Load ``trained`` into ``s2d_model``, each backbone's plain stem
    rewritten onto the space-to-depth stem."""
    state = trained.state_dict()
    for name in backbones:
        prefix = name + "."
        src = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix)}
        src = rewrite_stem_params(src, getattr(s2d_model, name).state_dict())
        state.update({prefix + k: v for k, v in src.items()})
    s2d_model.load_state_dict(state)
    print("Serving with the space-to-depth stem (lossless rewrite; "
          "--stem as-trained disables)")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Prediction-only inference from a trained run "
        "directory (best checkpoint + serving manifest)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--run-dir", required=True,
                        help="Training --save-path: holds best_model/, "
                        "model_config.json (and t_feature.npy for the "
                        "flagship)")
    parser.add_argument("--data-dir", required=True,
                        help="Root of the class folders to predict on")
    parser.add_argument("--output", default=None,
                        help="Predictions CSV path (default: "
                        "<run-dir>/predictions.csv)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--max-samples-per-class", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda raises when no GPU is present; it never "
                             "falls back to the CPU")
    parser.add_argument("--stem", choices=("auto", "as-trained"),
                        default="auto",
                        help="'auto' serves a plain-stem checkpoint through "
                        "the space-to-depth stem (exact rewrite at load) "
                        "when H and W are even; 'as-trained' keeps the "
                        "checkpoint's layout")
    parser.add_argument("--fold-bn", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="Fold eval-mode BatchNorm into the conv "
                        "weights at load (exact in float32)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    cfg = load_manifest(args.run_dir)
    target_shape = tuple(cfg["target_shape"])
    num_classes = int(cfg["num_classes"])
    compute_dtype = resolve_dtype(cfg.get("dtype", "float32"))
    feed = feed_dtype_for(compute_dtype)
    ckpt_dir = os.path.join(args.run_dir, "best_model")
    out_path = args.output or os.path.join(args.run_dir, "predictions.csv")
    cache = _VolumeCache(target_shape, num_workers=args.num_workers)
    cfg_s2d = bool(cfg.get("s2d_stem", False))
    even_hw = target_shape[1] % 2 == 0 and target_shape[2] % 2 == 0

    if cfg["kind"] == "fusion":
        table_a = {k: int(v) for k, v in cfg["class_names"].items()}
        table_b = _second_modality_table(cfg, args.data_dir, args.run_dir)
        dataset = MultimodalNiftiDataset(
            root_dir=args.data_dir, class_names_a=table_a,
            class_names_b=table_b,
            max_samples_per_class=args.max_samples_per_class)
        print(f"Found {len(dataset)} paired samples")
        loader = MultimodalLoader(dataset.samples, target_shape,
                                  args.batch_size, shuffle=False,
                                  cache=cache, feed_dtype=feed)
        s2d_rewrite = (args.stem == "auto" and not cfg_s2d
                       and not cfg.get("mri_backbone")
                       and not cfg.get("pet_backbone") and even_hw)

        def build(s2d):
            return MultimodalOTFusion(
                num_classes=num_classes, depth=int(cfg["model_depth"]),
                projection_dropout=float(cfg.get("projection_dropout", 0.0)),
                variant=cfg["variant"],
                mri_backbone=cfg.get("mri_backbone", ""),
                pet_backbone=cfg.get("pet_backbone", ""),
                s2d_stem=s2d, raw_plan=bool(cfg.get("raw_plan", False)),
                mri_shape=target_shape, pet_shape=target_shape)

        tv = None
        if cfg["variant"] == "per_epoch_attn":
            tv_path = os.path.join(args.run_dir, "t_feature.npy")
            if not os.path.exists(tv_path):
                raise FileNotFoundError(
                    f"{tv_path} not found — the flagship's attention "
                    "consumes the final training coupling at inference; "
                    "point --run-dir at a run that has one")
            tv = torch.from_numpy(np.load(tv_path)).to(device)
        model = build(cfg_s2d)
        backbones = ("mri_backbone", "pet_backbone")
        make_step = make_fusion_eval_step
        sample_paths = [(s[0], s[1]) for s in dataset.samples]
        extra = (tv,)
    else:
        table = {k: int(v) for k, v in cfg["class_names"].items()}
        dataset = NiftiDataset(
            root_dir=args.data_dir, class_names=table,
            max_samples_per_class=args.max_samples_per_class)
        print(f"Found {len(dataset)} samples")
        loader = Loader(dataset.samples, target_shape, args.batch_size,
                        shuffle=False, cache=cache, feed_dtype=feed)
        s2d_rewrite = args.stem == "auto" and not cfg_s2d and even_hw

        def build(s2d):
            return ResNet3DClassifier(depth=int(cfg["model_depth"]),
                                      num_classes=num_classes, s2d_stem=s2d)

        model = build(cfg_s2d)
        backbones = ("backbone",)
        make_step = make_unimodal_eval_step
        sample_paths = [(s[0],) for s in dataset.samples]
        extra = ()

    restore_checkpoint(ckpt_dir, model)
    if s2d_rewrite:
        trained, model = model, build(True)
        _graft_s2d(trained, model, backbones)
    model = place_model(model.eval(), device)
    if args.fold_bn and any(isinstance(m, FoldableBackbone)
                            for m in model.modules()):
        fold_state_for_serving(model)
        print("Serving with BatchNorm folded into the conv weights of the "
              "conv backbones (--no-fold-bn disables)")
    eval_step = make_step(model, compute_dtype=compute_dtype)

    preds, targets, probs = [], [], []
    timer = StepTimer(device)
    t0 = time.perf_counter()
    for batch in prefetch(iter(loader)):
        inputs = [x.to(device, non_blocking=True) for x in batch]
        start = timer.start()
        out = eval_step(*inputs, *extra)
        timer.stop(start)
        logits = out["logits"].cpu().numpy().astype(np.float32)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs.append(e / e.sum(axis=-1, keepdims=True))
        preds.extend(out["preds"].tolist())
        targets.extend(batch[-1].tolist())
    elapsed = time.perf_counter() - t0
    forward_ms = timer.median_ms()
    probs = np.concatenate(probs) if probs else np.zeros((0, num_classes))
    samples_per_s = len(preds) / elapsed if preds and elapsed > 0 else 0.0
    print(f"Predicted {len(preds)} samples in {elapsed:.2f} s "
          f"({samples_per_s:.1f} samples/s end-to-end, I/O + resize + "
          "forward)")
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"Median forward {forward_ms:.2f} ms per batch of "
          f"{args.batch_size} ({clock})")

    path_cols = (["mri_path", "pet_path"] if cfg["kind"] == "fusion"
                 else ["path"])
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(path_cols + ["label", "pred"]
                   + [f"prob_{c}" for c in range(num_classes)])
        for paths, label, pred, p in zip(sample_paths, targets, preds,
                                         probs):
            w.writerow([*paths, label, pred]
                       + [f"{float(x):.6f}" for x in p])
    print(f"Wrote {len(preds)} predictions to {out_path}")

    t = np.asarray(targets)
    p = np.asarray(preds)
    if len(t):
        m = classification_metrics(t, p, num_classes)
        acc = float((t == p).mean())
        print(f"Accuracy: {acc:.4f} Precision: {m['precision']:.4f} "
              f"Recall: {m['recall']:.4f} F1: {m['f1']:.4f} "
              f"Specificity: {m['specificity']:.4f}")
    return {"output": out_path, "n_samples": len(preds),
            "seconds": elapsed, "samples_per_s": samples_per_s,
            "median_forward_ms": forward_ms}


if __name__ == "__main__":
    main()

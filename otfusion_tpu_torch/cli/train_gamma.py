"""Legacy RIMA trainer (port of ``otfusion_tpu.cli.train_gamma``; reference
main.py): k-fold CV over the GAMMA fundus+OCT cohort, per-batch
bidirectional OT inside the train step, a per-epoch coupling over the train
set for validation, best-F1 checkpointing, and a final deep-ensemble
evaluation across folds (test.py parity) with the calibration battery.

Per epoch: the train steps (EGWL twice and kernel K2 in each, metrics read
two steps behind), the feature pass and coupling of the train set (kernel
K1 at L labels x ``--max-jax-samples``, then K2 on the (d_oct, 2048) plan),
validation under that plan, and a checkpoint when the validation
``classification_metrics(...)["f1"]`` (the macro F1) rises strictly. After
each fold the best checkpoint is restored and its plan recomputed. The
ensemble is scored on the last fold's validation set (whose cases the
other folds' members trained on, as in the JAX trainer), written to
``<save-path>/ensemble_metrics.json``; per-epoch phase seconds and median
step times go to ``<save-path>/timings.json``.

Run: ``python -m otfusion_tpu_torch.cli.train_gamma --data-root
<root>/MGamma --label-file labels.csv [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from otfusion_tpu_torch.cli.common import (
    resolve_device,
    resolve_dtype,
    set_seed,
)


def kfold_indices(n: int, n_splits: int, seed: int):
    """scikit-learn's ``KFold(n_splits, shuffle=True,
    random_state=seed).split(arange(n))``: ``RandomState(seed)`` shuffles
    ``arange(n)``, the first ``n % n_splits`` folds take one extra sample,
    and each fold's indices come back in ascending order."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"cannot split {n} samples into {n_splits} folds")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def add_gamma_args(parser: argparse.ArgumentParser) -> None:
    """Arguments the trainer and the tester share."""
    parser.add_argument("--data-root", type=str, required=True,
                        help="MGamma root (sibling multi-modality_images)")
    parser.add_argument("--label-file", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--oct-shape", type=int, nargs=3,
                        default=(96, 96, 96))
    parser.add_argument("--fundus-size", type=int, default=384)
    parser.add_argument("--num-classes", type=int, default=2)
    parser.add_argument("--max-jax-samples", type=int, default=64,
                        help="Max samples per label for the coupling")
    parser.add_argument("--ot-epsilon", type=float, default=5e-3)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda raises when no GPU is present; it never "
                             "falls back to the CPU")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])


def build_model(args, device):
    """The legacy model at ``--oct-shape`` on ``device`` (its OCT width
    from ``probe_oct_dim``)."""
    from otfusion_tpu_torch.models.legacy_fusion import (
        LegacyMultiModalFusion,
        probe_oct_dim,
    )

    return LegacyMultiModalFusion(
        num_classes=args.num_classes,
        oct_feature_dim=probe_oct_dim(args.oct_shape),
        oct_input_depth=args.oct_shape[0]).to(device)


def eval_coupling(model, loader, eval_step, args, device) -> torch.Tensor:
    """The (d_oct, 2048) feature plan Tv of ``model`` from the features of
    every batch of ``loader``: grouped by label (first
    ``--max-jax-samples`` of each), per-label GW (kernel K1 on CUDA), then
    FOT (kernel K2)."""
    from otfusion_tpu_torch.train.coupling import (
        coupling_pipeline,
        group_and_pad,
    )

    zeros = torch.zeros((model.oct_feature_dim, 2048), device=device)
    f_all, o_all, y_all = [], [], []
    for fundus, oct_vol, labels in loader:
        out = eval_step(model, fundus.to(device), oct_vol.to(device),
                        labels.to(device), zeros)
        f_all.append(out["fundus_feat"].float().cpu().numpy())
        o_all.append(out["oct_feat"].float().cpu().numpy())
        y_all.append(labels.numpy())
    f_all, o_all = np.concatenate(f_all), np.concatenate(o_all)
    y_all = np.concatenate(y_all)
    o_g, o_m = group_and_pad(o_all, y_all, args.num_classes,
                             args.max_jax_samples)
    f_g, f_m = group_and_pad(f_all, y_all, args.num_classes,
                             args.max_jax_samples)

    def on(a):
        return torch.from_numpy(a).to(device)

    tv, _, _ = coupling_pipeline(on(o_g), on(f_g), on(o_m), on(f_m),
                                 epsilon=args.ot_epsilon)
    return tv


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train legacy fundus+OCT OT fusion (GAMMA cohort)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    add_gamma_args(parser)
    parser.add_argument("--folds", type=int, default=5)
    parser.add_argument("--max-folds", type=int, default=None,
                        help="Train only the first K folds")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--save-path", type=str,
                        default="results/GAMMA_legacy")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)

    from otfusion_tpu_torch.data.gamma import GammaDataset, GammaLoader
    from otfusion_tpu_torch.data.loader import feed_dtype_for
    from otfusion_tpu_torch.metrics.classification import (
        classification_metrics,
    )
    from otfusion_tpu_torch.train.ensemble import (
        collect_member_logits,
        evaluate_ensemble,
    )
    from otfusion_tpu_torch.train.legacy_steps import (
        make_legacy_eval_step,
        make_legacy_train_step,
    )
    from otfusion_tpu_torch.train.loop import _PhaseClock, _run_train_epoch
    from otfusion_tpu_torch.train.train_state import make_optimizer
    from otfusion_tpu_torch.utils.checkpoint import (
        flush_checkpoints,
        restore_checkpoint,
        save_checkpoint,
    )

    os.makedirs(args.save_path, exist_ok=True)
    dataset = GammaDataset(args.data_root, args.label_file,
                           oct_shape=args.oct_shape,
                           fundus_size=args.fundus_size)
    print(f"GAMMA cohort: {len(dataset)} cases")
    compute_dtype = resolve_dtype(args.dtype)
    feed = feed_dtype_for(compute_dtype)
    eval_step = make_legacy_eval_step(compute_dtype=compute_dtype)

    folds = kfold_indices(len(dataset), args.folds, args.seed)
    if args.max_folds:
        folds = folds[: args.max_folds]

    fold_models, fold_tvs, timings = [], [], []
    for fold, (train_idx, val_idx) in enumerate(folds):
        print(f"\n=== Fold {fold + 1}/{len(folds)} "
              f"({len(train_idx)} train / {len(val_idx)} val) ===")
        train_loader = GammaLoader(dataset, train_idx, args.batch_size,
                                   shuffle=True, augment=True,
                                   seed=args.seed + fold, feed_dtype=feed)
        feat_loader = GammaLoader(dataset, train_idx, args.batch_size,
                                  feed_dtype=feed)
        val_loader = GammaLoader(dataset, val_idx, args.batch_size,
                                 feed_dtype=feed)

        torch.manual_seed(args.seed + fold)
        model = build_model(args, device)
        optimizer = make_optimizer(model.parameters(), args.lr)
        train_step = make_legacy_train_step(
            model, optimizer, ot_epsilon=args.ot_epsilon,
            compute_dtype=compute_dtype)
        generator = torch.Generator(device).manual_seed(args.seed + 100 + fold)

        best_f1 = -1.0
        fold_dir = os.path.join(args.save_path, f"fold{fold}")
        for epoch in range(1, args.epochs + 1):
            clock = _PhaseClock()
            train_loss, train_acc, step_ms = _run_train_epoch(
                train_step, train_loader, device, (generator,))
            clock("train")
            tv = eval_coupling(model, feat_loader, eval_step, args, device)
            clock("coupling")
            preds, targets = [], []
            for fundus, oct_vol, labels in val_loader:
                out = eval_step(model, fundus.to(device), oct_vol.to(device),
                                labels.to(device), tv)
                preds.extend(out["preds"].cpu().tolist())
                targets.extend(labels.tolist())
            m = classification_metrics(targets, preds, args.num_classes)
            clock("eval")
            print(f"fold {fold} epoch {epoch:03d} | "
                  f"train_loss={train_loss:.4f} "
                  f"train_acc={train_acc:.4f} | val_f1={m['f1']:.4f}")
            if m["f1"] > best_f1:
                best_f1 = m["f1"]
                save_checkpoint(fold_dir, model,
                                {"epoch": epoch, "fold": fold, **m})
            clock("checkpoint")
            timings.append({"fold": fold, "epoch": epoch,
                            "median_step_ms": step_ms,
                            "phase_seconds": dict(clock.phases)})
        restore_checkpoint(fold_dir, model)
        del optimizer, train_step
        fold_models.append(model)
        fold_tvs.append(eval_coupling(model, feat_loader, eval_step, args,
                                      device))

    # Deep-ensemble evaluation over the last fold's validation set.
    _, val_idx = folds[-1]
    val_loader = GammaLoader(dataset, val_idx, args.batch_size,
                             feed_dtype=feed)
    batches = [(f.to(device), o.to(device), l.to(device))
               for f, o, l in val_loader]
    member_logits, labels = collect_member_logits(
        fold_models, eval_step, batches, fold_tvs)
    metrics = evaluate_ensemble(member_logits, labels)
    flush_checkpoints()
    with open(os.path.join(args.save_path, "ensemble_metrics.json"),
              "w") as f:
        json.dump(metrics, f, indent=2, default=float)
    with open(os.path.join(args.save_path, "timings.json"), "w") as f:
        json.dump(timings, f, indent=2)
    print("\nEnsemble:", json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == "__main__":
    main()

"""Shared main() of the fusion trainers ``train_ot_attn``,
``train_mri_pet_ot``, ``train_mmfusion`` and ``train_t1_t2_ot`` (port of
``otfusion_tpu.cli._fusion_main``)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from types import SimpleNamespace

import torch

from otfusion_tpu_torch.cli.common import (
    add_common_args,
    add_ot_args,
    reject_unported,
    resolve_device,
    resolve_dtype,
    resolve_multimodal_split,
    set_seed,
)
from otfusion_tpu_torch.data.datasets import (
    CLASS_NAMES_MRI_BINARY,
    CLASS_NAMES_PET_BINARY,
    MultimodalNiftiDataset,
)
from otfusion_tpu_torch.data.splits import load_fixed_split
from otfusion_tpu_torch.train.loop import run_fusion_training


def fusion_main(*, variant: str, description: str, default_save_path: str,
                class_names_a=None, class_names_b=None, argv=None):
    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    add_common_args(
        parser, epochs=50, batch_size=2, lr=1e-5,
        save_path=default_save_path, data_dir="datasets/ADNI/MRI-PET",
    )
    add_ot_args(parser)
    args = parser.parse_args(argv)
    reject_unported(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # Fixed batch shapes: let cuDNN pick the fastest 3D-conv algorithms.
        torch.backends.cudnn.benchmark = True
    set_seed(args.seed)

    table_a = class_names_a or CLASS_NAMES_MRI_BINARY
    table_b = class_names_b or CLASS_NAMES_PET_BINARY

    patient_filter = None
    args._fixed_split = None
    id_split = None
    if args.load_patient_ids:
        spec = load_fixed_split(args.load_patient_ids, table_a)
        if spec["mode"] == "paths":
            args._fixed_split = spec
        elif spec["mode"] == "ids":
            id_split = spec
        elif spec["mode"] == "path_list":
            raise ValueError(
                "bare-list split files are train-only; supply a "
                "{train, val} split JSON (combine the emitted "
                "train_split.json/val_split.json)")
        else:
            patient_filter = spec["filter"]

    def build_dataset(filter_):
        return MultimodalNiftiDataset(
            root_dir=args.data_dir,
            class_names_a=table_a,
            class_names_b=table_b,
            max_samples_per_class=args.max_samples_per_class,
            patient_ids_filter=filter_,
            seed=args.seed,
        )

    repo_root = Path(args.data_dir).resolve().parent
    if id_split is not None:
        train_ds = build_dataset(id_split["train"])
        val_ds = build_dataset(id_split["val"])
        dataset = SimpleNamespace(
            samples=train_ds.samples + val_ds.samples,
            patient_ids_used={
                k: train_ds.patient_ids_used.get(k, [])
                + val_ds.patient_ids_used.get(k, [])
                for k in table_a
            },
        )
        print(f"Found {len(dataset.samples)} paired samples (fixed ID split)")
        fixed = (
            list(range(len(train_ds.samples))),
            list(range(len(train_ds.samples), len(dataset.samples))),
        )
        train_idx, val_idx = resolve_multimodal_split(
            args, dataset, repo_root, fixed_indices=fixed)
    else:
        dataset = build_dataset(patient_filter)
        print(f"Found {len(dataset)} paired samples")
        train_idx, val_idx = resolve_multimodal_split(args, dataset,
                                                      repo_root)
    print(f"Split: {len(train_idx)} train / {len(val_idx)} val")

    result = run_fusion_training(
        samples=dataset.samples,
        train_idx=train_idx,
        val_idx=val_idx,
        class_names=table_a,
        class_names_b=table_b,
        variant=variant,
        model_depth=args.model_depth,
        target_shape=tuple(args.target_shape),
        batch_size=args.batch_size,
        lr=args.lr,
        epochs=args.epochs,
        seed=args.seed,
        save_path=args.save_path,
        device=device,
        augment=args.augment,
        projection_dropout=args.projection_dropout,
        max_jax_samples=args.max_jax_samples,
        ot_epsilon=args.ot_epsilon,
        gw_max_iterations=args.gw_max_iterations,
        sinkhorn_max_iterations=args.sinkhorn_max_iterations,
        s2d_stem=args.s2d_stem,
        grad_accum=args.grad_accum,
        raw_plan=args.raw_reference_plan,
        compute_dtype=resolve_dtype(args.dtype),
        num_classes=2,
        num_workers=args.num_workers,
        latest_every=args.latest_every,
        feature_batch_size=args.feature_batch_size,
        eval_batch_size=args.eval_batch_size,
        config_lines={
            "Dataset": args.data_dir,
            "Train/Val Split": f"{1 - args.val_fraction:.1%}/"
                               f"{args.val_fraction:.1%}",
            "Total Samples": len(dataset.samples),
            "Train Samples": len(train_idx),
            "Val Samples": len(val_idx),
            "Batch Size": args.batch_size,
            "Learning Rate": args.lr,
            "Target Shape": list(args.target_shape),
            "Model Depth": args.model_depth,
            "Device": args.device,
        },
    )
    print(f"Best val loss: {result['best_val_loss']:.4f}")
    if result["best_summary"]:
        print(json.dumps(result["best_summary"], indent=2, default=float))
    print("Training complete!")
    return result

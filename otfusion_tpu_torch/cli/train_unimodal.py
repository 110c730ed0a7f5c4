"""Unimodal 3D ResNet trainer: single-modality AD/CN/MCI classification
with auto-detected class tables, ``--classes`` filtering and fixed or
stratified splits (port of ``otfusion_tpu.cli.train_unimodal``).

    python -m otfusion_tpu_torch.cli.train_unimodal --data-dir <ADNI root>
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from otfusion_tpu_torch.cli.common import (
    add_common_args,
    reject_unported,
    resolve_device,
    resolve_dtype,
    set_seed,
)
from otfusion_tpu_torch.data.datasets import (
    CLASS_NAMES_MRI,
    CLASS_NAMES_MRI_T1,
    CLASS_NAMES_MRI_T2,
    CLASS_NAMES_PET,
    NiftiDataset,
    detect_class_names,
)
from otfusion_tpu_torch.data.splits import (
    indices_from_path_entries,
    load_fixed_split,
    stratified_split,
)
from otfusion_tpu_torch.train.loop import run_unimodal_training

_TABLES = {"mri": CLASS_NAMES_MRI, "pet": CLASS_NAMES_PET,
           "t1": CLASS_NAMES_MRI_T1, "t2": CLASS_NAMES_MRI_T2}


def filter_classes(class_names: dict, wanted: list[str]) -> dict:
    """``--classes AD CN`` -> the matching folders, re-indexed in the
    order given."""
    filtered = {}
    for simple in wanted:
        match = next((d for d in class_names
                      if d.startswith(simple + "_") or f"_{simple}_" in d),
                     None)
        if match is None:
            raise ValueError(
                f"Class {simple} not found in available directories: "
                f"{list(class_names.keys())}")
        filtered[match] = len(filtered)
    return filtered


def _split(args, class_names, save_dir: Path):
    """(samples, train_idx, val_idx): a fixed patient-ID split (two
    cohorts), a fixed path split, or a stratified split of the cohort
    (which writes ``patient_ids.json``)."""
    spec = (load_fixed_split(args.load_patient_ids, class_names)
            if args.load_patient_ids else None)
    mode = spec["mode"] if spec else None
    common = dict(root_dir=args.data_dir, class_names=class_names,
                  max_samples_per_class=args.max_samples_per_class,
                  balance_to_minority=args.balance_to_minority,
                  seed=args.seed)
    if mode == "ids":
        train_ds = NiftiDataset(**common, patient_ids_filter=spec["train"])
        val_ds = NiftiDataset(**common, patient_ids_filter=spec["val"])
        samples = train_ds.samples + val_ds.samples
        n_train = len(train_ds.samples)
        return samples, list(range(n_train)), list(range(n_train,
                                                         len(samples)))
    if mode == "filter":
        dataset = NiftiDataset(**{**common, "max_samples_per_class": None},
                               patient_ids_filter=spec["filter"])
    else:
        dataset = NiftiDataset(**common)
    samples = dataset.samples
    if mode == "path_list":
        raise ValueError("bare-list split files are train-only; supply a "
                         "{train, val} split JSON")
    if mode == "paths":
        key = "mri_path" if args.modality != "pet" else "pet_path"
        root = Path(args.data_dir).resolve().parent
        return (samples,
                indices_from_path_entries(spec["train"], samples, root,
                                          path_key=key),
                indices_from_path_entries(spec["val"], samples, root,
                                          path_key=key))
    with open(save_dir / "patient_ids.json", "w") as f:
        json.dump(dataset.patient_ids_used, f, indent=2)
    train_idx, val_idx = stratified_split([s[1] for s in samples],
                                          args.val_fraction, args.seed)
    return samples, train_idx, val_idx


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a 3D ResNet on one ADNI modality",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    add_common_args(
        parser, epochs=200, batch_size=4, lr=2e-5,
        save_path="results/ADNI_MRI_3D_RESNET", data_dir="datasets/ADNI",
        num_workers=2,
    )
    parser.add_argument("--classes", type=str, nargs="+", default=None)
    parser.add_argument("--balance-to-minority", action="store_true")
    parser.add_argument("--modality", type=str, default="auto",
                        choices=["auto", "mri", "pet", "t1", "t2"])
    args = parser.parse_args(argv)
    reject_unported(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    set_seed(args.seed)

    class_names = _TABLES.get(args.modality) or \
        detect_class_names(args.data_dir)
    if args.classes:
        class_names = filter_classes(class_names, args.classes)
    print(f"Using classes: {class_names}")
    save_dir = Path(args.save_path)
    save_dir.mkdir(parents=True, exist_ok=True)
    samples, train_idx, val_idx = _split(args, class_names, save_dir)
    print(f"Split: {len(train_idx)} train / {len(val_idx)} val")

    result = run_unimodal_training(
        samples=samples,
        train_idx=train_idx,
        val_idx=val_idx,
        class_names=class_names,
        model_depth=args.model_depth,
        target_shape=tuple(args.target_shape),
        batch_size=args.batch_size,
        lr=args.lr,
        epochs=args.epochs,
        seed=args.seed,
        save_path=args.save_path,
        device=device,
        augment=args.augment,
        s2d_stem=args.s2d_stem,
        grad_accum=args.grad_accum,
        eval_batch_size=args.eval_batch_size,
        compute_dtype=resolve_dtype(args.dtype),
        num_workers=args.num_workers,
        latest_every=args.latest_every,
        profile_dir=args.profile_dir,
        resume=args.resume,
        config_lines={
            "Dataset": args.data_dir,
            "Train/Val Split": f"{1 - args.val_fraction:.1%}/"
                               f"{args.val_fraction:.1%}",
            "Total Samples": len(samples),
            "Train Samples": len(train_idx),
            "Val Samples": len(val_idx),
            "Batch Size": args.batch_size,
            "Learning Rate": args.lr,
            "Target Shape": list(args.target_shape),
            "Device": args.device,
        },
    )
    print(f"Best val loss: {result['best_val_loss']:.4f}")
    print("Training complete!")
    return result


if __name__ == "__main__":
    main()

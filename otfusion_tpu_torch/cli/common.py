"""Shared CLI plumbing (the subset of ``otfusion_tpu.cli.common`` the
single-device trainers need): argparse groups with the JAX CLI's names and
defaults, device resolution, seeding and split resolution.

Flags of the JAX CLI whose feature is not ported yet (parallelism) are
still accepted, and raise ``NotImplementedError`` when set
(``reject_unported``).
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

import numpy as np
import torch

from otfusion_tpu_torch.utils.device import resolve_device  # noqa: F401


def add_common_args(parser: argparse.ArgumentParser, *, epochs: int,
                    batch_size: int, lr: float, save_path: str,
                    data_dir: str, num_workers: int = 4) -> None:
    parser.add_argument("--data-dir", type=str, default=data_dir,
                        help="Root directory of the ADNI class folders")
    parser.add_argument("--epochs", type=int, default=epochs)
    parser.add_argument("--batch-size", type=int, default=batch_size)
    parser.add_argument("--num-workers", type=int, default=num_workers,
                        help="Volume-loading threads")
    parser.add_argument("--lr", type=float, default=lr)
    parser.add_argument("--val-fraction", type=float, default=0.2)
    parser.add_argument("--target-shape", type=int, nargs=3,
                        default=(128, 128, 128), metavar=("D", "H", "W"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save-path", type=str, default=save_path)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda raises when no GPU is present; it never "
                             "falls back to the CPU")
    parser.add_argument("--max-samples-per-class", type=int, default=None)
    parser.add_argument("--load-patient-ids", type=str, default=None,
                        help="Fixed-split or patient-filter JSON")
    parser.add_argument("--model-depth", type=int, default=101,
                        choices=[10, 18, 34, 50, 101, 152, 200])
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="Compute dtype (bf16 runs under torch.autocast "
                             "with fp32 parameters)")
    parser.add_argument("--s2d-stem", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="Space-to-depth ResNet stem (exact weight-space "
                             "equivalent of the stride-2 7x7 stem); default "
                             "on")
    parser.add_argument("--latest-every", type=int, default=1,
                        help="Save the 'latest' checkpoint every N epochs; "
                             "the final epoch always saves")
    parser.add_argument("--eval-batch-size", type=int, default=None,
                        help="Validation batch size (default 4x "
                             "--batch-size, voxel-capped)")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="Split each batch into N sequential "
                             "microbatches (strided rows i::N): one "
                             "optimiser update per batch with averaged "
                             "gradients; a batch N does not divide runs "
                             "unaccumulated")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from <save-path>/latest: model, "
                             "optimiser, LR scheduler, epoch and best "
                             "loss; results.txt and metrics.jsonl are "
                             "appended to")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of epoch 1's "
                             "train phase into this directory")
    # Accepted for CLI parity; each raises NotImplementedError when set.
    parser.add_argument("--num-devices", type=str, default="default")
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--tp-size", type=int, default=1)


def add_ot_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--max-jax-samples", type=int, default=64,
                        help="Max samples per label for OT computation")
    parser.add_argument("--ot-epsilon", type=float, default=5e-3)
    parser.add_argument("--gw-max-iterations", type=int, default=2000)
    parser.add_argument("--sinkhorn-max-iterations", type=int, default=2000)
    parser.add_argument("--projection-dropout", type=float, default=0.3)
    parser.add_argument("--feature-batch-size", type=int, default=None,
                        help="Batch size of the coupling's feature pass "
                             "(default 4x --batch-size, voxel-capped)")
    parser.add_argument("--raw-reference-plan", action="store_true",
                        help="Apply the raw plan pet_feat @ T.t() instead "
                             "of the column-normalised barycentric "
                             "projection")
    parser.add_argument("--mri-pretrained", type=str, default=None,
                        help="Pretrained MRI backbone: a port checkpoint "
                             "directory (a train_unimodal run's "
                             "best_model) or a torch .pth/.pt file")
    parser.add_argument("--pet-pretrained", type=str, default=None,
                        help="Pretrained PET backbone (as "
                             "--mri-pretrained)")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute each 3D ResNet block's "
                             "activations in the backward "
                             "(torch.utils.checkpoint): less activation "
                             "memory for larger batches")
    parser.add_argument("--mri-backbone", type=str, default="",
                        help="Registry backbone of the MRI side (e.g. "
                             "medicalnet-10, unetr_vit, resnet3d-18); "
                             "empty = the 3D ResNet at --model-depth")
    parser.add_argument("--pet-backbone", type=str, default="",
                        help="Registry backbone of the PET side (as "
                             "--mri-backbone)")


def check_volume_backbones(args: argparse.Namespace) -> None:
    """Build each registry backbone named by ``--mri-backbone`` /
    ``--pet-backbone`` on the meta device at ``--target-shape``, before any
    data is read: a 2D family (the volume trainers feed (B, D, H, W, 1)
    volumes) or a volume its geometry cannot take raises ``ValueError``."""
    from otfusion_tpu_torch.models.registry import feature_width

    for spec in (args.mri_backbone, args.pet_backbone):
        if spec:
            feature_width(spec, args.target_shape)


# flag -> (value meaning "not set", ROADMAP item that ports it)
_UNPORTED = {
    "num_devices": ("default", "parallelism"),
    "multihost": (False, "parallelism"),
    "tp_size": (1, "parallelism"),
}


def reject_unported(args: argparse.Namespace) -> None:
    """Raise for every flag set whose feature the port does not have yet."""
    for name, (unset, item) in _UNPORTED.items():
        if getattr(args, name, unset) != unset:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported to "
                f"otfusion_tpu_torch yet (ROADMAP.md, open item: {item})")


def resolve_dtype(name: str):
    """Compute dtype for autocast, or None for plain fp32."""
    return torch.bfloat16 if name == "bfloat16" else None


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_multimodal_split(args, dataset, repo_root: Path,
                             fixed_indices=None):
    """Fixed path-split JSON, precomputed indices (fixed patient-ID
    splits), patient-ID filter, or stratified split; emits the
    patient_ids/split artifacts and returns (train_idx, val_idx)."""
    from otfusion_tpu_torch.data.splits import (
        indices_from_path_entries,
        save_path_split,
        stratified_split,
    )

    save_dir = Path(args.save_path)
    save_dir.mkdir(parents=True, exist_ok=True)
    with open(save_dir / "patient_ids_all.json", "w") as f:
        json.dump(dataset.patient_ids_used, f, indent=2)

    if fixed_indices is not None:
        train_idx, val_idx = fixed_indices
    elif getattr(args, "_fixed_split", None):
        spec = args._fixed_split
        train_idx = indices_from_path_entries(spec["train"], dataset.samples,
                                              repo_root)
        val_idx = indices_from_path_entries(spec["val"], dataset.samples,
                                            repo_root)
    else:
        labels = [s[2] for s in dataset.samples]
        train_idx, val_idx = stratified_split(labels, args.val_fraction,
                                              args.seed)

    save_path_split(save_dir / "train_split.json", dataset.samples,
                    train_idx, repo_root)
    save_path_split(save_dir / "val_split.json", dataset.samples,
                    val_idx, repo_root)
    return train_idx, val_idx

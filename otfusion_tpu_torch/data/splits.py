"""Split management: stratified splits and the three fixed-split JSON
formats the reference consumes.

  1. per-class patient-ID lists ``{train: {class: [ids]}, val: {...}}``
     with cross-modality class-name prefix remapping (AD_MRI_* <-> AD_PET_*;
     3D_resnet.py:763-791 + map_ids logic).
  2. flat per-class patient-ID filter ``{class: [ids]}``
     (3D_resnet.py:793-816 cross-modality remap included).
  3. path-entry splits ``{train: [{mri_path, pet_path, label}], val: [...]}``
     (3D_resnet.py:856-872; emitted by the flagship trainer,
     attn:1135-1165).

Plus ``generate_patient_split``, the per-class shuffled patient split of
``cli/generate_split.py``.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Sequence, Tuple


def stratified_split(
    labels: Sequence[int],
    val_fraction: float,
    seed: int,
) -> Tuple[List[int], List[int]]:
    """Per-class shuffled index split (3D_resnet.py:443-474): the first
    ``int(n * val_fraction)`` shuffled indices of each class go to val."""
    by_label: Dict[int, List[int]] = {}
    for idx, label in enumerate(labels):
        by_label.setdefault(int(label), []).append(idx)
    rng = random.Random(seed)
    train_idx, val_idx = [], []
    for label, indices in by_label.items():
        rng.shuffle(indices)
        n_val = int(len(indices) * val_fraction)
        val_idx.extend(indices[:n_val])
        train_idx.extend(indices[n_val:])
    return train_idx, val_idx


def remap_class_ids(
    source_ids: Dict[str, List[str]], class_names: Dict[str, int]
) -> Dict[str, List[str]]:
    """Map patient-ID lists keyed by another modality's class dirs onto
    ``class_names`` by disease prefix (AD/CN/MCI) — 3D_resnet.py:771-786."""
    if not isinstance(source_ids, dict):
        raise ValueError(
            "patient-id split payload must map class directories to ID "
            f"lists, got {type(source_ids).__name__}"
        )
    mapped: Dict[str, List[str]] = {}
    for class_dir in class_names:
        if class_dir in source_ids:
            mapped[class_dir] = source_ids[class_dir]
            continue
        prefix = class_dir.split("_")[0]
        found = None
        for key in source_ids:
            if key.startswith(prefix + "_"):
                found = key
                break
        mapped[class_dir] = source_ids[found] if found else []
    return mapped


def load_fixed_split(path: str | Path, class_names: Dict[str, int]) -> dict:
    """Parse a fixed-split JSON into one of three normalised forms:

      {"mode": "paths", "train": [...], "val": [...]}          (format 3)
      {"mode": "ids", "train": {...}, "val": {...}}            (format 1)
      {"mode": "filter", "filter": {class: [ids]}}             (format 2)
      {"mode": "path_list", "entries": [...]}                  (format 3b:
          a bare list of path entries — the flagship emits train/val as
          two separate such files, attn:1141-1163)
    """
    with open(path) as f:
        payload = json.load(f)

    if isinstance(payload, list):
        if payload and not (
            isinstance(payload[0], dict) and "mri_path" in payload[0]
        ):
            raise ValueError(
                f"{path}: list-form split must contain path entries "
                "with an 'mri_path' key"
            )
        return {"mode": "path_list", "entries": payload}

    if isinstance(payload, dict) and "train" in payload and "val" in payload:
        sample = payload["train"]
        if (
            isinstance(sample, list)
            and sample
            and isinstance(sample[0], dict)
            and "mri_path" in sample[0]
        ):
            return {
                "mode": "paths",
                "train": payload["train"],
                "val": payload["val"],
            }
        return {
            "mode": "ids",
            "train": remap_class_ids(payload["train"], class_names),
            "val": remap_class_ids(payload["val"], class_names),
        }
    return {"mode": "filter", "filter": remap_class_ids(payload, class_names)}


def indices_from_path_entries(
    entries: List[dict],
    samples: Sequence[tuple],
    repo_root: str | Path,
    path_key: str = "mri_path",
    path_index: int = 0,
) -> List[int]:
    """Resolve path-entry split records to dataset indices
    (3D_resnet.py:856-869; flagship resolve at attn:1126-1135)."""
    path_to_index = {
        str(Path(s[path_index]).resolve()): i for i, s in enumerate(samples)
    }
    out = []
    for entry in entries:
        p = Path(entry[path_key])
        candidate = str(
            (p if p.is_absolute() else Path(repo_root) / p).resolve()
        )
        if candidate not in path_to_index:
            raise ValueError(f"Path {candidate} not found in dataset.")
        out.append(path_to_index[candidate])
    return out


def save_path_split(
    path: str | Path,
    samples: Sequence[tuple],
    indices: Sequence[int],
    repo_root: str | Path,
) -> None:
    """Emit a format-3 split file for a (mri, pet, label) sample list
    (flagship save_split_indices, attn:1141-1163)."""
    entries = []
    root = Path(repo_root).resolve()
    for idx in indices:
        mri_path, pet_path, label = samples[idx]
        def rel(p):
            rp = Path(p).resolve()
            try:
                return str(rp.relative_to(root))
            except ValueError:
                return str(rp)
        entries.append(
            {"mri_path": rel(mri_path), "pet_path": rel(pet_path),
             "label": int(label)}
        )
    with open(path, "w") as f:
        json.dump(entries, f, indent=2)


def generate_patient_split(
    patient_ids_by_class: Dict[str, List[str]],
    val_fraction: float,
    seed: int,
) -> Dict[str, Dict[str, List[str]]]:
    """Per-class sort and shuffle; the first ``int(n * val_fraction)``
    shuffled ids go to val, the rest to train. It seeds the stdlib's
    module-level ``random``, as the JAX function does, so the two give the
    same split."""
    random.seed(seed)
    out = {"train": {}, "val": {}}
    for class_dir, ids in patient_ids_by_class.items():
        ids = sorted(ids)
        random.shuffle(ids)
        n_val = int(len(ids) * val_fraction)
        out["val"][class_dir] = ids[:n_val]
        out["train"][class_dir] = ids[n_val:]
    return out

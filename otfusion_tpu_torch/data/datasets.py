"""Cohort assembly: NIfTI dataset indexing and MRI/PET pairing (a copy of
``otfusion_tpu.data.datasets``, which is pure Python; the JAX package's
``data`` package imports jax, so the port carries its own copy).

Behavioural port of the reference's dataset classes:

  * ``NiftiDataset`` — 3D_resnet.py:131-295: recursive sorted walk,
    patient-ID extraction, one-scan-per-patient dedup, per-class patient
    filters, balance-to-minority downsampling, max-samples-per-class cap.
  * ``MultimodalNiftiDataset`` — MRI_PET_OT.py:198-376: pairs MRI and PET
    scans of the same patient, label-consistency checked, patient-diverse
    random capping.

Parity-relevant details preserved: sorted ``os.walk`` for determinism
(3D_resnet.py:175-178), ``random.Random(seed)`` for all subsampling
(:197), the ``XXX_S_XXXX`` ADNI patient-ID pattern widened to 4-5 trailing
digits (MRI_PET_OT.py:310-327 + nojax:345), and insertion-ordered
``patient_ids_used`` emission.
"""

from __future__ import annotations

import os
import random
import re
from typing import Dict, List, Tuple

# Reference class tables (3D_resnet.py:60-82, MRI_T1_T2_OT.py:43-51).
CLASS_NAMES_MRI = {
    "AD_MRI_130_FIN": 0,
    "CN_MRI_229_FIN": 1,
    "MCI_MRI_86_FIN": 2,
}
CLASS_NAMES_PET = {
    "AD_PET_130_FIN": 0,
    "CN_PET_229_FIN": 1,
    "MCI_PET_86_FIN": 2,
}
CLASS_NAMES_MRI_T1 = {
    "1204_AD_MRI_T1_FIN": 0,
    "1204_CN_MRI_T1_FIN": 1,
    "1204_MCI_MRI_T1_FIN": 2,
}
CLASS_NAMES_MRI_T2 = {
    "1204_AD_MRI_T2_FIN": 0,
    "1204_CN_MRI_T2_FIN": 1,
    "1204_MCI_MRI_T2_FIN": 2,
}

# Paired (binary AD/CN) tables used by the fusion trainers
# (MRI_PET_OT_OT_per_epoch_attn.py:111-120).
CLASS_NAMES_MRI_BINARY = {"AD_MRI_130_FIN": 0, "CN_MRI_229_FIN": 1}
CLASS_NAMES_PET_BINARY = {"AD_PET_130_FIN": 0, "CN_PET_229_FIN": 1}

_PID_DIR_RE = re.compile(r"^\d{3}_S_\d{4,5}$")
_PID_FILE_RE = re.compile(r"^(\d{3}_S_\d{4,5})_")


def detect_class_names(root_dir: str) -> Dict[str, int]:
    """Auto-detect the modality's class table from present directories,
    priority T1 > T2 > MRI > PET (3D_resnet.py:85-119)."""

    def present(table):
        return any(
            os.path.isdir(os.path.join(root_dir, d)) for d in table
        )

    def count(table):
        return sum(
            os.path.isdir(os.path.join(root_dir, d)) for d in table
        )

    if present(CLASS_NAMES_MRI_T1):
        return CLASS_NAMES_MRI_T1
    if present(CLASS_NAMES_MRI_T2):
        return CLASS_NAMES_MRI_T2
    mri, pet = present(CLASS_NAMES_MRI), present(CLASS_NAMES_PET)
    if mri and not pet:
        return CLASS_NAMES_MRI
    if pet and not mri:
        return CLASS_NAMES_PET
    if mri and pet:
        return (
            CLASS_NAMES_MRI
            if count(CLASS_NAMES_MRI) >= count(CLASS_NAMES_PET)
            else CLASS_NAMES_PET
        )
    raise RuntimeError(f"No MRI or PET class directories found in {root_dir}")


def extract_patient_id(path: str) -> str | None:
    """ADNI patient ID from a directory component or filename prefix."""
    for part in path.split(os.sep):
        if _PID_DIR_RE.match(part):
            return part
    m = _PID_FILE_RE.match(os.path.basename(path))
    return m.group(1) if m else None


def _walk_nifti(dir_path: str):
    """Deterministic recursive scan for .nii/.nii.gz files."""
    for root, dirs, files in os.walk(dir_path):
        dirs.sort()
        files.sort()
        for name in files:
            if name.endswith((".nii", ".nii.gz")):
                yield os.path.join(root, name)


class NiftiDataset:
    """Single-modality cohort index: list of (path, label) samples."""

    def __init__(
        self,
        root_dir: str,
        class_names: Dict[str, int] | None = None,
        max_samples_per_class: int | None = None,
        patient_ids_filter: Dict[str, List[str]] | None = None,
        balance_to_minority: bool = False,
        seed: int = 42,
    ):
        self.root_dir = root_dir
        self.class_names = class_names or detect_class_names(root_dir)
        self.max_samples_per_class = max_samples_per_class
        self.patient_ids_filter = patient_ids_filter
        self.balance_to_minority = balance_to_minority
        self.seed = seed
        self.samples: List[Tuple[str, int]] = []
        self.patient_ids_used: Dict[str, List[str]] = {
            c: [] for c in self.class_names
        }
        self._collect()

    def _collect(self) -> None:
        rng = random.Random(self.seed)
        final: Dict[str, List[Tuple[str, int, str]]] = {}

        for class_dir, label in self.class_names.items():
            dir_path = os.path.join(self.root_dir, class_dir)
            groups: Dict[str, List[Tuple[str, int, str]]] = {}
            if os.path.isdir(dir_path):
                for path in _walk_nifti(dir_path):
                    pid = extract_patient_id(path)
                    if pid:
                        groups.setdefault(pid, []).append((path, label, pid))

            if self.patient_ids_filter and class_dir in self.patient_ids_filter:
                # Filter order follows the provided ID list (3D_resnet.py:203-209)
                final[class_dir] = [
                    groups[pid][0]
                    for pid in self.patient_ids_filter[class_dir]
                    if pid in groups
                ]
            else:
                # One scan per patient, walk order.
                final[class_dir] = [g[0] for g in groups.values()]

        if self.balance_to_minority and not self.patient_ids_filter:
            # Minority size over *present* classes only (the reference's
            # min over all configured classes, 3D_resnet.py:219-221, would
            # empty the cohort when a class directory is absent).
            sizes = [len(v) for v in final.values() if v]
            min_count = min(sizes) if sizes else 0
            for class_dir, class_samples in final.items():
                if len(class_samples) > min_count:
                    rng.shuffle(class_samples)
                    final[class_dir] = class_samples[:min_count]

        if self.max_samples_per_class:
            for class_dir, class_samples in final.items():
                if len(class_samples) > self.max_samples_per_class:
                    rng.shuffle(class_samples)
                    final[class_dir] = class_samples[
                        : self.max_samples_per_class
                    ]

        for class_dir, class_samples in final.items():
            for path, label, pid in class_samples:
                self.samples.append((path, label))
                if pid not in self.patient_ids_used[class_dir]:
                    self.patient_ids_used[class_dir].append(pid)

        if not self.samples:
            raise RuntimeError(f"No NIfTI files found under {self.root_dir}")

    def __len__(self) -> int:
        return len(self.samples)


class MultimodalNiftiDataset:
    """Paired MRI+PET cohort: list of (mri_path, pet_path, label).

    Pairing: PET scans are matched to MRI scans of the same patient ID with
    the same label (MRI_PET_OT.py:221-267). Works for MRI/PET and T1/T2
    trees via the ``class_names_a``/``class_names_b`` tables.
    """

    def __init__(
        self,
        root_dir: str,
        class_names_a: Dict[str, int] | None = None,
        class_names_b: Dict[str, int] | None = None,
        max_samples_per_class: int | None = None,
        patient_ids_filter: Dict[str, List[str]] | None = None,
        seed: int = 42,
    ):
        self.root_dir = root_dir
        self.class_names_a = class_names_a or CLASS_NAMES_MRI_BINARY
        self.class_names_b = class_names_b or CLASS_NAMES_PET_BINARY
        self.max_samples_per_class = max_samples_per_class
        self.patient_ids_filter = patient_ids_filter
        self.seed = seed
        self.samples: List[Tuple[str, str, int]] = []
        self.patient_ids_used: Dict[str, List[str]] = {
            c: [] for c in self.class_names_a
        }
        self._collect()

    def _collect(self) -> None:
        # Index modality A (MRI) by patient id.
        a_files: Dict[str, Tuple[str, int]] = {}
        for class_dir, label in self.class_names_a.items():
            dir_path = os.path.join(self.root_dir, class_dir)
            if not os.path.isdir(dir_path):
                continue
            for path in _walk_nifti(dir_path):
                pid = extract_patient_id(path)
                if pid:
                    a_files[pid] = (path, label)

        by_class: Dict[str, List[Tuple[str, str, int, str]]] = {
            c: [] for c in self.class_names_a
        }
        label_to_a_dir = {v: k for k, v in self.class_names_a.items()}
        for class_dir_b, label in self.class_names_b.items():
            class_dir_a = label_to_a_dir[label]
            dir_path = os.path.join(self.root_dir, class_dir_b)
            if not os.path.isdir(dir_path):
                continue
            for path_b in _walk_nifti(dir_path):
                pid = extract_patient_id(path_b)
                if pid and pid in a_files:
                    path_a, label_a = a_files[pid]
                    if label_a == label:
                        by_class[class_dir_a].append(
                            (path_a, path_b, label, pid)
                        )

        rng = random.Random(self.seed)
        for class_dir, class_samples in by_class.items():
            if self.patient_ids_filter and class_dir in self.patient_ids_filter:
                wanted = set(self.patient_ids_filter[class_dir])
                class_samples = [
                    s for s in class_samples if s[3] in wanted
                ]
            elif self.max_samples_per_class:
                # Patient-diverse random cap (MRI_PET_OT.py:279-297).
                groups: Dict[str, List] = {}
                for s in class_samples:
                    groups.setdefault(s[3], []).append(s)
                pids = list(groups)
                rng.shuffle(pids)
                selected = []
                for pid in pids:
                    if len(selected) >= self.max_samples_per_class:
                        break
                    selected.extend(groups[pid][:1])
                class_samples = selected[: self.max_samples_per_class]

            for path_a, path_b, label, pid in class_samples:
                self.samples.append((path_a, path_b, label))
                if pid not in self.patient_ids_used[class_dir]:
                    self.patient_ids_used[class_dir].append(pid)

        if not self.samples:
            raise RuntimeError(
                f"No paired samples found under {self.root_dir}"
            )

    def __len__(self) -> int:
        return len(self.samples)

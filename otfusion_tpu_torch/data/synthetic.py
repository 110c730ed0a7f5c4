"""Synthetic ADNI-layout fixture generator.

The reference ships no test data (and the ADNI cohort is access-controlled);
this generator builds a miniature on-disk tree with the exact directory and
naming conventions the cohort-assembly code expects:

    root/
      AD_MRI_130_FIN/<pid>/scan/AD_<pid>_MR.nii.gz
      CN_MRI_229_FIN/...
      AD_PET_130_FIN/<pid>/scan/<pid>_AV45.nii.gz
      CN_PET_229_FIN/...

Volumes carry a class- and modality-dependent signal (a centred Gaussian
blob whose radius/intensity depends on the class) so a model can actually
learn AD-vs-CN from the fixtures, plus patient-specific structure so
MRI/PET of the same patient are correlated — giving the OT alignment
something real to find.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from otfusion_tpu_torch.data.nifti_io import write_nifti


def _blob(shape, center, radius, rng):
    zz, yy, xx = np.meshgrid(
        *[np.arange(s, dtype=np.float32) for s in shape], indexing="ij"
    )
    c = [cc * s for cc, s in zip(center, shape)]
    dist2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
    return np.exp(-dist2 / (2.0 * (radius * min(shape)) ** 2))


def make_synthetic_adni(
    root: str | Path,
    n_per_class: int = 6,
    shape: tuple[int, int, int] = (24, 24, 24),
    classes: tuple[str, ...] = ("AD", "CN"),
    modalities: tuple[str, ...] = ("MRI", "PET"),
    seed: int = 0,
    heterogeneous_shapes: bool = False,
    class_gap: float = 1.0,
    noise: float = 0.05,
    signal_dropout: float = 0.0,
    signal_jitter: float = 0.0,
    shared_severity: float = 0.0,
) -> Path:
    """Build the fixture tree; returns the root path.

    ``heterogeneous_shapes`` varies raw scan shapes per patient (the real
    ADNI tree is anisotropic — get_nii_sizes.py exists because of it), to
    exercise the resize path.

    The "hard cohort" knobs shape the difficulty so architecture
    differences become measurable (on the default easy cohort every
    variant saturates at val acc 1.0):
      * ``class_gap`` scales the AD-vs-CN radius/intensity difference
        (1.0 = the easy default; ~0.3 leaves heavy class overlap).
      * ``noise`` is the additive volume noise sigma.
      * ``signal_dropout`` is the fraction of patients whose scan in ONE
        modality carries NO class signal (class-neutral blob) —
        alternating MRI/PET per patient, mirroring real cohorts where one
        scan is uninformative. A unimodal model caps near
        1 - dropout/2 while a fusion model can integrate both scans.
      * ``signal_jitter`` corrupts each scan's class signal with an
        INDEPENDENT per-(patient, modality) Gaussian perturbation — the
        complementary-evidence regime: with jitter comparable to
        class_gap a unimodal model is noise-limited by its single
        measurement while a fusion model averages two independent
        measurements (sqrt(2) SNR gain), so fusion strictly dominates
        either modality in expectation. Mirrors real multi-modal cohorts
        where each scan is a noisy view of the same pathology.
      * ``shared_severity`` (v3, see hard_cohort_summary.md) makes the
        CROSS-MODAL SHARED structure class-relevant: each patient draws
        a latent disease severity s = class +
        shared_severity*N(0,1), shared across the patient's scans;
        each scan observes s through its own independent measurement
        noise (``signal_jitter``) and renders it through
        MODALITY-SPECIFIC geometry — MRI encodes its severity view as
        blob radius/intensity (as before), PET encodes its view as blob
        POSITION along the depth axis with class-neutral amplitude. The
        two views share the pathology latent but express it in
        different geometric codes, the regime the reference's OT
        manifold alignment targets (two views of the same brain) and
        the regime the v2 generator provably lacked (its shared
        structure was class-irrelevant geometry). Labels stay the class
        directory, so large severity spread adds label noise near the
        boundary.
    """
    root = Path(root)
    rng = np.random.default_rng(seed)
    dir_counts = {"AD": 130, "CN": 229, "MCI": 86}

    for ci, cls in enumerate(classes):
        for mod in modalities:
            class_dir = root / f"{cls}_{mod}_{dir_counts[cls]}_FIN"
            for p in range(n_per_class):
                pid = f"{(ci + 1):03d}_S_{4000 + p:04d}"
                if heterogeneous_shapes:
                    s = tuple(
                        int(d + rng.integers(-4, 5)) for d in shape
                    )
                else:
                    s = shape
                # class signal: blob radius/intensity differ per class;
                # patient signal: blob centre jitter shared across
                # modalities of the same patient.
                pid_rng = np.random.default_rng(seed * 10_000 + ci * 100 + p)
                center = 0.5 + pid_rng.uniform(-0.1, 0.1, size=3)
                # signal dropout: this patient's MRI (even p) or PET
                # (odd p) blob is class-neutral.
                blind = (
                    pid_rng.uniform() < signal_dropout
                    and mod == ("MRI" if p % 2 == 0 else "PET")
                )
                eff = 0.5 if blind else float(ci)
                if shared_severity and not blind:
                    # latent severity SHARED across the patient's scans
                    # (the class-relevant cross-modal structure, see
                    # docstring)
                    sev_rng = np.random.default_rng((seed, 7, ci, p))
                    eff = float(ci) + \
                        shared_severity * sev_rng.standard_normal()
                if signal_jitter and not (blind and shared_severity):
                    # independent per-(patient, modality) measurement
                    # noise on the class/severity channel — NOT shared
                    # across the patient's scans (see docstring)
                    scan_rng = np.random.default_rng(
                        (seed, ci, p, 0 if mod == "MRI" else 1))
                    eff = eff + signal_jitter * scan_rng.standard_normal()
                if shared_severity and mod == "PET" and not blind:
                    # PET renders its severity view as blob POSITION
                    # along depth (class-neutral amplitude): the same
                    # latent as MRI, a different geometric code.
                    center = center.copy()
                    center[0] += 0.25 * float(np.clip(eff - 0.5,
                                                      -1.2, 1.2))
                    eff = 0.5
                radius = max(0.05, 0.18 + 0.10 * class_gap * eff)
                intensity = 1.0 + 0.5 * class_gap * eff
                vol = intensity * _blob(s, center, radius, rng)
                if mod == "PET":
                    vol = 0.8 * vol + 0.2 * _blob(s, center, radius * 1.5, rng)
                # patient-specific nuisance structure (shared across the
                # patient's modalities in position, not amplitude).
                nuis_center = 0.5 + pid_rng.uniform(-0.3, 0.3, size=3)
                vol = vol + 0.4 * _blob(s, nuis_center, 0.08, rng)
                vol = vol + noise * rng.normal(size=s).astype(np.float32)
                scan_dir = class_dir / pid / "scan"
                scan_dir.mkdir(parents=True, exist_ok=True)
                suffix = "_AV45.nii" if mod == "PET" else "_MR.nii.gz"
                write_nifti(
                    scan_dir / f"{pid}{suffix}", vol.astype(np.float32)
                )
    return root

"""Host-side volume preprocessing (the host path of
``otfusion_tpu.data.preprocess``): nan_to_num -> trilinear resize
(half-pixel centres, ``align_corners=False``) -> z-score with the Bessel-
corrected std and a 1e-5 guard. Pure NumPy, safe on loader threads."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from otfusion_tpu_torch.data.nifti_io import read_nifti


def resize_trilinear_np(
    volume: np.ndarray, target_shape: tuple[int, int, int]
) -> np.ndarray:
    """Trilinear resize of a (D, H, W) volume, axis by axis."""
    volume = np.asarray(volume, np.float32)
    out = volume
    for axis, new_size in enumerate(target_shape):
        old_size = out.shape[axis]
        if old_size == new_size:
            continue
        scale = old_size / new_size
        coords = (np.arange(new_size, dtype=np.float32) + 0.5) * scale - 0.5
        coords = np.clip(coords, 0.0, old_size - 1)
        lo = np.floor(coords).astype(np.int64)
        hi = np.minimum(lo + 1, old_size - 1)
        w = (coords - lo).astype(np.float32)
        moved = np.moveaxis(out, axis, 0)
        shape_w = (new_size,) + (1,) * (moved.ndim - 1)
        interp = moved[lo] * (1.0 - w.reshape(shape_w)) + moved[hi] * w.reshape(shape_w)
        out = np.moveaxis(interp, 0, axis)
    return out


def load_volume(
    path: str | Path,
    target_shape: tuple[int, int, int],
) -> np.ndarray:
    """Read and preprocess one scan; returns (D, H, W, 1) float32."""
    raw = read_nifti(path)
    raw = np.nan_to_num(np.asarray(raw, np.float32))
    if raw.ndim == 4:
        raw = raw[..., 0]  # first volume of a 4D series
    elif raw.ndim != 3:
        raise ValueError(f"{path}: expected 3D/4D volume, got {raw.shape}")
    vol = resize_trilinear_np(raw, tuple(target_shape))
    mean = vol.mean()
    std = vol.std(ddof=1) if vol.size > 1 else 0.0
    vol = (vol - mean) / (std + 1e-5)
    return vol[..., None]

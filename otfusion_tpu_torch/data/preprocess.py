"""Volume preprocessing (port of ``otfusion_tpu.data.preprocess``):
nan_to_num -> trilinear resize -> z-score with the Bessel-corrected std and
a 1e-5 guard.

Two paths, as in JAX:

  * on the tensor's device: ``resize_trilinear``, ``zscore``,
    ``preprocess_volume`` and ``random_flips`` (with ``flip_axes``, its
    deterministic half). ``resize_trilinear`` is ``jax.image.resize(method=
    "trilinear")``: triangle weights on half-pixel centres, and, since that
    call antialiases by default, the triangle widened by the scale on an
    axis that shrinks. It is one (new, old) weight matrix per axis, applied
    with one product per axis;
  * on the host: ``resize_trilinear_np`` and ``load_volume``, pure NumPy
    and safe on loader threads. This path interpolates between the two
    nearest voxels and does not antialias, as JAX's host path does not.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from otfusion_tpu_torch.data.nifti_io import read_nifti

_F32_EPS = float(np.finfo(np.float32).eps)


def _resize_weights(old: int, new: int, device) -> torch.Tensor:
    """(new, old) float32 weights of ``jax.image``'s antialiased triangle
    kernel (``compute_weight_mat``, translation 0)."""
    inv_scale = 1.0 / (new / old)
    sample = (torch.arange(new, dtype=torch.float32, device=device) + 0.5
              ) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(old, dtype=torch.float32,
                                        device=device)[None, :]).abs()
    w = (1.0 - x / max(inv_scale, 1.0)).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= old - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def resize_trilinear(volume: torch.Tensor,
                     target_shape: tuple[int, int, int]) -> torch.Tensor:
    """``jax.image.resize(volume, target_shape, "trilinear")`` of a float
    (D, H, W) tensor, on its device."""
    out = volume
    for axis, new in enumerate(target_shape):
        old = out.shape[axis]
        if old == new:
            continue
        w = _resize_weights(old, new, out.device).to(out.dtype)
        out = torch.movedim(
            torch.tensordot(w, torch.movedim(out, axis, 0), dims=1), 0, axis)
    return out


def zscore(volume: torch.Tensor) -> torch.Tensor:
    """Per-volume standardisation with the Bessel-corrected std."""
    mean = volume.mean()
    var = ((volume - mean) ** 2).sum() / max(volume.numel() - 1, 1)
    return (volume - mean) / (torch.sqrt(var) + 1e-5)


def preprocess_volume(volume: torch.Tensor,
                      target_shape: tuple[int, int, int]) -> torch.Tensor:
    """nan_to_num -> resize -> z-score of a (D, H, W) tensor; returns
    (D', H', W', 1) float32 on its device."""
    vol = torch.nan_to_num(volume.to(torch.float32))
    return zscore(resize_trilinear(vol, tuple(target_shape)))[..., None]


def flip_axes(volume: torch.Tensor, bits) -> torch.Tensor:
    """Flip (D, H, W, C) ``volume`` along each spatial axis whose bit is
    set (three bits, a sequence or a tensor); no host read."""
    if not isinstance(bits, torch.Tensor):
        bits = torch.tensor(np.asarray(bits, bool))
    bits = bits.to(volume.device)
    for axis in range(3):
        volume = torch.where(bits[axis], torch.flip(volume, (axis,)), volume)
    return volume


def random_flips(volume: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """Independent p = 0.5 flips along each spatial axis, drawn from
    ``generator`` (on its device)."""
    bits = torch.rand(3, generator=generator, device=generator.device) < 0.5
    return flip_axes(volume, bits)


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

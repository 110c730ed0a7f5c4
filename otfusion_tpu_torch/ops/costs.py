"""Cost-matrix construction for OT solvers (port of ``otfusion_tpu.ops.costs``).

  * squared-Euclidean point-cloud costs via the Gram expansion, clamped at 0;
  * ``scale_cost="max_cost"`` normalisation: divide by the (masked) max so
    the entropic epsilon is relative to the max cost.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def pairwise_sq_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``C[..., i, j] = ||x_i - y_j||^2`` for ``x`` (..., n, d), ``y`` (..., m, d)."""
    x_sq = torch.sum(x * x, dim=-1)
    y_sq = torch.sum(y * y, dim=-1)
    cross = x @ y.transpose(-1, -2)
    cost = x_sq[..., :, None] + y_sq[..., None, :] - 2.0 * cross
    # Gram expansion can go slightly negative from rounding; clamp like OTT.
    return torch.clamp_min(cost, 0.0)


def masked_max(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Max over the last two axes where ``mask`` is True (all if None)."""
    if mask is not None:
        values = torch.where(mask, values, torch.full_like(values, _NEG_INF))
    return torch.amax(values, dim=(-2, -1))


def scale_by_max(
    cost: torch.Tensor,
    mask: torch.Tensor | None = None,
    eps_floor: float = 1e-12,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Divide ``cost`` (..., n, m) by its (masked) max; a degenerate
    all-zero cost divides by 1. Returns ``(scaled_cost, scale)``."""
    m = masked_max(cost, mask)
    scale = torch.where(m > eps_floor, m, torch.ones_like(m))
    return cost / scale[..., None, None], scale

"""Entropic Gromov-Wasserstein (port of ``otfusion_tpu.ops.gromov``).

Per label: masked centring, max-scaled squared-Euclidean self-costs of the
centred clouds and uniform masked marginals; then the warm-started
linearisation loop of ``ops.gw_kernel`` (kernel K1 on CUDA tensors, its
batched plain version on CPU tensors); then the final GW cost and the
row-marginal check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otfusion_tpu_torch.ops.costs import pairwise_sq_euclidean, scale_by_max
from otfusion_tpu_torch.ops.gw_kernel import const_c, gw_solve, gw_solve_plain
from otfusion_tpu_torch.ops.sinkhorn import _masked_log_weights, f32


class GWResult(NamedTuple):
    """Solution of a batch of entropic GW problems (leading axis: label)."""

    coupling: torch.Tensor
    n_iters: torch.Tensor          # outer (linearisation) iterations
    converged: torch.Tensor        # outer loop converged
    linear_converged: torch.Tensor  # final row marginal within threshold
    cost: torch.Tensor             # <M(T), T>
    err: torch.Tensor              # final relative ||T - T_prev||_F


def _prep(feats: torch.Tensor, mask: torch.Tensor):
    """Masked centring, max-scaled self-cost (0 on padded pairs) and the
    uniform masked marginal with its log, batched over labels."""
    feats = torch.nan_to_num(feats.detach().to(torch.float32))
    mask = mask.to(device=feats.device, dtype=torch.bool)
    count = torch.clamp_min(mask.sum(dim=1), 1)
    centre = (torch.where(mask[..., None], feats, 0.0).sum(dim=1, keepdim=True)
              / count[:, None, None])
    centred = feats - centre
    pair = mask[:, :, None] & mask[:, None, :]
    c, _ = scale_by_max(pairwise_sq_euclidean(centred, centred), pair)
    c = torch.where(pair, c, 0.0)
    w, log_w = _masked_log_weights(None, mask, mask.shape[1], feats.device)
    return c.contiguous(), w.contiguous(), log_w.contiguous()


def _egw(x, y, x_mask, y_mask, *, epsilon, max_iterations, inner_sweeps,
         threshold, sinkhorn_threshold, plain) -> GWResult:
    with torch.no_grad():
        cx, p, log_p = _prep(x, x_mask)
        cy, q, log_q = _prep(y, y_mask)
        solve = gw_solve_plain if plain else gw_solve
        t, n_iters, err = solve(
            cx, cy, log_p, log_q, p, q, epsilon=epsilon,
            max_iterations=max_iterations, threshold=threshold,
            inner_sweeps=inner_sweeps)
        m_final = const_c(cx, cy, p, q) - 2.0 * cx @ (t @ cy.transpose(-1, -2))
        cost = torch.sum(m_final * t, dim=(1, 2))
        row_err = torch.sum(torch.abs(t.sum(dim=2) - p), dim=1)
        return GWResult(
            coupling=t,
            n_iters=n_iters,
            converged=err <= f32(threshold),
            linear_converged=row_err <= f32(sinkhorn_threshold),
            cost=cost,
            err=err,
        )


def egw_per_label(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor,
    y_mask: torch.Tensor,
    *,
    epsilon: float = 5e-3,
    max_iterations: int = 2000,
    sinkhorn_max_iterations: int = 2000,
    threshold: float = 1e-3,
    sinkhorn_threshold: float = 1e-3,
    plain: bool = False,
) -> GWResult:
    """Batched per-label entropic GW: x (L, n_cap, d), y (L, m_cap, d'),
    validity masks (L, n_cap) / (L, m_cap). CUDA inputs run kernel K1,
    CPU inputs the batched plain solver; ``plain=True`` takes the plain
    solver on any device."""
    return _egw(x, y, x_mask, y_mask, epsilon=epsilon,
                max_iterations=max_iterations,
                inner_sweeps=min(10, sinkhorn_max_iterations),
                threshold=threshold, sinkhorn_threshold=sinkhorn_threshold,
                plain=plain)


def egw_per_label_kernel(x, y, x_mask, y_mask, **kwargs) -> GWResult:
    """``egw_per_label`` on CUDA inputs, which solves through kernel K1
    (the counterpart of ``egw_per_label_pallas``); raises for inputs that
    are not on a CUDA device."""
    if not x.is_cuda:
        raise ValueError(f"egw_per_label_kernel: expected CUDA inputs, got "
                         f"{x.device}")
    return egw_per_label(x, y, x_mask, y_mask, **kwargs)


def entropic_gw(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    epsilon: float = 5e-3,
    max_iterations: int = 2000,
    sinkhorn_max_iterations: int = 2000,
    threshold: float = 1e-3,
    sinkhorn_threshold: float = 1e-3,
    inner_sweeps: int = 10,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
) -> GWResult:
    """Entropic GW between point clouds ``x`` (n, d) and ``y`` (m, d'):
    ``egw_per_label`` on a batch of one label."""
    xm = (torch.ones(x.shape[0], dtype=torch.bool) if x_mask is None
          else x_mask)
    ym = (torch.ones(y.shape[0], dtype=torch.bool) if y_mask is None
          else y_mask)
    res = _egw(x[None], y[None], xm[None], ym[None], epsilon=epsilon,
               max_iterations=max_iterations,
               inner_sweeps=min(inner_sweeps, sinkhorn_max_iterations),
               threshold=threshold, sinkhorn_threshold=sinkhorn_threshold,
               plain=False)
    return GWResult(*(v[0] for v in res))

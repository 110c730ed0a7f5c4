"""Entropic Gromov-Wasserstein (port of ``otfusion_tpu.ops.gromov``).

Per label: masked centring, max-scaled squared-Euclidean self-costs of the
centred clouds and uniform masked marginals; then the warm-started
linearisation loop of ``ops.gw_kernel`` (kernel K1 on CUDA tensors, its
batched plain version on CPU tensors); then the final GW cost and the
row-marginal check.

``entropic_gw_labels`` (EGWL) is another problem: ONE global GW over the
concatenated cohorts, its self-costs max-scaled over all pairs and its
plan masked to the label blocks (not a product of row and column masks).
The JAX package computes it with XLA ops and no Pallas kernel, so here it
is PyTorch ops on the tensors' device (``_egw_warm_loop``), the loop's
exit read on the host once per 8 linearisations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from otfusion_tpu_torch.ops.costs import pairwise_sq_euclidean, scale_by_max
from otfusion_tpu_torch.ops.gw_kernel import const_c, gw_solve, gw_solve_plain
from otfusion_tpu_torch.ops.sinkhorn import (
    _masked_log_weights,
    f32,
    log_sinkhorn_sweeps,
)

_STALL_PATIENCE = 25
_OUTER_UNROLL = 8
_BIG = 1e30


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


def _egw_warm_loop(linearized_cost, pair_mask, p_w, log_p, log_q, epsilon,
                   max_iterations, threshold, inner_sweeps, t0):
    """Warm-started entropic-GW linearisation loop of one (n, m) problem
    (JAX ``_egw_warm_loop``): each of ``_OUTER_UNROLL`` micro-steps per
    check re-linearises the cost (1e30 off ``pair_mask``), runs
    ``inner_sweeps`` log-domain sweeps from the previous duals and forms
    the plan; a check reads the relative plan change to the host, and the
    loop ends at the threshold, after ``_STALL_PATIENCE`` checks without a
    0.999x improvement, or at ``max_iterations``. Returns (T, err,
    n_iters, row-marginal L1 error)."""
    eps = float(epsilon)
    thr = np.float32(threshold)

    def masked(mat):
        return torch.where(pair_mask, mat, _BIG)

    def plan(f, g, m_cost):
        t = torch.exp((f[:, None] + g[None, :] - m_cost) / eps)
        return torch.where(pair_mask, t, 0.0)

    t = t0
    f = torch.zeros(t0.shape[0], dtype=torch.float32, device=t0.device)
    g = torch.zeros(t0.shape[1], dtype=torch.float32, device=t0.device)
    err = best = np.float32(np.inf)
    it = stall = 0
    while it < max_iterations and err > thr and stall < _STALL_PATIENCE:
        t_new = t
        for _ in range(_OUTER_UNROLL):
            m_cost = masked(linearized_cost(t_new))
            f, g = log_sinkhorn_sweeps(m_cost, log_p, log_q, eps, f, g,
                                       inner_sweeps)
            t_new = plan(f, g, m_cost)
        e = (torch.linalg.vector_norm(t_new - t)
             / torch.clamp_min(torch.linalg.vector_norm(t_new), 1e-30))
        err = np.float32(e.item())
        stall = 0 if err < np.float32(0.999) * best else stall + 1
        best = np.minimum(best, err)
        t = t_new
        it += _OUTER_UNROLL
    row_err = torch.sum(torch.abs(torch.sum(t, dim=1) - p_w))
    return t, err, it, row_err


def entropic_gw_labels(
    x: torch.Tensor,
    y: torch.Tensor,
    labels_x: torch.Tensor,
    labels_y: torch.Tensor,
    *,
    epsilon: float = 5e-3,
    max_iterations: int = 2000,
    sinkhorn_max_iterations: int = 2000,
    threshold: float = 1e-3,
    sinkhorn_threshold: float = 1e-3,
    inner_sweeps: int = 10,
) -> GWResult:
    """Label-constrained global entropic GW (EGWL) between ``x`` (n, d) and
    ``y`` (m, d') with per-sample labels: centred clouds, self-costs
    max-scaled over all pairs, uniform marginals, the plan masked to pairs
    of equal labels (off-block entries carry cost 1e30) and started from
    the masked product plan. Computed on the tensors' device; ``n_iters``
    grows in steps of 8. Results are 0-d tensors but ``coupling``."""
    with torch.no_grad():
        x = torch.nan_to_num(x.detach().to(torch.float32))
        y = torch.nan_to_num(y.detach().to(torch.float32))
        device = x.device
        n, m = x.shape[0], y.shape[0]
        plan_mask = (labels_x.to(device)[:, None]
                     == labels_y.to(device)[None, :])
        x = x - torch.mean(x, dim=0)
        y = y - torch.mean(y, dim=0)
        cx, _ = scale_by_max(pairwise_sq_euclidean(x, x))
        cy, _ = scale_by_max(pairwise_sq_euclidean(y, y))
        p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
        q = torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)
        c0 = ((cx * cx) @ p)[:, None] + ((cy * cy) @ q)[None, :]
        _, log_p = _masked_log_weights(None, None, n, device)
        _, log_q = _masked_log_weights(None, None, m, device)

        def linearized_cost(tt):
            return c0 - 2.0 * cx @ (tt @ cy.T)

        t0 = torch.where(plan_mask, p[:, None] * q[None, :], 0.0)
        t0 = t0 / torch.clamp_min(torch.sum(t0), 1e-30)
        t, err, n_iters, row_err = _egw_warm_loop(
            linearized_cost, plan_mask, p, log_p, log_q, epsilon,
            max_iterations, threshold,
            min(inner_sweeps, sinkhorn_max_iterations), t0)
        cost = torch.sum(linearized_cost(t) * t)
        return GWResult(
            coupling=t,
            n_iters=torch.tensor(n_iters, dtype=torch.int32, device=device),
            converged=torch.tensor(bool(err <= np.float32(threshold)),
                                   device=device),
            linear_converged=row_err <= f32(sinkhorn_threshold),
            cost=cost,
            err=torch.tensor(err, dtype=torch.float32, device=device),
        )

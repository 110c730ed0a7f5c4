"""Log-domain entropic OT (Sinkhorn) solver (port of ``otfusion_tpu.ops.sinkhorn``).

Semantics kept from the JAX solver:

  * log-domain updates with fp32 accumulators;
  * explicit row/column/plan masks realised with the -1e30 sentinel: padded
    entries carry cost 1e30 (zero kernel weight) and log-weight -1e30;
  * ``scale_cost`` divides by the masked max cost;
  * ``f0 = update_f(0)`` then ``g0``, the L1 row-marginal error after them,
    ``n_iters`` starting at 1 and growing by ``check_every`` sweeps per
    check until the error drops to ``threshold`` or ``max_iterations``;
  * no gradient through the solve;
  * ``n_iters``, ``converged`` and ``err`` returned as device tensors.

The solve itself is ``ops.sinkhorn_kernel.solve``: on CUDA tensors kernel
K2 runs it whole, exit included, in one launch and the host reads nothing;
on CPU tensors its plain version runs the loop on the host and reads the
error once per check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otfusion_tpu_torch.ops import sinkhorn_kernel
from otfusion_tpu_torch.ops.costs import scale_by_max

_NEG_INF = -1e30


class SinkhornResult(NamedTuple):
    """Solution of an entropic OT problem (see the JAX ``SinkhornResult``).
    ``n_iters``, ``converged`` and ``err`` are 0-d tensors on the cost's
    device, as JAX's are device arrays: a caller that logs one reads it."""

    coupling: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    n_iters: torch.Tensor
    converged: torch.Tensor
    err: torch.Tensor
    cost: torch.Tensor


def f32(x: float) -> float:
    """``x`` rounded to float32, so host-side comparisons with fp32 device
    values behave as the JAX solver's fp32 comparisons do."""
    return torch.tensor(x, dtype=torch.float32).item()


def _masked_log_weights(
    w: torch.Tensor | None, mask: torch.Tensor | None, n: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, log_weights) of a marginal over the last axis; uniform
    over valid entries when ``w`` is None, -1e30 log-weight on padding."""
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)
    mask = mask.to(torch.bool)
    if w is None:
        count = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1)
        w = torch.where(mask, 1.0 / count, 0.0).to(torch.float32)
    else:
        w = torch.where(mask, w.to(torch.float32), 0.0)
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-30)
    log_w = torch.where(mask, torch.log(torch.clamp_min(w, 1e-38)),
                        torch.full_like(w, _NEG_INF))
    return w, log_w


def log_sinkhorn_sweeps(cost, log_p, log_q, epsilon, f, g, sweeps: int):
    """``sweeps`` paired log-domain updates from warm-start duals, batched
    over any leading axes: cost (..., n, m), log_p/f (..., n), log_q/g
    (..., m). ``cost`` carries its masking already (1e30 on disallowed
    entries)."""
    eps = float(epsilon)
    neg_c = -cost / eps
    for _ in range(sweeps):
        f = eps * (log_p - torch.logsumexp(neg_c + g[..., None, :] / eps,
                                           dim=-1))
        g = eps * (log_q - torch.logsumexp(neg_c + f[..., :, None] / eps,
                                           dim=-2))
    return f, g


def _sinkhorn(cost, p, q, epsilon, max_iterations, threshold, scale_cost,
              row_mask, col_mask, plan_mask, check_every,
              plain: bool) -> SinkhornResult:
    cost = cost.detach().to(torch.float32)
    n, m = cost.shape
    device = cost.device
    if row_mask is not None:
        row_mask = row_mask.to(device=device, dtype=torch.bool)
    if col_mask is not None:
        col_mask = col_mask.to(device=device, dtype=torch.bool)

    pair_mask = None
    if row_mask is not None or col_mask is not None or plan_mask is not None:
        rm = row_mask if row_mask is not None else torch.ones(
            n, dtype=torch.bool, device=device)
        cm = col_mask if col_mask is not None else torch.ones(
            m, dtype=torch.bool, device=device)
        pair_mask = rm[:, None] & cm[None, :]
        if plan_mask is not None:
            pair_mask = pair_mask & plan_mask.to(device=device,
                                                 dtype=torch.bool)

    cost_scaled = scale_by_max(cost, pair_mask)[0] if scale_cost else cost
    if pair_mask is not None:
        cost_scaled = torch.where(pair_mask, cost_scaled, -_NEG_INF)

    p_w, log_p = _masked_log_weights(p, row_mask, n, device)
    q_w, log_q = _masked_log_weights(q, col_mask, m, device)

    eps = float(epsilon)
    neg_c = (-cost_scaled / eps).contiguous()
    thr = f32(threshold)

    run = sinkhorn_kernel.solve_plain if plain else sinkhorn_kernel.solve
    f, g, coupling, n_iters, err = run(
        neg_c, log_p, log_q, p_w, eps, max_iterations=max_iterations,
        threshold=thr, check_every=check_every)
    if pair_mask is not None:
        coupling = torch.where(pair_mask, coupling, 0.0)
        transport_cost = torch.sum(coupling * torch.where(pair_mask, cost, 0.0))
    else:
        transport_cost = torch.sum(coupling * cost)
    return SinkhornResult(coupling=coupling, f=f, g=g, n_iters=n_iters,
                          converged=err <= thr, err=err, cost=transport_cost)


def sinkhorn(
    cost: torch.Tensor,
    p: torch.Tensor | None = None,
    q: torch.Tensor | None = None,
    *,
    epsilon: float = 1e-2,
    max_iterations: int = 2000,
    threshold: float = 1e-3,
    scale_cost: bool = False,
    row_mask: torch.Tensor | None = None,
    col_mask: torch.Tensor | None = None,
    plan_mask: torch.Tensor | None = None,
    check_every: int = 5,
    plain: bool = False,
) -> SinkhornResult:
    """Solve entropic OT ``min_T <C, T> - eps H(T)`` with marginals (p, q).

    Arguments as in ``otfusion_tpu.ops.sinkhorn.sinkhorn``. A CUDA ``cost``
    runs on kernel K2, a CPU ``cost`` on the plain solve; ``plain=True``
    takes the plain solve on any device (the version the kernel is held
    against).
    """
    with torch.no_grad():
        return _sinkhorn(cost, p, q, epsilon, max_iterations, threshold,
                         scale_cost, row_mask, col_mask, plan_mask,
                         check_every, plain)

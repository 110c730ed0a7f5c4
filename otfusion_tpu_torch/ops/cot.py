"""Labelled CO-Optimal Transport, COOT-L (port of ``otfusion_tpu.ops.cot``).

Block-coordinate descent over per-label *sample* couplings Ts^k and one
shared *feature* coupling Tv:

  repeat:  for each label k:  M_s^k = constC_s^k - 2 X_k Tv Y_k^T
                              Ts^k  = OT(M_s^k, w1_k, w2_k)
           M_v = sum_k (constC_v^k - 2 X_k^T Ts^k Y_k)
           Tv  = OT(M_v, v1, v2), renormalised to mass 1
  until ||dTs|| + ||dTv|| < 1e-16 or |dcost| < 1e-7, at most ``niter``.

Labels are padded to a common cap with validity masks. Every OT is a
``sinkhorn`` solve with ``scale_cost=True`` (kernel K2 on CUDA): the sample
stage one solve per label under its row and column masks (JAX vmaps the
stage; here it is a loop over labels), the feature stage one solve on
(d, d') with COOT's feature marginals, which are the normalised column
sums when the features are non-negative (a dead channel then has mass 0)
and uniform otherwise. The exit is read on the host once per COOT
iteration, never once per solve: L + 1 launches and one read an iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otfusion_tpu_torch.ops.sinkhorn import sinkhorn


class COTLResult(NamedTuple):
    sample_couplings: torch.Tensor  # (L, n_cap, m_cap)
    feature_coupling: torch.Tensor  # (d, d')
    cost: torch.Tensor              # 0-d, <M_v, Tv>
    n_iters: int                    # COOT iterations run
    converged: bool


class COOTProblem(NamedTuple):
    """The masked data of a COOT-L problem and what stays fixed across its
    iterations: per-label sample weights ``w1`` (L, n), ``w2`` (L, m),
    feature marginals ``v1`` (d,), ``v2`` (d',) and the constant part of
    the sample costs (L, n, m)."""

    x: torch.Tensor
    y: torch.Tensor
    x_mask: torch.Tensor
    y_mask: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    const_s: torch.Tensor


def _feature_marginal(flat: torch.Tensor, data_driven: bool) -> torch.Tensor:
    """Normalised column sums of non-negative data, else uniform."""
    d = flat.shape[1]
    uniform = torch.full((d,), 1.0 / d, dtype=torch.float32,
                         device=flat.device)
    if not data_driven:
        return uniform
    sums = flat.sum(0) / torch.clamp_min(flat.sum(), 1e-30)
    return torch.where(torch.all(flat >= 0), sums, uniform)


def coot_problem(x, y, x_mask, y_mask,
                 data_driven_feature_marginals: bool = True) -> COOTProblem:
    """Float32, NaN-free, masked copies of the padded data (L, n_cap, d),
    (L, m_cap, d') and their fixed weights and costs."""
    x = torch.nan_to_num(x.detach().to(torch.float32))
    y = torch.nan_to_num(y.detach().to(torch.float32))
    x_mask = x_mask.to(device=x.device, dtype=torch.bool)
    y_mask = y_mask.to(device=x.device, dtype=torch.bool)
    x = torch.where(x_mask[..., None], x, 0.0)
    y = torch.where(y_mask[..., None], y, 0.0)
    # Per-label uniform sample weights over valid rows.
    w1 = x_mask / torch.clamp_min(x_mask.sum(1, keepdim=True), 1)
    w2 = y_mask / torch.clamp_min(y_mask.sum(1, keepdim=True), 1)
    v1 = _feature_marginal(x.reshape(-1, x.shape[2]),
                           data_driven_feature_marginals)
    v2 = _feature_marginal(y.reshape(-1, y.shape[2]),
                           data_driven_feature_marginals)
    const_s = ((x * x) @ v1)[:, :, None] + ((y * y) @ v2)[:, None, :]
    return COOTProblem(x, y, x_mask, y_mask, w1, w2, v1, v2, const_s)


def sample_costs(prob: COOTProblem, tv: torch.Tensor) -> torch.Tensor:
    """Each label's linearised sample cost (L, n, m) given Tv."""
    return prob.const_s - 2.0 * torch.einsum("lnd,de,lme->lnm", prob.x, tv,
                                             prob.y)


def feature_costs(prob: COOTProblem, ts: torch.Tensor) -> torch.Tensor:
    """The shared feature cost (d, d') given the sample plans, summed over
    labels."""
    x, y = prob.x, prob.y
    const_v = (torch.einsum("lnd,ln->d", x * x, torch.sum(ts, dim=2))[:, None]
               + torch.einsum("lme,lm->e", y * y, torch.sum(ts, dim=1))[None])
    return const_v - 2.0 * torch.einsum("lnd,lnm,lme->de", x, ts, y)


def cotl(
    x: torch.Tensor,       # (L, n_cap, d) zero-padded
    y: torch.Tensor,       # (L, m_cap, d')
    x_mask: torch.Tensor,  # (L, n_cap)
    y_mask: torch.Tensor,  # (L, m_cap)
    *,
    epsilon: float = 0.2,
    feature_epsilon: float | None = None,
    niter: int = 100,
    sinkhorn_max_iterations: int = 2000,
    sinkhorn_threshold: float = 1e-3,
    data_driven_feature_marginals: bool = True,
) -> COTLResult:
    """COOT-L on the tensors' device. ``epsilon`` is the sample stage's
    (and, unless ``feature_epsilon`` is given, the feature stage's)
    entropic regulariser, relative to each cost's max."""
    with torch.no_grad():
        prob = coot_problem(x, y, x_mask, y_mask,
                            data_driven_feature_marginals)
        n_labels, d, dp = prob.x.shape[0], prob.x.shape[2], prob.y.shape[2]
        feat_eps = epsilon if feature_epsilon is None else feature_epsilon

        def solve(cost, p, q, eps, **masks):
            return sinkhorn(cost, p, q, epsilon=eps,
                            max_iterations=sinkhorn_max_iterations,
                            threshold=sinkhorn_threshold, scale_cost=True,
                            **masks).coupling

        ts = prob.w1[:, :, None] * prob.w2[:, None, :]
        tv = torch.full((d, dp), 1.0 / (d * dp), dtype=torch.float32,
                        device=prob.x.device)
        cost = torch.tensor(float("inf"), device=prob.x.device)
        converged = False
        n_iters = 0
        while n_iters < niter and not converged:
            m_s = sample_costs(prob, tv)
            ts_new = torch.stack([
                solve(m_s[k], prob.w1[k], prob.w2[k], epsilon,
                      row_mask=prob.x_mask[k], col_mask=prob.y_mask[k])
                for k in range(n_labels)])
            m_v = feature_costs(prob, ts_new)
            tv_new = solve(m_v, prob.v1, prob.v2, feat_eps)
            tv_new = tv_new / torch.clamp_min(torch.sum(tv_new), 1e-30)
            new_cost = torch.sum(m_v * tv_new)
            delta = (torch.linalg.vector_norm(ts_new - ts)
                     + torch.linalg.vector_norm(tv_new - tv))
            converged = bool((delta < 1e-16)
                             | (torch.abs(cost - new_cost) < 1e-7))
            ts, tv, cost = ts_new, tv_new, new_cost
            n_iters += 1
        return COTLResult(ts, tv, cost, n_iters, converged)

"""Log-domain Sinkhorn sweeps — wrappers of kernel K2 and their plain versions.

Counterpart of the Pallas kernel ``otfusion_tpu.experimental.sinkhorn_kernel``.
The CUDA source is ``csrc/sinkhorn.cu``; its header says what bounds it and
how it is laid out. Each primitive below takes ``neg_c = -C / eps`` (the
scaled, masked fp32 cost the solver builds once) and:

  * on a CPU tensor, runs its plain PyTorch version (``PLAIN``);
  * on a CUDA tensor, launches the kernel, or raises.

``ops.sinkhorn.sinkhorn`` drives these primitives with the production exit
(the L1 row-marginal error every 5 iterations); ``sinkhorn_fixed`` drives
them for a fixed number of iterations with no check, as ``sinkhorn_pallas``
does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from otfusion_tpu_torch.utils.cuda_build import (
    LaunchCounter,
    launch,
    load_library,
    require_cuda_f32,
)

COUNTER = LaunchCounter("sinkhorn")


class SweepOps(NamedTuple):
    """The four primitives of a log-domain Sinkhorn solve."""

    update_f: Callable
    update_g: Callable
    marginal_err: Callable
    plan: Callable


# --- plain versions ----------------------------------------------------------


def _plain_update_f(neg_c, g, log_p, eps):
    return eps * (log_p - torch.logsumexp(neg_c + g[None, :] / eps, dim=1))


def _plain_update_g(neg_c, f, log_q, eps):
    return eps * (log_q - torch.logsumexp(neg_c + f[:, None] / eps, dim=0))


def _plain_marginal_err(neg_c, f, g, p_w, eps):
    log_t = neg_c + f[:, None] / eps + g[None, :] / eps
    row_marg = torch.exp(torch.logsumexp(log_t, dim=1))
    return torch.sum(torch.abs(row_marg - p_w))


def _plain_plan(neg_c, f, g, eps):
    return torch.exp(neg_c + f[:, None] / eps + g[None, :] / eps)


PLAIN = SweepOps(_plain_update_f, _plain_update_g, _plain_marginal_err,
                 _plain_plan)


# --- kernel wrappers ---------------------------------------------------------


def _lib():
    return load_library("sinkhorn")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return True
    require_cuda_f32("sinkhorn kernel", *tensors)
    return False


def _check_2d(neg_c, *vectors):
    if neg_c.dim() != 2:
        raise ValueError(f"expected a 2-D cost, got shape {tuple(neg_c.shape)}")
    for v, size in vectors:
        if v.shape != (size,):
            raise ValueError(f"expected a vector of {size}, got "
                             f"{tuple(v.shape)}")


def update_f(neg_c, g, log_p, eps: float):
    """f = eps * (log p - lse_j(neg_c + g / eps))."""
    if _on_cpu(neg_c, g, log_p):
        return _plain_update_f(neg_c, g, log_p, eps)
    n, m = neg_c.shape
    _check_2d(neg_c, (g, m), (log_p, n))
    f = torch.empty(n, device=neg_c.device, dtype=torch.float32)
    launch(_lib(), "otf_sinkhorn_update_f", COUNTER, neg_c, g, log_p, f,
           n, m, float(eps))
    return f


def update_g(neg_c, f, log_q, eps: float):
    """g = eps * (log q - lse_i(neg_c + f / eps))."""
    if _on_cpu(neg_c, f, log_q):
        return _plain_update_g(neg_c, f, log_q, eps)
    n, m = neg_c.shape
    _check_2d(neg_c, (f, n), (log_q, m))
    g = torch.empty(m, device=neg_c.device, dtype=torch.float32)
    launch(_lib(), "otf_sinkhorn_update_g", COUNTER, neg_c, f, log_q, g,
           n, m, float(eps))
    return g


def marginal_err(neg_c, f, g, p_w, eps: float):
    """L1 deviation of the plan's row marginal from ``p_w`` (0-d tensor),
    summed in a fixed order. Two kernels: per-row errors, then their sum."""
    if _on_cpu(neg_c, f, g, p_w):
        return _plain_marginal_err(neg_c, f, g, p_w, eps)
    n, m = neg_c.shape
    _check_2d(neg_c, (f, n), (g, m), (p_w, n))
    row_err = torch.empty(n, device=neg_c.device, dtype=torch.float32)
    err = torch.empty((), device=neg_c.device, dtype=torch.float32)
    launch(_lib(), "otf_sinkhorn_row_marginal", COUNTER, neg_c, f, g, p_w,
           row_err, n, m, float(eps))
    launch(_lib(), "otf_sinkhorn_sum", COUNTER, row_err, err, n)
    return err


def plan(neg_c, f, g, eps: float):
    """The plan exp(neg_c + f / eps + g / eps)."""
    if _on_cpu(neg_c, f, g):
        return _plain_plan(neg_c, f, g, eps)
    n, m = neg_c.shape
    _check_2d(neg_c, (f, n), (g, m))
    out = torch.empty((n, m), device=neg_c.device, dtype=torch.float32)
    launch(_lib(), "otf_sinkhorn_plan", COUNTER, neg_c, f, g, out, n, m,
           float(eps))
    return out


KERNEL = SweepOps(update_f, update_g, marginal_err, plan)


# --- fixed-iteration solve (what sinkhorn_pallas computes) -------------------


def sinkhorn_fixed(cost, p=None, q=None, *, epsilon: float = 5e-3,
                   n_iters: int = 64, plain: bool = False) -> torch.Tensor:
    """Entropic OT plan after ``n_iters`` log-domain iterations with no exit
    check (what ``sinkhorn_pallas`` computes). ``cost`` (n, m) is divided by
    its max, so ``epsilon`` is relative to the max cost; ``p``/``q`` default
    to uniform. A CUDA ``cost`` launches K2; ``plain=True`` takes the plain
    primitives on any device."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    ops = PLAIN if plain else KERNEL
    with torch.no_grad():
        cost = cost.detach().to(torch.float32)
        n, m = cost.shape
        cost = cost / torch.clamp_min(torch.amax(cost), 1e-12)
        if p is None:
            p = torch.full((n,), 1.0 / n, device=cost.device)
        if q is None:
            q = torch.full((m,), 1.0 / m, device=cost.device)
        log_p = torch.log(torch.clamp_min(p.to(torch.float32), 1e-38))
        log_q = torch.log(torch.clamp_min(q.to(torch.float32), 1e-38))
        eps = float(epsilon)
        neg_c = (-cost / eps).contiguous()
        g = torch.zeros(m, device=cost.device, dtype=torch.float32)
        for _ in range(int(n_iters)):
            f = ops.update_f(neg_c, g, log_p, eps)
            g = ops.update_g(neg_c, f, log_q, eps)
        return ops.plan(neg_c, f, g, eps)

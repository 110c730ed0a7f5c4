"""Whole log-domain Sinkhorn solve — kernel K2 and its plain version.

Counterpart of the Pallas kernel ``otfusion_tpu.experimental.sinkhorn_kernel``.
The CUDA source is ``csrc/sinkhorn.cu``; its header says what bounds it and
how it is laid out. A solve takes ``neg_c = -C / eps`` (the scaled, masked
fp32 cost the solver builds once) and runs the production exit of the JAX
solver: ``f0, g0`` and the L1 row-marginal error, then ``check_every``
iterations per check while the error is above the threshold and the count
below ``max_iterations``; with ``check=False`` a fixed count, as
``sinkhorn_pallas`` runs.

  * ``solve_plain`` drives the plain PyTorch primitives (``PLAIN``) from a
    host loop that reads the error once per check;
  * ``solve`` takes ``solve_plain`` for CPU tensors and, for CUDA tensors,
    launches K2 once per solve (or raises) and returns ``n_iters`` and
    ``err`` as device tensors: nothing in it waits for the device, so a
    train step that solves in the middle queues its backward pass behind
    the solve. ``COUNTER`` counts one launch per solve.

``sinkhorn_layout`` is the launch's pure-Python layout: band height, grid
and whether a band fits in shared memory.
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
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on Hopper
_WARPS = 16           # csrc/sinkhorn.cu: kThreads / 32


class SweepOps(NamedTuple):
    """The four primitives of a log-domain Sinkhorn solve."""

    update_f: Callable
    update_g: Callable
    marginal_err: Callable
    plan: Callable


class Solve(NamedTuple):
    """Result of one solve: duals, plan, iterations run (0-d int32) and the
    last row-marginal error (0-d float32, NaN with the check off), all on
    the solve's device."""

    f: torch.Tensor
    g: torch.Tensor
    plan: torch.Tensor
    n_iters: torch.Tensor
    err: torch.Tensor


# --- plain version -----------------------------------------------------------


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


def solve_plain(neg_c, log_p, log_q, p_w, eps: float, *, max_iterations: int,
                threshold: float = 0.0, check_every: int = 5,
                check: bool = True) -> Solve:
    """The solve on the plain primitives, its loop on the host. With
    ``check=False`` it runs ``max_iterations`` iterations."""
    ops = PLAIN
    step = check_every if check else 1
    g = torch.zeros(neg_c.shape[1], dtype=torch.float32, device=neg_c.device)
    f = ops.update_f(neg_c, g, log_p, eps)
    g = ops.update_g(neg_c, f, log_q, eps)
    err = float(ops.marginal_err(neg_c, f, g, p_w, eps)) if check else \
        float("nan")
    n_iters = 1
    while n_iters < max_iterations and (not check or err > threshold):
        for _ in range(step):
            f = ops.update_f(neg_c, g, log_p, eps)
            g = ops.update_g(neg_c, f, log_q, eps)
        if check:
            err = float(ops.marginal_err(neg_c, f, g, p_w, eps))
        n_iters += step
    device = neg_c.device
    return Solve(f, g, ops.plan(neg_c, f, g, eps),
                 torch.tensor(n_iters, dtype=torch.int32, device=device),
                 torch.tensor(err, dtype=torch.float32, device=device))


# --- kernel ------------------------------------------------------------------


def _round4(x: int) -> int:
    return (x + 3) & ~3


class SinkhornLayout(NamedTuple):
    """How K2 cuts an (n, m) problem: ``grid`` blocks (at most one per SM)
    of ``rows`` consecutive rows each, ``cols`` columns merged per block,
    and the band's home (``"shared"`` memory or ``"device"`` memory)."""

    grid: int
    rows: int
    cols: int
    route: str
    smem_bytes: int


def sinkhorn_layout(n: int, m: int, sm_count: int) -> SinkhornLayout:
    """Layout of one K2 launch; the same sizes as ``csrc/sinkhorn.cu``."""
    if n < 1 or m < 1 or sm_count < 1:
        raise ValueError(f"sinkhorn_layout: bad shape ({n}, {m}) or SM "
                         f"count {sm_count}")
    rows = -(-n // min(sm_count, n))
    if rows * m >= 2 ** 31:
        raise ValueError(f"sinkhorn: a band of {rows} x {m} is too large")
    grid = -(-n // rows)
    cols = -(-m // grid)
    small = 3 * _round4(rows) + 2 * _WARPS * 32 + 4
    shared = 4 * (small + _round4(m) + rows * m)
    if shared <= SMEM_LIMIT:
        return SinkhornLayout(grid, rows, cols, "shared", shared)
    if 4 * small > SMEM_LIMIT:
        raise ValueError(f"sinkhorn: {rows} rows per block do not fit in "
                         f"shared memory")
    return SinkhornLayout(grid, rows, cols, "device", 4 * small)


def _check_shapes(neg_c, log_p, log_q, p_w) -> tuple[int, int]:
    if neg_c.dim() != 2:
        raise ValueError(f"expected a 2-D cost, got shape {tuple(neg_c.shape)}")
    n, m = neg_c.shape
    for v, size in ((log_p, n), (log_q, m), (p_w, n)):
        if v.shape != (size,):
            raise ValueError(f"expected a vector of {size}, got "
                             f"{tuple(v.shape)}")
    return n, m


def solve(neg_c, log_p, log_q, p_w, eps: float, *, max_iterations: int,
          threshold: float = 0.0, check_every: int = 5,
          check: bool = True) -> Solve:
    """The whole solve (arguments and result as ``solve_plain``). CPU
    tensors take ``solve_plain``; CUDA tensors launch K2 once, and its
    ``n_iters`` and ``err`` stay on the device (no host read)."""
    tensors = (neg_c, log_p, log_q, p_w)
    if all(t.device.type == "cpu" for t in tensors):
        return solve_plain(neg_c, log_p, log_q, p_w, eps,
                           max_iterations=max_iterations, threshold=threshold,
                           check_every=check_every, check=check)
    require_cuda_f32("sinkhorn kernel", *tensors)
    n, m = _check_shapes(*tensors)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    device = neg_c.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lay = sinkhorn_layout(n, m, sms)
    f = torch.empty(n, device=device, dtype=torch.float32)
    g = torch.empty(m, device=device, dtype=torch.float32)
    plan = torch.empty((n, m), device=device, dtype=torch.float32)
    stats = torch.empty(2, device=device, dtype=torch.int32)
    scratch = torch.empty(lay.grid * 2 * m + m + lay.grid, device=device,
                          dtype=torch.float32)
    barrier = torch.zeros(1, device=device, dtype=torch.int32)
    launch(load_library("sinkhorn"), "otf_sinkhorn_solve", COUNTER, neg_c,
           log_p, log_q, p_w, f, g, plan, stats, scratch, barrier, n, m,
           lay.rows, lay.route == "shared", float(eps), int(max_iterations),
           float(threshold), int(check_every if check else 1), bool(check))
    # stats = (n_iters, err's bits): both stay on the device, unread.
    return Solve(f, g, plan, stats[0], stats[1:].view(torch.float32)[0])


# --- fixed-iteration solve (what sinkhorn_pallas computes) -------------------


def sinkhorn_fixed(cost, p=None, q=None, *, epsilon: float = 5e-3,
                   n_iters: int = 64, plain: bool = False) -> torch.Tensor:
    """Entropic OT plan after ``n_iters`` log-domain iterations with no exit
    check (what ``sinkhorn_pallas`` computes). ``cost`` (n, m) is divided by
    its max, so ``epsilon`` is relative to the max cost; ``p``/``q`` default
    to uniform. A CUDA ``cost`` launches K2; ``plain=True`` takes the plain
    solve on any device."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    with torch.no_grad():
        cost = cost.detach().to(torch.float32)
        n, m = cost.shape
        cost = cost / torch.clamp_min(torch.amax(cost), 1e-12)
        if p is None:
            p = torch.full((n,), 1.0 / n, device=cost.device)
        if q is None:
            q = torch.full((m,), 1.0 / m, device=cost.device)
        p = p.to(torch.float32).contiguous()
        log_p = torch.log(torch.clamp_min(p, 1e-38))
        log_q = torch.log(torch.clamp_min(q.to(torch.float32), 1e-38))
        eps = float(epsilon)
        neg_c = (-cost / eps).contiguous()
        run = solve_plain if plain else solve
        return run(neg_c, log_p, log_q, p, eps, max_iterations=int(n_iters),
                   check=False).plan

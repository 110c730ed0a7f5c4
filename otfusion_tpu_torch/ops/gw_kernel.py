"""Per-label entropic-GW whole solve — kernel K1 and its plain version.

Counterpart of the Pallas kernel ``otfusion_tpu.experimental.gw_kernel``
(``gw_solve_pallas``). Given max-scaled self-costs and masked marginals per
label (``ops.gromov`` builds them), the warm-started linearisation loop

  constC = (Cx^2 p) 1^T + 1 (q^T Cy^2),  T_0 = p q^T
  repeat 8x per check:  M = constC - 2 Cx T Cy^T  (1e30 on padded pairs)
                        10 warm-started log-Sinkhorn sweeps on M
                        T = exp((f + g - M) / eps)
  until the relative ||T - T_prev||_F reaches the threshold, the error
  stalls (no 0.999x improvement for 25 checks) or the iteration cap.

``gw_solve_plain`` is the batched plain version: it runs all labels in one
loop and freezes each label once its own condition fails — the semantics
of the JAX package's ``vmap`` over a ``while_loop`` — so ``n_iters`` match
label by label. ``gw_solve`` takes it for CPU tensors and launches
``csrc/gw.cu`` for CUDA tensors, on one of two routes (``gw_route``):

  * the cluster route (cap <= ``MAX_CAP``): one thread-block cluster per
    label runs the whole loop in shared memory. ``gw_layout`` is its
    pure-Python layout (rows per block, shared bytes per block); the
    cluster size per cap is a constant of ``gw.cu``, read from the library.
    ``COUNTER`` counts its launches.
  * the device route (cap > ``MAX_CAP``): one persistent cooperative launch
    over all labels, the labels' matrices in device memory, the two cap^3
    products tiled in shared memory in the kernel's body.
    ``gw_device_layout`` is its layout (product tiles, column strips, grid,
    shared bytes). ``DEVICE_COUNTER`` counts its launches.

Both routes compute what ``gw_solve_plain`` computes, with one launch per
solve; ``n_iters`` and ``err`` stay on the device, unread.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otfusion_tpu_torch.ops.sinkhorn import f32, log_sinkhorn_sweeps
from otfusion_tpu_torch.utils.cuda_build import (
    LaunchCounter,
    launch,
    load_library,
    require_cuda_f32,
)

COUNTER = LaunchCounter("gw")
DEVICE_COUNTER = LaunchCounter("gw_device")
_STALL_PATIENCE = 25
_OUTER_UNROLL = 8
_BIG = 1e30
MAX_CAP = 128         # csrc/gw.cu: kMaxCap
CLUSTER_SIZES = (1, 2, 4, 8)
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on Hopper
_WARPS = 16           # csrc/gw.cu: kThreads / 32
_MAX_ROWS_PER_WARP = 4
# csrc/gw.cu, the device route: kDevWarps, kDevBlocksPerSm, kTile, kTileK,
# kTileLd, kStrip
DEV_WARPS = 8
DEV_BLOCKS_PER_SM = 2
DEV_TILE = 64
_DEV_TILE_K = 16
_DEV_TILE_LD = DEV_TILE + 4
DEV_STRIP = 32


class GWLayout(NamedTuple):
    """How K1 cuts one label: ``cluster`` blocks of at most ``rows`` rows
    each (a block past the last row owns none), ``smem_bytes`` of dynamic
    shared memory per block."""

    cluster: int
    rows: int
    smem_bytes: int


def _round4(x: int) -> int:
    return (x + 3) & ~3


def gw_layout(cap: int, cluster: int) -> GWLayout:
    """Layout of a K1 launch at ``cap`` with ``cluster`` blocks per label;
    the same sizes as ``csrc/gw.cu:gw_layout``. Raises where the kernel
    cannot run: cap above ``MAX_CAP``, more than 4 rows per warp, or more
    shared memory than a block may use."""
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"gw_solve: cap {cap} exceeds the kernel's limit of "
                         f"{MAX_CAP} samples per label")
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"gw_solve: cluster size {cluster} not in "
                         f"{CLUSTER_SIZES}")
    rows = -(-cap // cluster)
    floats = (2 * _round4(cap * cap) + 2 * _round4(rows * cap)
              + 2 * _round4(_WARPS * cap) + 2 * _round4(2 * cap)
              + 6 * _round4(cap) + 2 * _round4(rows)
              + _round4(2 * _WARPS + 2))
    if rows > _WARPS * _MAX_ROWS_PER_WARP or 4 * floats > SMEM_LIMIT:
        raise ValueError(f"gw_solve: cap {cap} does not fit {cluster} "
                         f"block(s) per label")
    return GWLayout(cluster, rows, 4 * floats)


class GWDeviceLayout(NamedTuple):
    """How K1's device route cuts L labels of ``cap``: ``tiles`` x ``tiles``
    product tiles of ``DEV_TILE`` per label, ``strips`` column strips of
    ``DEV_STRIP`` per label (the column pass), ``grid`` co-resident blocks
    (at most ``DEV_BLOCKS_PER_SM`` per SM) and ``smem_bytes`` of static
    shared memory per block."""

    tiles: int
    strips: int
    grid: int
    smem_bytes: int


def gw_device_layout(L: int, cap: int, sm_count: int) -> GWDeviceLayout:
    """Layout of a K1 device-route launch; the same sizes as
    ``csrc/gw.cu:gw_device_layout``. The grid is the largest count of work
    items of one phase (product tiles, rows a warp each, column strips),
    capped at ``DEV_BLOCKS_PER_SM`` blocks per SM."""
    if L < 1 or cap < 1 or sm_count < 1:
        raise ValueError(f"gw_device_layout: bad problem ({L} labels, cap "
                         f"{cap}) or SM count {sm_count}")
    tiles = -(-cap // DEV_TILE)
    strips = -(-cap // DEV_STRIP)
    most = max(L * tiles * tiles, -(-L * cap // DEV_WARPS), L * strips)
    grid = min(sm_count * DEV_BLOCKS_PER_SM, most)
    smem = 4 * (2 * _DEV_TILE_K * _DEV_TILE_LD + 2 * DEV_WARPS * DEV_STRIP)
    return GWDeviceLayout(tiles, strips, grid, smem)


def gw_device_bytes(L: int, cap: int) -> int:
    """Device memory the device route allocates for a solve: the plan, four
    (L, cap, cap) work matrices (the last check's T, T Cy^T, M, -M/eps),
    eight (L, cap) vectors, the per-label state and the results."""
    floats = 5 * L * cap * cap + 8 * L * cap + 2 * L
    ints = 3 * L + 2
    return 4 * (floats + ints) + 8 * L


def gw_route(cap: int) -> str:
    """K1's route for a cap: ``"cluster"`` up to ``MAX_CAP``, else
    ``"device"``."""
    return "cluster" if cap <= MAX_CAP else "device"


def const_c(cx, cy, p, q):
    """(Cx^2 p) 1^T + 1 (q^T Cy^2), batched over labels."""
    return ((cx * cx) @ p[..., None]) + ((cy * cy) @ q[..., None]).transpose(
        -1, -2)


def gw_solve_plain(cx, cy, log_p, log_q, p, q, *, epsilon: float = 5e-3,
                   max_iterations: int = 2000, threshold: float = 1e-3,
                   inner_sweeps: int = 10):
    """Solve L entropic-GW problems given max-scaled self-costs cx (L, n, n),
    cy (L, m, m), marginals p (L, n), q (L, m) (0 on padding) and their
    masked logs. Returns (T (L, n, m), n_iters (L,) int32, err (L,))."""
    eps = float(epsilon)
    thr = f32(threshold)
    L = cx.shape[0]
    device = cx.device
    pair = (p > 0)[:, :, None] & (q > 0)[:, None, :]
    c0 = const_c(cx, cy, p, q)
    cy_t = cy.transpose(-1, -2)

    t = p[:, :, None] * q[:, None, :]
    f = torch.zeros_like(p)
    g = torch.zeros_like(q)
    err = torch.full((L,), float("inf"), device=device)
    best = torch.full((L,), float("inf"), device=device)
    it = torch.zeros((L,), dtype=torch.int32, device=device)
    stall = torch.zeros((L,), dtype=torch.int32, device=device)

    def running():
        return (it < max_iterations) & (err > thr) & (stall < _STALL_PATIENCE)

    active = running()
    while bool(active.any()):
        t_new, f_new, g_new = t, f, g
        for _ in range(_OUTER_UNROLL):
            m_cost = c0 - 2.0 * cx @ (t_new @ cy_t)
            m_cost = torch.where(pair, m_cost, _BIG)
            f_new, g_new = log_sinkhorn_sweeps(m_cost, log_p, log_q, eps,
                                               f_new, g_new, inner_sweeps)
            t_new = torch.exp((f_new[:, :, None] + g_new[:, None, :] - m_cost)
                              / eps)
            t_new = torch.where(pair, t_new, 0.0)
        e = (torch.linalg.vector_norm(t_new - t, dim=(1, 2))
             / torch.clamp_min(torch.linalg.vector_norm(t_new, dim=(1, 2)),
                               1e-30))
        improved = e < 0.999 * best
        a3 = active[:, None, None]
        t = torch.where(a3, t_new, t)
        f = torch.where(active[:, None], f_new, f)
        g = torch.where(active[:, None], g_new, g)
        err = torch.where(active, e, err)
        stall = torch.where(active, torch.where(improved, 0, stall + 1), stall)
        best = torch.where(active, torch.minimum(best, e), best)
        it = torch.where(active, it + _OUTER_UNROLL, it)
        active = running()
    return t, it, err


def gw_solve(cx, cy, log_p, log_q, p, q, *, epsilon: float = 5e-3,
             max_iterations: int = 2000, threshold: float = 1e-3,
             inner_sweeps: int = 10):
    """Solve L entropic-GW problems (arguments and results as
    ``gw_solve_plain``; both caps equal). CPU tensors take the plain
    solver; CUDA tensors launch K1 once, on the cluster route up to
    ``MAX_CAP`` and on the device route above it. The device route refuses
    only a problem whose buffers exceed the card's memory."""
    tensors = (cx, cy, log_p, log_q, p, q)
    if all(t.device.type == "cpu" for t in tensors):
        return gw_solve_plain(cx, cy, log_p, log_q, p, q, epsilon=epsilon,
                              max_iterations=max_iterations,
                              threshold=threshold, inner_sweeps=inner_sweeps)
    require_cuda_f32("gw_solve", *tensors)
    L, cap = cx.shape[0], cx.shape[1]
    for name, t, shape in (("cx", cx, (L, cap, cap)), ("cy", cy, (L, cap, cap)),
                           ("log_p", log_p, (L, cap)), ("log_q", log_q, (L, cap)),
                           ("p", p, (L, cap)), ("q", q, (L, cap))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gw_solve: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    lib = load_library("gw")
    if gw_route(cap) == "device":
        return _launch_device(lib, cx, cy, log_p, log_q, p, q, epsilon,
                              max_iterations, threshold, inner_sweeps)
    return _launch(lib, cx, cy, log_p, log_q, p, q,
                   lib.otf_gw_cluster_for_cap(cap), epsilon, max_iterations,
                   threshold, inner_sweeps)


def _launch(lib, cx, cy, log_p, log_q, p, q, cluster, epsilon,
            max_iterations, threshold, inner_sweeps):
    """One K1 launch with ``cluster`` blocks per label (``gw_solve`` passes
    the library's size for the cap; a measurement may pass another)."""
    L, cap = cx.shape[0], cx.shape[1]
    gw_layout(cap, cluster)
    device = cx.device
    t_out = torch.empty((L, cap, cap), device=device, dtype=torch.float32)
    iters = torch.empty((L,), device=device, dtype=torch.int32)
    err = torch.empty((L,), device=device, dtype=torch.float32)
    launch(lib, "otf_gw_solve", COUNTER, cx, cy, log_p, log_q, p, q, t_out,
           iters, err, L, cap, cluster, float(epsilon), int(max_iterations),
           float(threshold), int(inner_sweeps))
    return t_out, iters, err


def _launch_device(lib, cx, cy, log_p, log_q, p, q, epsilon, max_iterations,
                   threshold, inner_sweeps):
    """One launch of K1's device route (any cap; ``gw_solve`` takes it above
    ``MAX_CAP``, a test may take it below)."""
    L, cap = cx.shape[0], cx.shape[1]
    device = cx.device
    props = torch.cuda.get_device_properties(device)
    need = gw_device_bytes(L, cap)
    if need > props.total_memory:
        raise ValueError(
            f"gw_solve: {L} labels of cap {cap} need {need} bytes of device "
            f"memory for the device route; the card has {props.total_memory}")
    gw_device_layout(L, cap, props.multi_processor_count)
    t_out = torch.empty((L, cap, cap), device=device, dtype=torch.float32)
    iters = torch.empty((L,), device=device, dtype=torch.int32)
    err = torch.empty((L,), device=device, dtype=torch.float32)
    scratch = torch.empty(4 * L * cap * cap + 8 * L * cap + 2 * L,
                          device=device, dtype=torch.float32)
    istate = torch.zeros(3 * L + 2, device=device, dtype=torch.int32)
    launch(lib, "otf_gw_device_solve", DEVICE_COUNTER, cx, cy, log_p, log_q,
           p, q, t_out, iters, err, scratch, istate, L, cap,
           props.multi_processor_count, float(epsilon), int(max_iterations),
           float(threshold), int(inner_sweeps))
    return t_out, iters, err

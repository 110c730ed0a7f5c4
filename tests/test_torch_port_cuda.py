"""Kernels K1 and K2 against their plain versions on a CUDA card.

A CUDA kernel has no interpret mode, so these tests need the card: they are
marked ``cuda`` and skip without one. ``chip_smoke.py`` holds the kernels to
their plain versions at the main path's shapes; these tests add ragged
shapes, masks, both band routes of K2, every cluster size of K1, bitwise
reruns, the wrappers' refusals, K2 at the base trainer's in-step inputs and
a base train step that must not read the device from the host. They import
no JAX, so on a machine with a GPU they run without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from otfusion_tpu_torch.cli.bench_kernels import correlated_groups
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel
from otfusion_tpu_torch.ops.fot import feature_cost
from otfusion_tpu_torch.ops.gromov import _prep, egw_per_label
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
from otfusion_tpu_torch.train.steps import make_fusion_train_step
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.ops.sinkhorn_kernel import sinkhorn_fixed
from otfusion_tpu_torch.utils.cuda_build import load_library

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1 and K2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, rel):
    """max |out - ref| within ``rel`` of the largest |ref|."""
    diff = float((out - ref).abs().max())
    assert diff <= rel * float(ref.abs().max()), (diff, float(ref.abs().max()))


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("n,m", [(1, 1), (37, 45), (100, 33), (257, 1000),
                                 (3000, 40), (300, 20000)])
def test_sinkhorn_whole_solve_matches_plain(cuda, n, m):
    """The whole solve to its exit at ragged shapes; (3000, 40) has bands
    taller than the 16 rows the column pass keeps in registers, and
    (300, 20000) does not fit a band in shared memory and takes the
    device-memory route."""
    rng = np.random.default_rng(n * 1000 + m)
    cost = torch.from_numpy(rng.uniform(size=(n, m)).astype(np.float32)
                            ).to(cuda)
    route = sinkhorn_kernel.sinkhorn_layout(n, m, _sm_count(cuda)).route
    assert route == ("device" if m == 20000 else "shared")
    kw = dict(epsilon=0.05, threshold=1e-3, scale_cost=True)
    before = sinkhorn_kernel.COUNTER.count
    ker = sinkhorn(cost, **kw)
    assert sinkhorn_kernel.COUNTER.count == before + 1  # one launch a solve
    ref = sinkhorn(cost, plain=True, **kw)
    assert int(ker.n_iters) == int(ref.n_iters)
    assert bool(ker.converged) == bool(ref.converged)
    assert float(ker.err) == pytest.approx(float(ref.err), rel=1e-3, abs=1e-6)
    _close(ker.coupling, ref.coupling, 1e-4)
    torch.testing.assert_close(ker.f, ref.f, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.g, ref.g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_solve_matches_plain(cuda, masked):
    rng = np.random.default_rng(3)
    cost = torch.from_numpy(rng.uniform(size=(300, 130)).astype(np.float32)
                            * 5.0).to(cuda)
    kw = dict(epsilon=5e-3, threshold=1e-3, scale_cost=True)
    if masked:
        rm = torch.ones(300, dtype=torch.bool, device=cuda)
        rm[250:] = False
        cm = torch.ones(130, dtype=torch.bool, device=cuda)
        cm[::9] = False
        kw.update(row_mask=rm, col_mask=cm)
    ker = sinkhorn(cost, **kw)
    ref = sinkhorn(cost, plain=True, **kw)
    assert int(ker.n_iters) == int(ref.n_iters)
    assert bool(ker.converged) == bool(ref.converged)
    _close(ker.coupling, ref.coupling, 1e-4)
    if masked:
        assert float(ker.coupling[250:].abs().sum()) == 0.0
        assert float(ker.coupling[:, ::9].abs().sum()) == 0.0


def test_sinkhorn_fixed_matches_plain(cuda):
    rng = np.random.default_rng(4)
    cost = torch.from_numpy(rng.uniform(size=(200, 72)).astype(np.float32)
                            ).to(cuda)
    p = torch.from_numpy(rng.uniform(0.5, 1.5, 200).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.uniform(0.5, 1.5, 72).astype(np.float32)).to(cuda)
    p, q = p / p.sum(), q / q.sum()
    _close(sinkhorn_fixed(cost, p, q, epsilon=0.05, n_iters=50),
           sinkhorn_fixed(cost, p, q, epsilon=0.05, n_iters=50, plain=True),
           1e-4)


def _gw_groups(cuda, cap, valid, seed=None):
    rng = np.random.default_rng(cap if seed is None else seed)
    z = rng.normal(size=(2, cap, 4))
    x = z @ rng.normal(size=(4, 24)) + 0.05 * rng.normal(size=(2, cap, 24))
    y = z @ rng.normal(size=(4, 16)) + 0.05 * rng.normal(size=(2, cap, 16))
    mask = np.ones((2, cap), bool)
    mask[1, valid:] = False
    x[1, valid:] = 0.0
    y[1, valid:] = 0.0
    to = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    return to(x.astype(np.float32)), to(y.astype(np.float32)), to(mask)


def _check_gw(t_k, it_k, ref, valid):
    torch.testing.assert_close(t_k, ref.coupling, rtol=1e-3, atol=1e-6)
    # one convergence check (8 iterations) apart at most, if the order of a
    # sum flips a check at the threshold
    assert (it_k - ref.n_iters).abs().max() <= 8
    assert float(t_k[1, valid:].abs().sum()) == 0.0
    assert float(t_k[1, :, valid:].abs().sum()) == 0.0


@pytest.mark.parametrize("cap,valid", [(1, 1), (3, 2), (33, 20), (64, 64),
                                       (65, 50), (100, 77), (128, 100)])
def test_gw_kernel_matches_plain(cuda, cap, valid):
    """Every register-tile shape of K1, with padding in label 1; at cap 1 and
    3 some blocks of a cluster own no rows."""
    x, y, m = _gw_groups(cuda, cap, valid)
    before = gw_kernel.COUNTER.count
    ker = egw_per_label(x, y, m, m)
    assert gw_kernel.COUNTER.count == before + 1
    ref = egw_per_label(x, y, m, m, plain=True)
    _check_gw(ker.coupling, ker.n_iters, ref, valid)


@pytest.mark.parametrize("cap,cluster", [(64, 1), (64, 2), (64, 4), (64, 8),
                                         (128, 2), (128, 4), (128, 8)])
def test_gw_every_cluster_size_matches_plain(cuda, cap, cluster):
    """Each cluster size the layout admits gives the plain plan (the size
    the library picks per cap is the fastest of these)."""
    x, y, m = _gw_groups(cuda, cap, cap - 7, seed=cap + cluster)
    cx, p, log_p = _prep(x, m)
    cy, q, log_q = _prep(y, m)
    t, it, _ = gw_kernel._launch(load_library("gw"), cx, cy, log_p, log_q, p,
                                 q, cluster, 5e-3, 2000, 1e-3, 10)
    ref = egw_per_label(x, y, m, m, plain=True)
    _check_gw(t, it, ref, cap - 7)


def test_k1_rerun_bitwise_equal(cuda):
    """No atomics in any sum: a rerun gives the same bits."""
    x, y, m = _gw_groups(cuda, 64, 50)
    a, b = egw_per_label(x, y, m, m), egw_per_label(x, y, m, m)
    assert torch.equal(a.coupling, b.coupling)
    assert torch.equal(a.n_iters, b.n_iters) and torch.equal(a.err, b.err)


def test_k2_rerun_bitwise_equal(cuda):
    rng = np.random.default_rng(5)
    cost = torch.from_numpy(rng.uniform(size=(700, 900)).astype(np.float32)
                            ).to(cuda)
    kw = dict(epsilon=5e-3, threshold=1e-3, scale_cost=True)
    a, b = sinkhorn(cost, **kw), sinkhorn(cost, **kw)
    assert torch.equal(a.coupling, b.coupling)
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    assert torch.equal(a.n_iters, b.n_iters) and torch.equal(a.err, b.err)


def test_layouts_match_the_library(cuda):
    gw = load_library("gw")
    assert gw.otf_gw_max_cap() == gw_kernel.MAX_CAP
    for cap in (1, 3, 33, 64, 65, 100, 128):
        cluster = gw.otf_gw_cluster_for_cap(cap)
        assert cluster in gw_kernel.CLUSTER_SIZES
        for c in gw_kernel.CLUSTER_SIZES:
            try:
                lay = gw_kernel.gw_layout(cap, c)
            except ValueError:
                assert c != cluster
                continue
            assert gw.otf_gw_smem_bytes(cap, c) == lay.smem_bytes
    sk = load_library("sinkhorn")
    sk.otf_sinkhorn_smem_bytes.restype = ctypes.c_longlong
    for n, m in ((1, 1), (257, 1000), (2048, 2048), (300, 20000)):
        lay = sinkhorn_kernel.sinkhorn_layout(n, m, _sm_count(cuda))
        assert lay.grid <= _sm_count(cuda)
        assert sk.otf_sinkhorn_smem_bytes(
            m, lay.rows, int(lay.route == "shared")) == lay.smem_bytes


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    neg_c = torch.zeros((4, 3), device=cuda)
    g = torch.zeros(3, device=cuda)
    log_p = torch.zeros(4, device=cuda)

    def solve(c, lq, lp):
        return sinkhorn_kernel.solve(c, lp, lq, lp, 0.1, max_iterations=10)

    with pytest.raises(ValueError, match="float32"):
        solve(neg_c.double(), g.double(), log_p.double())
    with pytest.raises(ValueError, match="contiguous"):
        solve(torch.zeros((3, 4), device=cuda).T, g, log_p)
    with pytest.raises(ValueError, match="CUDA"):
        solve(neg_c, g.cpu(), log_p)
    with pytest.raises(ValueError, match="vector of 3"):
        solve(neg_c, torch.zeros(5, device=cuda), log_p)
    cap = gw_kernel.MAX_CAP + 1
    c = torch.zeros((1, cap, cap), device=cuda)
    v = torch.zeros((1, cap), device=cuda)
    with pytest.raises(ValueError, match="limit"):
        gw_kernel.gw_solve(c, c, v, v, v, v)


@pytest.mark.parametrize("b", [8, 4])
def test_k2_at_the_base_inputs_matches_plain(cuda, b):
    """The base trainer's in-step solve: FOT cost of b rows of 2048-dim
    features under eye(b) / b, eps 1e-3 (scaled cost down to -1000). The
    exits may lie one check apart; the plan is held against the plain solve
    run for the kernel's own count."""
    x, y = correlated_groups(np.random.default_rng(2), 1, b, 2048)
    ts = torch.eye(b, device=cuda) / b
    cost = feature_cost(torch.from_numpy(x[0]).to(cuda),
                        torch.from_numpy(y[0]).to(cuda), ts).contiguous()
    kw = dict(epsilon=1e-3, threshold=1e-3, max_iterations=2000,
              scale_cost=True)
    ker = sinkhorn(cost, **kw)
    ref = sinkhorn(cost, plain=True, **kw)
    assert abs(int(ker.n_iters) - int(ref.n_iters)) <= 5
    assert bool(ker.converged) and bool(ref.converged)
    n = cost.shape[0]
    neg_c = (-(cost / cost.max()) / 1e-3).contiguous()
    log_w = torch.full((n,), -float(np.log(n)), device=cuda)
    same = sinkhorn_kernel.solve_plain(
        neg_c, log_w, log_w, log_w.exp(), 1e-3,
        max_iterations=int(ker.n_iters), check=False)
    _close(ker.coupling, same.plan, 1e-4)


def test_sinkhorn_reads_nothing_back(cuda):
    """The whole solve, exit included, queues without a host read."""
    rng = np.random.default_rng(6)
    cost = torch.from_numpy(rng.uniform(size=(300, 200)).astype(np.float32)
                            ).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = sinkhorn(cost, epsilon=5e-3, scale_cost=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.n_iters.is_cuda and res.converged.is_cuda and res.err.is_cuda
    assert bool(res.converged)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_base_train_step_makes_no_host_read(cuda, grad_accum):
    """A base step (in-batch FOT on K2, bf16 autocast, AdamW) under
    ``set_sync_debug_mode("error")``: the step, its solves included, never
    waits for the device."""
    torch.manual_seed(0)
    model = MultimodalOTFusion(depth=10, s2d_stem=True, variant="base").to(
        device=cuda, memory_format=torch.channels_last_3d)
    step = make_fusion_train_step(
        model, make_optimizer(model.parameters(), 1e-5), in_batch_fot=True,
        grad_accum=grad_accum, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(1)
    mri, pet = (torch.randn((4, 32, 32, 32, 1), device=cuda, generator=gen)
                for _ in range(2))
    labels = torch.tensor([0, 1, 0, 1], device=cuda)
    step(mri, pet, labels, None, gen)  # warm-up
    torch.cuda.synchronize()
    before = sinkhorn_kernel.COUNTER.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        met = step(mri, pet, labels, None, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sinkhorn_kernel.COUNTER.count - before == grad_accum
    assert torch.isfinite(met["loss"]) and float(met["ot_loss"]) > 0.0

"""Kernels K1 and K2 against their plain versions on a CUDA card.

A CUDA kernel has no interpret mode, so these tests need the card: they are
marked ``cuda`` and skip without one. ``chip_smoke.py`` holds the kernels to
their plain versions at the main path's shapes; these tests add ragged
shapes, masks, every cap regime of K1 and the wrappers' refusals. They
import no JAX, so on a machine with a GPU they run without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel
from otfusion_tpu_torch.ops.gromov import egw_per_label
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
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


@pytest.mark.parametrize("n,m", [(1, 1), (37, 45), (100, 33), (257, 1000)])
def test_sinkhorn_primitives_match_plain(cuda, n, m):
    rng = np.random.default_rng(n * 1000 + m)
    eps = 0.05
    neg_c = torch.from_numpy(-rng.uniform(size=(n, m)).astype(np.float32)
                             / eps).to(cuda)
    f = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(0, 0.1, m).astype(np.float32)).to(cuda)
    log_p = torch.full((n,), -np.log(n), device=cuda)
    log_q = torch.full((m,), -np.log(m), device=cuda)
    p = log_p.exp()
    plain = sinkhorn_kernel.PLAIN
    before = sinkhorn_kernel.COUNTER.count
    torch.testing.assert_close(sinkhorn_kernel.update_f(neg_c, g, log_p, eps),
                               plain.update_f(neg_c, g, log_p, eps),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sinkhorn_kernel.update_g(neg_c, f, log_q, eps),
                               plain.update_g(neg_c, f, log_q, eps),
                               rtol=1e-5, atol=1e-6)
    _close(sinkhorn_kernel.plan(neg_c, f, g, eps),
           plain.plan(neg_c, f, g, eps), 1e-5)
    torch.testing.assert_close(
        sinkhorn_kernel.marginal_err(neg_c, f, g, p, eps),
        plain.marginal_err(neg_c, f, g, p, eps), rtol=1e-4, atol=1e-7)
    # one count per kernel: f, g, plan, then row marginal + its sum
    assert sinkhorn_kernel.COUNTER.count == before + 5


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
    assert ker.n_iters == ref.n_iters and ker.converged == ref.converged
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


@pytest.mark.parametrize("cap,valid", [(3, 2), (33, 20), (64, 64), (65, 50),
                                       (128, 100)])
def test_gw_kernel_matches_plain(cuda, cap, valid):
    """Shared-memory caps (<= 64) and device-scratch caps (65..128)."""
    rng = np.random.default_rng(cap)
    z = rng.normal(size=(2, cap, 4))
    x = z @ rng.normal(size=(4, 24)) + 0.05 * rng.normal(size=(2, cap, 24))
    y = z @ rng.normal(size=(4, 16)) + 0.05 * rng.normal(size=(2, cap, 16))
    mask = np.ones((2, cap), bool)
    mask[1, valid:] = False
    x[1, valid:] = 0.0
    y[1, valid:] = 0.0
    to = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    x, y, m = to(x.astype(np.float32)), to(y.astype(np.float32)), to(mask)
    before = gw_kernel.COUNTER.count
    ker = egw_per_label(x, y, m, m)
    assert gw_kernel.COUNTER.count == before + 1
    ref = egw_per_label(x, y, m, m, plain=True)
    torch.testing.assert_close(ker.coupling, ref.coupling, rtol=1e-3,
                               atol=1e-6)
    # one convergence check (8 iterations) apart at most, if the order of a
    # sum flips a check at the threshold
    assert (ker.n_iters - ref.n_iters).abs().max() <= 8
    assert float(ker.coupling[1, valid:].abs().sum()) == 0.0
    assert float(ker.coupling[1, :, valid:].abs().sum()) == 0.0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    neg_c = torch.zeros((4, 3), device=cuda)
    g = torch.zeros(3, device=cuda)
    log_p = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sinkhorn_kernel.update_f(neg_c.double(), g.double(), log_p.double(),
                                 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_kernel.update_f(torch.zeros((3, 4), device=cuda).T, g, log_p,
                                 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_kernel.update_f(neg_c, g.cpu(), log_p, 0.1)
    with pytest.raises(ValueError, match="vector of 3"):
        sinkhorn_kernel.update_f(neg_c, torch.zeros(5, device=cuda), log_p,
                                 0.1)
    cap = load_library("gw").otf_gw_max_cap() + 1
    c = torch.zeros((1, cap, cap), device=cuda)
    v = torch.zeros((1, cap), device=cuda)
    with pytest.raises(ValueError, match="limit"):
        gw_kernel.gw_solve(c, c, v, v, v, v)

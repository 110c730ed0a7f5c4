"""The port's OT solvers against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On CPU
tensors the port's wrappers run the plain PyTorch versions of kernels K1
and K2; where the JAX side is a Pallas kernel it runs with
``interpret=True``, as tests/test_gw_kernel.py and
tests/test_pallas_kernel.py run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.experimental.gw_kernel import egw_per_label_pallas
from otfusion_tpu.ops import egw_per_label as jax_egw_per_label
from otfusion_tpu.ops import fot as jax_fot
from otfusion_tpu.ops import pairwise_sq_euclidean as jax_pairwise
from otfusion_tpu.ops import scale_by_max as jax_scale_by_max
from otfusion_tpu.ops import sinkhorn as jax_sinkhorn
from otfusion_tpu.ops.fot import apply_feature_coupling as jax_apply
from otfusion_tpu.ops.pallas import sinkhorn_pallas
from otfusion_tpu.train.coupling import coupling_pipeline as jax_pipeline
from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel
from otfusion_tpu_torch.ops.costs import pairwise_sq_euclidean, scale_by_max
from otfusion_tpu_torch.ops.fot import apply_feature_coupling, fot
from otfusion_tpu_torch.ops.gromov import (
    egw_per_label,
    egw_per_label_kernel,
    entropic_gw,
)
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
from otfusion_tpu_torch.ops.sinkhorn_kernel import sinkhorn_fixed
from otfusion_tpu_torch.train.coupling import coupling_pipeline, group_and_pad

T = torch.from_numpy


def test_costs_match_jax(rng):
    x = rng.normal(size=(20, 7)).astype(np.float32)
    y = rng.normal(size=(15, 7)).astype(np.float32)
    c = pairwise_sq_euclidean(T(x), T(y)).numpy()
    np.testing.assert_allclose(c, np.asarray(jax_pairwise(x, y)),
                               rtol=1e-5, atol=1e-5)
    mask = rng.uniform(size=c.shape) > 0.3
    scaled, scale = scale_by_max(T(c), T(mask))
    j_scaled, j_scale = jax_scale_by_max(jnp.asarray(c), jnp.asarray(mask))
    np.testing.assert_allclose(scaled.numpy(), np.asarray(j_scaled),
                               rtol=1e-6)
    assert float(scale) == pytest.approx(float(j_scale), rel=1e-7)


@pytest.mark.parametrize("scale_cost", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_plain_matches_jax(rng, masked, scale_cost):
    cost = rng.uniform(size=(64, 48)).astype(np.float32) * 3.0
    kw = dict(epsilon=5e-2, scale_cost=scale_cost, max_iterations=2000,
              threshold=1e-4)
    rm = cm = None
    if masked:
        rm = np.ones(64, bool)
        rm[50:] = False
        cm = np.ones(48, bool)
        cm[::7] = False
    ref = jax_sinkhorn(jnp.asarray(cost),
                       row_mask=None if rm is None else jnp.asarray(rm),
                       col_mask=None if cm is None else jnp.asarray(cm), **kw)
    out = sinkhorn(T(cost), row_mask=None if rm is None else T(rm),
                   col_mask=None if cm is None else T(cm), **kw)
    assert out.n_iters == int(ref.n_iters)
    assert out.n_iters > 1
    assert out.converged == bool(ref.converged)
    np.testing.assert_allclose(out.coupling.numpy(), np.asarray(ref.coupling),
                               rtol=0, atol=1e-6)
    assert float(out.cost) == pytest.approx(float(ref.cost), rel=1e-4)
    if masked:
        t = out.coupling.numpy()
        assert t[50:].sum() == 0.0 and t[:, ::7].sum() == 0.0


def test_sinkhorn_fixed_plain_matches_pallas(rng):
    cost = rng.uniform(size=(128, 128)).astype(np.float32)
    ref = np.asarray(sinkhorn_pallas(jnp.asarray(cost), epsilon=5e-3,
                                     n_iters=300, block_rows=64,
                                     interpret=True))
    out = sinkhorn_fixed(T(cost), epsilon=5e-3, n_iters=300).numpy()
    assert np.abs(out - ref).max() < 5e-5
    np.testing.assert_allclose(out.sum(1), 1.0 / 128, atol=1e-5)
    np.testing.assert_allclose(out.sum(0), 1.0 / 128, atol=1e-5)


def test_sinkhorn_fixed_nonuniform_marginals(rng):
    cost = rng.uniform(size=(128, 128)).astype(np.float32)
    p = rng.uniform(0.5, 1.5, 128)
    p = (p / p.sum()).astype(np.float32)
    q = rng.uniform(0.5, 1.5, 128)
    q = (q / q.sum()).astype(np.float32)
    ref = np.asarray(sinkhorn_pallas(jnp.asarray(cost), jnp.asarray(p),
                                     jnp.asarray(q), epsilon=0.05,
                                     n_iters=200, block_rows=64,
                                     interpret=True))
    out = sinkhorn_fixed(T(cost), T(p), T(q), epsilon=0.05,
                         n_iters=200).numpy()
    assert np.abs(out - ref).max() < 5e-5
    np.testing.assert_allclose(out.sum(1), p, atol=1e-4)
    np.testing.assert_allclose(out.sum(0), q, atol=1e-4)


def test_sinkhorn_fixed_plain_flag_is_the_cpu_path(rng):
    cost = T(rng.uniform(size=(32, 40)).astype(np.float32))
    np.testing.assert_array_equal(
        sinkhorn_fixed(cost, n_iters=10).numpy(),
        sinkhorn_fixed(cost, n_iters=10, plain=True).numpy())
    with pytest.raises(ValueError):
        sinkhorn_fixed(cost, n_iters=0)


def test_kernel_wrappers_take_plain_versions_on_cpu(rng):
    """On CPU tensors ``solve`` is ``solve_plain`` (to the exit and at a
    fixed count) and launches nothing."""
    neg_c = T(rng.normal(size=(6, 5)).astype(np.float32))
    log_p = torch.full((6,), -float(np.log(6)))
    log_q = torch.full((5,), -float(np.log(5)))
    before = sinkhorn_kernel.COUNTER.count
    for kw in (dict(max_iterations=50, threshold=1e-4),
               dict(max_iterations=7, check=False)):
        out = sinkhorn_kernel.solve(neg_c, log_p, log_q, log_p.exp(), 0.1,
                                    **kw)
        ref = sinkhorn_kernel.solve_plain(neg_c, log_p, log_q, log_p.exp(),
                                          0.1, **kw)
        for a, b in zip(out[:3], ref[:3]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert out.n_iters == ref.n_iters
        np.testing.assert_array_equal(out.err, ref.err)
    assert out.n_iters == 7  # the fixed count, no check
    # the CPU path launches nothing
    assert sinkhorn_kernel.COUNTER.count == before


def _groups(rng, L=2, cap=16, d=12):
    z = rng.normal(size=(L, cap, 4))
    x = (z @ rng.normal(size=(4, d))
         + 0.05 * rng.normal(size=(L, cap, d))).astype(np.float32)
    y = (z @ rng.normal(size=(4, d))
         + 0.05 * rng.normal(size=(L, cap, d))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_gw_plain_matches_jax(rng, masked, reference):
    x, y = _groups(rng)
    x_mask = np.ones((2, 16), bool)
    y_mask = np.ones((2, 16), bool)
    if masked:
        x_mask[0, 12:] = False
        y_mask[1, 10:] = False
    kw = dict(epsilon=5e-3, max_iterations=400)
    if reference == "xla":
        ref = jax_egw_per_label(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(x_mask), jnp.asarray(y_mask),
                                sinkhorn_max_iterations=2000, **kw)
    else:
        ref = egw_per_label_pallas(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(x_mask), jnp.asarray(y_mask),
                                   interpret=True, **kw)
    out = egw_per_label(T(x), T(y), T(x_mask), T(y_mask), **kw)
    t = out.coupling.numpy()
    np.testing.assert_allclose(t, np.asarray(ref.coupling), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(out.n_iters.numpy(), np.asarray(ref.n_iters))
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3, atol=1e-7)
    for lbl in range(2):
        n_valid = int(x_mask[lbl].sum())
        m_valid = int(y_mask[lbl].sum())
        assert np.abs(t[lbl][n_valid:, :]).sum() == 0.0
        assert np.abs(t[lbl][:, m_valid:]).sum() == 0.0


def test_gw_labels_stop_on_their_own(rng):
    """Freezing per label: a label that stops early keeps its plan and
    count while the other runs on (vmap-over-while_loop semantics)."""
    x, y = _groups(rng)
    mask = np.ones((2, 16), bool)
    both = egw_per_label(T(x), T(y), T(mask), T(mask), max_iterations=400)
    for lbl in range(2):
        alone = egw_per_label(T(x[lbl:lbl + 1]), T(y[lbl:lbl + 1]),
                              T(mask[lbl:lbl + 1]), T(mask[lbl:lbl + 1]),
                              max_iterations=400)
        assert int(alone.n_iters[0]) == int(both.n_iters[lbl])
        np.testing.assert_allclose(alone.coupling[0].numpy(),
                                   both.coupling[lbl].numpy(), rtol=1e-5,
                                   atol=1e-9)
    single = entropic_gw(T(x[0]), T(y[0]), max_iterations=400)
    assert int(single.n_iters) == int(both.n_iters[0])


def test_gw_kernel_wrapper_uses_plain_solver_on_cpu(rng):
    x, y = _groups(rng, cap=8)
    mask = np.ones((2, 8), bool)
    before = gw_kernel.COUNTER.count
    a = egw_per_label(T(x), T(y), T(mask), T(mask), max_iterations=200)
    b = egw_per_label(T(x), T(y), T(mask), T(mask), max_iterations=200,
                      plain=True)
    np.testing.assert_array_equal(a.coupling.numpy(), b.coupling.numpy())
    assert gw_kernel.COUNTER.count == before
    with pytest.raises(ValueError):
        egw_per_label_kernel(T(x), T(y), T(mask), T(mask))


def test_fot_and_apply_feature_coupling_match_jax(rng):
    x = rng.normal(size=(8, 24)).astype(np.float32)
    y = rng.normal(size=(8, 20)).astype(np.float32)
    ts = np.eye(8, dtype=np.float32) / 8
    ref = jax_fot(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ts))
    out = fot(T(x), T(y), T(ts))
    assert out.n_iters == int(ref.n_iters)
    np.testing.assert_allclose(out.coupling.numpy(), np.asarray(ref.coupling),
                               rtol=0, atol=1e-6)
    tv = np.asarray(ref.coupling).copy()
    tv[0, 0] = np.nan
    tv[:, 3] = 0.0
    feats = rng.normal(size=(4, 24)).astype(np.float32)
    for normalize in (True, False):
        np.testing.assert_allclose(
            apply_feature_coupling(T(feats), T(tv), normalize).numpy(),
            np.asarray(jax_apply(jnp.asarray(feats), jnp.asarray(tv),
                                 normalize)), rtol=1e-5, atol=1e-6)


def test_coupling_pipeline_matches_jax(rng):
    L, cap, d = 2, 8, 64
    z = rng.normal(size=(L, cap, 4))
    pet = (z @ rng.normal(size=(4, d))
           + 0.1 * rng.normal(size=(L, cap, d))).astype(np.float32)
    mri = (z @ rng.normal(size=(4, d))
           + 0.1 * rng.normal(size=(L, cap, d))).astype(np.float32)
    mask = np.ones((L, cap), bool)
    mask[1, 6:] = False
    tv_j, gw_j, fot_j = jax_pipeline(jnp.asarray(pet), jnp.asarray(mri),
                                     jnp.asarray(mask), jnp.asarray(mask))
    tv, gw, fot_res = coupling_pipeline(T(pet), T(mri), T(mask), T(mask))
    tv_j = np.asarray(tv_j)
    assert tv.shape == (d, d)
    assert np.abs(tv.numpy() - tv_j).max() <= 1e-4 * tv_j.max()
    np.testing.assert_array_equal(gw.n_iters.numpy(), np.asarray(gw_j.n_iters))
    np.testing.assert_array_equal(gw.converged.numpy(),
                                  np.asarray(gw_j.converged))
    assert fot_res.n_iters == int(fot_j.n_iters)
    assert fot_res.converged == bool(fot_j.converged)
    assert float(tv.sum()) == pytest.approx(1.0, abs=1e-3)


def test_group_and_pad_first_come_order():
    feats = np.arange(12, dtype=np.float32).reshape(6, 2)
    labels = np.array([1, 0, 1, 1, 0, 1])
    groups, mask = group_and_pad(feats, labels, 2, 3)
    np.testing.assert_array_equal(groups[1], feats[[0, 2, 3]])
    np.testing.assert_array_equal(groups[0, :2], feats[[1, 4]])
    np.testing.assert_array_equal(mask, [[True, True, False]] + [[True] * 3])

"""Per-label entropic GW above K1's cluster cap of 128 rows, on the CPU.

On a CUDA card a label of more than 128 rows takes K1's device route
(``ops/gw_kernel.py:gw_route``); on the CPU the same call takes the plain
version, which is what the device route computes. Both are held here to
the JAX package's XLA solver, which has no cap: ``egw_per_label`` at 2
labels x 150 rows (label 1 padded to 110) from 64-dim features, and the
harness's ``get_coupling_egw_all_ott`` on a screen of 3 labels x 60 rows
(one "label" of 180 rows). The card's side is ``tests/test_torch_port_cuda.py``
(device route against plain) and ``chip_smoke.py``.

Tolerances: the same ``n_iters`` per label, the plan within 1e-5 of its
largest entry (reached: 4.1e-6 at 2 x 150, 24 and 72 iterations; 2.4e-6 on
the 180 rows, 40 iterations), the GW cost within 1e-5 relative.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.ops import api as jax_api
from otfusion_tpu.ops.gromov import egw_per_label as jax_egw_per_label
from otfusion_tpu_torch.ops import api
from otfusion_tpu_torch.ops.gromov import egw_per_label
from otfusion_tpu_torch.ops.gw_kernel import MAX_CAP, gw_route

from test_eval_harness import synthetic_screen

CAP, VALID, D = 150, 110, 64
EPS = 1e-2
PLAN_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _labels():
    """Two labels of (X, Y) rows sharing an 8-dim latent; label 1 keeps its
    first 110 rows."""
    rng = np.random.default_rng(7)
    z = rng.normal(size=(2, CAP, 8))
    x = z @ rng.normal(size=(8, D)) + 0.05 * rng.normal(size=(2, CAP, D))
    y = z @ rng.normal(size=(8, D)) + 0.05 * rng.normal(size=(2, CAP, D))
    mask = np.ones((2, CAP), bool)
    mask[1, VALID:] = False
    x[1, VALID:] = 0.0
    y[1, VALID:] = 0.0
    return x.astype(np.float32), y.astype(np.float32), mask


@pytest.fixture(scope="module")
def screen():
    return synthetic_screen(n_labels=3, n=60, d=6, dp=5, seed=9)


@pytest.fixture(scope="module")
def jax_refs(screen):
    """The JAX solves of this file, once, in threads."""
    x, y, m = _labels()
    calls = {
        "per_label": lambda: jax_egw_per_label(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), jnp.asarray(m),
            epsilon=EPS),
        "all": lambda: jax_api.get_coupling_egw_all_ott(
            (screen["Xs_dict"], screen["Xt_dict"]), EPS),
    }
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {k: pool.submit(fn) for k, fn in calls.items()}
        return {k: f.result() for k, f in futures.items()}


def test_caps_above_128_take_the_device_route():
    assert MAX_CAP == 128
    assert gw_route(CAP) == "device" and gw_route(180) == "device"


def test_per_label_gw_above_the_cluster_cap_matches_jax(jax_refs):
    x, y, m = _labels()
    got = egw_per_label(*(torch.from_numpy(a) for a in (x, y, m, m)),
                        epsilon=EPS)
    want = jax_refs["per_label"]
    assert got.n_iters.tolist() == np.asarray(want.n_iters).tolist()
    t_ref = np.asarray(want.coupling)
    diff = np.abs(got.coupling.numpy() - t_ref).max()
    assert diff <= PLAN_REL * t_ref.max(), diff / t_ref.max()
    # nothing on label 1's padding
    assert float(got.coupling[1, VALID:].abs().sum()) == 0.0
    assert float(got.coupling[1, :, VALID:].abs().sum()) == 0.0
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-5)
    assert got.converged.tolist() == np.asarray(want.converged).tolist()


def test_egw_all_ott_on_180_rows_matches_jax(screen, jax_refs):
    """The whole screen as one label of 180 rows (labels ignored)."""
    t, log = api.get_coupling_egw_all_ott(
        (screen["Xs_dict"], screen["Xt_dict"]), EPS, device="cpu")
    t_ref, log_ref = jax_refs["all"]
    t_ref = np.asarray(t_ref)
    assert t.shape == t_ref.shape == (180, 180)
    assert np.abs(t - t_ref).max() <= PLAN_REL * t_ref.max()
    assert log["n_iters_outer"] == log_ref["n_iters_outer"]
    assert log["converged_outer"] == log_ref["converged_outer"]
    assert log["GW cost"] == pytest.approx(log_ref["GW cost"], rel=1e-5)

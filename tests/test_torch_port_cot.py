"""The port's COOT-L (``ops/cot.py``) and its four ``get_coupling_*``
wrappers against the JAX package, on the CPU.

COOT stops when ``|cost - new_cost| < 1e-7``, an absolute test on a
float32 cost. On this screen at unit scale the cost is 9.44 at eps 1e-2
(16.37 at eps 0.1), where a float32 step is 9.5e-7 (1.9e-6), so the test
only passes when two successive costs round to the same float: where it
stops is rounding noise. JAX's own count there moves from 53 to 9
iterations (eps 1e-2) and from 17 to 13 (eps 0.1) when label 0's X moves
by one float32 step. So the counts are held equal on features scaled by
0.01 (costs near 1e-3, where 1e-7 is a tolerance the iterates cross), and
at unit scale only the plans, which agree at any count. Tolerances: plans
within ``atol=1e-6, rtol=1e-3``; ``n_iters`` and ``converged`` equal.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from otfusion_tpu.ops import api as jax_api
from otfusion_tpu_torch.ops import api
from otfusion_tpu_torch.ops.cot import cotl

from test_torch_port_ot_api import PLAN, screen

SMALL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores at once, where PyTorch's default of a thread per core
    makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
CASES = {
    # name: (JAX wrapper, eps, feature scale, non-negative features)
    "cotl_sinkhorn": ("get_coupling_cotl_sinkhorn", 1e-2, SMALL, False),
    "cot_sinkhorn": ("get_coupling_cot_sinkhorn", 1e-2, SMALL, False),
    "each_cot_sinkhorn": ("get_coupling_each_cot_sinkhorn", 1e-1, SMALL,
                          False),
    # post-ReLU features with a dead channel: data-driven feature
    # marginals, one of them exactly 0
    "cotl_sinkhorn_relu": ("get_coupling_cotl_sinkhorn", 1e-2, SMALL, True),
    "cotl_sinkhorn_unit": ("get_coupling_cotl_sinkhorn", 1e-1, 1.0, False),
}


def _data(scale, relu):
    xs, ys = screen()
    if relu:
        xs = {l: np.maximum(v, 0.0) for l, v in xs.items()}
        ys = {l: np.maximum(v, 0.0) for l, v in ys.items()}
        for v in xs.values():
            v[:, 2] = 0.0
    return ({l: v * np.float32(scale) for l, v in xs.items()},
            {l: v * np.float32(scale) for l, v in ys.items()})


@pytest.fixture(scope="module")
def refs():
    """{case: (data, JAX coupling, JAX log)}; the JAX solves in threads,
    so their compiles overlap."""
    with ThreadPoolExecutor(len(CASES)) as pool:
        futures = {}
        for case, (name, eps, scale, relu) in CASES.items():
            data = _data(scale, relu)
            futures[case] = (data, pool.submit(getattr(jax_api, name), data,
                                               eps))
        return {case: (data, *future.result())
                for case, (data, future) in futures.items()}


def _counts(log):
    if "n_iters" in log:
        return log["n_iters"], log["converged"]
    return {label: _counts(sub) for label, sub in log.items()}


# port wrapper -> the JAX case it must equal: ``get_coupling_cotl`` (the
# feature stage at the sample stage's eps) computes what
# ``get_coupling_cotl_sinkhorn`` does
WRAPPERS = {case: (CASES[case][0], case) for case in CASES}
WRAPPERS["cotl"] = ("get_coupling_cotl", "cotl_sinkhorn")


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_coot_wrapper_matches_jax(refs, wrapper):
    name, case = WRAPPERS[wrapper]
    _, eps, scale, _ = CASES[case]
    data, t_ref, log_ref = refs[case]
    t, log = getattr(api, name)(data, eps, device="cpu")
    if isinstance(t_ref, dict):
        assert sorted(t) == sorted(t_ref)
        for label in t_ref:
            np.testing.assert_allclose(t[label], t_ref[label], **PLAN)
    else:
        np.testing.assert_allclose(t, np.asarray(t_ref), **PLAN)
    assert log.keys() == log_ref.keys()
    logs = log.values() if "time" not in log else [log]
    logs_ref = log_ref.values() if "time" not in log_ref else [log_ref]
    for sub, sub_ref in zip(logs, logs_ref):
        np.testing.assert_allclose(sub["Tv"], sub_ref["Tv"], **PLAN)
        np.testing.assert_allclose(sub["cost"], sub_ref["cost"], **PLAN)
    if scale == SMALL:
        assert _counts(log) == _counts(log_ref)


def test_cotl_padded_labels_and_zero_marginal_match_jax(refs):
    """``cotl`` itself on padded labels (the last label 6 of 8 rows) with a
    dead feature channel, against JAX's wrapper on the same data: the same
    plans and count; no mass on padding, and the dead channel's row of Tv
    at its marginal's floor (log 1e-38), as JAX's."""
    data, t_ref, log_ref = refs["cotl_sinkhorn_relu"]
    labels, x, y, xm, ym = api._pad_dicts(*data)
    res = cotl(*(torch.from_numpy(a) for a in (x, y, xm, ym)), epsilon=1e-2)
    ts = res.sample_couplings.numpy()
    for i, label in enumerate(labels):
        n, m = data[0][label].shape[0], data[1][label].shape[0]
        np.testing.assert_allclose(ts[i, :n, :m], t_ref[label], **PLAN)
    tv = res.feature_coupling.numpy()
    np.testing.assert_allclose(tv, log_ref["Tv"], **PLAN)
    assert (res.n_iters, res.converged) == (log_ref["n_iters"],
                                            log_ref["converged"])
    assert ts[2, 6:].max() == 0.0 and ts[2, :, 6:].max() == 0.0
    assert tv[2].max() <= 1e-30 and log_ref["Tv"][2].max() <= 1e-30

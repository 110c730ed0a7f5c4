"""The port's ``get_coupling_*`` API, EGWL, FOT's wrapper and the exact
solvers against the JAX package, on the CPU.

Inputs are a small chemical screen made with numpy from a seed (the JAX
harness tests' ``synthetic_screen`` shape: 3 labels of 8 rows, one label
cut to 6 so the per-label caps pad, d = d' = 6). On the CPU the port runs
the kernels' plain versions (K1's batched solver, K2's host loop). Each JAX
reference is computed once per module. Tolerances: plans within
``atol=1e-6, rtol=1e-3``, with equal ``n_iters`` and convergence flags;
the exact solvers (float64 numpy on both sides) to 1e-9.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from otfusion_tpu.ops import api as jax_api
from otfusion_tpu.ops.emd import emd as jax_emd
from otfusion_tpu.ops.fot import mdict_to_matrix as jax_mdict_to_matrix
from otfusion_tpu_torch.ops import api
from otfusion_tpu_torch.ops.emd import emd
from otfusion_tpu_torch.ops.fot import get_coupling_fot, mdict_to_matrix
from otfusion_tpu_torch.ops.gromov import entropic_gw_labels

PLAN = dict(atol=1e-6, rtol=1e-3)
EXACT = dict(atol=1e-9, rtol=0)
# Every method at eps 1e-2; the two masked solves (EGWL's plan mask, LEOT's
# plan-masked K2) at 1e-3 as well.
CASES = [(m, 1e-2) for m in ("egw_ott", "egw_pgd", "egw_labels_ott",
                             "egw_all_ott", "egw_all", "eot_ott",
                             "leot_ott")]
CASES += [("egw_labels_ott", 1e-3), ("leot_ott", 1e-3)]
# (port function, JAX function it must equal): aliases are held to the
# function they call in JAX, so each JAX solve runs once.
METHODS = {
    "egw_ott": ("get_coupling_egw_ott", "get_coupling_egw_ott"),
    "egw_pgd": ("get_coupling_egw_pgd", "get_coupling_egw_ott"),
    "egw_labels_ott": ("get_coupling_egw_labels_ott",
                       "get_coupling_egw_labels_ott"),
    "egw_all_ott": ("get_coupling_egw_all_ott", "get_coupling_egw_all_ott"),
    "egw_all": ("get_coupling_egw_all", "get_coupling_egw_all_ott"),
    "eot_ott": ("get_coupling_eot_ott", "get_coupling_eot_ott"),
    "leot_ott": ("get_coupling_leot_ott", "get_coupling_leot_ott"),
}
# Log entries that are float solver outputs (compared with the plans'
# tolerance) or wall times (not compared).
_FLOAT_KEYS = ("GW cost", "cost")
_SKIP_KEYS = ("time", "cost_time")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores at once, where PyTorch's default of a thread per core
    makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def screen(n_labels=3, n=8, d=6, short=6, seed=3):
    """Per-label (X, Y) rows sharing a 3-dim latent (true pairs share a row
    index); the last label has ``short`` rows."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, d))
    b = rng.normal(size=(3, d))
    xs, ys = {}, {}
    for label in range(n_labels):
        rows = short if label == n_labels - 1 else n
        z = rng.normal(size=(rows, 3))
        xs[label] = (z @ a + 0.05 * rng.normal(size=(rows, d))).astype(
            np.float32)
        ys[label] = (z @ b + 0.05 * rng.normal(size=(rows, d))).astype(
            np.float32)
    return xs, ys


@pytest.fixture(scope="module")
def data():
    return screen()


@pytest.fixture(scope="module")
def jax_refs(data):
    """{(JAX function name, eps): (coupling, log)}, each solved once. The
    solves run in threads: each is an eager JAX call whose first use of a
    shape compiles, and the compiles overlap (13.8 s in a row, 5.5 s so)."""
    keys = sorted({(METHODS[m][1], eps) for m, eps in CASES})
    with ThreadPoolExecutor(len(keys)) as pool:
        futures = {(name, eps): pool.submit(getattr(jax_api, name), data, eps)
                   for name, eps in keys}
        return {key: future.result() for key, future in futures.items()}


def _assert_plans(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_plans(got[key], want[key])
        return
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **PLAN)


def _assert_logs(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key in _SKIP_KEYS:
            continue
        if isinstance(value, dict):
            _assert_logs(got[key], value)
        elif key in _FLOAT_KEYS:
            np.testing.assert_allclose(got[key], value, **PLAN)
        else:
            assert got[key] == value, key  # n_iters, converged flags


@pytest.mark.parametrize("method,eps", CASES)
def test_coupling_matches_jax(data, jax_refs, method, eps):
    port_name, jax_name = METHODS[method]
    t, log = getattr(api, port_name)(data, eps, device="cpu")
    t_ref, log_ref = jax_refs[jax_name, eps]
    _assert_plans(t, t_ref)
    _assert_logs(log, log_ref)


def test_egw_labels_is_one_masked_global_solve(data):
    """EGWL: zero mass off the label blocks, ``n_iters`` in steps of 8, and
    not per-label GW (the global max-scaling gives another plan)."""
    labels, x, y, lx, ly = api._concat_dicts(*data)
    res = entropic_gw_labels(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(lx), torch.from_numpy(ly),
                             epsilon=1e-2)
    t = res.coupling.numpy()
    assert t[lx[:, None] != ly[None, :]].max() == 0.0
    assert int(res.n_iters) % 8 == 0 and int(res.n_iters) > 0
    assert t.sum() == pytest.approx(1.0, abs=1e-3)
    per_label, _ = api.get_coupling_egw_ott(data, 1e-2, device="cpu")
    blocks = api._split_by_label(t, labels, lx, ly)
    assert max(np.abs(blocks[l] / blocks[l].sum()
                      - per_label[l] / per_label[l].sum()).max()
               for l in labels) > 1e-3


@pytest.mark.parametrize("method", ["gw_cg", "gw_all"])
def test_exact_gw_matches_jax(data, method):
    name = f"get_coupling_{method}"
    t, log = getattr(api, name)(data, device="cpu")
    t_ref, log_ref = getattr(jax_api, name)(data)
    if isinstance(t_ref, dict):
        assert sorted(t) == sorted(t_ref)
        for label in t_ref:
            np.testing.assert_allclose(t[label], t_ref[label], **EXACT)
    else:
        np.testing.assert_allclose(t, t_ref, **EXACT)
    assert log.keys() == log_ref.keys()


def test_emd_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.5, 7)
    b = rng.uniform(0.5, 1.5, 5)
    a, b = a / a.sum(), b / b.sum()
    cost = rng.uniform(size=(7, 5))
    t = emd(a, b, cost)
    np.testing.assert_allclose(t, jax_emd(a, b, cost), **EXACT)
    np.testing.assert_allclose(t.sum(1), a, atol=1e-9)
    np.testing.assert_allclose(t.sum(0), b, atol=1e-9)


def test_mdict_to_matrix_matches_jax():
    rng = np.random.default_rng(6)
    src = np.array([2, 0, 0, 2, 1])
    tgt = np.array([0, 1, 2, 2, 0, 1])
    blocks = {l: rng.uniform(size=((src == l).sum(), (tgt == l).sum()))
              for l in (0, 1, 2)}
    got = mdict_to_matrix(blocks, src, tgt)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_mdict_to_matrix(blocks, src, tgt))


@pytest.mark.parametrize("dense", [False, True])
def test_get_coupling_fot_matches_jax(data, dense):
    """FOT's wrapper from per-label blocks and from one dense block
    matrix (the feature plan goes through ``fot``: K2 on CUDA)."""
    xs, ys = data
    ts = {l: np.eye(xs[l].shape[0]) / xs[l].shape[0] for l in xs}
    if dense:
        src = np.concatenate([np.full(xs[l].shape[0], l) for l in xs])
        tgt = np.concatenate([np.full(ys[l].shape[0], l) for l in ys])
        ts = mdict_to_matrix(ts, src, tgt)
    tv, log = get_coupling_fot(data, ts, 1e-2, device="cpu")
    tv_ref, log_ref = jax_api.get_coupling_fot(data, ts, 1e-2)
    np.testing.assert_allclose(tv, tv_ref, **PLAN)
    assert log.keys() == log_ref.keys() == {"cost", "converged", "n_iters",
                                            "time"}
    assert (log["n_iters"], log["converged"]) == (log_ref["n_iters"],
                                                  log_ref["converged"])
    np.testing.assert_allclose(log["cost"], log_ref["cost"], **PLAN)


def test_entry_points_default_to_the_card(data, monkeypatch):
    """Every entry point's device defaults to CUDA, which raises without a
    GPU: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in api.__all__:
        fn = getattr(api, name)
        args = (data, {l: np.eye(6) for l in data[0]}) if name.endswith(
            "fot") else (data,)
        with pytest.raises(RuntimeError, match="--device cuda"):
            fn(*args)

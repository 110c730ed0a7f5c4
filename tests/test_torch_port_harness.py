"""The eval harness's runs and its CLI against the JAX package, on the CPU.

``run_all``, ``run_feature_matching``, ``run_loo`` and ``run_outer_cv``
(the per-label GW method ``EGW_ott`` and the ``perfect`` baseline), and the
CLI's ``all`` subcommand, each on the same seeded screen in both packages:
the same keys, metrics within 1e-4, couplings within ``atol=1e-6,
rtol=1e-3``, the same solver counts.

``run_outer_cv``'s predictor is an MLP trained by full-batch Adam, which
on these 16 training rows amplifies float32 rounding: from JAX's initial
weights the two loss curves part from 1e-7 to 1e-4 within 16 epochs (the
loss oscillates, 0.028 to 0.044), and the held-out predictions end
0.02-0.1 apart. So the comparison with JAX gives both harnesses the same
deterministic predictor in the MLP's place (each package's
coupling-weighted OLS fit) and holds what the harness computes around it;
``test_torch_port_eval.py`` holds ``train_mlp`` itself to JAX on a
well-conditioned fit, and one run here trains the port's real MLP. The VAE
family is not ported: selecting it raises.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from otfusion_tpu.cli import perturbot_eval as jax_cli
from otfusion_tpu.eval import harness as jax_harness
from otfusion_tpu.eval import predictors as jax_predictors
from otfusion_tpu_torch.cli import perturbot_eval
from otfusion_tpu_torch.eval import harness, predictors
from otfusion_tpu_torch.eval.prediction import EVAL_METRIC_NAMES

from test_eval_harness import synthetic_screen
from test_torch_port_ot_api import PLAN

METRIC = dict(rtol=0, atol=1e-4)
EPS = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores at once, where PyTorch's default of a thread per core
    makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ols_model(package):
    """A stand-in for ``train_mlp``: ``package``'s coupling-weighted OLS
    fit, with ``train_mlp``'s return shape."""
    def fit(train_data, t_dict, **_):
        param = package.weighted_ols_normed(*train_data, t_dict)
        return (lambda x: package.predict(x, param)), {"final_loss": 0.0}
    return fit


@pytest.fixture(scope="module")
def screen():
    return synthetic_screen(n_labels=3, n=8, d=5, dp=4, seed=4)


def _jax_outer_cv(data, baseline):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_harness, "train_mlp", _ols_model(jax_predictors))
        return jax_harness.run_outer_cv(data, "EGW_ott", 0, EPS, EPS,
                                        baseline=baseline)


@pytest.fixture(scope="module")
def jax_runs(screen):
    """Every JAX reference of this file, computed once, in threads so that
    the eager solves' compiles overlap."""
    calls = {
        "all": lambda: jax_harness.run_all(screen, "EGW_ott", EPS),
        "features": lambda: jax_harness.run_feature_matching(
            screen, "EGW_ott", EPS, best_eps=EPS),
        "features_perfect": lambda: jax_harness.run_feature_matching(
            screen, "perfect", EPS),
        "loo": lambda: jax_harness.run_loo(screen, "EGW_ott", EPS),
        "outer": lambda: _jax_outer_cv(screen, None),
        "outer_perfect": lambda: _jax_outer_cv(screen, "perfect"),
    }
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {k: pool.submit(fn) for k, fn in calls.items()}
        return {k: f.result() for k, f in futures.items()}


def _close(got, want, tol):
    """Nested dicts/lists of arrays and floats within ``tol``; strings and
    ints (ids, labels, solver counts) equal; wall times skipped."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            if key != "time":
                _close(got[key], want[key], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, tol)
    elif isinstance(want, (str, bool, int, np.integer)) or want is None:
        assert got == want
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), **tol)


def test_run_all_matches_jax(screen, jax_runs):
    got = harness.run_all(screen, "EGW_ott", EPS, device="cpu")
    want = jax_runs["all"]
    assert got.keys() == want.keys()
    _close(got["matching_evals"], want["matching_evals"], METRIC)
    _close(got["T"], want["T"], PLAN)
    _close(got["log"], want["log"], PLAN)


@pytest.mark.parametrize("method", ["EGW_ott", "perfect"])
def test_run_feature_matching_matches_jax(screen, jax_runs, method):
    if method == "perfect":
        got = harness.run_feature_matching(screen, method, EPS, device="cpu")
        want = jax_runs["features_perfect"]
    else:
        got = harness.run_feature_matching(screen, method, EPS, best_eps=EPS,
                                           device="cpu")
        want = jax_runs["features"]
    assert got.keys() == want.keys()
    _close(got["Tv"], want["Tv"], PLAN)
    _close(got["log"], want["log"], PLAN)
    assert (got["eps"], got["sample_eps"]) == (want["eps"], want["sample_eps"])


def test_run_loo_matches_jax(screen, jax_runs):
    rows, log = harness.run_loo(screen, "EGW_ott", EPS, device="cpu")
    rows_ref, log_ref = jax_runs["loo"]
    _close(rows, rows_ref, METRIC)
    assert log.keys() == log_ref.keys()
    _close(log["ot_couplings"], log_ref["ot_couplings"], PLAN)
    _close(log["logs"], log_ref["logs"], PLAN)
    _close(log["preds"], log_ref["preds"], dict(rtol=1e-3, atol=1e-4))


@pytest.mark.parametrize("baseline", [None, "perfect"])
def test_run_outer_cv_matches_jax(screen, jax_runs, baseline, monkeypatch):
    monkeypatch.setattr(harness, "train_mlp", _ols_model(predictors))
    got = harness.run_outer_cv(screen, "EGW_ott", 0, EPS, EPS,
                               baseline=baseline, device="cpu")
    want = jax_runs["outer_perfect" if baseline else "outer"]
    _close(got, want, METRIC)


def test_run_outer_cv_trains_the_mlp(screen):
    """The real predictor: the port's MLP (its own seeded initialisation)
    trains on the device and predicts the held-out label."""
    got = harness.run_outer_cv(screen, "EGW_ott", 0, EPS, EPS, device="cpu")
    y_pred, y_true = got["pred"]["Y_pred"], got["pred"]["Y_true"]
    assert y_pred.shape == y_true.shape == (8, 4)
    assert np.isfinite(y_pred).all()
    assert 0.0 < got["log"]["mlp"]["final_loss"] < 1e-2
    evals = got["pred_evals"]["full"]
    assert evals.keys() == {*EVAL_METRIC_NAMES, "_id"}
    assert all(np.isfinite(evals[k]) for k in EVAL_METRIC_NAMES)


def test_cli_all_round_trip_matches_jax(screen, tmp_path):
    """``all EGW_ott`` through both CLIs: the same pickle name and keys,
    metrics within 1e-4."""
    path = tmp_path / "screen.pkl"
    path.write_bytes(pickle.dumps(screen))
    args = ["--quiet", "all", "EGW_ott", str(path), str(EPS)]
    assert perturbot_eval.main(["--device", "cpu", "--out-dir",
                                str(tmp_path / "port"), *args]) == 0
    assert jax_cli.main(["--out-dir", str(tmp_path / "jax"), *args]) == 0
    name = f"all_EGW_ott.{EPS}.pkl"
    got = pickle.loads((tmp_path / "port" / name).read_bytes())
    want = pickle.loads((tmp_path / "jax" / name).read_bytes())
    assert got.keys() == want.keys()
    _close(got["matching_evals"], want["matching_evals"], METRIC)
    _close(got["T"], want["T"], PLAN)


def test_vae_family_and_latent_loo_raise(screen, tmp_path):
    """``VAE``/``VAE_label`` stay selectable, as in JAX, and raise when
    run; so do ``run_loo_latent`` and ``loo --latent-vae``."""
    assert harness.OT_METHOD_MAP.keys() == jax_harness.OT_METHOD_MAP.keys()
    assert harness.OT_METHOD_HYPERPARAMS == jax_harness.OT_METHOD_HYPERPARAMS
    for method in ("VAE", "VAE_label"):
        with pytest.raises(NotImplementedError, match="VAE family"):
            harness.run_all(screen, method, (10, 128, 1e-4), device="cpu")
    with pytest.raises(NotImplementedError, match="VAE family"):
        harness.run_loo_latent(screen, "EGW_ott", EPS, device="cpu")
    path = tmp_path / "screen.pkl"
    path.write_bytes(pickle.dumps(screen))
    for argv in (["all", "VAE", str(path), "10,128,1e-4"],
                 ["loo", "EGW_ott", str(path), str(EPS), "--latent-vae"]):
        with pytest.raises(NotImplementedError, match="VAE family"):
            perturbot_eval.main(["--device", "cpu", "--out-dir",
                                 str(tmp_path), *argv])


def test_cli_device_cuda_without_gpu_raises(screen, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "screen.pkl"
    path.write_bytes(pickle.dumps(screen))
    with pytest.raises(RuntimeError, match="--device cuda"):
        perturbot_eval.main(["--out-dir", str(tmp_path), "all", "EGW_ott",
                             str(path), str(EPS)])
    assert not list(tmp_path.glob("all_*.pkl"))

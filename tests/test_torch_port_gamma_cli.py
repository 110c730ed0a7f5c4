"""The port's GAMMA trainer and ensemble tester end to end on the CPU, at a
small size: 8 synthetic cases (fundus 64^2 resized to 32^2, OCT 24^3
resized to 16^3, so d_oct = 1024), 2 folds, 1 epoch, float32.

The solves are counted by wrapping the kernels' entry points (on the CPU
they run the plain versions): per-label GW (kernel K1's ``gw_solve``) once
per coupling, never in a train step, whose EGWL is PyTorch ops; Sinkhorn
(K2's ``solve``) once per train step and once per coupling, as on the
card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from otfusion_tpu.train import ensemble as jax_ensemble
from otfusion_tpu_torch.cli import test_gamma, train_gamma
from otfusion_tpu_torch.data.gamma import make_synthetic_gamma
from otfusion_tpu_torch.ops import gromov, sinkhorn_kernel

SIZE = ["--fundus-size", "32", "--oct-shape", "16", "16", "16"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("gamma_cli")
    yield make_synthetic_gamma(root, n_cases=8, seed=5)
    torch.set_num_threads(threads)


def _count_solves(mp):
    """Count calls of K1's and K2's entry points (patched through ``mp``)."""
    seen = {"gw": 0, "sinkhorn": 0}
    for module, name, key in ((gromov, "gw_solve", "gw"),
                              (sinkhorn_kernel, "solve", "sinkhorn")):
        def wrapped(*args, _fn=getattr(module, name), _key=key, **kwargs):
            seen[_key] += 1
            return _fn(*args, **kwargs)

        mp.setattr(module, name, wrapped)
    return seen


@pytest.fixture
def counts(monkeypatch):
    return _count_solves(monkeypatch)


@pytest.fixture(scope="module")
def trained(cohort, tmp_path_factory):
    """One 2-fold, 1-epoch run; returns (run dir, its metrics, counts)."""
    mgamma, labels = cohort
    run = tmp_path_factory.mktemp("gamma_run") / "run"
    mp = pytest.MonkeyPatch()
    seen = _count_solves(mp)
    try:
        metrics = train_gamma.main([
            "--data-root", str(mgamma), "--label-file", str(labels),
            "--folds", "2", "--epochs", "1", "--device", "cpu",
            "--dtype", "float32", "--save-path", str(run), *SIZE])
    finally:
        mp.undo()
    return run, metrics, seen


def test_train_gamma_writes_folds_and_ensemble_metrics(trained):
    run, metrics, seen = trained
    for fold in ("fold0", "fold1"):
        assert (run / fold / "checkpoint.pt").exists()
        meta = json.loads((run / f"{fold}.meta.json").read_text())
        assert meta["epoch"] == 1 and "f1" in meta
    saved = json.loads((run / "ensemble_metrics.json").read_text())
    want_keys = list(jax_ensemble.evaluate_ensemble(
        [np.zeros((4, 2)), np.ones((4, 2))], np.array([0, 1, 0, 1])))
    assert list(saved) == list(metrics) == want_keys
    assert saved["n_members"] == 2
    timings = json.loads((run / "timings.json").read_text())
    assert [(t["fold"], t["epoch"]) for t in timings] == [(0, 1), (1, 1)]
    assert set(timings[0]["phase_seconds"]) == {"train", "coupling", "eval",
                                                "checkpoint"}
    # 4 train cases a fold, batch 4: one step per epoch; couplings: one
    # per epoch and one after each fold's restore
    steps, couplings = 2, 2 + 2
    assert seen == {"gw": couplings, "sinkhorn": steps + couplings}


def test_test_gamma_evaluates_the_fold_checkpoints(trained, cohort, counts,
                                                   tmp_path):
    run, _, _ = trained
    mgamma, labels = cohort
    out = tmp_path / "metrics.json"
    metrics = test_gamma.main([
        "--data-root", str(mgamma), "--label-file", str(labels),
        "--checkpoints", str(run / "fold0"), str(run / "fold1"),
        "--device", "cpu", "--dtype", "float32", "--output", str(out),
        *SIZE])
    assert json.loads(out.read_text()) == pytest.approx(metrics, nan_ok=True)
    assert metrics["n_members"] == 2
    for key in ("accuracy", "f1", "kappa", "ens_ece", "ens_nll",
                "entropy_total"):
        assert np.isfinite(metrics[key]), key
    assert counts == {"gw": 2, "sinkhorn": 2}


@pytest.mark.parametrize("cli", [train_gamma, test_gamma])
def test_device_cuda_without_a_gpu_raises(cli, cohort, monkeypatch,
                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mgamma, labels = cohort
    argv = ["--data-root", str(mgamma), "--label-file", str(labels)]
    if cli is test_gamma:
        argv += ["--checkpoints", str(tmp_path)]
    else:
        argv += ["--save-path", str(tmp_path / "run")]
    with pytest.raises(RuntimeError, match="--device cuda requested"):
        cli.main(argv)
    assert not Path(tmp_path / "run").exists()

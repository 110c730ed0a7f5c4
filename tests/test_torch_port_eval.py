"""The eval harness's host modules and its MLP predictor against the JAX
package, on the CPU.

``metrics/ot_quality.py``, ``eval/matching.py``, ``eval/prediction.py`` and
the OLS predictors are numpy on both sides: equal to 1e-9. ``train_mlp``
trains with PyTorch's Adam on the device where JAX uses optax: started from
JAX's initial weights (carried across by ``mlp_state_dict_from_jax``), its
loss curve lies within 1e-4 of JAX's, relative to the curve's first loss
(the loss falls to ~1e-8, where float32 noise alone is a large relative
error), and its predictions of a held-out label within 1e-3. The two nets
each fit their targets to a residual near 1e-4 and differ in how: JAX's
own predictions move by 1.6e-4 (held-out rows) to 1.8e-4 (training rows)
when one input moves by one float32 step, and the port's lie 6.6e-4 and
1.9e-4 from JAX's. The coupling is OT-like (0.9 of the identity plus a
uniform tenth). Under a uniform coupling the targets of a label are nearly
one point and Adam's late spikes (loss 1e-4 jumping to 1e-2) fall on other
epochs on either side: 1.4e-2 apart at epoch 191, and JAX's own curve
moves by 1.9e-3 under that one-step change. Inputs are made with numpy
from a seed in the JAX harness tests' ``synthetic_screen`` shape.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from otfusion_tpu.eval import matching as jax_matching
from otfusion_tpu.eval import prediction as jax_prediction
from otfusion_tpu.eval import predictors as jax_predictors
from otfusion_tpu.metrics import ot_quality as jax_ot_quality
from otfusion_tpu_torch.eval import matching, prediction, predictors
from otfusion_tpu_torch.metrics import ot_quality
from otfusion_tpu_torch.utils.convert import mlp_state_dict_from_jax

from test_eval_harness import synthetic_screen

EXACT = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores at once, where PyTorch's default of a thread per core
    makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def screen():
    data = synthetic_screen(n_labels=3, n=8, d=5, dp=4, seed=2)
    xs, ys = data["Xs_dict"], data["Xt_dict"]
    zs = data["Zs_dict"]["dosage"]
    rng = np.random.default_rng(7)
    ts = {k: rng.uniform(size=(8, 8)) for k in xs}
    return xs, ys, zs, ts


def _same(got, want):
    """Equal to 1e-9 through nested tuples, lists and dicts."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, **EXACT)


def _dense(ts):
    """Per-label blocks as one block-diagonal matrix."""
    n = sum(t.shape[0] for t in ts.values())
    m = sum(t.shape[1] for t in ts.values())
    out, i, j = np.zeros((n, m)), 0, 0
    for t in ts.values():
        out[i:i + t.shape[0], j:j + t.shape[1]] = t
        i, j = i + t.shape[0], j + t.shape[1]
    return out


def test_ot_quality_matches_jax(screen):
    xs, ys, _, ts = screen
    x, y, t = xs[0], ys[0][:, :4], ts[0]
    for name, args in (("knn_coupling", (x[:, :4], y, 3)),
                       ("foscttm", (x[:, :4], y)),
                       ("diag_fraction", (t,)),
                       ("relative_mse", (t,))):
        _same(getattr(ot_quality, name)(*args),
              getattr(jax_ot_quality, name)(*args))
    sliced = {k: v[:, :4] for k, v in xs.items()}
    _same(ot_quality.knn_couplings_per_label(sliced, ys, [1, 3]),
          jax_ot_quality.knn_couplings_per_label(sliced, ys, [1, 3]))
    with pytest.raises(ValueError):
        ot_quality.knn_coupling(x, y, 0)


@pytest.mark.parametrize("dense", [False, True])
def test_matching_matches_jax(screen, dense):
    xs, ys, zs, ts = screen
    t = _dense(ts) if dense else ts
    for name, args, kwargs in (
            ("coupling_confusion_matrix", (t, xs, ys, zs, zs), {}),
            ("get_diag_fracs", (t, xs, ys, zs, zs), {}),
            ("get_FOSCTTM", (t, xs, ys), {}),
            ("get_FOSCTTM", (t, xs, ys), {"use_agg": "median"}),
            ("get_FOSCTTM", (None, {k: v[:, :4] for k, v in xs.items()},
                             ys), {"use_barycenter": False})):
        _same(getattr(matching, name)(*args, **kwargs),
              getattr(jax_matching, name)(*args, **kwargs))
    _same(matching.get_rel_mse(ts), jax_matching.get_rel_mse(ts))
    _same(matching.foscttm_per_sample(xs[0], xs[1]),
          jax_matching.foscttm_per_sample(xs[0], xs[1]))


def test_prediction_matches_jax():
    rng = np.random.default_rng(8)
    y_true = rng.normal(size=(9, 6))
    y_pred = y_true + 0.3 * rng.normal(size=(9, 6))
    tied = np.round(y_pred, 0)  # ties for the average-rank transform
    norm = rng.uniform(0.5, 2.0, 6)
    for name, args, kwargs in (
            ("pearson_rowwise", (y_pred, y_true), {}),
            ("spearman_rowwise", (tied, y_true), {}),
            ("get_corrs", (y_pred, y_true), {"idx": [0, 2, 5]}),
            ("mse", (y_pred, y_true), {}),
            ("get_evals", (y_true, tied), {"prediction_id": "p"}),
            ("get_evals", (y_true, y_pred), {"agg_method": "median",
                                             "norm_Y": norm}),
            ("get_evals_preds", (y_true, [y_pred, tied], ["a", "b"]), {})):
        _same(getattr(prediction, name)(*args, **kwargs),
              getattr(jax_prediction, name)(*args, **kwargs))
    got, want = prediction.nan_evals("x"), jax_prediction.nan_evals("x")
    assert got.keys() == want.keys() and got["_id"] == "x"
    assert all(np.isnan(got[k]) for k in prediction.EVAL_METRIC_NAMES)


@pytest.mark.parametrize("dense", [False, True])
def test_ols_predictors_match_jax(screen, dense):
    xs, ys, zs, ts = screen
    x_new = np.random.default_rng(9).normal(size=(5, 5))
    t = _dense(ts) if dense else ts
    fits = [("weighted_ols_normed", (xs, ys, t))]
    if not dense:
        fits += [("ols_normed", (xs, ys, zs)),
                 ("weight_1_ols_normed", (xs, ys, zs)),
                 ("weight_conc_normed", (xs, ys, zs))]
    for name, args in fits:
        param = getattr(predictors, name)(*args)
        want = getattr(jax_predictors, name)(*args)
        _same(param, want)
        _same(predictors.predict(x_new, param),
              jax_predictors.predict(x_new, want))
    _same(predictors.make_G(8, zs[0]), jax_predictors.make_G(8, zs[0]))
    with pytest.raises(ValueError):
        predictors.make_G(7, zs[0])


class _JaxMLP(nn.Module):
    """The MLP JAX's ``train_mlp`` builds (same module names, so the same
    key gives the same initial weights)."""

    out_dim: int

    @nn.compact
    def __call__(self, h):
        h = nn.relu(nn.Dense(512)(h))
        h = nn.relu(nn.Dense(512)(h))
        return nn.Dense(self.out_dim)(h)


def jax_mlp_state(in_dim, out_dim, seed=0):
    """The port's state dict of the weights JAX's ``train_mlp(seed=seed)``
    starts from."""
    params = _JaxMLP(out_dim).init(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, in_dim), jnp.float32))
    return mlp_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]))


def test_train_mlp_matches_jax_from_its_initial_weights():
    data = synthetic_screen(n_labels=4, n=8, d=5, dp=4, seed=2)
    xs, ys = data["Xs_dict"], data["Xt_dict"]
    held_out = xs.pop(3)
    ys.pop(3)
    rng = np.random.default_rng(11)
    ts = {k: 0.9 * np.eye(8) + 0.1 * rng.uniform(size=(8, 8)) / 8
          for k in xs}
    predict_ref, log_ref = jax_predictors.train_mlp((xs, ys), ts)
    predict_fn, log = predictors.train_mlp(
        (xs, ys), ts, device="cpu", state_dict=jax_mlp_state(5, 4))
    curve, curve_ref = log["loss_curve"], np.asarray(log_ref["loss_curve"])
    assert curve.shape == curve_ref.shape == (300,)
    assert np.abs(curve - curve_ref).max() <= 1e-4 * curve_ref[0]
    assert log["final_loss"] == pytest.approx(float(curve[-1]))
    np.testing.assert_allclose(predict_fn(held_out), predict_ref(held_out),
                               rtol=0, atol=1e-3)


def test_train_mlp_seeded_init_has_flax_statistics():
    """The port's own initialisation: flax ``Dense``'s LeCun-normal
    (variance 1/fan_in, truncated at 2 std) and zero biases, the same
    draws for the same seed."""
    model = predictors.MLP(64, 3)
    predictors.flax_dense_init_(model, torch.Generator().manual_seed(0))
    again = predictors.MLP(64, 3)
    predictors.flax_dense_init_(again, torch.Generator().manual_seed(0))
    for layer, twin in zip((model.dense0, model.dense1, model.dense2),
                           (again.dense0, again.dense1, again.dense2)):
        w = layer.weight.detach().numpy()
        fan_in = layer.in_features
        assert abs(w.var() * fan_in - 1.0) < 0.1
        assert np.abs(w).max() <= 2.0 * math.sqrt(1.0 / fan_in) / 0.8796
        assert not layer.bias.detach().any()
        assert torch.equal(layer.weight, twin.weight)
    # the 512-wide hidden layer against flax's own draw
    flax_w = np.asarray(jax_mlp_state(64, 3)["dense1.weight"])
    w = model.dense1.weight.detach().numpy()
    assert abs(w.var() / flax_w.var() - 1.0) < 0.02


def test_port_sources_import_no_jax_and_no_host_only_packages():
    """By grep over the sources: no module of the port, nor
    ``chip_smoke.py``, imports JAX, flax, optax or the JAX package
    anywhere, nor matplotlib, sklearn, pandas or openpyxl at module level
    (the machine with the card has none of those four)."""
    repo = Path(__file__).resolve().parents[1]
    sources = sorted((repo / "otfusion_tpu_torch").rglob("*.py"))
    sources.append(repo / "chip_smoke.py")
    anywhere = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|otfusion_tpu)(\.|\s|$)", re.M)
    top_level = re.compile(
        r"^(import|from)\s+(matplotlib|sklearn|pandas|openpyxl)(\.|\s|$)",
        re.M)
    assert len(sources) > 30
    for path in sources:
        text = path.read_text()
        assert not anywhere.search(text), path
        assert not top_level.search(text), path

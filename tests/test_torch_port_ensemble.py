"""The port's scikit-learn stand-ins, calibration battery and deep-ensemble
evaluation against scikit-learn and the JAX package, on the CPU.

  * ``kfold_indices`` equals ``KFold(shuffle=True)``'s splits for n in
    5..23, k in 2..5 and three seeds;
  * each ``metrics.ranking`` function equals scikit-learn's to 1e-12 on
    hypothesis-drawn labels and scores with many ties, a single class and
    three classes; where scikit-learn has no AUC (a single class: it warns
    and returns nan, or raises in older versions) the port raises
    ``ValueError``, which ``evaluate_ensemble`` turns into nan as the JAX
    function does;
  * ``uncertainty_metrics`` and ``evaluate_ensemble`` equal the JAX
    package's to 1e-12, key for key.
"""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn import metrics as skm
from sklearn.model_selection import KFold

from otfusion_tpu.metrics import calibration as jax_calibration
from otfusion_tpu.train import ensemble as jax_ensemble
from otfusion_tpu_torch.cli.train_gamma import kfold_indices
from otfusion_tpu_torch.metrics import calibration, ranking
from otfusion_tpu_torch.train.ensemble import evaluate_ensemble

TOL = 1e-12
HYPOTHESIS = settings(max_examples=60, deadline=None)


@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_kfold_indices_equal_sklearn(seed):
    for n in range(5, 24):
        for k in range(2, 6):
            want = list(KFold(n_splits=k, shuffle=True,
                              random_state=seed).split(np.arange(n)))
            got = kfold_indices(n, k, seed)
            assert len(got) == len(want) == k
            for (tr, te), (tr_ref, te_ref) in zip(got, want):
                np.testing.assert_array_equal(tr, tr_ref)
                np.testing.assert_array_equal(te, te_ref)


def test_kfold_indices_refuses_too_few_samples():
    with pytest.raises(ValueError):
        kfold_indices(3, 5, 0)


def _binary(draw, n_min=2, n_max=30, levels=6):
    """(labels in {0, 1}, scores on a few levels: many ties)."""
    n = draw(st.integers(n_min, n_max))
    y = np.array(draw(st.lists(st.integers(0, 1), min_size=n, max_size=n)))
    s = np.array(draw(st.lists(st.integers(0, levels), min_size=n,
                               max_size=n)), np.float64) / levels
    return y, s


@st.composite
def binary_cases(draw):
    return _binary(draw)


@st.composite
def multiclass_cases(draw):
    """Three classes, every one present, and probabilities from a few
    levels (ties across rows)."""
    n = draw(st.integers(3, 30))
    y = np.array(draw(st.lists(st.integers(0, 2), min_size=n, max_size=n)))
    y[:3] = draw(st.permutations([0, 1, 2]))
    raw = np.array(draw(st.lists(st.integers(1, 4), min_size=3 * n,
                                 max_size=3 * n)), np.float64).reshape(n, 3)
    return y, raw / raw.sum(axis=1, keepdims=True)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@HYPOTHESIS
@given(binary_cases())
def test_roc_curve_and_average_precision_equal_sklearn(case):
    y, s = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = skm.roc_curve(y, s)
        want_ap = skm.average_precision_score(y, s)
    for got, ref in zip(ranking.roc_curve(y, s), want):
        _close(got, ref)
    _close(ranking.average_precision_score(y, s), want_ap)


@HYPOTHESIS
@given(binary_cases())
def test_binary_auc_equals_sklearn_or_raises_where_it_has_none(case):
    y, s = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want = skm.roc_auc_score(y, s)
        except ValueError:
            want = float("nan")
    if len(np.unique(y)) < 2:
        assert np.isnan(want)
        with pytest.raises(ValueError, match="Only one class"):
            ranking.roc_auc_score(y, s)
    else:
        _close(ranking.roc_auc_score(y, s), want)


@HYPOTHESIS
@given(multiclass_cases())
def test_multiclass_auc_equals_sklearn_ovr_macro(case):
    y, p = case
    _close(ranking.roc_auc_score(y, p),
           skm.roc_auc_score(y, p, multi_class="ovr"))
    # a class missing from y_true: both raise
    two = np.where(y == 2, 1, y)
    with pytest.raises(ValueError):
        skm.roc_auc_score(two, p, multi_class="ovr")
    with pytest.raises(ValueError):
        ranking.roc_auc_score(two, p)


@st.composite
def label_pairs(draw):
    """(y_true, y_pred) over up to three classes, either side possibly
    missing a class or holding one class only."""
    n = draw(st.integers(1, 25))
    classes = draw(st.integers(1, 3))
    lists = st.lists(st.integers(0, classes - 1), min_size=n, max_size=n)
    return np.array(draw(lists)), np.array(draw(lists))


@HYPOTHESIS
@given(label_pairs())
def test_kappa_and_weighted_scores_equal_sklearn(pair):
    y, p = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kappa = skm.cohen_kappa_score(y, p)
        want = [f(y, p, average="weighted", zero_division=0)
                for f in (skm.precision_score, skm.recall_score,
                          skm.f1_score)]
    got = ranking.cohen_kappa_score(y, p)
    if np.isnan(kappa):
        assert np.isnan(got)
    else:
        _close(got, kappa)
    _close(ranking.weighted_precision_recall_f1(y, p), want)


def _assert_same_metrics(got, want):
    assert list(got) == list(want)
    for key in want:
        if isinstance(want[key], float) and np.isnan(want[key]):
            assert np.isnan(got[key]), key
        else:
            assert got[key] == pytest.approx(want[key], rel=0, abs=TOL), key


def _logits(rng, labels, classes, skill):
    return (np.eye(classes)[labels] * skill
            + rng.normal(size=(len(labels), classes))).astype(np.float32)


@pytest.mark.parametrize("classes", [2, 3])
def test_uncertainty_metrics_equal_jax(classes):
    rng = np.random.default_rng(classes)
    labels = rng.integers(0, classes, 40)
    logits = _logits(rng, labels, classes, 1.5)
    _assert_same_metrics(calibration.uncertainty_metrics(logits, labels),
                         jax_calibration.uncertainty_metrics(logits, labels))
    all_right = np.eye(classes)[labels] * 9.0
    _assert_same_metrics(
        calibration.uncertainty_metrics(all_right, labels),
        jax_calibration.uncertainty_metrics(all_right, labels))


@pytest.mark.parametrize("case", ["binary", "three_classes", "one_class",
                                  "three_members"])
def test_evaluate_ensemble_equals_jax(case):
    rng = np.random.default_rng(7)
    classes = 3 if case == "three_classes" else 2
    labels = rng.integers(0, classes, 30)
    if case == "one_class":
        labels[:] = 1
    members = 3 if case == "three_members" else 2
    member_logits = [_logits(rng, labels, classes, skill)
                     for skill in (2.0, 0.3, 1.0)[:members]]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_ensemble.evaluate_ensemble(member_logits, labels)
    got = evaluate_ensemble(member_logits, labels)
    _assert_same_metrics(got, want)
    assert got["n_members"] == members
    assert np.isnan(got["auc"]) == (case == "one_class")

"""Ranking and agreement metrics in numpy, as scikit-learn computes them.

The JAX package's ensemble evaluation and calibration battery call
scikit-learn, which the machine the port runs on lacks. These functions
give scikit-learn's numbers for the calls that code makes:

  * ``roc_curve(y_true, y_score)``: thresholds at the distinct scores
    (ties grouped, scores sorted by a stable descending sort), collinear
    points dropped (``drop_intermediate=True``), a leading (0, 0) point;
    ``nan`` rates when a class is absent;
  * ``roc_auc_score``: binary scores, or (n, C) probabilities one-vs-rest
    with the macro average. It raises ``ValueError`` for a single class in
    ``y_true``, for a class count that differs from the columns, and for
    rows that do not sum to 1;
  * ``average_precision_score``: the step-wise sum
    ``sum_k (R_k - R_{k-1}) P_k`` with no interpolation;
  * ``cohen_kappa_score``: ``nan`` where it is undefined;
  * ``weighted_precision_recall_f1``: precision, recall and F1 per class
    (labels of either argument), 0 where a denominator is 0, averaged with
    the classes' support as weights (``average="weighted"``,
    ``zero_division=0``).
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import trapezoid


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, descending."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    order = np.argsort(-y_score, kind="stable")
    y_score = y_score[order]
    y_true = (y_true[order] == 1).astype(np.float64)
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) of binary labels (positive = 1)."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if len(fps) > 2:
        keep = np.nonzero(np.concatenate([
            [True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
            [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds])
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def _binary_auc(y_true, y_score) -> float:
    if len(np.unique(y_true)) != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(trapezoid(tpr, fpr))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve: binary ``y_score`` (n,) scores the larger
    label as positive; (n, C) probabilities with C > 2 are scored one
    class against the rest and macro-averaged."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, np.float64)
    classes = np.unique(y_true)
    if y_score.ndim == 2 and y_score.shape[1] <= 2:
        raise ValueError("binary y_score needs the shape (n_samples,)")
    if y_score.ndim == 2 or len(classes) > 2:
        if y_score.ndim != 2:
            raise ValueError("y_score needs to be of shape (n_samples, "
                             "n_classes) for multiclass y_true")
        if not np.allclose(1, y_score.sum(axis=1)):
            raise ValueError("Target scores need to be probabilities for "
                             "multiclass roc_auc, i.e. they should sum up "
                             "to 1.0 over classes")
        if len(classes) != y_score.shape[1]:
            raise ValueError("Number of classes in y_true not equal to the "
                             "number of columns in 'y_score'")
        return float(np.mean([
            _binary_auc((y_true == c).astype(np.int64), y_score[:, i])
            for i, c in enumerate(classes)]))
    positive = (y_true == classes[-1]).astype(np.int64)
    return _binary_auc(positive if len(classes) == 2 else y_true * 0,
                       y_score.ravel())


def average_precision_score(y_true, y_score) -> float:
    """Average precision of binary labels (positive = 1): the precision at
    each threshold weighted by the recall it adds."""
    fps, tps, _ = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _labels(y_true, y_pred):
    return np.union1d(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel())


def _confusion(y_true, y_pred, labels) -> np.ndarray:
    t = np.searchsorted(labels, np.asarray(y_true).ravel())
    p = np.searchsorted(labels, np.asarray(y_pred).ravel())
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def cohen_kappa_score(y1, y2) -> float:
    """Cohen's kappa of two labelings; ``nan`` where it is undefined."""
    confusion = _confusion(y1, y2, _labels(y1, y2)).astype(np.float64)
    n = confusion.shape[0]
    sum0, sum1 = confusion.sum(axis=0), confusion.sum(axis=1)
    if sum0.sum() == 0:
        return float("nan")
    expected = np.outer(sum0, sum1) / sum0.sum()
    w = np.ones((n, n)) - np.eye(n)
    denominator = np.sum(w * expected)
    if denominator == 0:
        return float("nan")
    return float(1 - np.sum(w * confusion) / denominator)


def weighted_precision_recall_f1(y_true, y_pred) -> tuple[float, float,
                                                           float]:
    """(precision, recall, F1), each per class with 0 where undefined and
    averaged with the classes' support in ``y_true`` as weights."""
    cm = _confusion(y_true, y_pred, _labels(y_true, y_pred))
    tp = np.diag(cm).astype(np.float64)
    true_sum = cm.sum(axis=1).astype(np.float64)
    pred_sum = cm.sum(axis=0).astype(np.float64)

    def divide(num, den):
        return np.divide(num, den, out=np.zeros_like(num), where=den != 0)

    per_class = (divide(tp, pred_sum), divide(tp, true_sum),
                 divide(2.0 * tp, true_sum + pred_sum))
    if true_sum.sum() == 0:
        return 0.0, 0.0, 0.0
    return tuple(float(np.average(v, weights=true_sum)) for v in per_class)

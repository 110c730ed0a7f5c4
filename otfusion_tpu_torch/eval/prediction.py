"""Cross-modal prediction metrics (port of ``otfusion_tpu.eval.prediction``;
numpy, on the host).

Rebuild of the reference's ``perturbot/perturbot/eval/prediction.py``:
row-wise Pearson/Spearman correlations per sample and per feature, MSE,
and the aggregated metric frame (get_evals :45-176, get_evals_preds
:179-210). The reference's per-row ``scipy.stats.spearmanr`` loop
(prediction.py:16-26) is replaced by a single vectorised rank transform +
row-wise Pearson — identical values (average ranks for ties), no Python
loop over samples.

Metric-frame keys match the reference exactly
(``Pearson_corr``/``Spearman_corr`` row-wise over samples,
``Pearson_samples``/``Spearman_samples`` computed on the transpose —
i.e. per-feature — and ``MSE``), so downstream selection logic
(cv_inner_loop.py:364-381 best-eps picks) transfers unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

EVAL_METRIC_NAMES = [
    "Pearson_corr",
    "Spearman_corr",
    "Pearson_samples",
    "Spearman_samples",
    "MSE",
]


def pearson_rowwise(a: np.ndarray, b: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Row-wise Pearson correlation (reference _pearson_rowwise,
    prediction.py:7-13)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    am = a - a.mean(1, keepdims=True)
    bm = b - b.mean(1, keepdims=True)
    ssa = np.einsum("ij,ij->i", am, am)
    ssb = np.einsum("ij,ij->i", bm, bm)
    return np.einsum("ij,ij->i", am, bm) / (np.sqrt(ssa * ssb) + eps)


def _rank_rows(a: np.ndarray) -> np.ndarray:
    """Average-rank transform of each row (ties share their mean rank),
    matching ``scipy.stats.rankdata(..., method='average')`` row-wise."""
    a = np.asarray(a, np.float64)
    order = np.argsort(a, axis=1, kind="stable")
    ranks = np.empty_like(a)
    rng = np.arange(1, a.shape[1] + 1, dtype=np.float64)
    np.put_along_axis(ranks, order, np.broadcast_to(rng, a.shape), axis=1)
    # Average ranks over ties: for each row, group equal values.
    sorted_vals = np.take_along_axis(a, order, axis=1)
    for i in range(a.shape[0]):
        vals = sorted_vals[i]
        # boundaries of runs of equal values
        change = np.nonzero(np.diff(vals))[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(vals)]])
        run_lens = ends - starts
        if np.all(run_lens == 1):
            continue
        mean_rank = (starts + ends + 1) / 2.0  # ranks are 1-based
        row_ranks = np.repeat(mean_rank, run_lens)
        ranks[i, order[i]] = row_ranks
    return ranks


def spearman_rowwise(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise Spearman correlation = Pearson of the rank transforms
    (replaces the reference's per-row scipy loop, prediction.py:16-26)."""
    return pearson_rowwise(_rank_rows(a), _rank_rows(b))


def get_corrs(y_pred: np.ndarray, y_true: np.ndarray, idx=None):
    """(reference get_corrs, prediction.py:29-35)"""
    if idx is not None:
        y_pred = y_pred[:, idx]
        y_true = y_true[:, idx]
    return pearson_rowwise(y_pred, y_true), spearman_rowwise(y_pred, y_true)


def mse(y_pred: np.ndarray, y_true: np.ndarray, idx=None) -> np.ndarray:
    """Per-sample MSE (reference mse, prediction.py:38-42)."""
    y_pred = np.asarray(y_pred, np.float64)
    y_true = np.asarray(y_true, np.float64)
    if idx is not None:
        y_pred, y_true = y_pred[:, idx], y_true[:, idx]
    return np.mean((y_pred - y_true) ** 2, axis=1)


def get_evals(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    prediction_id="pred",
    agg_method: str = "mean",
    norm_Y: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Aggregate prediction metrics (reference get_evals,
    prediction.py:45-176, ``full=False`` path — the only one the live
    harness uses; note the reference passes ``(Y_true, Y_pred)`` into a
    ``(Y_pred, Y_true)`` signature, harmless because every metric here is
    symmetric). Returns ``{metric_name: value}`` plus the prediction id
    under ``"_id"``."""
    agg = np.median if agg_method == "median" else np.mean
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    if norm_Y is not None:
        p, s = get_corrs(y_pred / norm_Y[None, :], y_true / norm_Y[None, :])
    else:
        p, s = get_corrs(y_pred, y_true)
    p_c, s_c = get_corrs(y_pred.T, y_true.T)
    vals = [agg(p), agg(s), agg(p_c), agg(s_c), agg(mse(y_pred, y_true))]
    out = {k: float(v) for k, v in zip(EVAL_METRIC_NAMES, vals)}
    out["_id"] = prediction_id
    return out


def get_evals_preds(
    y_true: np.ndarray,
    y_preds: Sequence[np.ndarray],
    pred_labels: Sequence[str],
) -> List[Dict[str, float]]:
    """Evaluate several predictions against one truth
    (reference get_evals_preds, prediction.py:179-210)."""
    return [
        get_evals(y_true, y_pred, prediction_id=label)
        for y_pred, label in zip(y_preds, pred_labels)
    ]


def nan_evals(prediction_id="pred") -> Dict[str, float]:
    """All-NaN metric frame — the reference's COOT-underflow sentinel
    (cv_inner_loop.py:252-285)."""
    out = {k: float("nan") for k in EVAL_METRIC_NAMES}
    out["_id"] = prediction_id
    return out


__all__ = [
    "EVAL_METRIC_NAMES",
    "get_corrs",
    "get_evals",
    "get_evals_preds",
    "mse",
    "nan_evals",
    "pearson_rowwise",
    "spearman_rowwise",
]

"""Calibration / uncertainty metrics (port of
``otfusion_tpu.metrics.calibration``; reference metrics.py + metrics2.py,
used by the legacy ensemble evaluation in main.py/test.py). The ROC and
precision-recall areas come from ``metrics.ranking`` (scikit-learn's
numbers without scikit-learn).

Definitions preserved from the reference (vectorised, torch-free):
  * ECE: 15 equal-width confidence bins over max-softmax, |acc - conf|
    weighted by bin mass (metrics2.py:70-97; bins (lo, hi] like the
    reference's gt/le pair).
  * AURC/EAURC: sort by confidence desc, running selective risk averaged
    over coverage points; EAURC subtracts the optimal-risk area
    r + (1-r)log(1-r) (metrics2.py:39-50, 125-157).
  * FPR@95TPR / AUPR of correctness-vs-confidence (metrics2.py:52-68).
  * NLL x10 and Brier x100 scaling quirks of the reference are NOT kept —
    we return the plain values (metrics2.py:113-116 multiplies for
    printing; the scaled values leak into its return, a quirk normalised
    here and noted in uncertainty_metrics).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from otfusion_tpu_torch.metrics.ranking import (
    average_precision_score,
    roc_curve,
)


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def expected_calibration_error(
    probs: np.ndarray, labels: np.ndarray, bins: int = 15
) -> float:
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == np.asarray(labels)).astype(np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    ece = 0.0
    n = len(conf)
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        if in_bin.any():
            ece += abs(correct[in_bin].mean() - conf[in_bin].mean()) * (
                in_bin.sum() / n
            )
    return float(ece)


def aurc_eaurc(probs: np.ndarray, labels: np.ndarray) -> tuple[float, float]:
    conf = probs.max(axis=1)
    correct = (probs.argmax(axis=1) == np.asarray(labels)).astype(np.float64)
    order = np.argsort(-conf, kind="stable")
    sorted_correct = correct[order]
    cum_err = np.cumsum(1.0 - sorted_correct)
    coverage_counts = np.arange(1, len(conf) + 1)
    risks = cum_err / coverage_counts
    aurc = float(risks.mean())
    final_risk = risks[-1]
    optimal = (
        final_risk + (1 - final_risk) * np.log(1 - final_risk)
        if final_risk < 1.0
        else final_risk
    )
    return aurc, float(aurc - optimal)


def fpr_at_95_tpr(probs: np.ndarray, labels: np.ndarray) -> float:
    conf = probs.max(axis=1)
    correct = (probs.argmax(axis=1) == np.asarray(labels)).astype(int)
    fpr, tpr, _ = roc_curve(correct, conf)
    return float(fpr[np.argmin(np.abs(tpr - 0.95))])


def aupr_error(probs: np.ndarray, labels: np.ndarray) -> float:
    conf = probs.max(axis=1)
    correct = (probs.argmax(axis=1) == np.asarray(labels)).astype(int)
    return float(average_precision_score(correct, conf))


def negative_log_likelihood(logits: np.ndarray, labels: np.ndarray) -> float:
    z = logits - logits.max(axis=1, keepdims=True)
    log_probs = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    idx = np.arange(len(labels))
    return float(-log_probs[idx, np.asarray(labels)].mean())


def brier_score(probs: np.ndarray, labels: np.ndarray) -> float:
    onehot = np.eye(probs.shape[1])[np.asarray(labels)]
    return float(np.sum((probs - onehot) ** 2, axis=1).mean())


def predictive_entropy(logits: np.ndarray, from_probs: bool = False,
                       skip_first_class: bool = False) -> np.ndarray:
    """Per-sample normalised predictive entropy
    H(p)/log(C) in [0, 1] (reference Uentropy/Uentropy_our,
    metrics.py:101-129; dead code there, live here as the ensemble's
    uncertainty score).

    ``from_probs`` mirrors Uentropy_our (inputs already probabilities —
    e.g. the ensemble's averaged member softmax). ``skip_first_class``
    reproduces the reference's slice ``u_all[:, 1:]`` which silently
    drops class 0's entropy contribution — off by default (quirk
    normalised, kept available for strict reproduction)."""
    x = np.asarray(logits, np.float64)
    if from_probs:
        p = x / np.maximum(x.sum(axis=1, keepdims=True), 1e-30)
    else:
        p = _softmax(x)
    c = p.shape[1]
    u = -p * np.log(np.maximum(p, 1e-30)) / np.log(c)
    if skip_first_class:
        u = u[:, 1:]
    return u.sum(axis=1)


def entropy_decomposition(
    member_probs: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Deep-ensemble uncertainty decomposition over ``member_probs`` of
    shape (n_members, n_samples, n_classes):

      total (predictive entropy of the mean) =
        aleatoric (mean of member entropies) + epistemic (mutual
        information between prediction and member identity).

    The reference's ensemble driver reports only scalar calibration
    metrics; this is the standard decomposition its Uentropy scaffolding
    (metrics.py:101-129) points toward."""
    p = np.asarray(member_probs, np.float64)
    mean_p = p.mean(axis=0)
    total = predictive_entropy(mean_p, from_probs=True)
    aleatoric = np.stack(
        [predictive_entropy(m, from_probs=True) for m in p]
    ).mean(axis=0)
    return {
        "total": total,
        "aleatoric": aleatoric,
        "epistemic": total - aleatoric,
    }


def uncertainty_metrics(
    logits: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    """Full battery, reference metric_ece_aurc_eaurc-style. Values are
    unscaled (the reference returns NLLx10 / Brierx100)."""
    probs = _softmax(np.asarray(logits, np.float64))
    labels = np.asarray(labels)
    aurc, eaurc = aurc_eaurc(probs, labels)
    return {
        "accuracy": float((probs.argmax(1) == labels).mean()),
        "ece": expected_calibration_error(probs, labels),
        "aurc": aurc,
        "eaurc": eaurc,
        "aupr": aupr_error(probs, labels),
        "fpr_at_95_tpr": fpr_at_95_tpr(probs, labels),
        "nll": negative_log_likelihood(logits, labels),
        "brier": brier_score(probs, labels),
        "mean_entropy": float(predictive_entropy(logits).mean()),
    }

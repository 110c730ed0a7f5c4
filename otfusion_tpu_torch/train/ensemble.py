"""Deep-ensemble evaluation with uncertainty metrics (port of
``otfusion_tpu.train.ensemble``).

Reference test_ensemble (main.py:351-448 / test.py:219-355): N
independently trained members; softmax probabilities averaged; reports
accuracy, weighted precision, recall and F1, AUC, Cohen's kappa, plus the
calibration battery (ECE, AURC/EAURC, AUPR, FPR@95, NLL, Brier) and the
entropy decomposition over the members. The same keys as the JAX function;
the scikit-learn metrics come from ``metrics.ranking``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from otfusion_tpu_torch.metrics.calibration import (
    _softmax,
    entropy_decomposition,
    uncertainty_metrics,
)
from otfusion_tpu_torch.metrics.ranking import (
    cohen_kappa_score,
    roc_auc_score,
    weighted_precision_recall_f1,
)


def evaluate_ensemble(
    member_logits: Sequence[np.ndarray],
    labels: np.ndarray,
) -> Dict[str, float]:
    """Metrics for an ensemble given each member's (N, C) logits."""
    labels = np.asarray(labels)
    member_probs = [_softmax(np.asarray(l)) for l in member_logits]
    probs = np.mean(member_probs, axis=0)
    preds = probs.argmax(axis=1)
    precision, recall, f1 = weighted_precision_recall_f1(labels, preds)
    metrics = {
        "accuracy": float((preds == labels).mean()),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "kappa": cohen_kappa_score(labels, preds),
        "n_members": len(member_logits),
    }
    try:
        metrics["auc"] = roc_auc_score(
            labels, probs[:, 1] if probs.shape[1] == 2 else probs)
    except ValueError:
        metrics["auc"] = float("nan")

    # Uncertainty battery on the averaged predictive distribution.
    log_probs = np.log(np.maximum(probs, 1e-12))
    metrics.update(
        {f"ens_{k}": v for k, v in uncertainty_metrics(log_probs,
                                                       labels).items()}
    )
    # Predictive-entropy decomposition over the members (total =
    # aleatoric + epistemic).
    decomp = entropy_decomposition(np.stack(member_probs))
    metrics.update({
        "entropy_total": float(decomp["total"].mean()),
        "entropy_aleatoric": float(decomp["aleatoric"].mean()),
        "entropy_epistemic": float(decomp["epistemic"].mean()),
    })
    return metrics


def collect_member_logits(
    members: Sequence,
    eval_step: Callable,
    batches: Sequence,
    t_features: Sequence | None = None,
) -> tuple[List[np.ndarray], np.ndarray]:
    """Run each ensemble member over ``batches``; returns per-member
    logits + labels. ``eval_step(member, *batch, tv)`` is the legacy eval
    step (``train.legacy_steps.make_legacy_eval_step``) and ``t_features``
    supplies each member's coupling Tv."""
    member_logits = []
    labels_out = None
    for i, member in enumerate(members):
        logits = []
        labels = []
        tv = None if t_features is None else t_features[i]
        for batch in batches:
            out = eval_step(member, *batch, tv)
            logits.append(out["logits"].float().cpu().numpy())
            labels.append(np.asarray(batch[-1].cpu()))
        member_logits.append(np.concatenate(logits))
        labels_out = np.concatenate(labels)
    return member_logits, labels_out

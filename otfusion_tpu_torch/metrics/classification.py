"""Classification metrics (reference calculate_metrics parity,
3D_resnet.py:649-672): macro precision/recall/F1 with zero-division -> 0,
plus per-class specificity averaged. Pure NumPy (no sklearn dependency in
the hot reporting path); validated against sklearn in tests."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def confusion_matrix(
    y_true: Sequence[int], y_pred: Sequence[int], num_classes: int
) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        cm[int(t), int(p)] += 1
    return cm


def classification_metrics(
    y_true: Sequence[int], y_pred: Sequence[int], num_classes: int
) -> Dict[str, float]:
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)      # per true class
    predicted = cm.sum(axis=0).astype(np.float64)    # per predicted class

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    total = cm.sum()
    specificities = []
    for i in range(num_classes):
        tn = total - (cm[i, :].sum() + cm[:, i].sum() - cm[i, i])
        fp = cm[:, i].sum() - cm[i, i]
        specificities.append(tn / (tn + fp) if (tn + fp) > 0 else 0.0)

    return {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1": float(f1.mean()),
        "specificity": float(np.mean(specificities)),
    }

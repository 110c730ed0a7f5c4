"""OT coupling quality metrics (port of ``otfusion_tpu.metrics.ot_quality``;
numpy, on the host).

  * FOSCTTM, "fraction of samples closer than the true match": for aligned
    X, Y, the mean normalised rank of the true match y_i among all y by
    distance from x_i (0 = perfect, 0.5 = random);
  * the diagonal mass fraction of a coupling;
  * the relative MSE of the coupling's diagonal against the identity
    coupling's, normalised by the all-to-all coupling's error;
  * kNN-baseline couplings, the non-OT floor: mass 1/(n k) on each
    sample's k nearest cross-modal neighbours.
"""

from __future__ import annotations

import numpy as np


def knn_coupling(x: np.ndarray, y: np.ndarray, k: int) -> np.ndarray:
    """kNN baseline coupling (reference get_T_from_nn,
    eval/utils.py:48-56): T[i, j] = 1/(n_x·k) for the k nearest rows of
    ``y`` to ``x[i]`` (Euclidean), else 0. Vectorised (no per-row loop)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, m = x.shape[0], y.shape[0]
    if not 0 < k <= m:
        raise ValueError(f"k={k} must be in [1, {m}]")
    d2 = (
        np.sum(x * x, 1)[:, None]
        + np.sum(y * y, 1)[None, :]
        - 2.0 * x @ y.T
    )
    t = np.zeros((n, m))
    # argpartition semantics match the reference: exactly k entries per
    # row (ties broken by partition order).
    nbr = np.argpartition(d2, min(k, m - 1), axis=1)[:, :k]
    t[np.arange(n)[:, None], nbr] = 1.0 / (n * k)
    return t


def knn_couplings_per_label(
    x_groups: dict, y_groups: dict, ks: "list[int]"
) -> dict:
    """Per-label kNN baselines (reference get_Ts_from_nn_multKs,
    eval/utils.py:59-87): neighbours are searched over the label-
    concatenated clouds, then the global plan is split back into the
    per-label diagonal blocks (off-block mass is dropped, exactly as the
    reference's slicing does). Returns {k: {label: T_block}}."""
    labels = list(x_groups.keys())
    x = np.concatenate([x_groups[lbl] for lbl in labels])
    y = np.concatenate([y_groups[lbl] for lbl in labels])
    out: dict = {}
    for k in ks:
        t = knn_coupling(x, y, k)
        blocks, i, j = {}, 0, 0
        for lbl in labels:
            ni, nj = x_groups[lbl].shape[0], y_groups[lbl].shape[0]
            blocks[lbl] = t[i : i + ni, j : j + nj]
            i, j = i + ni, j + nj
        out[k] = blocks
    return out


def foscttm(x: np.ndarray, y: np.ndarray) -> float:
    """Mean fraction-closer-than-true-match of aligned rows of x vs y.
    0 = perfect alignment, 0.5 = random."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    d2 = (
        np.sum(x * x, 1)[:, None]
        + np.sum(y * y, 1)[None, :]
        - 2.0 * x @ y.T
    )
    true_d = np.diag(d2)
    closer = (d2 < true_d[:, None]).sum(axis=1)
    ties = (d2 == true_d[:, None]).sum(axis=1) - 1  # mean-rank tie handling
    return float(((closer + ties / 2.0) / (n - 1)).mean())


def diag_fraction(t: np.ndarray) -> float:
    """Fraction of total coupling mass on the diagonal."""
    t = np.asarray(t, np.float64)
    return float(np.trace(t) / max(t.sum(), 1e-30))


def relative_mse(t: np.ndarray) -> float:
    """MSE of diag(T/sum) vs diag(identity/n), relative to the all-to-all
    coupling's error (reference get_rel_mse, eval/match.py:10-27).
    0 = perfect, 1 = as bad as uniform."""
    t = np.asarray(t, np.float64)
    n = t.shape[0]
    t = t / max(t.sum(), 1e-30)
    perfect_diag = 1.0 / n
    err = np.mean((np.diag(t) - perfect_diag) ** 2)
    worst = np.mean((1.0 / (n * t.shape[1]) - perfect_diag) ** 2)
    return float(err / max(worst, 1e-30))

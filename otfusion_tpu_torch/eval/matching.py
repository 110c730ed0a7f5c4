"""Coupling-quality metrics over labelled treatment groups (port of
``otfusion_tpu.eval.matching``; numpy, on the host).

Dict-aware rebuild of the reference's ``perturbot/perturbot/eval/match.py``
(get_confusion_matrix :29-87, get_diag_fracs :89-175, get_FOSCTTM
:178-242, get_rel_mse :10-27). Couplings arrive either as
``{label: (n_l, m_l) block}`` dicts or as one dense block-diagonal matrix;
the per-entry Python double loops of the reference are replaced with
vectorised scatter-adds (``np.add.at``) and the FOSCTTM rank loop with one
distance-matrix comparison.

Conventions (identical to the reference):

* ``Zs/Zt`` are integer side-information labels per sample (the
  chemical-screen "dosage"); the confusion matrix accumulates coupling
  mass between source/target Z classes.
* ``get_diag_fracs`` returns the raw diagonal mass fraction *and* the
  fraction rescaled between the all-to-all coupling (0) and the perfect
  identity coupling (1) — reference match.py:129-131.
* ``get_FOSCTTM`` projects targets barycentrically through the coupling
  (match.py:202-206) before ranking; it returns (per-sample fractions,
  aggregate). The reference's per-label tail (match.py:210-222) is dead
  code after an unconditional ``return`` and is not reproduced.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

from otfusion_tpu_torch.ops.fot import mdict_to_matrix

CouplingLike = Union[np.ndarray, Dict]


def _labels_of(x_dict: Dict) -> list:
    return list(x_dict.keys())


def _block_split(t: np.ndarray, x_dict: Dict, y_dict: Dict) -> Dict:
    """Slice a dense block-diagonal coupling back into per-label blocks
    (reference get_diag_fracs single-matrix branch, match.py:96-107)."""
    out, i, j = {}, 0, 0
    for lbl in _labels_of(x_dict):
        ni, nj = x_dict[lbl].shape[0], y_dict[lbl].shape[0]
        out[lbl] = t[i : i + ni, j : j + nj]
        i, j = i + ni, j + nj
    return out


def _num_classes(zs_dict: Dict, zt_dict: Dict) -> int:
    vals = [v for vals in zs_dict.values() for v in np.asarray(vals).ravel()]
    vals += [v for vals in zt_dict.values() for v in np.asarray(vals).ravel()]
    return int(max(vals)) + 1


def coupling_confusion_matrix(
    t_dict: CouplingLike,
    xs_dict: Dict,
    xt_dict: Dict,
    zs_dict: Dict,
    zt_dict: Dict,
) -> Tuple[np.ndarray, float]:
    """Mass-weighted Z-class confusion matrix of a coupling
    (reference get_confusion_matrix, match.py:29-87).

    Returns ``(C, diag_frac)`` where ``C[a, b]`` is the total coupling
    mass between source samples with Z class ``a`` and target samples
    with Z class ``b``, and ``diag_frac`` is the mass on the diagonal.
    Single dense couplings are normalised to mass 1 first, exactly as
    the reference's single-matrix branch does (match.py:80).
    """
    m = _num_classes(zs_dict, zt_dict)
    cmat = np.zeros((m, m))
    if not isinstance(t_dict, dict):
        t = np.asarray(t_dict, np.float64)
        t = t / max(t.sum(), 1e-300)
        zs = np.concatenate([np.asarray(zs_dict[k]) for k in xs_dict.keys()])
        zt = np.concatenate([np.asarray(zt_dict[k]) for k in xs_dict.keys()])
        idx = np.nonzero(t)
        np.add.at(
            cmat, (zs[idx[0]].astype(int), zt[idx[1]].astype(int)), t[idx]
        )
        return cmat, float(np.trace(cmat))
    for k in _labels_of(xs_dict):
        t = np.asarray(t_dict[k], np.float64)
        zs = np.asarray(zs_dict[k]).astype(int)
        zt = np.asarray(zt_dict[k]).astype(int)
        idx = np.nonzero(t)
        np.add.at(cmat, (zs[idx[0]], zt[idx[1]]), t[idx])
    return cmat, float(np.trace(cmat))


def get_diag_fracs(
    t_dict: CouplingLike,
    xs_dict: Dict,
    xt_dict: Dict,
    zs_dict: Dict,
    zt_dict: Dict,
) -> Tuple[float, float]:
    """Diagonal Z-class mass fraction and its rescaling between the
    random (0) and perfect (1) couplings (reference get_diag_fracs,
    match.py:89-131).

    Perfect coupling: per-label identity scaled by the total source count
    (match.py:111-119). Random coupling: all-ones scaled by the total
    number of coupling entries (match.py:123-124).
    """
    if not isinstance(t_dict, dict):
        t_dict = _block_split(np.asarray(t_dict), xs_dict, xt_dict)
    _, dfrac = coupling_confusion_matrix(t_dict, xs_dict, xt_dict, zs_dict, zt_dict)

    total_n = sum(t_dict[k].shape[0] for k in t_dict)
    t_perfect = {k: np.eye(t_dict[k].shape[0]) / total_n for k in t_dict}
    _, dfrac_perfect = coupling_confusion_matrix(
        t_perfect, xs_dict, xt_dict, zs_dict, zt_dict
    )
    total_size = sum(t_dict[k].size for k in t_dict)
    t_random = {k: np.ones(t_dict[k].shape) / total_size for k in t_dict}
    _, dfrac_random = coupling_confusion_matrix(
        t_random, xs_dict, xt_dict, zs_dict, zt_dict
    )
    denom = dfrac_perfect - dfrac_random
    rel = (dfrac - dfrac_random) / (denom if abs(denom) > 1e-300 else 1e-300)
    return dfrac, rel


def foscttm_per_sample(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-sample fraction-closer-than-the-true-match of aligned rows
    (reference eval/utils.py:18-45), vectorised: one (n, n) distance
    matrix instead of a per-row sort. Ties share their mean rank, which
    equals the reference's ``np.where(sorted == true).mean()``."""
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
    ties = (d2 == true_d[:, None]).sum(axis=1) - 1
    return (closer + ties / 2.0) / max(n - 1, 1)


def get_FOSCTTM(
    t_dict: CouplingLike,
    xs_dict: Dict,
    xt_dict: Dict,
    use_barycenter: bool = True,
    use_agg: str = "mean",
) -> Tuple[np.ndarray, float]:
    """Barycentric FOSCTTM of a coupling (reference get_FOSCTTM,
    match.py:178-209): project each source sample to the target space via
    its row-normalised coupling, then rank the projection against the true
    target among all targets. Returns (per-sample array, aggregate)."""
    agg = np.nanmedian if use_agg == "median" else np.nanmean
    if not use_barycenter:
        # coupling unused on this path (e.g. the VAE latents flow,
        # cv_inner_loop.py:291-293 passes the opaque model object here)
        xs = np.concatenate([np.asarray(xs_dict[l]) for l in xs_dict])
        xt = np.concatenate([np.asarray(xt_dict[l]) for l in xt_dict])
        fr = foscttm_per_sample(xs, xt)
        return fr, float(agg(fr))
    if isinstance(t_dict, dict):
        labels = _labels_of(xs_dict)
        src = np.concatenate(
            [np.full(xs_dict[l].shape[0], i) for i, l in enumerate(labels)]
        )
        tgt = np.concatenate(
            [np.full(xt_dict[l].shape[0], i) for i, l in enumerate(labels)]
        )
        t = mdict_to_matrix(
            {i: np.asarray(t_dict[l]) for i, l in enumerate(labels)}, src, tgt
        )
    else:
        t = np.asarray(t_dict, np.float64)
    xs = np.concatenate([np.asarray(xs_dict[l]) for l in xs_dict.keys()])
    xt = np.concatenate([np.asarray(xt_dict[l]) for l in xt_dict.keys()])
    if use_barycenter:
        marg = t.sum(axis=-1)
        marg = np.where(marg == 0, 1e-30, marg)
        xt_pred = (t / marg[:, None]) @ xt
        fr = foscttm_per_sample(xt_pred, xt)
    else:
        fr = foscttm_per_sample(xs, xt)
    return fr, float(agg(fr))


def get_rel_mse(t_dict: Dict) -> Dict:
    """Per-label diagonal MSE relative to the all-to-all coupling
    (reference get_rel_mse, match.py:10-27). The reference normalises T
    into a local variable but then diffs the *unnormalised* diagonal
    (match.py:13-18); the obvious intent — compare the normalised
    coupling — is implemented here and the divergence documented."""
    out = {}
    for k, t in t_dict.items():
        t = np.asarray(t, np.float64)
        n = t.shape[0]
        t = t / max(t.sum(), 1e-300)
        perfect = 1.0 / n
        err = np.mean((np.diag(t) - perfect) ** 2)
        worst = np.mean((1.0 / t.size - perfect) ** 2)
        out[k] = float(err / max(worst, 1e-300))
    return out


__all__ = [
    "coupling_confusion_matrix",
    "foscttm_per_sample",
    "get_FOSCTTM",
    "get_diag_fracs",
    "get_rel_mse",
]

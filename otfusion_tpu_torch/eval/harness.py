"""Cross-validation and leave-one-out runs for OT coupling methods (port of
``otfusion_tpu.eval.harness``).

The reference's 5-fold inner hyperparameter loop, outer test evaluation,
leave-one-out, whole-dataset matching run and FOT feature-matching stage,
plus ``run_grid``, the in-process replacement of its LSF submitters. Every
run takes ``device=`` (default the card) and passes it to the OT
solvers (``ops.api``: kernels K1 and K2 on CUDA), to ``get_coupling_fot``
and to the MLP predictor; matching metrics and the OLS predictors are
numpy on the host.

Data: a dict with ``Xs_dict``/``Xt_dict`` ({treatment label: (n_l, d)
features} per modality) and ``Zs_dict``/``Zt_dict`` (per-sample side
information, possibly nested one level: ``{"dosage": {label: (n_l,)}}``).

The VAE matching family (``VAE``, ``VAE_label``) and the VAE-then-OT
leave-one-out (``run_loo_latent``) are not ported: they stay in
``OT_METHOD_MAP`` and raise ``NotImplementedError`` when called.
"""

from __future__ import annotations

from itertools import product
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from otfusion_tpu_torch.eval.matching import get_FOSCTTM, get_diag_fracs
from otfusion_tpu_torch.eval.prediction import (
    get_evals,
    get_evals_preds,
    nan_evals,
)
from otfusion_tpu_torch.eval.predictors import (
    make_G,
    ols_normed,
    predict,
    train_mlp,
    weight_1_ols_normed,
    weight_conc_normed,
    weighted_ols_normed,
)
from otfusion_tpu_torch.ops.api import (
    get_coupling_cot_sinkhorn,
    get_coupling_cotl_sinkhorn,
    get_coupling_each_cot_sinkhorn,
    get_coupling_egw_all_ott,
    get_coupling_egw_labels_ott,
    get_coupling_egw_ott,
    get_coupling_eot_ott,
    get_coupling_fot,
    get_coupling_leot_ott,
)
from otfusion_tpu_torch.utils.device import resolve_device

Device = str | torch.device
_VAE_ITEM = ("the VAE family of the eval harness: eval/vae.py, "
             "eval/preprocess.py, run_loo_latent, --latent-vae")


def _vae_unported(*args, **kwargs):
    raise NotImplementedError(
        "the VAE matching methods are not ported to otfusion_tpu_torch yet "
        f"(ROADMAP.md, open item: {_VAE_ITEM})")


# Reference registry (cv_inner_loop.py:59-71); both EGWL names resolve to
# the label-masked global GW.
OT_METHOD_MAP: Dict[str, Callable] = {
    "ECOOTL": get_coupling_cotl_sinkhorn,
    "ECOOT_each": get_coupling_each_cot_sinkhorn,
    "ECOOT": get_coupling_cot_sinkhorn,
    "EGWL": get_coupling_egw_labels_ott,
    "EOT_ott": get_coupling_eot_ott,
    "LEOT_ott": get_coupling_leot_ott,
    "EGW_ott": get_coupling_egw_ott,
    "EGW_all_ott": get_coupling_egw_all_ott,
    "EGWL_ott": get_coupling_egw_labels_ott,
    "VAE_label": _vae_unported,
    "VAE": _vae_unported,
}

# Hyperparameter grid (cv_inner_loop.py:102-129): epsilons for the OT
# methods, (adv_weight, latent_dim, lr) tuples for the VAE family.
OT_METHOD_HYPERPARAMS: Dict[str, list] = {
    m: [0.1, 1e-2, 1e-3, 1e-4, 1e-5]
    for m in OT_METHOD_MAP if "VAE" not in m
}
for _m in ("VAE", "VAE_label"):
    OT_METHOD_HYPERPARAMS[_m] = list(
        product([1, 5, 10, 50, 100], [128], [1e-4])
    )


def _is_vae(method: str) -> bool:
    return "VAE" in method


# Methods returning one dense coupling over all samples
# (cv_inner_loop.py:131).
ALL_TO_ALL_METHODS = ["GW_all", "EGW_all_ott", "EOT_all_ott", "EOT_ott", "ECOOT"]

BASELINE_PRED_METHODS = [ols_normed, weight_1_ols_normed, weight_conc_normed]
BASELINE_PRED_LABELS = ["perfect", "random", "by_conc"]


def _unpack(data: Dict, z_key: str = "dosage"):
    x_dict = data["Xs_dict"]
    y_dict = data["Xt_dict"]
    zs = data.get("Zs_dict", {})
    zt = data.get("Zt_dict", {})
    if z_key in zs:
        zs = zs[z_key]
    if z_key in zt:
        zt = zt[z_key]
    return x_dict, y_dict, zs, zt


def _pop_keys(d: Dict, ks) -> Dict:
    """(reference eval/utils.py:97-105)"""
    d = dict(d)
    for k in ks:
        del d[k]
    return d


def _kfold(items: Sequence, n_splits: int):
    """Deterministic contiguous K-fold over a list — sklearn
    ``KFold(shuffle=False)`` semantics, as the reference uses
    (cv_inner_loop.py:155-157)."""
    n = len(items)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = list(range(start, start + size))
        train = [i for i in range(n) if i < start or i >= start + size]
        folds.append((train, test))
        start += size
    return folds


def _normalize_mass(ts):
    """Normalise a coupling (dict of blocks, or dense) to total mass 1
    (reference all.py:132-140 / cv_outer_loop.py:225-237)."""
    if isinstance(ts, dict):
        total = sum(np.asarray(v, np.float64).sum() for v in ts.values())
        total = total if total > 0 else 1.0
        return {k: np.asarray(v, np.float64) / total for k, v in ts.items()}
    ts = np.asarray(ts, np.float64)
    return ts / max(ts.sum(), 1e-300)


def _coupling_failed(ts) -> bool:
    """The reference's COOT-underflow sentinel is an int return
    (cv_inner_loop.py:252); native solvers signal failure with
    non-finite mass instead."""
    if isinstance(ts, dict):
        return any(not np.all(np.isfinite(v)) for v in ts.values())
    return not np.all(np.isfinite(ts))




def run_inner_cv(
    data: Dict,
    method: str,
    test_idx: int,
    epsilons: Optional[Sequence[float]] = None,
    n_splits: int = 5,
    z_key: str = "dosage",
    progress: Optional[Callable[[str], None]] = None,
    device: Device = "cuda",
) -> Dict:
    """One outer fold's inner hyperparameter selection: hold out the
    ``test_idx``-th outer fold of treatment labels, 5-fold the rest,
    couple each inner-train set at every epsilon, score matching (FOSCTTM
    and diagonal fractions on the coupled samples) and prediction (the
    coupling-weighted OLS on the inner-val labels), and pick the best
    epsilon per criterion. Returns the reference's ``val_logs``:
    ``matching_evals``, ``dfracs``, ``pred_evals``, ``pred_mse``, ``T``,
    ``log``, ``best_eps`` ({"matching", "pred"}) and ``test_labels``."""
    device = resolve_device(device)
    say = progress or (lambda s: None)
    epsilons = list(
        epsilons if epsilons is not None else OT_METHOD_HYPERPARAMS[method]
    )
    x_dict, y_dict, zs_dict, _ = _unpack(data, z_key)
    labels = list(x_dict.keys())
    train_val_idx, test_fold = _kfold(labels, n_splits)[test_idx]
    test_labels = [labels[i] for i in test_fold]
    tv_x = _pop_keys(x_dict, test_labels)
    tv_y = _pop_keys(y_dict, test_labels)
    tv_z = _pop_keys(zs_dict, test_labels) if zs_dict else {}
    tv_labels = [labels[i] for i in train_val_idx]

    folds = []
    for _, val_fold in _kfold(tv_labels, n_splits):
        val_labels = tuple(tv_labels[i] for i in val_fold)
        folds.append((
            val_labels,
            _pop_keys(tv_x, val_labels),
            _pop_keys(tv_y, val_labels),
            _pop_keys(tv_z, val_labels) if tv_z else {},
        ))

    solver = OT_METHOD_MAP[method]
    matching: Dict[float, list] = {e: [] for e in epsilons}
    dfracs: Dict[float, list] = {e: [] for e in epsilons}
    pred_evals: Dict[float, list] = {e: [] for e in epsilons}
    t_store: Dict[float, Dict] = {e: {} for e in epsilons}
    log_store: Dict[float, Dict] = {e: {} for e in epsilons}

    for eps, (val_labels, tr_x, tr_y, tr_z) in product(epsilons, folds):
        say(f"{method} eps={eps} val={val_labels}")
        ts, log = solver((tr_x, tr_y), eps, device=device)
        t_store[eps][val_labels] = ts
        log_store[eps][val_labels] = log
        if _coupling_failed(ts):
            # underflow sentinel (cv_inner_loop.py:252-285)
            matching[eps].append(100.0)
            for _ in val_labels:
                pred_evals[eps].append(nan_evals((eps, val_labels)))
            continue
        _, mean_foscttm = get_FOSCTTM(ts, tr_x, tr_y, use_agg="mean")
        matching[eps].append(mean_foscttm)
        if tr_z:
            _, rel = get_diag_fracs(ts, tr_x, tr_y, tr_z, tr_z)
            dfracs[eps].append(rel)
        param = weighted_ols_normed(tr_x, tr_y, ts)
        for vl in val_labels:
            pred = predict(np.asarray(tv_x[vl]), param)
            try:
                pred_evals[eps].append(get_evals(
                    np.asarray(tv_y[vl]), pred,
                    prediction_id=(eps, val_labels)))
            except Exception:
                pred_evals[eps].append(nan_evals((eps, val_labels)))

    matching_mean = {e: float(np.nanmean(v)) for e, v in matching.items()}
    best_matching = min(matching_mean, key=matching_mean.get)
    mse_mean = {
        e: float(np.nanmean([d["MSE"] for d in v])) if v else float("inf")
        for e, v in pred_evals.items()
    }
    best_pred = min(mse_mean, key=mse_mean.get)
    return {
        "matching_evals": matching_mean,
        "dfracs": dfracs,
        "pred_evals": pred_evals,
        "pred_mse": mse_mean,
        "T": t_store,
        "log": log_store,
        "best_eps": {"matching": best_matching, "pred": best_pred},
        "test_labels": test_labels,
    }


def run_outer_cv(
    data: Dict,
    method: str,
    test_idx: int,
    match_eps: float,
    pred_eps: float,
    baseline: Optional[str] = None,
    pred_data: Optional[Dict] = None,
    n_splits: int = 5,
    z_key: str = "dosage",
    device: Device = "cuda",
) -> Dict:
    """Outer test evaluation at the inner loop's epsilons: couple all
    train-val labels and score matching; fit the MLP predictor on the
    coupling at ``pred_eps`` over the full features (``pred_data`` if
    given, else ``data``) and score it on the held-out test labels.
    ``baseline`` ("perfect", "random", "by_conc") replaces the OT coupling
    with that control."""
    device = resolve_device(device)
    x_dict, y_dict, zs_dict, _ = _unpack(data, z_key)
    labels = list(x_dict.keys())
    _, test_fold = _kfold(labels, n_splits)[test_idx]
    test_labels = [labels[i] for i in test_fold]
    tr_x = _pop_keys(x_dict, test_labels)
    tr_y = _pop_keys(y_dict, test_labels)
    tr_z = _pop_keys(zs_dict, test_labels) if zs_dict else {}

    log_match = log_pred_match = None
    if baseline is not None:
        if baseline == "perfect":
            ts_match = {
                k: np.eye(np.asarray(v).shape[0]) for k, v in tr_x.items()
            }
        elif baseline == "random":
            ts_match = {
                k: np.ones(
                    (np.asarray(v).shape[0], np.asarray(tr_y[k]).shape[0])
                )
                for k, v in tr_x.items()
            }
        elif baseline == "by_conc":
            ts_match = {
                k: make_G(np.asarray(tr_x[k]).shape[0], tr_z[k], k)
                for k in tr_x
            }
        else:
            raise ValueError(f"unknown baseline {baseline!r}")
        ts_pred = ts_match
    else:
        solver = OT_METHOD_MAP[method]
        ts_match, log_match = solver((tr_x, tr_y), match_eps, device=device)
        if match_eps != pred_eps:
            ts_pred, log_pred_match = solver((tr_x, tr_y), pred_eps,
                                             device=device)
        else:
            ts_pred = ts_match

    ts_match = _normalize_mass(ts_match)
    _, mean_foscttm = get_FOSCTTM(ts_match, tr_x, tr_y, use_agg="mean")
    dfrac, rel_dfrac = (float("nan"), float("nan"))
    if tr_z:
        dfrac, rel_dfrac = get_diag_fracs(ts_match, tr_x, tr_y, tr_z, tr_z)

    # Prediction on full features (cv_outer_loop.py:258-284).
    fx_dict, fy_dict, _, _ = _unpack(pred_data or data, z_key)
    ftr_x = _pop_keys(fx_dict, test_labels)
    ftr_y = _pop_keys(fy_dict, test_labels)
    test_x = np.concatenate([np.asarray(fx_dict[l]) for l in test_labels])
    test_y = np.concatenate([np.asarray(fy_dict[l]) for l in test_labels])
    model, log_mlp = train_mlp((ftr_x, ftr_y), ts_pred, device=device)
    y_pred = model(test_x)
    pred_eval = get_evals(test_y, y_pred, prediction_id="eval")

    return {
        "eps": {"match": match_eps, "pred": pred_eps},
        "matching_evals": {
            "mean_foscttm": mean_foscttm,
            "dfracs": dfrac,
            "rel_dfracs": rel_dfrac,
        },
        "pred_evals": {"full": pred_eval},
        "T": {"match": ts_match, "pred": ts_pred},
        "pred": {"Y_pred": y_pred, "Y_true": test_y},
        "log": {"match": log_match, "match_pred": log_pred_match,
                "mlp": {"final_loss": log_mlp["final_loss"]}},
        "test_labels": test_labels,
    }


def run_loo(
    data: Dict,
    method: str,
    eps: float,
    z_key: str = "dosage",
    progress: Optional[Callable[[str], None]] = None,
    device: Device = "cuda",
) -> Tuple[List[Dict], Dict]:
    """Leave-one-treatment-out: for every held-out label, couple the rest,
    fit the coupling-weighted OLS and the perfect/random/by_conc
    baselines, and score their predictions of the held-out pair. Returns
    (per-label metric frames, log)."""
    device = resolve_device(device)
    say = progress or (lambda s: None)
    x_dict, y_dict, zs_dict, _ = _unpack(data, z_key)
    solver = OT_METHOD_MAP[method]
    log: Dict = {"ot_couplings": {}, "params": {}, "preds": {}, "logs": {}}
    eval_rows: List[Dict] = []
    for test_label in list(x_dict.keys()):
        say(f"loo hold-out {test_label}")
        tr_x = _pop_keys(x_dict, [test_label])
        tr_y = _pop_keys(y_dict, [test_label])
        tr_z = _pop_keys(zs_dict, [test_label]) if zs_dict else None
        ts, solver_log = solver((tr_x, tr_y), eps, device=device)
        log["ot_couplings"][test_label] = ts
        log["logs"][test_label] = solver_log
        params = [weighted_ols_normed(tr_x, tr_y, ts)]
        for baseline in BASELINE_PRED_METHODS:
            params.append(baseline(tr_x, tr_y, tr_z))
        log["params"][test_label] = params
        preds = [predict(np.asarray(x_dict[test_label]), p) for p in params]
        log["preds"][test_label] = preds
        rows = get_evals_preds(
            np.asarray(y_dict[test_label]), preds, ["ot"] + BASELINE_PRED_LABELS
        )
        for row in rows:
            row["loo_test_idx"] = test_label
        eval_rows.extend(rows)
    return eval_rows, log


def run_loo_latent(*args, **kwargs):
    """The VAE-then-OT leave-one-out: not ported yet (raises)."""
    raise NotImplementedError(
        "run_loo_latent (--latent-vae) is not ported to otfusion_tpu_torch "
        f"yet (ROADMAP.md, open item: {_VAE_ITEM})")


def run_all(
    data: Dict, method: str, eps: float, z_key: str = "dosage",
    device: Device = "cuda",
) -> Dict:
    """Whole-dataset matching at one epsilon: couple everything,
    normalise to mass 1, report FOSCTTM and the diagonal fractions."""
    device = resolve_device(device)
    x_dict, y_dict, zs_dict, _ = _unpack(data, z_key)
    ts, log = OT_METHOD_MAP[method]((x_dict, y_dict), eps, device=device)
    ts = _normalize_mass(ts)
    _, mean_foscttm = get_FOSCTTM(ts, x_dict, y_dict, use_agg="mean")
    dfrac = rel_dfrac = float("nan")
    if zs_dict:
        dfrac, rel_dfrac = get_diag_fracs(ts, x_dict, y_dict, zs_dict, zs_dict)
    return {
        "eps": eps,
        "matching_evals": {
            "mean_foscttm": mean_foscttm,
            "dfracs": dfrac,
            "rel_dfracs": rel_dfrac,
        },
        "T": ts,
        "log": log,
    }


def run_feature_matching(
    data: Dict,
    method: str,
    eps: float,
    ts=None,
    best_eps=None,
    best_k: int = 10,
    z_key: str = "dosage",
    device: Device = "cuda",
) -> Dict:
    """Feature-level FOT given sample couplings: without ``ts``, build the
    baseline coupling ``method`` names ("perfect", "random", "by_conc") or
    solve the OT method at ``best_eps`` (else ``eps``); then FOT at ``eps``
    gives the feature coupling Tv. ``best_k`` is the VAE methods' kNN
    size (kept for the signature; they are not ported)."""
    device = resolve_device(device)
    x_dict, y_dict, zs_dict, _ = _unpack(data, z_key)
    if ts is None:
        if method == "random":
            ts = {
                k: np.ones(
                    (np.asarray(v).shape[0], np.asarray(y_dict[k]).shape[0])
                )
                / (np.asarray(v).shape[0] * np.asarray(y_dict[k]).shape[0])
                for k, v in x_dict.items()
            }
        elif method == "perfect":
            ts = {
                k: np.eye(np.asarray(v).shape[0]) / np.asarray(v).shape[0]
                for k, v in x_dict.items()
            }
        elif method == "by_conc":
            ts = {
                k: make_G(np.asarray(x_dict[k]).shape[0], zs_dict[k], k)
                for k in x_dict
            }
        else:
            ts, _ = OT_METHOD_MAP[method](
                (x_dict, y_dict), best_eps if best_eps is not None else eps,
                device=device)
    tv, log = get_coupling_fot((x_dict, y_dict), ts, eps, device=device)
    return {"Tv": tv, "log": log, "eps": eps, "sample_eps": best_eps}


def run_grid(
    data: Dict,
    method: str,
    kind: str = "all",
    epsilons: Optional[Sequence[float]] = None,
    n_splits: int = 5,
    z_key: str = "dosage",
    progress: Optional[Callable[[str], None]] = None,
    device: Device = "cuda",
) -> Dict:
    """The reference's LSF grids, in process: the requested stage at every
    epsilon (and, for ``kind="inner-cv"``, every outer fold); returns
    {key: result}."""
    device = resolve_device(device)
    say = progress or (lambda s: None)
    if epsilons is not None:
        epsilons = list(epsilons)
    elif _is_vae(method):
        epsilons = OT_METHOD_HYPERPARAMS[method]  # (adv, dim, lr) tuples
    else:
        epsilons = [1e-2, 1e-3, 1e-4, 1e-5]  # grid of all.py:171
    out: Dict = {}
    if kind == "all":
        for eps in epsilons:
            say(f"all {method} eps={eps}")
            out[eps] = run_all(data, method, eps, z_key=z_key, device=device)
    elif kind == "inner-cv":
        for test_idx in range(n_splits):
            say(f"inner-cv {method} fold={test_idx}")
            out[test_idx] = run_inner_cv(
                data, method, test_idx, epsilons=epsilons,
                n_splits=n_splits, z_key=z_key, progress=progress,
                device=device,
            )
    elif kind == "feature-matching":
        # Select the sample-coupling eps by the best relative diagonal
        # fraction, as submit_feature_run does (feature_matching.py:120-137).
        if method in ("perfect", "random", "by_conc"):
            best_eps = None
        else:
            rel = {
                e: run_all(data, method, e, z_key=z_key, device=device)[
                    "matching_evals"]["rel_dfracs"]
                for e in epsilons
            }
            best_eps = max(rel, key=lambda e: np.nan_to_num(rel[e], nan=-10))
        for eps in epsilons:
            say(f"feature-matching {method} eps={eps}")
            out[eps] = run_feature_matching(
                data, method, eps, best_eps=best_eps, z_key=z_key,
                device=device,
            )
    else:
        raise ValueError(f"unknown grid kind {kind!r}")
    return out


__all__ = [
    "ALL_TO_ALL_METHODS",
    "BASELINE_PRED_LABELS",
    "BASELINE_PRED_METHODS",
    "OT_METHOD_HYPERPARAMS",
    "OT_METHOD_MAP",
    "run_all",
    "run_feature_matching",
    "run_grid",
    "run_inner_cv",
    "run_loo",
    "run_loo_latent",
    "run_outer_cv",
]

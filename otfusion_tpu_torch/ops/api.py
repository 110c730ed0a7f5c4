"""The ``get_coupling_*`` API (port of ``otfusion_tpu.ops.api``).

Each function takes ``((X_dict, Y_dict), eps)``, dicts of per-label
(n_l, d) numpy features, and returns ``(T or {label: T_l}, log)`` with the
JAX package's dict conventions and log keys, plus ``device=`` (default the
card; ``"cuda"`` without a GPU raises). Which solver runs where:

  * ``egw_ott`` / ``egw_pgd``: per-label GW, ``egw_per_label`` (kernel K1
    on CUDA, labels padded to one cap for both sides);
  * ``egw_all_ott`` / ``egw_all``: global GW, ``entropic_gw`` (K1 on one
    "label"; K1 holds at most 128 samples a label and raises above);
  * ``egw_labels_ott``: label-masked global GW, ``entropic_gw_labels``
    (PyTorch ops on the device, as JAX's is XLA ops);
  * ``eot_ott`` / ``leot_ott``: one ``sinkhorn`` (K2), the latter under the
    label plan mask;
  * ``cotl*`` / ``cot_sinkhorn`` / ``each_cot_sinkhorn``: ``cotl`` (K2
    once per label and once for the features, per COOT iteration);
  * ``gw_cg`` / ``gw_all``: Frank-Wolfe over exact EMD on the host.

Results come back to the host as numpy; "time" is the solve's wall time up
to its results on the host.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from otfusion_tpu_torch.ops.costs import pairwise_sq_euclidean
from otfusion_tpu_torch.ops.cot import cotl
from otfusion_tpu_torch.ops.emd import gw_conditional_gradient
from otfusion_tpu_torch.ops.fot import get_coupling_fot
from otfusion_tpu_torch.ops.gromov import (
    egw_per_label,
    entropic_gw,
    entropic_gw_labels,
)
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
from otfusion_tpu_torch.utils.device import resolve_device

__all__ = [
    "get_coupling_egw_ott",
    "get_coupling_egw_labels_ott",
    "get_coupling_egw_all_ott",
    "get_coupling_eot_ott",
    "get_coupling_leot_ott",
    "get_coupling_cotl",
    "get_coupling_cotl_sinkhorn",
    "get_coupling_cot_sinkhorn",
    "get_coupling_each_cot_sinkhorn",
    "get_coupling_gw_cg",
    "get_coupling_egw_pgd",
    "get_coupling_gw_all",
    "get_coupling_egw_all",
    "get_coupling_fot",
]

Device = str | torch.device


def _pad_dicts(x_dict, y_dict, common_cap=False):
    """Labels (sorted), zero-padded (L, cap, d) stacks and validity masks;
    ``common_cap`` pads both sides to one cap (K1 takes square labels)."""
    labels = sorted(x_dict.keys())
    cap_x = max(x_dict[l].shape[0] for l in labels)
    cap_y = max(y_dict[l].shape[0] for l in labels)
    if common_cap:
        cap_x = cap_y = max(cap_x, cap_y)
    d = x_dict[labels[0]].shape[1]
    dp = y_dict[labels[0]].shape[1]
    xs = np.zeros((len(labels), cap_x, d), np.float32)
    ys = np.zeros((len(labels), cap_y, dp), np.float32)
    xm = np.zeros((len(labels), cap_x), bool)
    ym = np.zeros((len(labels), cap_y), bool)
    for i, l in enumerate(labels):
        nx, ny = x_dict[l].shape[0], y_dict[l].shape[0]
        xs[i, :nx] = x_dict[l]
        ys[i, :ny] = y_dict[l]
        xm[i, :nx] = True
        ym[i, :ny] = True
    return labels, xs, ys, xm, ym


def _concat_dicts(x_dict, y_dict):
    labels = sorted(x_dict.keys())
    x = np.concatenate([x_dict[l] for l in labels]).astype(np.float32)
    y = np.concatenate([y_dict[l] for l in labels]).astype(np.float32)
    lx = np.concatenate(
        [np.full(x_dict[l].shape[0], i) for i, l in enumerate(labels)])
    ly = np.concatenate(
        [np.full(y_dict[l].shape[0], i) for i, l in enumerate(labels)])
    return labels, x, y, lx, ly


def _split_by_label(t, labels, lx, ly):
    return {l: t[np.ix_(lx == i, ly == i)] for i, l in enumerate(labels)}


def _on(device):
    return lambda a: torch.as_tensor(a, device=device)


def get_coupling_egw_ott(
    data: Tuple[Dict, Dict], eps: float = 5e-3,
    gw_max_iterations: int = 2000, sinkhorn_max_iterations: int = 2000,
    device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """Per-label entropic GW, all labels in one batched solve (K1 on
    CUDA)."""
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    labels, xs, ys, xm, ym = _pad_dicts(x_dict, y_dict, common_cap=True)
    start = time.time()
    res = egw_per_label(
        on(xs), on(ys), on(xm), on(ym), epsilon=eps,
        max_iterations=gw_max_iterations,
        sinkhorn_max_iterations=sinkhorn_max_iterations)
    coupling, n_iters, converged, linear, cost = (
        v.cpu().numpy() for v in (res.coupling, res.n_iters, res.converged,
                                  res.linear_converged, res.cost))
    elapsed = time.time() - start
    ts, log = {}, {}
    for i, l in enumerate(labels):
        nx, ny = x_dict[l].shape[0], y_dict[l].shape[0]
        ts[l] = coupling[i, :nx, :ny]
        log[l] = {
            "n_iters_outer": int(n_iters[i]),
            "converged_outer": bool(converged[i]),
            "converged_inner": bool(linear[i]),
            "GW cost": float(cost[i]),
            "time": elapsed / len(labels),
            "cost_time": 0.0,
        }
    return ts, log


def _gw_log(res, start):
    return {
        "n_iters_outer": int(res.n_iters),
        "converged_outer": bool(res.converged),
        "GW cost": float(res.cost),
        "time": time.time() - start,
    }


def get_coupling_egw_labels_ott(
    data: Tuple[Dict, Dict], eps: float = 5e-3, device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """Global label-constrained entropic GW, split back into per-label
    blocks."""
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    labels, x, y, lx, ly = _concat_dicts(x_dict, y_dict)
    start = time.time()
    res = entropic_gw_labels(on(x), on(y), on(lx), on(ly), epsilon=eps)
    t = res.coupling.cpu().numpy()
    log = _gw_log(res, start)
    return _split_by_label(t, labels, lx, ly), log


def get_coupling_egw_all_ott(
    data: Tuple[Dict, Dict], eps: float = 5e-3, device: Device = "cuda",
) -> Tuple[np.ndarray, Dict]:
    """All-to-all entropic GW, labels ignored (K1 on one label of
    max(n, m) rows; the shorter side is padded and sliced off)."""
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    _, x, y, _, _ = _concat_dicts(x_dict, y_dict)
    n, m = x.shape[0], y.shape[0]
    cap = max(n, m)
    xp = np.zeros((cap, x.shape[1]), np.float32)
    yp = np.zeros((cap, y.shape[1]), np.float32)
    xp[:n], yp[:m] = x, y
    start = time.time()
    res = entropic_gw(on(xp), on(yp), epsilon=eps,
                      x_mask=on(np.arange(cap) < n),
                      y_mask=on(np.arange(cap) < m))
    t = res.coupling.cpu().numpy()[:n, :m]
    return t, _gw_log(res, start)


def _ot_log(res, start):
    return {
        "n_iters": int(res.n_iters),
        "converged": bool(res.converged),
        "cost": float(res.cost),
        "time": time.time() - start,
    }


def get_coupling_eot_ott(
    data: Tuple[Dict, Dict], eps: float = 5e-3, device: Device = "cuda",
) -> Tuple[np.ndarray, Dict]:
    """Entropic OT on the cross squared-Euclidean cost (needs d == d')."""
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    _, x, y, _, _ = _concat_dicts(x_dict, y_dict)
    start = time.time()
    res = sinkhorn(pairwise_sq_euclidean(on(x), on(y)), epsilon=eps,
                   scale_cost=True)
    t = res.coupling.cpu().numpy()
    return t, _ot_log(res, start)


def get_coupling_leot_ott(
    data: Tuple[Dict, Dict], eps: float = 5e-3, device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """Label-constrained entropic OT (plan masked to the label blocks),
    split per label."""
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    labels, x, y, lx, ly = _concat_dicts(x_dict, y_dict)
    start = time.time()
    res = sinkhorn(pairwise_sq_euclidean(on(x), on(y)), epsilon=eps,
                   scale_cost=True,
                   plan_mask=on(lx[:, None] == ly[None, :]))
    t = res.coupling.cpu().numpy()
    log = _ot_log(res, start)
    return _split_by_label(t, labels, lx, ly), log


def _cot_log(res, start):
    return {
        "cost": [float(res.cost)],
        "n_iters": res.n_iters,
        "converged": res.converged,
        "time": time.time() - start,
        "Tv": res.feature_coupling.cpu().numpy(),
    }


def _cotl_wrapper(data, eps, feature_eps, device):
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    labels, xs, ys, xm, ym = _pad_dicts(x_dict, y_dict)
    start = time.time()
    res = cotl(on(xs), on(ys), on(xm), on(ym), epsilon=eps,
               feature_epsilon=feature_eps)
    sample = res.sample_couplings.cpu().numpy()
    ts = {l: sample[i, :x_dict[l].shape[0], :y_dict[l].shape[0]]
          for i, l in enumerate(labels)}
    return ts, _cot_log(res, start)


def get_coupling_cot_sinkhorn(
    data: Tuple[Dict, Dict], eps: float = 0.2, device: Device = "cuda",
) -> Tuple[np.ndarray, Dict]:
    """Unlabelled entropic COOT (the harness's "ECOOT"): COOT-L with one
    group over the label-concatenated clouds."""
    on = _on(resolve_device(device))
    x_dict, y_dict = data
    _, x, y, _, _ = _concat_dicts(x_dict, y_dict)
    start = time.time()
    res = cotl(on(x[None]), on(y[None]),
               on(np.ones((1, x.shape[0]), bool)),
               on(np.ones((1, y.shape[0]), bool)),
               epsilon=eps, feature_epsilon=eps)
    t = res.sample_couplings[0].cpu().numpy()
    return t, _cot_log(res, start)


def get_coupling_each_cot_sinkhorn(
    data: Tuple[Dict, Dict], eps: float = 0.2, device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """Per-label independent entropic COOT (the harness's "ECOOT_each"):
    each label its own COOT with its own feature coupling."""
    x_dict, y_dict = data
    ts, log = {}, {}
    for l in sorted(x_dict.keys()):
        ts[l], log[l] = get_coupling_cot_sinkhorn(
            ({0: x_dict[l]}, {0: y_dict[l]}), eps, device=device)
    return ts, log


def get_coupling_cotl(
    data: Tuple[Dict, Dict], eps: float = 0.2, device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """Labelled CO-Optimal Transport; the feature stage at the sample
    stage's eps."""
    return _cotl_wrapper(data, eps, None, device)


def get_coupling_cotl_sinkhorn(
    data: Tuple[Dict, Dict], eps: float = 0.2, device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """COOT-L with entropic solvers on both stages (the harness's
    "ECOOTL")."""
    return _cotl_wrapper(data, eps, eps, device)


# ---- the exact ablation family, on the host -------------------------------


def get_coupling_gw_cg(data: Tuple[Dict, Dict], eps=None,
                       device: Device = "cuda") -> Tuple[Dict, Dict]:
    """Per-label unregularised GW by Frank-Wolfe over exact EMD, on the
    host; ``eps`` is accepted and ignored, as the reference's is.
    ``device`` is resolved as every entry point's is, and unused."""
    resolve_device(device)
    x_dict, y_dict = data
    ts, log = {}, {}
    for l in sorted(x_dict.keys()):
        start = time.time()
        ts[l] = gw_conditional_gradient(x_dict[l], y_dict[l])
        log[l] = {"time": time.time() - start}
    return ts, log


def get_coupling_egw_pgd(
    data: Tuple[Dict, Dict], eps: float = 5e-3, device: Device = "cuda",
) -> Tuple[Dict, Dict]:
    """Per-label entropic GW under the reference's 'PGD' name."""
    return get_coupling_egw_ott(data, eps, device=device)


def get_coupling_gw_all(data: Tuple[Dict, Dict], eps=None,
                        device: Device = "cuda"):
    """Global unregularised GW by Frank-Wolfe, on the host (``device`` as
    in ``get_coupling_gw_cg``)."""
    resolve_device(device)
    x_dict, y_dict = data
    _, x, y, _, _ = _concat_dicts(x_dict, y_dict)
    start = time.time()
    t = gw_conditional_gradient(x, y)
    return t, {"time": time.time() - start}


def get_coupling_egw_all(
    data: Tuple[Dict, Dict], eps: float = 5e-3, device: Device = "cuda",
):
    """Global entropic GW under the reference's name."""
    return get_coupling_egw_all_ott(data, eps, device=device)

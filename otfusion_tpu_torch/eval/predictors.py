"""Coupling-weighted cross-modal predictors (port of
``otfusion_tpu.eval.predictors``).

The reference harness imports these from ``perturbot.predict`` modules
that do not exist in its repository; they are reconstructed from their
call sites:

* ``param = weighted_ols_normed(X_dict, Y_dict, Ts)`` then
  ``pred = predict(val_X, param)``: a linear map fit on coupling-weighted
  sample pairs of z-scored features, in closed form;
* the baselines ``ols_normed`` / ``weight_1_ols_normed`` /
  ``weight_conc_normed`` ("perfect" / "random" / "by_conc"): the same fit
  under the identity, uniform and dosage-block couplings;
* ``predict_fn, log = train_mlp((X_dict, Y_dict), Ts)``: an MLP on
  barycentric-projected targets.

Given per-label couplings ``T_l`` (n_l x m_l), the weighted OLS solves
``min_W sum_l sum_ij T^l_ij ||W^T x~_i - y_j||^2`` with ``x~ = [x, 1]``:
``(sum_l X~_l^T diag(T_l 1) X~_l + lambda I) W = sum_l X~_l^T T_l Y_l``.
The OLS family is float64 numpy on the host (the system is often
ill-conditioned at d = 2048). The MLP trains on the device: full-batch
Adam with optax's defaults, initialised as flax's ``Dense``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from otfusion_tpu_torch.utils.device import resolve_device


def make_G(size: int, label, k=None) -> np.ndarray:
    """Block membership matrix of a side-information labelling
    (reference eval/utils.py:6-15): ``G[i, j] = 1`` iff samples i, j share
    a Z class. Vectorised equality instead of the reference's triple loop."""
    label = np.asarray(label).ravel()
    if size != len(label):
        raise ValueError(f"size {size} != len(label) {len(label)} ({k})")
    g = (label[:, None] == label[None, :]).astype(np.float64)
    if not (g.sum(axis=0) > 0).all():
        raise ValueError(f"empty Z class column ({k})")
    return g


def _zstats(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mean = a.mean(axis=0)
    std = a.std(axis=0)
    return mean, np.where(std < 1e-12, 1.0, std)


def _weighted_ols(
    x_dict: Dict, y_dict: Dict, t_dict, ridge: float = 1e-6
) -> Dict:
    """Closed-form coupling-weighted OLS on z-scored features. Returns the
    param dict consumed by :func:`predict`. A single dense coupling over
    the label-concatenated clouds (the all-to-all methods, e.g. ECOOT /
    EGW_all_ott) is treated as one group so cross-label mass is kept."""
    if not isinstance(t_dict, dict):
        labels = list(x_dict.keys())
        x_dict = {
            0: np.concatenate([np.asarray(x_dict[l]) for l in labels])
        }
        y_dict = {
            0: np.concatenate([np.asarray(y_dict[l]) for l in labels])
        }
        t_dict = {0: np.asarray(t_dict)}
    labels = list(x_dict.keys())
    x_all = np.concatenate([np.asarray(x_dict[l], np.float64) for l in labels])
    y_all = np.concatenate([np.asarray(y_dict[l], np.float64) for l in labels])
    x_mean, x_std = _zstats(x_all)
    y_mean, y_std = _zstats(y_all)

    d = x_all.shape[1] + 1  # + bias
    dp = y_all.shape[1]
    gram = np.zeros((d, d))
    cross = np.zeros((d, dp))
    for l in labels:
        x = (np.asarray(x_dict[l], np.float64) - x_mean) / x_std
        y = (np.asarray(y_dict[l], np.float64) - y_mean) / y_std
        t = np.asarray(t_dict[l], np.float64)
        mass = t.sum()
        if mass <= 0:
            continue
        t = t / mass * t.shape[0]  # keep label blocks comparably weighted
        xb = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
        row_mass = t.sum(axis=1)
        gram += xb.T @ (xb * row_mass[:, None])
        cross += xb.T @ (t @ y)
    gram += ridge * np.trace(gram) / d * np.eye(d)
    w = np.linalg.solve(gram, cross)
    return {
        "W": w,
        "x_mean": x_mean,
        "x_std": x_std,
        "y_mean": y_mean,
        "y_std": y_std,
    }


def predict(x: np.ndarray, param: Dict) -> np.ndarray:
    """Apply a fitted linear param (reconstructs
    ``perturbot.predict.linear_regression.predict``; used as
    ``pred_from_param`` at cv_inner_loop.py:135)."""
    x = (np.asarray(x, np.float64) - param["x_mean"]) / param["x_std"]
    xb = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
    y = xb @ param["W"]
    return y * param["y_std"] + param["y_mean"]


def weighted_ols_normed(x_dict: Dict, y_dict: Dict, t_dict: Dict) -> Dict:
    """The harness's main prediction model (``pred_method``,
    cv_inner_loop.py:132): OLS weighted by the OT coupling."""
    return _weighted_ols(x_dict, y_dict, t_dict)


def ols_normed(x_dict: Dict, y_dict: Dict, z_dict: Optional[Dict] = None) -> Dict:
    """"perfect" baseline (cv_inner_loop.py:133-134): identity pairing —
    assumes per-label X/Y rows are truly aligned, as the synthetic
    chemical-screen data guarantees."""
    t = {
        k: np.eye(np.asarray(x_dict[k]).shape[0]) for k in x_dict.keys()
    }
    return _weighted_ols(x_dict, y_dict, t)


def weight_1_ols_normed(
    x_dict: Dict, y_dict: Dict, z_dict: Optional[Dict] = None
) -> Dict:
    """"random" baseline: uniform coupling — every source matched equally
    to every target; the regression floor."""
    t = {
        k: np.ones(
            (np.asarray(x_dict[k]).shape[0], np.asarray(y_dict[k]).shape[0])
        )
        for k in x_dict.keys()
    }
    return _weighted_ols(x_dict, y_dict, t)


def weight_conc_normed(x_dict: Dict, y_dict: Dict, z_dict: Dict) -> Dict:
    """"by_conc" baseline: coupling constant within dosage blocks
    (make_G over Z, as built explicitly at cv_outer_loop.py:172-175)."""
    t = {
        k: make_G(np.asarray(x_dict[k]).shape[0], z_dict[k], k)
        for k in x_dict.keys()
    }
    return _weighted_ols(x_dict, y_dict, t)


def _barycentric_targets(x_dict: Dict, y_dict: Dict, t_dict):
    if not isinstance(t_dict, dict):
        labels = list(x_dict.keys())
        x_dict = {0: np.concatenate([np.asarray(x_dict[l]) for l in labels])}
        y_dict = {0: np.concatenate([np.asarray(y_dict[l]) for l in labels])}
        t_dict = {0: np.asarray(t_dict)}
    xs, ys = [], []
    for l in x_dict.keys():
        x = np.asarray(x_dict[l], np.float32)
        y = np.asarray(y_dict[l], np.float32)
        t = np.asarray(t_dict[l], np.float64)
        row = t.sum(axis=1)
        row = np.where(row == 0, 1e-30, row)
        xs.append(x)
        ys.append(((t / row[:, None]) @ y).astype(np.float32))
    return np.concatenate(xs), np.concatenate(ys)


class MLP(nn.Module):
    """``Dense(hidden) -> ReLU -> Dense(hidden) -> ReLU -> Dense(out)``."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 512):
        super().__init__()
        self.dense0 = nn.Linear(in_dim, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, out_dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.dense0(h))
        h = F.relu(self.dense1(h))
        return self.dense2(h)


def flax_dense_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax ``Dense``'s initialisation, in place: LeCun-normal kernels
    (variance 1/fan_in, truncated at 2 standard deviations, the std
    corrected for the truncation) and zero biases, drawn from
    ``generator``."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std,
                                      b=2.0 * std, generator=generator)
                nn.init.zeros_(layer.bias)


def train_mlp(
    train_data: Tuple[Dict, Dict],
    t_dict: Dict,
    *,
    hidden: int = 512,
    epochs: int = 300,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device: str | torch.device = "cuda",
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
):
    """Fit an MLP X -> Y on coupling-matched pairs: the targets are the
    barycentric projections ``(T_l / row) @ Y_l``, both sides z-scored;
    full-batch Adam (lr ``learning_rate``, betas (0.9, 0.999), eps 1e-8) on
    the mean squared error for ``epochs`` epochs on ``device``. The
    weights start from flax's initialisation drawn from a generator seeded
    by ``seed``, or from ``state_dict``. Returns ``(predict_fn, log)``:
    ``predict_fn(x)`` maps a numpy array to numpy predictions; ``log`` has
    ``final_loss`` and ``loss_curve`` (the loss before each update)."""
    device = resolve_device(device)
    x, y = _barycentric_targets(train_data[0], train_data[1], t_dict)
    x_mean, x_std = _zstats(x.astype(np.float64))
    y_mean, y_std = _zstats(y.astype(np.float64))
    xn = torch.as_tensor(((x - x_mean) / x_std).astype(np.float32),
                         device=device)
    yn = torch.as_tensor(((y - y_mean) / y_std).astype(np.float32),
                         device=device)

    model = MLP(x.shape[1], y.shape[1], hidden)
    if state_dict is None:
        flax_dense_init_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(epochs, device=device)
    for epoch in range(epochs):
        loss = torch.mean((model(xn) - yn) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[epoch] = loss.detach()
    losses = losses.cpu().numpy()
    model.eval()

    def predict_fn(v: np.ndarray) -> np.ndarray:
        vn = ((np.asarray(v, np.float64) - x_mean) / x_std).astype(np.float32)
        with torch.no_grad():
            out = model(torch.as_tensor(vn, device=device))
        return out.cpu().numpy().astype(np.float64) * y_std + y_mean

    log = {"final_loss": float(losses[-1]), "loss_curve": losses}
    return predict_fn, log


__all__ = [
    "MLP",
    "make_G",
    "ols_normed",
    "predict",
    "train_mlp",
    "weight_1_ols_normed",
    "weight_conc_normed",
    "weighted_ols_normed",
]

"""Feature Optimal Transport (port of ``otfusion_tpu.ops.fot``).

``Tv`` (d, d') maps PET features into MRI space. With the sample coupling
``Ts`` held fixed, the linearised COOT feature cost ``M`` is constant, so
``Tv`` is one entropic OT solve on ``M`` (max-scaled, uniform marginals).
The products are plain ``torch.matmul``, as XLA computed them outside any
kernel; the solve goes through ``ops.sinkhorn`` (kernel K2 on CUDA). ``fot``
computes in float32 under any ``torch.autocast``, as the JAX ``fot`` casts
to float32: the base trainer solves inside its bf16 train step at
``epsilon=1e-3``, where a bf16 cost would move the plan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otfusion_tpu_torch.ops.sinkhorn import sinkhorn


class FOTResult(NamedTuple):
    """Feature coupling and solve diagnostics."""

    coupling: torch.Tensor   # (d, d') feature transport plan
    cost: torch.Tensor       # <M, Tv> on the unscaled linearised cost
    converged: torch.Tensor  # 0-d bool, on the device
    n_iters: torch.Tensor    # 0-d int32 Sinkhorn iterations, on the device


def feature_cost(x: torch.Tensor, y: torch.Tensor,
                 ts: torch.Tensor) -> torch.Tensor:
    """``M_kl = sum_ij (X_ik - Y_jl)^2 Ts_ij
             = (X^2ᵀ w_x) 1ᵀ + 1 (w_yᵀ Y^2) - 2 Xᵀ Ts Y``
    with w_x = Ts 1 and w_y = Tsᵀ 1."""
    w_x = torch.sum(ts, dim=1)
    w_y = torch.sum(ts, dim=0)
    const_c = ((x * x).T @ w_x)[:, None] + ((y * y).T @ w_y)[None, :]
    return const_c - 2.0 * (x.T @ ts) @ y


def fot(x: torch.Tensor, y: torch.Tensor, ts: torch.Tensor, *,
        epsilon: float = 5e-3, max_iterations: int = 2000,
        threshold: float = 1e-3) -> FOTResult:
    """FOT feature coupling for ``x`` (n, d), ``y`` (m, d') under the fixed
    sample plan ``ts`` (n, m), normalised to total mass 1. ``epsilon`` is
    relative to the max of the feature cost. Float32 and no gradient,
    whatever autocast or grad mode the caller runs under."""
    with torch.no_grad(), torch.autocast(device_type=x.device.type,
                                         enabled=False):
        x = torch.nan_to_num(x.detach().to(torch.float32))
        y = torch.nan_to_num(y.detach().to(torch.float32))
        ts = ts.detach().to(torch.float32)
        ts = ts / torch.clamp_min(torch.sum(ts), 1e-30)
        m = feature_cost(x, y, ts)
        res = sinkhorn(m, epsilon=epsilon, max_iterations=max_iterations,
                       threshold=threshold, scale_cost=True)
        return FOTResult(coupling=res.coupling,
                         cost=torch.sum(m * res.coupling),
                         converged=res.converged, n_iters=res.n_iters)


def apply_feature_coupling(features: torch.Tensor, tv: torch.Tensor,
                           normalize: bool = True) -> torch.Tensor:
    """Barycentric projection of ``features`` (B, d_src) through ``tv``
    (d_src, d_tgt): ``out[:, l] = sum_k f[:, k] tv[k, l] / sum_k tv[k, l]``,
    with NaN entries of the plan sent to 1e-8 and empty columns divided
    by 1e-8. ``normalize=False`` applies the raw plan."""
    tv = torch.nan_to_num(tv, nan=1e-8)
    if normalize:
        col_mass = torch.sum(tv, dim=0, keepdim=True)
        tv = tv / torch.where(col_mass == 0, 1e-8, col_mass)
    return features @ tv.to(features.dtype)

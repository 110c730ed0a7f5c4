"""Per-epoch coupling (port of ``otfusion_tpu.train.coupling``).

Before each epoch the trainer extracts backbone features for the whole
train set, groups them by label (capped at ``max_samples_per_label``,
zero-padded), solves per-label entropic GW for the sample plans ``Ts``
(kernel K1 on CUDA) and then FOT for the (d_pet, d_mri) feature plan ``Tv``
(kernel K2 on CUDA) that every forward of the next epoch consumes.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch

from otfusion_tpu_torch.ops.gromov import egw_per_label
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn


def group_and_pad(features: np.ndarray, labels: np.ndarray, n_labels: int,
                  cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Group rows of ``features`` by label, first ``cap`` rows of each in
    order, zero-padded: returns ((n_labels, cap, d), mask (n_labels, cap))."""
    d = features.shape[1]
    out = np.zeros((n_labels, cap, d), features.dtype)
    mask = np.zeros((n_labels, cap), bool)
    for lbl in range(n_labels):
        rows = features[labels == lbl][:cap]
        out[lbl, : len(rows)] = rows
        mask[lbl, : len(rows)] = True
    return out, mask


def coupling_pipeline(
    pet_groups: torch.Tensor,   # (L, cap, d_pet)
    mri_groups: torch.Tensor,   # (L, cap, d_mri)
    pet_mask: torch.Tensor,     # (L, cap)
    mri_mask: torch.Tensor,
    *,
    epsilon: float = 5e-3,
    gw_max_iterations: int = 2000,
    sinkhorn_max_iterations: int = 2000,
    fot_epsilon: float = 5e-3,
    fot_max_iterations: int = 2000,
):
    """EGW per label -> block-diagonal sample plan -> FOT feature plan.
    Returns (Tv, GWResult, SinkhornResult). The FOT cost
    ``M = constC - 2 X^T Ts Y`` is summed over labels: off-block mass is
    zero, so the (L*cap, L*cap) block matrix is never built. CUDA groups
    solve on kernels K1 and K2, CPU groups on their plain versions."""
    with torch.no_grad():
        pet_mask = pet_mask.to(torch.bool)
        mri_mask = mri_mask.to(torch.bool)
        gw = egw_per_label(pet_groups, mri_groups, pet_mask, mri_mask,
                           epsilon=epsilon, max_iterations=gw_max_iterations,
                           sinkhorn_max_iterations=sinkhorn_max_iterations)
        ts = gw.coupling / torch.clamp_min(torch.sum(gw.coupling), 1e-30)
        x = torch.where(pet_mask[..., None], pet_groups.float(), 0.0)
        y = torch.where(mri_mask[..., None], mri_groups.float(), 0.0)
        w_x = torch.sum(ts, dim=2)
        w_y = torch.sum(ts, dim=1)
        const_c = (torch.einsum("lnd,ln->d", x * x, w_x)[:, None]
                   + torch.einsum("lme,lm->e", y * y, w_y)[None, :])
        cross = torch.einsum("lnd,lnm,lme->de", x, ts, y)
        m = const_c - 2.0 * cross
        fot_res = sinkhorn(m, epsilon=fot_epsilon,
                           max_iterations=fot_max_iterations, scale_cost=True)
        return fot_res.coupling, gw, fot_res


class CouplingService:
    """Runs the feature pass and the coupling pipeline each epoch."""

    def __init__(self, feature_extract_step: Callable, n_labels: int,
                 device: torch.device, max_samples_per_label: int = 64,
                 epsilon: float = 5e-3, gw_max_iterations: int = 2000,
                 sinkhorn_max_iterations: int = 2000,
                 fot_epsilon: float = 5e-3):
        self.feature_extract_step = feature_extract_step
        self.n_labels = n_labels
        self.device = device
        self.cap = max_samples_per_label
        self.epsilon = epsilon
        self.gw_max_iterations = gw_max_iterations
        self.sinkhorn_max_iterations = sinkhorn_max_iterations
        self.fot_epsilon = fot_epsilon
        self.last_log: dict = {}

    def compute(self, batches: Iterable) -> torch.Tensor:
        """Extract features over ``batches`` of (mri, pet, labels) and
        return the (d_pet, d_mri) feature plan on ``self.device``."""
        mri_feats, pet_feats, labels = [], [], []
        # Copy features to the host two batches behind, so the next
        # forward is queued before the copy waits on the device.
        pending: deque = deque()

        def _drain():
            mf, pf = pending.popleft()
            mri_feats.append(mf.cpu().numpy())
            pet_feats.append(pf.cpu().numpy())

        for mri, pet, lbl in batches:
            pending.append(self.feature_extract_step(
                mri.to(self.device, non_blocking=True),
                pet.to(self.device, non_blocking=True)))
            labels.append(np.asarray(lbl))
            if len(pending) > 2:
                _drain()
        while pending:
            _drain()
        y = np.concatenate(labels)
        mri_all = np.concatenate(mri_feats)
        pet_all = np.concatenate(pet_feats)
        if len(y) != len(mri_all):
            raise AssertionError(
                f"feature/label row mismatch: {len(mri_all)} features vs "
                f"{len(y)} labels")
        mri_g, mri_m = group_and_pad(mri_all, y, self.n_labels, self.cap)
        pet_g, pet_m = group_and_pad(pet_all, y, self.n_labels, self.cap)
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        tv, gw, fot_res = coupling_pipeline(
            to(pet_g), to(mri_g), to(pet_m), to(mri_m),
            epsilon=self.epsilon, gw_max_iterations=self.gw_max_iterations,
            sinkhorn_max_iterations=self.sinkhorn_max_iterations,
            fot_epsilon=self.fot_epsilon)
        self.last_log = {
            "gw_outer_iters": gw.n_iters.tolist(),
            "gw_converged": gw.converged.tolist(),
            "gw_cost": gw.cost.tolist(),
            "fot_converged": bool(fot_res.converged),
            "fot_iters": int(fot_res.n_iters),
        }
        return tv

"""Train, eval and feature-extract steps (port of ``otfusion_tpu.train.steps``).

Each factory closes over the model (and the optimiser) and returns a
function of tensors. ``compute_dtype=torch.bfloat16`` runs the forward under
``torch.autocast`` with fp32 parameters (the JAX package's bf16 compute
dtype); ``None`` runs in fp32.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from otfusion_tpu_torch.train.losses import cosine_alignment_loss, cross_entropy


def _autocast(device: torch.device, dtype):
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def make_fusion_train_step(model, optimizer, *, in_batch_fot: bool = False,
                           grad_accum: int = 1, compute_dtype=None) -> Callable:
    """One optimiser update of ``MultimodalOTFusion`` on a batch: CE plus
    the cosine OT alignment of ``mri_fused`` with the Tv-mapped PET
    features, AdamW, BatchNorm statistics updated by the forward."""
    if in_batch_fot:
        raise NotImplementedError(
            "in-batch FOT (the base variant's train step) is not ported yet "
            "(ROADMAP.md, open item: grad_accum and the base variant's "
            "in-step FOT)")
    if grad_accum > 1:
        raise NotImplementedError(
            "grad_accum > 1 is not ported yet (ROADMAP.md, open item: "
            "grad_accum and the base variant's in-step FOT)")
    use_ot_loss = model.variant in ("per_epoch_attn", "base")

    def step(mri, pet, labels, t_feature, generator=None):
        model.train()
        with _autocast(mri.device, compute_dtype):
            out = model(mri, pet, t_feature=t_feature, generator=generator)
            ce = cross_entropy(out["logits"], labels)
            ot_loss = torch.zeros((), device=ce.device)
            if use_ot_loss and out["ot_mri_from_pet"] is not None:
                ot_loss = cosine_alignment_loss(out["mri_fused"],
                                                out["ot_mri_from_pet"])
            loss = ce + ot_loss
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {
            "loss": loss.detach(),
            "ce_loss": ce.detach(),
            "ot_loss": ot_loss.detach(),
            "correct": (out["logits"].argmax(-1) == labels).sum(),
        }

    return step


def make_fusion_eval_step(model, *, compute_dtype=None) -> Callable:
    """Eval-mode forward with running BN statistics; ``ot_loss`` stays 0
    outside training, as in the reference."""

    @torch.no_grad()
    def step(mri, pet, labels, t_feature):
        model.eval()
        with _autocast(mri.device, compute_dtype):
            out = model(mri, pet, t_feature=t_feature)
        ce = cross_entropy(out["logits"], labels)
        preds = out["logits"].argmax(-1)
        return {
            "loss": ce,
            "ce_loss": ce,
            "ot_loss": torch.zeros((), device=ce.device),
            "preds": preds,
            "logits": out["logits"].float(),
            "correct": (preds == labels).sum(),
        }

    return step


def make_feature_extract_step(model, *, compute_dtype=None) -> Callable:
    """Backbone-only eval-mode forward for the per-epoch coupling:
    returns (mri_feat, pet_feat), fp32."""

    @torch.no_grad()
    def step(mri, pet):
        model.eval()
        with _autocast(mri.device, compute_dtype):
            return model.mri_backbone(mri), model.pet_backbone(pet)

    return step

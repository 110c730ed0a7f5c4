"""Train, eval and feature-extract steps (port of ``otfusion_tpu.train.steps``).

Each factory closes over the model (and the optimiser) and returns a
function of tensors. ``compute_dtype=torch.bfloat16`` runs the forward under
``torch.autocast`` with fp32 parameters (the JAX package's bf16 compute
dtype); ``None`` runs in fp32.

``grad_accum=k`` (both train steps) splits a batch of ``n`` rows into ``k``
microbatches run one after another, as the JAX step's ``lax.scan`` does:

  * microbatch ``i`` takes the strided rows ``i::k`` (which rows share a
    microbatch sets the BatchNorm statistics);
  * a batch with ``n < k`` or ``n % k != 0`` takes the plain path;
  * BatchNorm running statistics update once per microbatch, in order;
  * the gradient is the mean over microbatches (each loss divided by ``k``
    and accumulated), followed by one optimiser update;
  * ``ce`` / ``ot_loss`` are the mean over microbatches, ``correct`` their
    sum; each microbatch draws its own dropout from the step's generator.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from otfusion_tpu_torch.ops.fot import apply_feature_coupling, fot
from otfusion_tpu_torch.train.losses import cosine_alignment_loss, cross_entropy

# The base variant's in-step FOT solves at a fixed eps (the reference's
# in-batch coupling), not at the per-epoch coupling's --ot-epsilon.
_FOT_EPSILON = 1e-3


def _autocast(device: torch.device, dtype):
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def micro_count(n: int, grad_accum: int) -> int:
    """Microbatches a batch of ``n`` rows runs as (the JAX step's rule)."""
    if grad_accum > 1 and n >= grad_accum and n % grad_accum == 0:
        return grad_accum
    return 1


def _accumulate(micro_loss: Callable, optimizer, batch, k: int,
                *extra) -> tuple:
    """Run ``micro_loss(*rows, *extra)`` on the ``k`` strided microbatches
    of ``batch`` (tensors sharing the leading axis, labels last), backward
    each loss / k, then step ``optimizer`` once. ``micro_loss`` returns
    (losses tuple, logits). Returns (mean of each loss, correct)."""
    optimizer.zero_grad(set_to_none=True)
    totals, correct = 0, 0
    for i in range(k):
        rows = [x[i::k] for x in batch]
        losses, logits = micro_loss(*rows, *extra)
        (sum(losses) / k).backward()
        totals = totals + torch.stack(losses).detach()
        correct = correct + (logits.argmax(-1) == rows[-1]).sum()
    optimizer.step()
    return list(totals / k), correct


def make_fusion_train_step(model, optimizer, *, in_batch_fot: bool = False,
                           fot_max_iterations: int = 2000,
                           fot_threshold: float = 1e-3,
                           grad_accum: int = 1, compute_dtype=None) -> Callable:
    """One optimiser update of ``MultimodalOTFusion`` on a batch: CE plus
    the cosine OT alignment of ``mri_fused`` with the Tv-mapped PET
    features, AdamW, BatchNorm statistics updated by the forward.

    ``in_batch_fot=True`` is the base trainer's step: ``Tv`` is solved
    inside the step by FOT on the (micro)batch's fused features under the
    identity sample plan ``eye(b) / b`` (kernel K2 on CUDA, once per
    microbatch, float32, eps 1e-3, no gradient through the solve);
    ``fot_threshold=0`` pins its iteration count. Otherwise the
    per-epoch plan ``t_feature`` (None for mmfusion) is used as given. Only
    ``per_epoch_attn`` and ``base`` carry an OT loss."""
    use_ot_loss = model.variant in ("per_epoch_attn", "base")

    def micro_loss(mri, pet, labels, t_feature, generator):
        with _autocast(mri.device, compute_dtype):
            out = model(mri, pet, t_feature=t_feature, generator=generator)
            ce = cross_entropy(out["logits"], labels)
            ot_loss = torch.zeros((), device=ce.device)
            if use_ot_loss:
                ot_mri = out["ot_mri_from_pet"]
                if in_batch_fot:
                    b = out["mri_fused"].shape[0]
                    ts = torch.eye(b, device=ce.device) / b
                    tv = fot(out["pet_fused"], out["mri_fused"], ts,
                             epsilon=_FOT_EPSILON,
                             max_iterations=fot_max_iterations,
                             threshold=fot_threshold).coupling
                    ot_mri = apply_feature_coupling(out["pet_fused"], tv)
                if ot_mri is not None:
                    ot_loss = cosine_alignment_loss(out["mri_fused"], ot_mri)
        return (ce, ot_loss), out["logits"]

    def step(mri, pet, labels, t_feature, generator=None):
        model.train()
        k = micro_count(mri.shape[0], grad_accum)
        (ce, ot_loss), correct = _accumulate(
            micro_loss, optimizer, (mri, pet, labels), k, t_feature,
            generator)
        return {"loss": ce + ot_loss, "ce_loss": ce, "ot_loss": ot_loss,
                "correct": correct}

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
    returns (mri_feat, pet_feat), fp32, the pooled feature of a backbone
    that returns (tokens, pooled). The backbones are the model's own, so
    they carry its ``remat`` (as JAX builds them with the model's), which
    has nothing to recompute without grad."""

    @torch.no_grad()
    def step(mri, pet):
        model.eval()
        with _autocast(mri.device, compute_dtype):
            return model.features(mri, pet)

    return step


def make_unimodal_train_step(model, optimizer, *, grad_accum: int = 1,
                             compute_dtype=None) -> Callable:
    """Cross-entropy step of ``ResNet3DClassifier`` (Adam in the unimodal
    trainer), with the same ``grad_accum`` contract as the fusion step."""

    def micro_loss(vol, labels):
        with _autocast(vol.device, compute_dtype):
            logits, _ = model(vol)
            return (cross_entropy(logits, labels),), logits

    def step(vol, labels):
        model.train()
        k = micro_count(vol.shape[0], grad_accum)
        (ce,), correct = _accumulate(micro_loss, optimizer, (vol, labels), k)
        return {"loss": ce, "correct": correct}

    return step


def make_unimodal_eval_step(model, *, compute_dtype=None) -> Callable:
    """Eval-mode forward of ``ResNet3DClassifier``: loss, predictions,
    fp32 logits and pooled features."""

    @torch.no_grad()
    def step(vol, labels):
        model.eval()
        with _autocast(vol.device, compute_dtype):
            logits, feats = model(vol)
        preds = logits.argmax(-1)
        return {
            "loss": cross_entropy(logits, labels),
            "preds": preds,
            "logits": logits.float(),
            "features": feats.float(),
            "correct": (preds == labels).sum(),
        }

    return step

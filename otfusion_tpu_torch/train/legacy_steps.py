"""Train and eval steps of the legacy RIMA trainer (port of
``otfusion_tpu.train.legacy_steps``).

For every training batch the step (reference main.py:153-250 +
baseline_models_fusion.py:134-207):

  1. encodes fundus and OCT once (BatchNorm in train mode);
  2. solves the label-constrained EGW both ways on the detached features
     (``ops.gromov.entropic_gw_labels``: one global GW with a label-masked
     plan, PyTorch ops on the features' device, never kernel K1; its loop
     reads its exit to the host once per 8 linearisations);
  3. solves FOT for the (d_oct, d_fundus) feature plan from the
     fundus->OCT sample plan (``ops.fot.fot``: kernel K2 on CUDA);
  4. draws a partner row-wise from each plan: a categorical over
     ``log(max(T, 1e-30))`` (Gumbel-max, from the step's generator), rows
     with no mass uniform (the reference's ``T[T.sum(-1)==0] = 1e-8``);
  5. adds the two cosine projection losses to the cross-entropy, then
     backward and AdamW.

Couplings carry no gradient; gradients flow through the projections, the
cosine losses and the head, as in the reference. Under
``compute_dtype=torch.bfloat16`` the forward runs under ``torch.autocast``
while EGWL and FOT compute in float32, as the JAX step casts their inputs.
"""

from __future__ import annotations

from typing import Callable

import torch

from otfusion_tpu_torch.ops.fot import fot
from otfusion_tpu_torch.ops.gromov import entropic_gw_labels
from otfusion_tpu_torch.train.losses import cosine_alignment_loss, cross_entropy
from otfusion_tpu_torch.train.steps import _autocast


def sample_partners(plan: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Row-wise categorical partner indices from an OT plan (n, m), on the
    plan's device: Gumbel-max over ``log(max(T, 1e-30))``, dead rows
    uniform."""
    logits = torch.log(torch.clamp_min(plan, 1e-30))
    dead = torch.sum(plan, dim=1, keepdim=True) <= 0
    logits = torch.where(dead, 0.0, logits)
    u = torch.rand(logits.shape, generator=generator, device=plan.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0)))
    return torch.argmax(logits + gumbel, dim=1)


def _draw_both(t_f2o, t_o2f, generator):
    return sample_partners(t_f2o, generator), sample_partners(t_o2f, generator)


def make_legacy_train_step(model, optimizer, *, ot_epsilon: float = 5e-3,
                           gw_max_iterations: int = 500, compute_dtype=None,
                           sample_partners: Callable | None = None
                           ) -> Callable:
    """``step(fundus, oct_vol, labels, generator=None)``: one AdamW update
    of ``LegacyMultiModalFusion`` on a batch, fundus (B, H, W, 3), OCT
    (B, D, H, W, 1). ``sample_partners(t_f2o, t_o2f, generator)`` returns
    (OCT partner of each fundus row, fundus partner of each OCT row); the
    default draws both on the device. Returns the losses and ``correct`` as
    device tensors."""
    draw = sample_partners or _draw_both

    def step(fundus, oct_vol, labels, generator=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with _autocast(fundus.device, compute_dtype):
            f_feat, o_feat = model.encode(fundus, oct_vol)
            f_sg, o_sg = f_feat.detach(), o_feat.detach()
            t_f2o = entropic_gw_labels(
                f_sg, o_sg, labels, labels, epsilon=ot_epsilon,
                max_iterations=gw_max_iterations).coupling
            t_o2f = entropic_gw_labels(
                o_sg, f_sg, labels, labels, epsilon=ot_epsilon,
                max_iterations=gw_max_iterations).coupling
            # OCT->fundus feature plan from the fundus->OCT sample plan
            # (reference :146-147: fot(oct_group, fundus_group, Ts)).
            tv = fot(o_sg, f_sg, t_f2o.T, epsilon=ot_epsilon).coupling
            pred_oct = model.project_fundus2oct(f_feat, generator)
            pred_fundus = model.project_oct2fundus(o_feat, generator)
            idx_oct, idx_fundus = draw(t_f2o, t_o2f, generator)
            ot_loss = (cosine_alignment_loss(pred_oct, o_sg[idx_oct])
                       + cosine_alignment_loss(pred_fundus, f_sg[idx_fundus]))
            # Projections are passed in: the 4096-wide MLPs run once.
            logits, _ = model.fuse(f_feat, o_feat, tv, generator,
                                   pred_oct=pred_oct, pred_fundus=pred_fundus)
            ce = cross_entropy(logits, labels)
        (ce + ot_loss).backward()
        optimizer.step()
        ce, ot_loss = ce.detach(), ot_loss.detach()
        return {
            "loss": ce + ot_loss,
            "ce_loss": ce,
            "ot_loss": ot_loss,
            "correct": (logits.detach().argmax(-1) == labels).sum(),
        }

    return step


def make_legacy_eval_step(*, compute_dtype=None) -> Callable:
    """``step(model, fundus, oct_vol, labels, t_feature)``: the eval-mode
    forward of one ensemble member (running BatchNorm statistics) under the
    feature plan ``t_feature``; float32 logits."""

    @torch.no_grad()
    def step(model, fundus, oct_vol, labels, t_feature):
        model.eval()
        with _autocast(fundus.device, compute_dtype):
            out = model(fundus, oct_vol, t_feature)
        logits = out["logits"].float()
        preds = logits.argmax(-1)
        return {
            "loss": cross_entropy(logits, labels),
            "preds": preds,
            "logits": logits,
            "correct": (preds == labels).sum(),
            "fundus_feat": out["fundus_feat"],
            "oct_feat": out["oct_feat"],
        }

    return step

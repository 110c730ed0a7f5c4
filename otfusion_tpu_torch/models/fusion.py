"""Multimodal OT fusion model (port of ``otfusion_tpu.models.fusion``).

  * ``variant="per_epoch_attn"`` — the flagship: tokens [mri_feat,
    pet_feat mapped by Tv, pet_to_mri] through a self-attention block,
    token mean, classifier on concat([attn_out, pet_fused]);
  * ``variant="base"`` — single-token attention over mri_fused, the OT
    mapping applied to pet_fused when a plan is given;
  * ``variant="mmfusion"`` — the no-OT baseline.

Backbones: only the inline ResNet3D (empty spec). Returns the same dict of
eight entries as the JAX module; losses live in ``train.losses``. Dropout
draws from the ``generator`` passed to ``forward``; the module's training
flag (``model.train()`` / ``model.eval()``) plays flax's ``train``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.models.attention import (
    SelfAttentionBlock,
    dense,
    dropout,
)
from otfusion_tpu_torch.models.resnet3d import ResNet3DBackbone
from otfusion_tpu_torch.ops.fot import apply_feature_coupling

VARIANTS = ("per_epoch_attn", "base", "mmfusion")


class _ProjectionMLP(nn.Module):
    """d_in -> 2*d_out -> d_out with ReLU + dropout."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.dense0 = dense(in_dim, out_dim * 2)
        self.dense1 = dense(out_dim * 2, out_dim)

    def forward(self, x, generator=None):
        x = F.relu(self.dense0(x))
        x = dropout(x, self.dropout, self.training, generator)
        return self.dense1(x)


class _FusionMLP(nn.Module):
    """concat -> d -> d with ReLU + dropout."""

    def __init__(self, in_dim: int, dim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.dense0 = dense(in_dim, dim)
        self.dense1 = dense(dim, dim)

    def forward(self, x, generator=None):
        x = F.relu(self.dense0(x))
        x = dropout(x, self.dropout, self.training, generator)
        return self.dense1(x)


def build_fusion_backbone(spec: str, depth: int,
                          s2d_stem: bool = False) -> ResNet3DBackbone:
    """The fusion-side backbone for a registry ``spec`` (empty = the
    inline ResNet3D at ``depth``)."""
    if spec:
        raise NotImplementedError(
            f"registry backbone {spec!r}: the model zoo is not ported yet "
            "(ROADMAP.md, open item: the model zoo)")
    return ResNet3DBackbone(depth, s2d_stem=s2d_stem)


class MultimodalOTFusion(nn.Module):
    """Dual-backbone OT fusion classifier. See module docstring."""

    def __init__(self, num_classes: int = 2, depth: int = 50,
                 projection_dropout: float = 0.3,
                 attention_dropout: float = 0.1,
                 variant: str = "per_epoch_attn", mri_backbone: str = "",
                 pet_backbone: str = "", s2d_stem: bool = False,
                 raw_plan: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant: {variant}")
        self.variant = variant
        self.depth = depth
        self.s2d_stem = s2d_stem
        self.raw_plan = raw_plan
        self.mri_backbone = build_fusion_backbone(mri_backbone, depth, s2d_stem)
        self.pet_backbone = build_fusion_backbone(pet_backbone, depth, s2d_stem)
        d_mri = self.mri_backbone.out_dim
        d_pet = self.pet_backbone.out_dim
        self.mri2pet = _ProjectionMLP(d_mri, d_pet, projection_dropout)
        self.pet2mri = _ProjectionMLP(d_pet, d_mri, projection_dropout)
        self.mri_fusion = _FusionMLP(d_mri + d_pet, d_mri, projection_dropout)
        self.pet_fusion = _FusionMLP(d_pet + d_mri, d_pet, projection_dropout)
        self.attention_mri = SelfAttentionBlock(embed_dim=d_mri, num_heads=8,
                                                ff_dim=d_mri,
                                                dropout=attention_dropout)
        self.fc = dense(d_mri + d_pet, num_classes)

    def forward(self, mri, pet, t_feature=None,
                generator: torch.Generator | None = None) -> dict:
        """mri, pet: (B, D, H, W, 1) volumes; t_feature: (d_pet, d_mri)
        feature plan Tv (required for "per_epoch_attn", optional for
        "base", unused for "mmfusion")."""
        mri_feat = self.mri_backbone(mri)
        pet_feat = self.pet_backbone(pet)
        mri_to_pet = self.mri2pet(mri_feat, generator)
        pet_to_mri = self.pet2mri(pet_feat, generator)
        mri_fused = self.mri_fusion(torch.cat([mri_feat, mri_to_pet], dim=1),
                                    generator)
        pet_fused = self.pet_fusion(torch.cat([pet_feat, pet_to_mri], dim=1),
                                    generator)

        ot_mri_from_pet = None
        if self.variant == "per_epoch_attn":
            if t_feature is None:
                raise ValueError(
                    "t_feature (Tv) is required for the per_epoch_attn "
                    "variant")
            if self.raw_plan:
                ot_mri_from_pet = pet_feat @ t_feature.to(pet_feat.dtype).T
            else:
                ot_mri_from_pet = apply_feature_coupling(pet_feat, t_feature)
            tokens = torch.stack([mri_feat, ot_mri_from_pet,
                                  pet_to_mri.to(mri_feat.dtype)], dim=1)
            attn_out = self.attention_mri(tokens, generator).mean(dim=1)
        else:
            if self.variant == "base" and t_feature is not None:
                ot_mri_from_pet = apply_feature_coupling(pet_fused, t_feature)
            attn_out = self.attention_mri(mri_fused[:, None, :],
                                          generator)[:, 0, :]

        logits = self.fc(torch.cat([attn_out, pet_fused.to(attn_out.dtype)],
                                   dim=1))
        return {
            "logits": logits,
            "mri_feat": mri_feat,
            "pet_feat": pet_feat,
            "mri_fused": mri_fused,
            "pet_fused": pet_fused,
            "mri_to_pet": mri_to_pet,
            "pet_to_mri": pet_to_mri,
            "ot_mri_from_pet": ot_mri_from_pet,
        }

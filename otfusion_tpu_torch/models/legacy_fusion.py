"""Legacy RIMA fusion model (port of ``otfusion_tpu.models.legacy_fusion``;
reference Multi_ResNet, baseline_models_fusion.py:95-264): Res2Net-50 2D
fundus encoder (2048-d) + MedicalNet-10 3D OCT encoder (512*D'-d; 6144 at
96^3 inputs), bidirectional OT alignment, 3-token fundus attention, concat
classifier.

The per-batch OT machinery (bidirectional label-constrained EGW,
partner sampling, FOT feature plan) lives in ``train.legacy_steps``.

Normalised reference quirk, as in the JAX module: projection heads run on
batch-ordered features everywhere (the reference applies them to
label-grouped features in training while fusing them with batch-ordered
encoder outputs, :141-196 vs :218-224; its own eval path is batch-ordered,
:209-216).

Numerics follow the JAX module under ``torch.autocast`` (its bf16 compute
dtype): the encoders return float32 features; the concatenation and the
token stack take the promoted type of their parts, as ``jnp.concatenate``
and ``jnp.stack`` do; the classifier ``fc`` computes in float32
(``float32_dense``; JAX's has no dtype). The OCT feature flattens the
(D', 512) map depth-major, as the JAX encoder does, so Tv and converted
Dense kernels line up element for element. Dropout (rates given to the
constructor, JAX's 0.3 and 0.1 by default) draws from the ``generator``
passed to each method; the module's training flag plays flax's ``train``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.models.attention import (
    SelfAttentionBlock,
    dense,
    dropout,
    float32_dense,
)
from otfusion_tpu_torch.models.medicalnet import MedicalNetResNet, _depth_out
from otfusion_tpu_torch.models.res2net import res2net50_v1b_26w_4s
from otfusion_tpu_torch.ops.fot import apply_feature_coupling


def probe_oct_dim(oct_shape) -> int:
    """Feature width (512 * D') of the MedicalNet-10 OCT encoder for
    volumes of ``oct_shape`` (D, H, W): the stem, the maxpool and layer2
    each halve the depth with ceil."""
    return 512 * _depth_out(int(oct_shape[0]))


def _promoted(parts):
    """``parts`` cast to their promoted type (``jnp.concatenate`` and
    ``jnp.stack`` promote; bf16 with float32 gives float32)."""
    dtype = functools.reduce(torch.promote_types, (p.dtype for p in parts))
    return [p.to(dtype) for p in parts]


class LegacyMultiModalFusion(nn.Module):
    """Fundus (2D) + OCT (3D) OT fusion classifier. ``oct_input_depth`` is
    the depth D of the OCT volumes it will see (it sizes the encoder's
    reported width); ``encode`` checks the width the encoder produces
    against ``oct_feature_dim``."""

    def __init__(self, num_classes: int = 2, oct_feature_dim: int = 6144,
                 fundus_feature_dim: int = 2048,
                 projection_dropout: float = 0.3,
                 attention_dropout: float = 0.1, oct_input_depth: int = 96):
        super().__init__()
        d_f, d_o = fundus_feature_dim, oct_feature_dim
        self.oct_feature_dim = d_o
        self.projection_dropout = projection_dropout
        self.fundus_encoder = res2net50_v1b_26w_4s()
        self.oct_encoder = MedicalNetResNet(depth=10, shortcut_type="B",
                                            pool="hw",
                                            input_depth=oct_input_depth)
        self.fundus2oct = nn.ModuleList([dense(d_f, 4096), dense(4096, d_o)])
        self.oct2fundus = nn.ModuleList([dense(d_o, 4096), dense(4096, d_f)])
        self.oct_fusion = nn.ModuleList([dense(2 * d_o, d_o), dense(d_o, d_o)])
        self.attention_fundus = SelfAttentionBlock(
            embed_dim=d_f, num_heads=4, ff_dim=d_f, dropout=attention_dropout)
        self.fc = dense(d_f + d_o, num_classes)

    def _mlp(self, layers, x, generator):
        x = F.relu(layers[0](x))
        x = dropout(x, self.projection_dropout, self.training, generator)
        return layers[1](x)

    def encode(self, fundus, oct_vol):
        """fundus (B, H, W, 3) -> (B, 2048); oct (B, D, H, W, 1) ->
        (B, d_o); both float32 (or wider)."""
        f = self.fundus_encoder(fundus)
        o = self.oct_encoder(oct_vol)
        if o.shape[-1] != self.oct_feature_dim:
            raise ValueError(
                f"OCT encoder produced {o.shape[-1]}-d features; expected "
                f"{self.oct_feature_dim} (input depth must give "
                f"512*D' = oct_feature_dim)")
        return f, o

    def project_fundus2oct(self, fundus_feat, generator=None):
        return self._mlp(self.fundus2oct, fundus_feat, generator)

    def project_oct2fundus(self, oct_feat, generator=None):
        return self._mlp(self.oct2fundus, oct_feat, generator)

    def fuse(self, fundus_feat, oct_feat, t_feature, generator=None,
             pred_oct=None, pred_fundus=None):
        """Classifier head given encoder features and the OCT->fundus
        feature plan ``t_feature`` (d_oct, d_fundus). Projections may be
        passed in precomputed (the train step computes them once for the
        OT losses) or are computed here. Returns (logits, aux)."""
        if pred_oct is None:
            pred_oct = self.project_fundus2oct(fundus_feat, generator)
        if pred_fundus is None:
            pred_fundus = self.project_oct2fundus(oct_feat, generator)
        ot_fundus_from_oct = apply_feature_coupling(oct_feat, t_feature)
        oct_feature = self._mlp(
            self.oct_fusion, torch.cat(_promoted([oct_feat, pred_oct]), dim=1),
            generator)
        tokens = torch.stack(_promoted([fundus_feat, ot_fundus_from_oct,
                                        pred_fundus]), dim=1)
        att = self.attention_fundus(tokens, generator).mean(dim=1)
        logits = float32_dense(
            self.fc, torch.cat(_promoted([att, oct_feature]), dim=1))
        return logits, {
            "pred_oct": pred_oct,
            "pred_fundus": pred_fundus,
            "ot_fundus_from_oct": ot_fundus_from_oct,
        }

    def forward(self, fundus, oct_vol, t_feature,
                generator: torch.Generator | None = None) -> dict:
        fundus_feat, oct_feat = self.encode(fundus, oct_vol)
        logits, aux = self.fuse(fundus_feat, oct_feat, t_feature, generator)
        return {
            "logits": logits,
            "fundus_feat": fundus_feat,
            "oct_feat": oct_feat,
            **aux,
        }

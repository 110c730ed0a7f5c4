"""UNETR-style 3D ViT feature encoder (port of ``otfusion_tpu.models.unetr``).

MONAI's UNETR ViT as the reference uses it (96^3 volumes, 16^3 patches ->
216 tokens, hidden 768, 12 layers, 12 heads, perceptron patch embedding),
pooled by a final LayerNorm and the mean over tokens. Numerics follow the
JAX module:

  * the patch embedding flattens each p^3 patch in the JAX reshape order
    (pD, pH, pW, C) and applies one linear layer;
  * a learned ``position_embeddings`` of (1, tokens, hidden), its token
    count set by ``img_size`` at construction;
  * pre-norm blocks: LayerNorm eps 1e-5, self-attention with q scaled by
    1/sqrt(head_dim), exact (erf) GELU MLP;
  * the final LayerNorm and the pooled feature are float32.

Parameter names are MONAI's (``patch_embedding.*``, ``blocks.i.norm1``,
``attn.qkv`` fused as [q|k|v][heads][head_dim], ``attn.out_proj``,
``mlp.linear1/2``, ``norm``), so a UNETR ``.pth`` grafts by name. MONAI's
``qkv`` has no bias by default; the port's has one (flax's MHA does),
initialised to zero as flax does, so a graft without it matches JAX's.
``remat=True`` recomputes each block in the backward. No dropout: the
JAX module's rate is 0 wherever it is built.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.models.attention import dense, remat

LAYER_NORM_EPS = 1e-5


def _f32_layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` on ``x`` in float32 (or wider), under autocast too."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    with torch.autocast(x.device.type, enabled=False):
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                            norm.eps)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.heads = heads
        self.qkv = dense(hidden, 3 * hidden)
        self.out_proj = dense(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, hd).unbind(2)
        w = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(hd), k)
        w = torch.softmax(w, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
        return self.out_proj(o.reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.linear1 = dense(hidden, mlp_dim)
        self.linear2 = dense(mlp_dim, hidden)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.attn = _SelfAttention(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.mlp = _MLP(hidden, 4 * hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbedding(nn.Module):
    def __init__(self, patch_volume: int, hidden: int, n_tokens: int):
        super().__init__()
        self.patch_embeddings = dense(patch_volume, hidden)
        self.position_embeddings = nn.Parameter(
            torch.randn(1, n_tokens, hidden) * 0.02)


class UNETRViTEncoder(nn.Module):
    """3D patch ViT; (B, D, H, W, 1) volumes of ``img_size`` -> the pooled
    (B, hidden) float32 feature."""

    def __init__(self, img_size=(96, 96, 96), hidden: int = 768,
                 layers: int = 12, heads: int = 12, patch_size: int = 16,
                 remat: bool = False):
        super().__init__()
        p = patch_size
        if len(img_size) != 3 or any(n % p for n in img_size):
            raise ValueError(f"volume {tuple(img_size)} not divisible by "
                             f"patch size {p}")
        self.patch_size = p
        self.remat = remat
        n_tokens = math.prod(n // p for n in img_size)
        self.patch_embedding = _PatchEmbedding(p ** 3, hidden, n_tokens)
        self.blocks = nn.ModuleList(ViTBlock(hidden, heads)
                                    for _ in range(layers))
        self.norm = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.out_dim = hidden

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``generator`` is unused (the encoder draws no randomness)."""
        b, d, h, w, c = x.shape
        p = self.patch_size
        x = x.reshape(b, d // p, p, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, (d // p) * (h // p) * (w // p), p ** 3 * c)
        x = self.patch_embedding.patch_embeddings(x)
        x = x + self.patch_embedding.position_embeddings.to(x.dtype)
        for block in self.blocks:
            if self.remat and self.training and torch.is_grad_enabled():
                x = remat(block, x)
            else:
                x = block(x)
        return _f32_layer_norm(self.norm, x).mean(dim=1)

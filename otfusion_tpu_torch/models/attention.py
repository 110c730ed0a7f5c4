"""Transformer-encoder fusion block (port of ``otfusion_tpu.models.attention``).

Post-norm encoder: MHA + residual + LayerNorm, ReLU-MLP + residual +
LayerNorm, dropout on the attention weights and both residual branches.
Numerics follow flax: LayerNorm eps 1e-6 computed in fp32, q scaled by
1/sqrt(head_dim), biases on q, k, v and out, Dense kernels initialised
lecun-normal (truncated) with zero biases.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

LAYER_NORM_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    entries by 1 / (1 - rate); draws from ``generator``."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def remat(fn, *args, generator: torch.Generator | None = None):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. The recompute draws from ``generator`` as
    the forward did (its state is saved here and put back around the
    recompute, then restored), so dropout and drop-path masks match."""
    state = generator.get_state() if generator is not None else None

    @contextlib.contextmanager
    def replay():
        if generator is None:
            yield
            return
        now = generator.get_state()
        generator.set_state(state)
        try:
            yield
        finally:
            generator.set_state(now)

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), replay()))


def dense(in_features: int, out_features: int, bias: bool = True
          ) -> nn.Linear:
    """``nn.Linear`` initialised as flax ``nn.Dense``: lecun-normal
    (truncated at 2 std) kernel, zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def float32_dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in (at least) float32 with autocast off: flax's
    ``nn.Dense`` with no dtype (the classifier heads) promotes a bf16 input
    against its float32 kernel and returns float32."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        return layer(x.to(torch.promote_types(x.dtype, torch.float32)))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, qkv width =
    embed width) on batch-first tokens (B, S, E). The q/k/v projections
    hold (heads * head_dim, E) weights, head-major."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.query = dense(embed_dim, embed_dim)
        self.key = dense(embed_dim, embed_dim)
        self.value = dense(embed_dim, embed_dim)
        self.out = dense(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, s, e = x.shape
        h = self.num_heads
        hd = e // h
        q = self.query(x).view(b, s, h, hd) / math.sqrt(hd)
        k = self.key(x).view(b, s, h, hd)
        v = self.value(x).view(b, s, h, hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        w = dropout(w, self.dropout, self.training, generator)
        o = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
        return self.out(o.reshape(b, s, e))


class SelfAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int = 2048, num_heads: int = 8,
                 ff_dim: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiHeadDotProductAttention(embed_dim, num_heads, dropout)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.ff1 = dense(embed_dim, ff_dim)
        self.ff2 = dense(ff_dim, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)

    def _norm(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                            norm.eps)

    def forward(self, tokens: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens: (batch, seq, embed), batch-first as in the JAX module."""
        attn = self.attn(tokens, generator)
        x = tokens + dropout(attn, self.dropout, self.training, generator)
        x = self._norm(self.norm1, x)
        h = F.relu(self.ff1(x))
        h = dropout(h, self.dropout, self.training, generator)
        h = self.ff2(h)
        x = x + dropout(h, self.dropout, self.training, generator)
        return self._norm(self.norm2, x)

"""Swin Transformer 2D backbone (port of ``otfusion_tpu.models.swin``).

p x p patch embedding (conv + LayerNorm), stages of window-attention
blocks with alternating cyclic shifts (the additive -100 mask across
shifted regions), a relative-position bias per head, padding of each
block's input to window multiples, patch merging between stages,
stochastic depth, and ``remat`` (each block recomputed in the backward).
Returns ``(tokens, pooled)``: the final LayerNorm's token sequence and its
mean, both float32. ``swin_base_384`` is the fundus configuration: 384^2
images, patch 4, embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32),
window 12, drop-path 0.5, remat on.

Numerics follow the JAX module: LayerNorm eps 1e-5, exact (erf) GELU, the
attention softmax in float32 (under autocast too), the final LayerNorm in
float32. Each block clamps its window to its feature map (``min(window, h,
w)``, no shift when the window covers the map), so the bias tables' sizes
depend on ``img_size``. Images are (B, H, W, C).

Parameter names are the official Swin's (``patch_embed.proj/norm``,
``layers.s.blocks.b.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.s.downsample.{norm, reduction}``, ``norm``), so an official
``.pth`` grafts by name. Patch merging concatenates the 2 x 2 quadrants in
the official order (0,0), (1,0), (0,1), (1,1) (row, column offsets); the
JAX module's is (0,0), (0,1), (1,0), (1,1), and ``utils.convert`` permutes
the merge weights between the two.

Drop-path masks draw from the ``generator`` passed to ``forward``; under
remat the recompute draws them again from the generator's saved state
(``attention.remat``), so it reproduces the forward.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.models.attention import dense, remat

LAYER_NORM_EPS = 1e-5
PATCH = 4  # the patch embedding's stride and kernel


def _window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(windows, ws, h, w):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws^2, ws^2) additive mask for shifted windows."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss, :] = cnt
            cnt += 1
    windows = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    windows = windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` in float32 (or wider), under autocast too."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    with torch.autocast(x.device.type, enabled=False):
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                            norm.eps)


def _drop_path(y, rate, training, generator):
    """Stochastic depth: each row kept with probability 1 - rate and scaled
    by 1 / (1 - rate)."""
    if rate == 0.0 or not training:
        return y
    keep = 1.0 - rate
    mask = torch.rand((y.shape[0],) + (1,) * (y.dim() - 1),
                      generator=generator, device=y.device) < keep
    return torch.where(mask, y / keep, torch.zeros_like(y))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.window = window
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, heads) * 0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(window).reshape(-1)), persistent=False)

    def forward(self, x, mask):
        bnw, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).view(bnw, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index].view(n, n, self.heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(bnw // nw, nw, self.heads, n, n) \
                + mask[None, :, None].to(attn.dtype)
            attn = attn.view(bnw, self.heads, n, n)
        with torch.autocast(x.device.type, enabled=False):
            attn = torch.softmax(attn.to(torch.promote_types(
                attn.dtype, torch.float32)), dim=-1)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = dense(dim, hidden)
        self.fc2 = dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One block at a fixed (h, w) feature map; its window is clamped to
    the map and its shift dropped when the window covers it."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 resolution: tuple[int, int], drop_path: float = 0.0):
        super().__init__()
        h, w = resolution
        self.ws = min(window, h, w)
        self.shift = shift if self.ws < min(h, w) else 0
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = WindowAttention(dim, heads, self.ws)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = _MLP(dim, 4 * dim)
        hp, wp = h + (-h) % self.ws, w + (-w) % self.ws
        mask = (torch.from_numpy(_shift_attn_mask(hp, wp, self.ws, self.shift))
                if self.shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x, generator=None):
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        y = self.norm1(x)
        pad_h, pad_w = (-h) % ws, (-w) % ws
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = self.attn(_window_partition(y, ws), self.attn_mask)
        y = _window_reverse(y, ws, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w, :]
        x = x + _drop_path(y, self.drop_path, self.training, generator)
        y = self.mlp(self.norm2(x))
        return x + _drop_path(y, self.drop_path, self.training, generator)


class PatchMerging(nn.Module):
    """2 x 2 neighbours to channels (official order), LayerNorm, linear
    4C -> 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LAYER_NORM_EPS)
        self.reduction = dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)


class SwinTransformer2D(nn.Module):
    """(B, H, W, C) images of ``img_size`` -> (tokens, pooled), float32."""

    def __init__(self, img_size=(384, 384), embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (4, 8, 16, 32), window: int = 12,
                 drop_path_rate: float = 0.5, remat: bool = True):
        super().__init__()
        if len(img_size) != 2:
            raise ValueError(f"Swin takes 2D images; got size {img_size}")
        self.remat = remat
        self.patch_embed = _PatchEmbed(3, embed_dim, PATCH)
        h, w = (-(-n // PATCH) for n in img_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        bi = 0
        stages = []
        for stage, depth in enumerate(depths):
            dim = embed_dim * 2 ** stage
            blocks = []
            for i in range(depth):
                blocks.append(SwinBlock(
                    dim, heads[stage], window,
                    shift=0 if i % 2 == 0 else window // 2,
                    resolution=(h, w), drop_path=float(dpr[bi])))
                bi += 1
            last = stage == len(depths) - 1
            stages.append(_Stage(blocks, None if last else PatchMerging(dim)))
            if not last:
                h, w = (h + h % 2) // 2, (w + w % 2) // 2
        self.layers = nn.ModuleList(stages)
        self.out_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.out_dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, generator=None):
        b = x.shape[0]
        x = x.permute(0, 3, 1, 2)
        # flax "SAME" padding of the stride-p patch conv (none when p
        # divides the image)
        pads = []
        for n in reversed(x.shape[2:]):
            total = (-n) % PATCH
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        for stage in self.layers:
            for block in stage.blocks:
                if self.remat and self.training and torch.is_grad_enabled():
                    x = remat(block, x, generator, generator=generator)
                else:
                    x = block(x, generator)
            if stage.downsample is not None:
                x = stage.downsample(x)
        tokens = _layer_norm(self.norm, x.reshape(b, -1, x.shape[-1]))
        return tokens, tokens.mean(dim=1)


def swin_base_384(**kwargs) -> SwinTransformer2D:
    """The fundus configuration (384^2, window 12, drop-path 0.5, remat)."""
    return SwinTransformer2D(**{
        "img_size": (384, 384), "embed_dim": 128, "depths": (2, 2, 18, 2),
        "heads": (4, 8, 16, 32), "window": 12, "drop_path_rate": 0.5,
        **kwargs})

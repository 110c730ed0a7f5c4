"""3D ResNet backbone and classifier (port of
``otfusion_tpu.models.resnet3d``).

Topology (reference inline ResNet3D):
  stem   Conv3d(in->64, k=(3,7,7), s=(1,2,2), p=(1,3,3), no bias) + BN + ReLU,
         or the space-to-depth stem: 2x2 H/W blocks to channels, then a
         stride-1 k=(3,4,4) conv with padding (1,1)/(2,1)/(2,1)
  pool   MaxPool3d(k=(1,3,3), s=(1,2,2), p=(0,1,1))
  stages 64/128/256/512 planes, strides 1,2,2,2; basic blocks for depths
         10-34, bottlenecks (expansion 4) for 50-200
  head   global average pool, cast to fp32

Parameter names follow the original torch model (``conv1``/``bn1``,
``layerN.i.convK``/``bnK``, ``downsample.0/1``), so
``otfusion_tpu.utils.torch_import.resnet3d_tree_from_torch`` maps them onto
the JAX tree. Numerics follow the JAX module, which differs from stock
PyTorch in two places:

  * flax ``"SAME"`` padding: a stride-2 3x3x3 conv pads (0, 1) on an even
    axis and (1, 1) on an odd one (``nn.Conv3d(padding=1)`` would always
    pad (1, 1)), so strided convs pad explicitly with ``F.pad``;
  * flax BatchNorm folds the *biased* batch variance into its running
    variance (momentum 0.9 on the old value); see ``FlaxBatchNorm3d``.

Public layout as in JAX: the backbone takes ``(B, D, H, W, C)`` volumes
and permutes once (the permuted tensor is channels-last-3d in memory).
``ResNet3DClassifier`` (the unimodal trainer's model) is the backbone plus a
linear ``fc`` head.

Two options of the JAX module (``fold_bn`` is a constructor field there,
as flax modules are immutable; here it is an in-place switch):

  * ``remat=True`` recomputes each residual block's activations in the
    backward (``torch.utils.checkpoint``, JAX's per-block ``nn.remat``) when
    the module trains with grad enabled. Parameter names do not change, and
    the recompute leaves the BatchNorm running statistics alone, so they
    move once per forward, as in JAX;
  * ``fold_bn_()`` (serving only) switches a built backbone in place to
    the folded layout: every conv gets a bias and every BatchNorm becomes
    ``nn.Identity``; the weights come from
    ``utils.checkpoint.fold_conv_bn_params``. A folded model refuses to
    run in training mode.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from otfusion_tpu_torch.models.attention import dense, float32_dense

# depth -> (stage block counts, block kind)
DEPTH_CONFIGS: dict[int, tuple[tuple[int, int, int, int], str]] = {
    10: ((1, 1, 1, 1), "basic"),
    18: ((2, 2, 2, 2), "basic"),
    34: ((3, 4, 6, 3), "basic"),
    50: ((3, 4, 6, 3), "bottleneck"),
    101: ((3, 4, 23, 3), "bottleneck"),
    152: ((3, 8, 36, 3), "bottleneck"),
    200: ((3, 24, 36, 3), "bottleneck"),
}


def space_to_depth_hw(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D, H/2, W/2, 4C): 2x2 H/W blocks move to
    channels, channel index = (dh*2 + dw)*C + c."""
    b, d, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"--s2d-stem requires even H and W (got H={h}, W={w}): the "
            "2x2 space-to-depth rearrangement has no remainder rows. "
            "Use an even --target-shape or the plain stem.")
    x = x.reshape(b, d, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, d, h // 2, w // 2, 4 * c)


def s2d_stem_kernel(w_old: np.ndarray) -> np.ndarray:
    """Rewrite a stride-(1,2,2) k=(3,7,7) stem kernel, torch layout
    (O, I, kD, kH, kW), into the exactly equivalent stride-1 k=(3,4,4)
    kernel over space-to-depth inputs (O, 4I, kD, 4, 4). Output row i
    reads input rows h = 2i + kh - 3 = 2u + dh: dh=1 taps come from
    kh = 2*qh, dh=0 taps from kh = 2*qh - 1 (qh = 0 has no source)."""
    cout, cin, kd, kh, kw = w_old.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d stem rewrite expects k=(*,7,7), got "
                         f"{(kd, kh, kw)}")
    w_new = np.zeros((cout, 4 * cin, kd, 4, 4), w_old.dtype)
    for qh in range(4):
        for dh in range(2):
            src_h = 2 * qh if dh == 1 else 2 * qh - 1
            if not 0 <= src_h < kh:
                continue
            for qw in range(4):
                for dw in range(2):
                    src_w = 2 * qw if dw == 1 else 2 * qw - 1
                    if not 0 <= src_w < kw:
                        continue
                    c = (dh * 2 + dw) * cin
                    w_new[:, c:c + cin, :, qh, qw] = w_old[:, :, :, src_h, src_w]
    return w_new


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad (B, C, D, H, W) as flax ``padding="SAME"`` does for a cubic
    ``kernel`` at ``stride``: total = max((ceil(n/s) - 1) s + k - n, 0),
    low side total // 2."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """BatchNorm3d with flax's statistics: eps 1e-5, running averages with
    momentum 0.9 on the old value (torch momentum 0.1), and the *biased*
    batch variance folded into ``running_var`` (torch folds the unbiased
    one). Normalisation itself is torch's (biased variance, as flax).

    ``frozen_stats`` (set only around a remat recompute) normalises with
    the batch statistics as a training forward does, through the same op
    on copies of the running buffers, so the buffers keep the one update
    the block's first forward made."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.frozen_stats:
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        keep = 1.0 - self.momentum
        # torch updates (and autograd keeps) this copy in place:
        # keep*old + m*var*n/(n-1); the buffer gets the biased refold.
        torch_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, torch_var, self.weight,
                         self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = keep * self.running_var
            self.running_var.copy_(kept + (torch_var - kept)
                                   * ((n - 1) / max(n, 1)))
        return y


class FlaxBatchNorm2d(FlaxBatchNorm3d):
    """``FlaxBatchNorm3d``'s statistics on (B, C, H, W) images."""


def _conv(cin, cout, kernel, stride=1, padding=0):
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


# The conv each BatchNorm of the inline ResNet3D follows, by child name:
# ``bnK`` -> ``convK``, and in a ``downsample`` Sequential ``1`` -> ``0``.
_CONV_OF_BN = {"bn1": "conv1", "bn2": "conv2", "bn3": "conv3", "1": "0"}


def conv_name_of_bn(bn_name: str) -> str:
    """Dotted name of the conv that BatchNorm ``bn_name`` (a dotted module
    name, e.g. ``layer1.0.bn2`` or ``layer2.0.downsample.1``) follows."""
    head, _, last = bn_name.rpartition(".")
    if last not in _CONV_OF_BN:
        raise ValueError(f"{bn_name}: not a ResNet3D BatchNorm")
    return f"{head}.{_CONV_OF_BN[last]}" if head else _CONV_OF_BN[last]


def _child(module: nn.Module, name: str) -> nn.Module | None:
    try:
        return module.get_submodule(name)
    except AttributeError:
        return None


def bn_conv_pairs(module: nn.Module) -> list[tuple[str, str]]:
    """(conv, BatchNorm) dotted names of every BatchNorm of ``module``,
    paired by dataflow: each module class names, in its ``CONV_OF_BN``
    map, the conv each of its own BatchNorms follows (never by index).
    Raises on a BatchNorm that no map pairs with a conv."""
    pairs = []
    for path, sub in module.named_modules():
        prefix = f"{path}." if path else ""
        for bn, conv in getattr(sub, "CONV_OF_BN", {}).items():
            if not isinstance(_child(sub, bn), FlaxBatchNorm3d):
                continue  # e.g. a block without a downsample
            if not isinstance(_child(sub, conv), nn.modules.conv._ConvNd):
                raise ValueError(f"{prefix}{bn} has no conv partner at "
                                 f"{prefix}{conv}: unfoldable layout")
            pairs.append((prefix + conv, prefix + bn))
    paired = {bn for _, bn in pairs}
    for path, sub in module.named_modules():
        if isinstance(sub, FlaxBatchNorm3d) and path not in paired:
            raise ValueError(f"BatchNorm {path} has no conv partner: "
                             "unfoldable layout")
    return pairs


def fold_layout_(module: nn.Module) -> None:
    """In place: each conv followed by a BatchNorm (``bn_conv_pairs``)
    gets a zero bias, and the BatchNorm becomes ``nn.Identity`` (the folded
    weights are loaded after)."""
    for conv_name, bn_name in bn_conv_pairs(module):
        conv = module.get_submodule(conv_name)
        conv.bias = nn.Parameter(torch.zeros(
            conv.out_channels, device=conv.weight.device,
            dtype=conv.weight.dtype))
        head, _, last = bn_name.rpartition(".")
        setattr(module.get_submodule(head), last, nn.Identity())


class FoldableBackbone(nn.Module):
    """A conv backbone with a serving layout: ``fold_bn_()`` switches it in
    place to biased convs and no BatchNorm (load folded weights after);
    a folded backbone refuses to train."""

    fold_bn = False

    def fold_bn_(self):
        if not self.fold_bn:
            fold_layout_(self)
            self.fold_bn = True
        return self

    def _check_mode(self) -> None:
        if self.fold_bn and self.training:
            raise ValueError("fold_bn is inference-only: training needs "
                             "live BatchNorm batch statistics (call "
                             ".eval())")


@contextlib.contextmanager
def _frozen_stats(block: nn.Module):
    """Around a block's remat recompute: its BatchNorms leave their running
    statistics alone."""
    norms = [m for m in block.modules() if isinstance(m, FlaxBatchNorm3d)]
    for m in norms:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen_stats = False


class BasicBlock3D(nn.Module):
    """Two 3x3x3 convs with a residual connection."""

    expansion = 1
    CONV_OF_BN = {"bn1": "conv1", "bn2": "conv2",
                  "downsample.1": "downsample.0"}

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(in_planes, planes, 3, stride,
                           padding=1 if stride == 1 else 0)
        self.bn1 = FlaxBatchNorm3d(planes)
        self.conv2 = _conv(planes, planes, 3, padding=1)
        self.bn2 = FlaxBatchNorm3d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(_conv(in_planes, planes, 1, stride),
                                            FlaxBatchNorm3d(planes))

    def forward(self, x):
        h = x if self.stride == 1 else _same_pad(x, 3, self.stride)
        out = F.relu(self.bn1(self.conv1(h)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck3D(nn.Module):
    """1x1x1 -> 3x3x3(stride) -> 1x1x1 bottleneck, expansion 4."""

    expansion = 4
    CONV_OF_BN = {"bn1": "conv1", "bn2": "conv2", "bn3": "conv3",
                  "downsample.1": "downsample.0"}

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out_ch = planes * 4
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = FlaxBatchNorm3d(planes)
        self.conv2 = _conv(planes, planes, 3, stride,
                           padding=1 if stride == 1 else 0)
        self.bn2 = FlaxBatchNorm3d(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FlaxBatchNorm3d(out_ch)
        self.downsample = None
        if stride != 1 or in_planes != out_ch:
            self.downsample = nn.Sequential(_conv(in_planes, out_ch, 1, stride),
                                            FlaxBatchNorm3d(out_ch))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.stride != 1:
            out = _same_pad(out, 3, self.stride)
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet3DBackbone(FoldableBackbone):
    """Headless 3D ResNet returning pooled (B, 512*expansion) fp32 features
    from (B, D, H, W, C) volumes."""

    CONV_OF_BN = {"bn1": "conv1"}

    def __init__(self, depth: int = 50, s2d_stem: bool = False,
                 in_channels: int = 1, remat: bool = False):
        super().__init__()
        layers, kind = DEPTH_CONFIGS[depth]
        block = BasicBlock3D if kind == "basic" else Bottleneck3D
        self.depth = depth
        self.s2d_stem = s2d_stem
        self.remat = remat
        if s2d_stem:
            self.conv1 = _conv(4 * in_channels, 64, (3, 4, 4))
        else:
            self.conv1 = _conv(in_channels, 64, (3, 7, 7), (1, 2, 2),
                               padding=(1, 3, 3))
        self.bn1 = FlaxBatchNorm3d(64)
        self.maxpool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        in_planes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                       layers)):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(in_planes, planes, stride))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_dim = in_planes
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                block, x, use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    _frozen_stats(block)))
        return block(x)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``generator`` is unused (the backbone draws no randomness); every
        backbone of the zoo takes it."""
        self._check_mode()
        if self.s2d_stem:
            x = space_to_depth_hw(x)
        x = x.permute(0, 4, 1, 2, 3)
        if self.s2d_stem:
            x = F.pad(x, (2, 1, 2, 1, 1, 1))
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = self._block(block, x)
        x = x.mean(dim=(2, 3, 4))
        return x.to(torch.promote_types(x.dtype, torch.float32))


class ResNet3DClassifier(nn.Module):
    """Backbone + linear head (the JAX ``ResNet3DClassifier``): returns
    ``(logits, feats)``."""

    def __init__(self, depth: int = 50, num_classes: int = 2,
                 s2d_stem: bool = False):
        super().__init__()
        self.backbone = ResNet3DBackbone(depth, s2d_stem=s2d_stem)
        self.fc = dense(self.backbone.out_dim, num_classes)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x)
        return float32_dense(self.fc, feats), feats

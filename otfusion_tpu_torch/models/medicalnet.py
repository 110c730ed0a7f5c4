"""MedicalNet-style dilated 3D ResNet (port of
``otfusion_tpu.models.medicalnet``).

Differences from the inline ResNet3D (``models.resnet3d``):

  * isotropic 7^3 stride-2 stem with padding 3, then a 3^3 stride-2
    maxpool with padding 1;
  * every 3^3 conv pads explicitly and symmetrically by its dilation (not
    flax ``SAME``); ``layer3`` keeps stride 1 with dilation 2 and
    ``layer4`` stride 1 with dilation 4;
  * shortcut type ``"A"``: a parameter-free downsample (stride slice, then
    zero channels appended) in place of ``"B"``'s 1x1 conv + BatchNorm;
  * ``pool="hw"`` averages H and W only and keeps the depth axis, so the
    feature is D' x 512 x expansion wide (D' = ceil(ceil(ceil(D/2)/2)/2)):
    6144 for ResNet-10 at 96^3. ``pool="full"`` is the global average.

Parameter names are MedicalNet's own (``conv1``/``bn1``,
``layerN.i.convK``/``bnK``, ``downsample.0/1``), so a MedicalNet ``.pth``
grafts by name. ``fold_bn_()`` switches to the serving layout (weights from
``utils.checkpoint.fold_zoo_conv_bn``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.models.resnet3d import (
    DEPTH_CONFIGS,
    FlaxBatchNorm3d,
    FoldableBackbone,
)

# (planes, stride, dilation) of the four stages
_STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


def _conv3(cin, cout, stride=1, dilation=1):
    return nn.Conv3d(cin, cout, 3, stride=stride, padding=dilation,
                     dilation=dilation, bias=False)


def _conv1(cin, cout, stride=1):
    return nn.Conv3d(cin, cout, 1, stride=stride, bias=False)


def _shortcut_a(x: torch.Tensor, out_ch: int, stride: int) -> torch.Tensor:
    """Type-A downsample of (B, C, D, H, W): stride slice, then zero
    channels up to ``out_ch``."""
    if stride != 1:
        x = x[:, :, ::stride, ::stride, ::stride]
    pad = out_ch - x.shape[1]
    return F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad)) if pad > 0 else x


class _MedicalBlock(nn.Module):
    CONV_OF_BN = {"bn1": "conv1", "bn2": "conv2", "bn3": "conv3",
                  "downsample.1": "downsample.0"}

    def _shortcut_init(self, in_planes, out_ch, stride, shortcut_type):
        self.stride = stride
        self.out_ch = out_ch
        self.shortcut_a = False
        self.downsample = None
        if stride != 1 or in_planes != out_ch:
            if shortcut_type == "A":
                self.shortcut_a = True
            else:
                self.downsample = nn.Sequential(
                    _conv1(in_planes, out_ch, stride), FlaxBatchNorm3d(out_ch))

    def _residual(self, x):
        if self.shortcut_a:
            return _shortcut_a(x, self.out_ch, self.stride)
        return x if self.downsample is None else self.downsample(x)


class MedicalBasicBlock(_MedicalBlock):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, dilation=1,
                 shortcut_type="B"):
        super().__init__()
        self.conv1 = _conv3(in_planes, planes, stride, dilation)
        self.bn1 = FlaxBatchNorm3d(planes)
        self.conv2 = _conv3(planes, planes, 1, dilation)
        self.bn2 = FlaxBatchNorm3d(planes)
        self._shortcut_init(in_planes, planes, stride, shortcut_type)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self._residual(x))


class MedicalBottleneck(_MedicalBlock):
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, dilation=1,
                 shortcut_type="B"):
        super().__init__()
        self.conv1 = _conv1(in_planes, planes)
        self.bn1 = FlaxBatchNorm3d(planes)
        self.conv2 = _conv3(planes, planes, stride, dilation)
        self.bn2 = FlaxBatchNorm3d(planes)
        self.conv3 = _conv1(planes, planes * 4)
        self.bn3 = FlaxBatchNorm3d(planes * 4)
        self._shortcut_init(in_planes, planes * 4, stride, shortcut_type)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self._residual(x))


def _depth_out(d: int) -> int:
    """D' of a depth-``d`` volume after the stem, the maxpool and layer2's
    stride: each halves with ceil."""
    for _ in range(3):
        d = math.ceil(d / 2)
    return d


class MedicalNetResNet(FoldableBackbone):
    """Dilated 3D ResNet; (B, D, H, W, 1) volumes -> flattened fp32
    features. ``input_depth`` (D of the volumes it will see) sizes
    ``out_dim`` under ``pool="hw"``."""

    CONV_OF_BN = {"bn1": "conv1"}

    def __init__(self, depth: int = 10, shortcut_type: str = "B",
                 pool: str = "hw", input_depth: int | None = None):
        super().__init__()
        if pool not in ("hw", "full"):
            raise ValueError(f"unknown pool {pool!r}")
        if pool == "hw" and input_depth is None:
            raise ValueError("pool='hw' keeps the depth axis: give "
                             "input_depth to size the feature")
        layers, kind = DEPTH_CONFIGS[depth]
        block = MedicalBasicBlock if kind == "basic" else MedicalBottleneck
        self.depth = depth
        self.pool = pool
        self.conv1 = nn.Conv3d(1, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FlaxBatchNorm3d(64)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)
        in_planes = 64
        for stage, ((planes, stride, dilation), n_blocks) in enumerate(
                zip(_STAGES, layers)):
            blocks = []
            for i in range(n_blocks):
                blocks.append(block(in_planes, planes,
                                    stride if i == 0 else 1, dilation,
                                    shortcut_type))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_dim = (in_planes if pool == "full"
                        else in_planes * _depth_out(input_depth))
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        self._check_mode()
        x = x.permute(0, 4, 1, 2, 3)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        if self.pool == "hw":
            x = x.mean(dim=(3, 4)).transpose(1, 2).reshape(x.shape[0], -1)
        else:
            x = x.mean(dim=(2, 3, 4))
        return x.to(torch.promote_types(x.dtype, torch.float32))

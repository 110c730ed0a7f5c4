"""Res2Net-v1b 2D backbone (port of ``otfusion_tpu.models.res2net``).

The ``Bottle2neck`` splits its 3x3 stage into 4 groups of ``width``
channels solved hierarchically: group i's conv reads group i's input plus
group i-1's output; in a stage's first block (``stype="stage"``) each group
reads only its own input and the untouched last group is average-pooled to
the new stride. The v1b flavour has a deep stem of three 3x3 convs and an
avgpool + 1x1 conv + BatchNorm downsample. ``res2net50_v1b_26w_4s`` (base
width 26, scale 4) gives the 2048-dim feature.

Numerics follow the JAX module: flax ``avg_pool`` counts the padding
(``count_include_pad=True``), BatchNorm has flax's statistics
(``FlaxBatchNorm2d``). Images are (B, H, W, C). Parameter names are the
official ones (``conv1.{0,1,3,4,6}``, ``bn1``, ``layerN.i.conv1/bn1``,
``convs.j``/``bns.j``, ``conv3/bn3``, ``downsample.{1,2}``), so a Res2Net
``.pth`` grafts by name. ``fold_bn_()`` switches to the serving layout
(weights from ``utils.checkpoint.fold_zoo_conv_bn``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.models.resnet3d import (
    FlaxBatchNorm2d,
    FoldableBackbone,
)


def _conv(cin, cout, kernel, stride=1, padding=0):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


# base width and scale of res2net50_v1b_26w_4s, the one configuration used
BASE_WIDTH = 26
SCALE = 4


class Bottle2neck(nn.Module):
    expansion = 4
    CONV_OF_BN = {"bn1": "conv1", "bn3": "conv3",
                  "downsample.2": "downsample.1",
                  **{f"bns.{j}": f"convs.{j}" for j in range(SCALE - 1)}}

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 stype: str = "normal"):
        super().__init__()
        width = int(planes * (BASE_WIDTH / 64.0))
        out_ch = planes * 4
        self.width = width
        self.stride = stride
        self.stype = stype
        self.conv1 = _conv(in_planes, width * SCALE, 1)
        self.bn1 = FlaxBatchNorm2d(width * SCALE)
        self.convs = nn.ModuleList(_conv(width, width, 3, stride, 1)
                                   for _ in range(SCALE - 1))
        self.bns = nn.ModuleList(FlaxBatchNorm2d(width)
                                 for _ in range(SCALE - 1))
        self.conv3 = _conv(width * SCALE, out_ch, 1)
        self.bn3 = FlaxBatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_planes != out_ch:
            pool = (nn.AvgPool2d(stride, stride) if stride != 1
                    else nn.Identity())
            self.downsample = nn.Sequential(pool, _conv(in_planes, out_ch, 1),
                                            FlaxBatchNorm2d(out_ch))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        outs = []
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if i == 0 or self.stype == "stage" \
                else sp + splits[i]
            sp = F.relu(bn(conv(sp)))
            outs.append(sp)
        last = splits[-1]
        if self.stype == "stage":
            last = F.avg_pool2d(last, 3, self.stride, 1,
                                count_include_pad=True)
        out = self.bn3(self.conv3(torch.cat(outs + [last], dim=1)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Res2Net(FoldableBackbone):
    """Res2Net-v1b; (B, H, W, C) images -> the pooled (B, 2048) fp32
    feature."""

    CONV_OF_BN = {"conv1.1": "conv1.0", "conv1.4": "conv1.3",
                  "bn1": "conv1.6"}

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Sequential(
            _conv(3, 32, 3, 2, 1), FlaxBatchNorm2d(32), nn.ReLU(),
            _conv(32, 32, 3, 1, 1), FlaxBatchNorm2d(32), nn.ReLU(),
            _conv(32, 64, 3, 1, 1))
        self.bn1 = FlaxBatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_planes = 64
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n_blocks):
                blocks.append(Bottle2neck(
                    in_planes, planes,
                    stride=2 if (stage > 0 and i == 0) else 1,
                    stype="stage" if i == 0 else "normal"))
                in_planes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_dim = in_planes
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        self._check_mode()
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        x = x.mean(dim=(2, 3))
        return x.to(torch.promote_types(x.dtype, torch.float32))


def res2net50_v1b_26w_4s() -> Res2Net:
    """The 2048-dim Res2Net-50 v1b (base width 26, scale 4)."""
    return Res2Net(layers=(3, 4, 6, 3))

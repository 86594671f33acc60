"""ResNeXt backbone with dilation and optional Squeeze-and-Excitation
(PyTorch counterpart of ``gan_segmentation_tpu/models/resnext.py``).

Grouped-conv bottleneck blocks (``cardinality`` groups of width
``floor(channels * bottleneck_width / 64)``), a 7x7 stem, and the dilated
variant with stride-8 stages (layer3 dilation 2, layer4 dilation 4 whose
block 0 runs dilation 2).  Unlike `resnet.py`, block 0 of EVERY stage has
the 1x1 downsample.  ``use_se`` adds channel attention with BIASED 1x1
convs.  The reference's ``last_gamma`` condition is inverted and kept so:
the last batch norm of a block starts with a ZERO scale when ``last_gamma``
is False.

An alternative backbone with the same (c1, c3, c4) taps as
`resnet.ResNetV1s`; NHWC activations, names as in the JAX package.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import global_avg_pool
from .resnet import BatchNorm, Conv2d, init_parameters, max_pool_3x3_s2


class ResNextBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, cardinality: int = 32,
                 bottleneck_width: int = 4, strides: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 use_se: bool = False, last_gamma: bool = False):
        super().__init__()
        d = int(math.floor(channels * (bottleneck_width / 64)))
        group_width = cardinality * d
        out_ch = channels * 4
        self.conv1 = Conv2d(in_ch, group_width)
        self.bn1 = BatchNorm(group_width)
        self.conv2 = Conv2d(group_width, group_width, 3, stride=strides,
                            padding=dilation, dilation=dilation,
                            groups=cardinality)
        self.bn2 = BatchNorm(group_width)
        self.conv3 = Conv2d(group_width, out_ch)
        # the reference's quirk: zero scale when last_gamma is False
        self.bn3 = BatchNorm(out_ch, zero_scale=not last_gamma)
        if use_se:
            self.se_conv1 = Conv2d(out_ch, channels // 4, bias=True)
            self.se_conv2 = Conv2d(channels // 4, out_ch, bias=True)
        else:
            self.se_conv1 = None
        if downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, stride=strides)
            self.downsample_bn = BatchNorm(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se_conv1 is not None:
            w = global_avg_pool(y, keepdims=True)
            w = F.relu(self.se_conv1(w))
            y = y * torch.sigmoid(self.se_conv2(w))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNextDilated(nn.Module):
    """``forward(x) -> (c1, c3, c4)``, NHWC."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 cardinality: int = 32, bottleneck_width: int = 4,
                 use_se: bool = False, dilated: bool = True,
                 last_gamma: bool = False, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = tuple(layers)
        self.stem_conv = Conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.stem_bn = BatchNorm(64)
        block = dict(cardinality=cardinality,
                     bottleneck_width=bottleneck_width, use_se=use_se,
                     last_gamma=last_gamma)
        ch = 64
        late = ((1, 2), (1, 4)) if dilated else ((2, 1), (2, 1))
        for idx, (channels, (strides, dilation)) in enumerate(
                zip((64, 128, 256, 512), ((1, 1), (2, 1)) + late), start=1):
            first = 2 if dilation == 4 else 1
            self.add_module(f"layer{idx}_block0", ResNextBlock(
                ch, channels, strides=strides, downsample=True,
                dilation=first, **block))
            ch = channels * 4
            for b in range(1, self.layers[idx - 1]):
                self.add_module(f"layer{idx}_block{b}", ResNextBlock(
                    ch, channels, dilation=dilation, **block))
        self.out_channels = (256, 1024, 2048)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def _stage(self, x, idx):
        for b in range(self.layers[idx - 1]):
            x = getattr(self, f"layer{idx}_block{b}")(x)
        return x

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = max_pool_3x3_s2(x)
        c1 = self._stage(x, 1)
        c2 = self._stage(c1, 2)
        c3 = self._stage(c2, 3)
        c4 = self._stage(c3, 4)
        return c1, c3, c4


def resnext50_32x4d(dilated=True, use_se=False, **kwargs):
    return ResNextDilated(layers=(3, 4, 6, 3), cardinality=32,
                          bottleneck_width=4, dilated=dilated, use_se=use_se,
                          **kwargs)


def resnext101_32x4d(dilated=True, use_se=False, **kwargs):
    return ResNextDilated(layers=(3, 4, 23, 3), cardinality=32,
                          bottleneck_width=4, dilated=dilated, use_se=use_se,
                          **kwargs)


def resnext101_64x4d(dilated=True, use_se=False, **kwargs):
    return ResNextDilated(layers=(3, 4, 23, 3), cardinality=64,
                          bottleneck_width=4, dilated=dilated, use_se=use_se,
                          **kwargs)


def se_resnext50_32x4d(dilated=True, **kwargs):
    return resnext50_32x4d(dilated=dilated, use_se=True, **kwargs)


def se_resnext101_32x4d(dilated=True, **kwargs):
    return resnext101_32x4d(dilated=dilated, use_se=True, **kwargs)

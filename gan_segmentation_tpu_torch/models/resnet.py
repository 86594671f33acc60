"""ResNet-V1b/s backbone with dilation (PyTorch counterpart of
``gan_segmentation_tpu/models/resnet.py``).

The gluoncv ``resnet50_v1s`` family under the DeepLab heads: a deep stem of
three 3x3 convs (3 -> 64 -> 64 -> 128, stride 2 on the first), max-pool
3x3 stride 2, four stages of ``BottleneckV1b`` blocks (planes 64, 128, 256,
512, expansion 4).  Dilated (output stride 8): layer3 runs stride 1 with
dilation 2 and layer4 stride 1 with dilation 4, and block 0 of a stage
takes the gluoncv first-block rule: dilation 1 in the dilation-2 stage and
dilation 2 in the dilation-4 stage.  A block has a 1x1 ``downsample`` on
its residual where its stride is not 1 or its width changes, so block 0 of
layer3 and layer4 has one with stride 1.  Returns the taps (c1, c3, c4).

Activations are NHWC in the dtype of the input; parameters and batch-norm
statistics stay f32 (a conv casts its kernel to the activation's dtype).
Submodules carry the JAX package's names (``stem_conv0``,
``layer3_block0.downsample_bn``, ...), so its parameter tree maps onto the
``state_dict`` name by name (`core/params_bridge.py::tree_state_dict`).
The input's channel count, which the JAX package infers, is the
constructor's ``in_channels``.

``Conv2d``, ``BatchNorm`` and ``init_parameters`` serve `resnext.py` and
`deeplab.py` too.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d_oihw
from ..ops.norm import batch_norm

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # the JAX package's 0.9 counts the share that is kept
# std of a unit normal truncated at +-2, which lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Module):
    """A conv on NHWC activations: OIHW ``weight`` (kept in channels-last
    memory, the layout of an NHWC activation viewed as NCHW) and an optional
    ``bias``, both f32 and cast to the activation's dtype at the call."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 1, *,
                 stride: int = 1, padding=0, dilation: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(torch.zeros(
            features, in_ch // groups, k, k).contiguous(
                memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        """The JAX package's defaults: ``lecun_normal`` (a normal of
        variance 1 / fan_in truncated at two standard deviations, fan_in =
        kh * kw * Cin / groups) and a zero bias."""
        std = math.sqrt(1.0 / math.prod(self.weight.shape[1:])) / _TRUNC_STD
        with torch.no_grad():
            drawn = torch.empty(self.weight.shape, device=gen.device)
            nn.init.trunc_normal_(drawn, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            self.weight.copy_(drawn)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d_oihw(x, self.weight.to(x.dtype), b, stride=self.stride,
                           padding=self.padding, dilation=self.dilation,
                           groups=self.groups)


class BatchNorm(nn.BatchNorm2d):
    """The JAX package's ``BatchNorm(momentum=0.9, epsilon=1e-5)`` on NHWC
    activations (`ops/norm.py::batch_norm`); train or eval by
    ``self.training``.  ``zero_scale`` starts the scale at 0.
    ``process_group`` (``set_process_group``): train mode over the global
    batch of that group's processes."""

    process_group = None

    def __init__(self, features: int, zero_scale: bool = False):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.zero_scale = zero_scale
        self.reset_parameters()

    def reset_parameters(self):
        super().reset_parameters()
        if getattr(self, "zero_scale", False):
            nn.init.zeros_(self.weight)

    def forward(self, x):
        return batch_norm(x, self, self.training, self.process_group)


def set_process_group(module: nn.Module, group) -> None:
    """Every ``BatchNorm`` under ``module`` takes its train-mode statistics
    over the global batch of ``group`` (None: this process's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group


def init_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every ``Conv2d`` and ``BatchNorm`` under ``module`` as the
    JAX package does, drawing from ``gen``."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(gen)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


def max_pool_3x3_s2(x):
    """3x3 max-pool, stride 2, one pixel of -inf padding, on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


class BottleneckV1b(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, strides: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=strides,
                            padding=dilation, dilation=dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch)
        self.bn3 = BatchNorm(out_ch)
        if downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, stride=strides)
            self.downsample_bn = BatchNorm(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNetV1s(nn.Module):
    """Deep-stem ResNet; ``layers`` e.g. (3, 4, 6, 3) for resnet50.
    ``forward(x) -> (c1, c3, c4)``, NHWC."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 stem_width: int = 64, dilated: bool = True,
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers, self.dilated = tuple(layers), dilated
        sw = stem_width
        self.stem_conv0 = Conv2d(in_channels, sw, 3, stride=2, padding=1)
        self.stem_bn0 = BatchNorm(sw)
        self.stem_conv1 = Conv2d(sw, sw, 3, padding=1)
        self.stem_bn1 = BatchNorm(sw)
        self.stem_conv2 = Conv2d(sw, sw * 2, 3, padding=1)
        self.stem_bn2 = BatchNorm(sw * 2)
        ch = sw * 2
        late = ((1, 2), (1, 4)) if dilated else ((2, 1), (2, 1))
        for idx, (planes, (strides, dilation)) in enumerate(
                zip((64, 128, 256, 512), ((1, 1), (2, 1)) + late), start=1):
            ch = self._add_stage(idx, ch, planes, self.layers[idx - 1],
                                 strides, dilation)
        self.out_channels = (256, 1024, 2048)  # of c1, c3, c4
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def _add_stage(self, idx, in_ch, planes, blocks, strides, dilation):
        out_ch = planes * BottleneckV1b.expansion
        need_ds = strides != 1 or in_ch != out_ch
        # gluoncv's first-block rule: a dilation-2 stage starts at 1, a
        # dilation-4 stage at 2
        first = 1 if dilation <= 2 else dilation // 2
        self.add_module(f"layer{idx}_block0", BottleneckV1b(
            in_ch, planes, strides, first, downsample=need_ds))
        for b in range(1, blocks):
            self.add_module(f"layer{idx}_block{b}", BottleneckV1b(
                out_ch, planes, 1, dilation))
        return out_ch

    def _stage(self, x, idx):
        for b in range(self.layers[idx - 1]):
            x = getattr(self, f"layer{idx}_block{b}")(x)
        return x

    def forward(self, x):
        for k in range(3):
            x = getattr(self, f"stem_conv{k}")(x)
            x = F.relu(getattr(self, f"stem_bn{k}")(x))
        x = max_pool_3x3_s2(x)
        c1 = self._stage(x, 1)
        c2 = self._stage(c1, 2)
        c3 = self._stage(c2, 3)
        c4 = self._stage(c3, 4)
        return c1, c3, c4


def resnet50_v1s(dilated: bool = True, **kwargs) -> ResNetV1s:
    return ResNetV1s(layers=(3, 4, 6, 3), dilated=dilated, **kwargs)


def resnet101_v1s(dilated: bool = True, **kwargs) -> ResNetV1s:
    return ResNetV1s(layers=(3, 4, 23, 3), dilated=dilated, **kwargs)


def resnet152_v1s(dilated: bool = True, **kwargs) -> ResNetV1s:
    return ResNetV1s(layers=(3, 8, 36, 3), dilated=dilated, **kwargs)

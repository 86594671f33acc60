"""DeepLabV3 / DeepLabV3+ heads over the dilated ResNet backbone (PyTorch
counterpart of ``gan_segmentation_tpu/models/deeplab.py``).

- ``ASPP``: a 1x1 branch, three dilated 3x3 branches (rates 12 / 24 / 36,
  padding = rate), a global-pool branch BROADCAST (not resized) to the
  input's size, concatenated in that order, projected by a 1x1 conv with
  dropout 0.5;
- ``SkipProject``: 1x1 -> 32 channels, BN, relu on c1;
- V3+ head: ``[aspp upsampled to c1's size, projected c1]`` through two
  depthwise-separable convs (``SeparableConv``, with the reference's
  (begin, end) same-padding and relu placement by ``depth_activation``)
  and a biased 1x1 classifier;
- aux ``FCNHead`` on c3: 3x3 -> C/4, BN, relu, dropout 0.1, biased 1x1;
- align-corners bilinear resizes to ``out_hw`` (default: the input's size).

Only ``head_classifier`` and ``auxlayer.conv1`` carry a bias.  Activations
are NHWC in the input's dtype.  Train or eval by ``self.training``; in
train mode the dropout bits come from the ``torch.Generator`` given to
``forward``, or from ``dropout_u``, the uniform draws that
``draw_dropout`` made before from that generator in the forward's order
and shapes (a CUDA graph's static inputs; the same bits either way).  None
is needed when ``use_dropout`` is False.  The channel
counts that the JAX package infers are constructor arguments here; the
backbone takes 4 input channels (``in_channels=4``) when ``forward`` is
given a ``depth`` plane.

The reference trains everything outside the backbone at 10 times the
rate: ``head_param_groups`` splits a model's parameters so.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from ..ops.resize import bilinear_resize, global_avg_pool
from .resnet import BatchNorm, Conv2d, ResNetV1s, init_parameters

HEAD_LR_MULT = 10.0


def _same_padding(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """The reference's (begin, end) same-padding of a dilated kernel."""
    eff = kernel_size + (kernel_size - 1) * (dilation - 1)
    total = eff - 1
    beg = total // 2
    return beg, total - beg


def _drop(x, rate, training, use_dropout, generator, uniforms=None):
    """Dropout at one site; ``uniforms`` is an iterator over the forward's
    pre-drawn uniforms, of which this site takes the next."""
    if not (training and use_dropout):
        return x
    if uniforms is not None:
        return dropout(x, rate=rate, uniform=next(uniforms))
    if generator is None:
        raise ValueError("train mode with dropout needs a torch.Generator "
                         "for the dropout bits")
    return dropout(x, generator, rate)


def _stride8(n: int) -> int:
    """The size of c3 and c4 of the dilated backbone for an input of ``n``
    pixels: each of its three stride-2 ops (the stem's first conv, the
    max-pool, layer2's first block) rounds up."""
    for _ in range(3):
        n = (n + 1) // 2
    return n


class _DropoutDraws:
    """``dropout_shapes`` / ``draw_dropout`` of a DeepLab model, whose
    ``_dropout_sites()`` lists (module with ``use_dropout``, channels) in
    the forward's order."""

    def dropout_shapes(self, x_shape) -> List[Tuple[int, ...]]:
        """The shape of each train-mode dropout draw, in the forward's
        order, for an NHWC input of ``x_shape``: every site runs at output
        stride 8."""
        n, h, w = x_shape[:3]
        return [(n, _stride8(h), _stride8(w), c)
                for module, c in self._dropout_sites() if module.use_dropout]

    def draw_dropout(self, x_shape, generator: torch.Generator
                     ) -> List[torch.Tensor]:
        """The uniform draws of train-mode dropout, made from ``generator``
        up front in the order and shapes in which the forward would make
        them (``torch.rand``, on the generator's device)."""
        return [torch.rand(s, generator=generator, device=generator.device)
                for s in self.dropout_shapes(x_shape)]


class SeparableConv(nn.Module):
    """Depthwise 3x3 + BN, pointwise 1x1 + BN; relu after each BN when
    ``depth_activation``, else one relu before the depthwise conv."""

    def __init__(self, in_ch: int, out_filters: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1,
                 depth_activation: bool = True):
        super().__init__()
        self.depth_activation = depth_activation
        self.depthwise = Conv2d(in_ch, in_ch, kernel_size, stride=strides,
                                padding=_same_padding(kernel_size, dilation),
                                dilation=dilation, groups=in_ch)
        self.depthwise_bn = BatchNorm(in_ch)
        self.pointwise = Conv2d(in_ch, out_filters)
        self.pointwise_bn = BatchNorm(out_filters)

    def forward(self, x):
        if not self.depth_activation:
            x = F.relu(x)
        x = self.depthwise_bn(self.depthwise(x))
        if self.depth_activation:
            x = F.relu(x)
        x = self.pointwise_bn(self.pointwise(x))
        if self.depth_activation:
            x = F.relu(x)
        return x


class ASPP(nn.Module):
    def __init__(self, in_ch: int, atrous_rates=(12, 24, 36),
                 out_channels: int = 256, use_dropout: bool = True):
        super().__init__()
        c = out_channels
        self.use_dropout = use_dropout
        self.b0_conv = Conv2d(in_ch, c)
        self.b0_bn = BatchNorm(c)
        self.n_atrous = len(atrous_rates)
        for bi, rate in enumerate(atrous_rates, start=1):
            self.add_module(f"b{bi}_conv", Conv2d(in_ch, c, 3, padding=rate,
                                                  dilation=rate))
            self.add_module(f"b{bi}_bn", BatchNorm(c))
        self.pool_conv = Conv2d(in_ch, c)
        self.pool_bn = BatchNorm(c)
        self.project_conv = Conv2d(c * (self.n_atrous + 2), c)
        self.project_bn = BatchNorm(c)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                uniforms=None):
        branches = [F.relu(getattr(self, f"b{bi}_bn")(
            getattr(self, f"b{bi}_conv")(x)))
            for bi in range(self.n_atrous + 1)]
        pool = global_avg_pool(x, keepdims=True)
        pool = F.relu(self.pool_bn(self.pool_conv(pool)))
        branches.append(pool.expand(*x.shape[:3], -1))
        y = torch.cat(branches, dim=-1)
        y = F.relu(self.project_bn(self.project_conv(y)))
        return _drop(y, 0.5, self.training, self.use_dropout, generator,
                     uniforms)


class FCNHead(nn.Module):
    """gluoncv ``_FCNHead`` (the aux head on c3)."""

    def __init__(self, in_ch: int, nclass: int, use_dropout: bool = True):
        super().__init__()
        inter = in_ch // 4
        self.use_dropout = use_dropout
        self.conv0 = Conv2d(in_ch, inter, 3, padding=1)
        self.bn0 = BatchNorm(inter)
        self.conv1 = Conv2d(inter, nclass, bias=True)
        self.inter = inter

    def forward(self, x, generator: Optional[torch.Generator] = None,
                uniforms=None):
        x = F.relu(self.bn0(self.conv0(x)))
        x = _drop(x, 0.1, self.training, self.use_dropout, generator,
                  uniforms)
        return self.conv1(x)


class SkipProject(nn.Module):
    def __init__(self, in_ch: int, out_channels: int = 32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_channels)
        self.bn = BatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


_BACKBONE_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                    "resnet152": (3, 8, 36, 3),
                    # the reference's LSUN-finetuned resnet50s: the same
                    # architecture, whose weights arrive as a backbone file
                    "resnet50_lsun": (3, 4, 6, 3),
                    "resnet50_lsun2": (3, 4, 6, 3)}


def _backbone(kind: str, in_channels: int = 3) -> ResNetV1s:
    if kind not in _BACKBONE_LAYERS:
        raise ValueError(f"unknown backbone: {kind}")
    return ResNetV1s(layers=_BACKBONE_LAYERS[kind], dilated=True,
                     in_channels=in_channels)


class DeepLabV3Plus(_DropoutDraws, nn.Module):
    """``forward(x) -> (out,)`` or ``(out, aux)``, NHWC logits at
    ``out_hw``."""

    def __init__(self, nclass: int, backbone: str = "resnet50",
                 aux: bool = True, crop_size: int = 480,
                 in_channels: int = 3, use_dropout: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nclass, self.aux, self.crop_size = nclass, aux, crop_size
        self.backbone = _backbone(backbone, in_channels)
        c1, c3, c4 = self.backbone.out_channels
        self.skip_project = SkipProject(c1, 32)
        self.aspp = ASPP(c4, use_dropout=use_dropout)
        self.head_sep0 = SeparableConv(256 + 32, 256, depth_activation=True)
        self.head_sep1 = SeparableConv(256, 256, depth_activation=True)
        self.head_classifier = Conv2d(256, nclass, bias=True)
        if aux:
            self.auxlayer = FCNHead(c3, nclass, use_dropout=use_dropout)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def _dropout_sites(self):
        sites = [(self.aspp, 256)]
        return sites + [(self.auxlayer, self.auxlayer.inter)] if self.aux \
            else sites

    def forward(self, x, out_hw: Optional[Tuple[int, int]] = None,
                depth=None, generator: Optional[torch.Generator] = None,
                dropout_u: Optional[List[torch.Tensor]] = None):
        out_hw = out_hw or (x.shape[1], x.shape[2])
        u = None if dropout_u is None else iter(dropout_u)
        if depth is not None:  # the inverse-depth plane joins the RGB planes
            x = torch.cat([x, depth.to(x.dtype)], dim=-1)
        c1, c3, c4 = self.backbone(x)
        c1p = self.skip_project(c1)
        y = self.aspp(c4, generator, u)
        y = bilinear_resize(y, c1p.shape[1], c1p.shape[2])
        y = torch.cat([y, c1p], dim=-1)
        y = self.head_sep1(self.head_sep0(y))
        outputs = [bilinear_resize(self.head_classifier(y), *out_hw)]
        if self.aux:
            outputs.append(bilinear_resize(self.auxlayer(c3, generator, u),
                                           *out_hw))
        return tuple(outputs)


class DeepLabV3(_DropoutDraws, nn.Module):
    """Plain DeepLabV3 (no encoder-decoder skip)."""

    def __init__(self, nclass: int, backbone: str = "resnet50",
                 aux: bool = True, in_channels: int = 3,
                 use_dropout: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nclass, self.aux, self.use_dropout = nclass, aux, use_dropout
        self.backbone = _backbone(backbone, in_channels)
        _c1, c3, c4 = self.backbone.out_channels
        self.aspp = ASPP(c4, use_dropout=use_dropout)
        self.head_conv = Conv2d(256, 256, 3, padding=1)
        self.head_bn = BatchNorm(256)
        self.head_classifier = Conv2d(256, nclass, bias=True)
        if aux:
            self.auxlayer = FCNHead(c3, nclass, use_dropout=use_dropout)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def _dropout_sites(self):
        sites = [(self.aspp, 256), (self, 256)]
        return sites + [(self.auxlayer, self.auxlayer.inter)] if self.aux \
            else sites

    def forward(self, x, out_hw: Optional[Tuple[int, int]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_u: Optional[List[torch.Tensor]] = None):
        out_hw = out_hw or (x.shape[1], x.shape[2])
        u = None if dropout_u is None else iter(dropout_u)
        _c1, c3, c4 = self.backbone(x)
        y = self.aspp(c4, generator, u)
        y = F.relu(self.head_bn(self.head_conv(y)))
        y = _drop(y, 0.1, self.training, self.use_dropout, generator, u)
        outputs = [bilinear_resize(self.head_classifier(y), *out_hw)]
        if self.aux:
            outputs.append(bilinear_resize(self.auxlayer(c3, generator, u),
                                           *out_hw))
        return tuple(outputs)


def head_param_groups(model: nn.Module) -> Tuple[List[nn.Parameter],
                                                 List[nn.Parameter]]:
    """(the backbone's parameters, all others): the others (aspp,
    skip_project, head_*, auxlayer) train at ``HEAD_LR_MULT`` times the
    rate."""
    base, head = [], []
    for name, p in model.named_parameters():
        (base if name.split(".")[0] == "backbone" else head).append(p)
    return base, head

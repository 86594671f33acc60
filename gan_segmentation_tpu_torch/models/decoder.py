"""Segmentation decoder over the GAN feature pyramid (PyTorch counterpart of
``gan_segmentation_tpu/models/decoder.py``).

- per scale ``cvt_i``: conv3x3 (in_ch -> feat) + BN + LeakyReLU(0.2)
  + dropout 0.5;
- progressive fusion: concat ``[prev, cvt]``, nearest-2x upsample, then a
  ``DecoderResBlock`` (2 x conv3x3-BN-LReLU, plus a 1x1 shortcut when the
  width changes) — at the last scale a plain conv3x3 to the class logits.

Eval mode: batch norm folds into the conv before it (``fold_bn``), every
3x3 conv runs through kernel 2 (`kernels/small_conv.py`) with the leaky
epilogue fused (none for the final conv), dropout is the identity.

Train mode (``.train()``): every 3x3 conv is ``kernels/conv3x3_grad.py::
Conv3x3`` (kernel 3 where its contract holds, else kernel 2, with the
input gradient through the same kernels), then batch norm over the batch
statistics as the JAX package computes them (``batch_norm_train``; over the
global batch of a data-parallel fit's processes with ``group``), leaky
0.2, and for ``cvt_i`` dropout drawn from the ``torch.Generator`` the caller
passes, or given as the uniform draws ``draw_dropout`` made before (the
static inputs of the train step's CUDA graph; the same bits).

Int8 (``forward_int8``, ``generate --quant``): every conv in s8 from the
state of ``ops/quant.py::prepare_decoder_int8`` (kernel 2's s8 body for
the 3x3 sites, an integer product for the shortcut), the JAX package's
int8 decoder over this layout.

The 1x1 shortcut and the residual add stay plain.  Parameters keep the JAX
package's names (``cvt_0_conv``, ``main_0.bn_0``, ...); BatchNorm2d's
momentum 0.1 is the JAX package's momentum 0.9.
"""

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import SolverConfig
from ..kernels.conv3x3_grad import Conv3x3
from ..kernels.small_conv import conv3x3_small
from ..ops.conv import conv2d
from ..ops.dropout import dropout
from ..ops import quant
from ..ops.norm import batch_norm_train
from ..ops.resize import upsample_nearest_2x
from .layers import hwio

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2
Folded = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def mx_xavier_in(t: torch.Tensor, gen: torch.Generator,
                 magnitude: float = 2.34) -> None:
    """mxnet ``Xavier(factor_type='in', magnitude=2.34)`` in place:
    uniform(-sqrt(magnitude/fan_in), +sqrt(magnitude/fan_in)), fan_in =
    Cin*kh*kw of an OIHW kernel (not ``nn.init.xavier_uniform_``)."""
    fan_in = math.prod(t.shape[1:])
    scale = math.sqrt(magnitude / fan_in)
    with torch.no_grad():  # drawn where ``gen`` lives: the same on any device
        t.copy_(torch.empty(t.shape, device=gen.device).uniform_(
            -scale, scale, generator=gen))


class Conv(nn.Module):
    """A conv's parameters: OIHW ``weight`` and ``bias``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator):
        mx_xavier_in(self.weight, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        """Plain conv (the 1x1 shortcut), in x's dtype."""
        return conv2d(x, hwio(self.weight).to(x.dtype),
                      self.bias.to(x.dtype),
                      padding=self.weight.shape[-1] // 2)


def leaky_relu(x, slope: float = LEAKY_SLOPE):
    """``where(x >= 0, x, slope * x)``, as the JAX package (its gradient at
    0 is 1)."""
    return torch.where(x >= 0, x, slope * x)


def conv3x3_train(conv: "Conv", x):
    """A 3x3 conv with its gradients through the kernels (``Conv3x3``)."""
    return Conv3x3.apply(x, hwio(conv.weight).to(x.dtype), conv.bias)


def conv_bn_lrelu_train(conv: "Conv", bn: Optional[nn.BatchNorm2d], x,
                        group=None):
    """``group``: batch norm over the global batch of its processes."""
    y = conv3x3_train(conv, x)
    if bn is not None:
        y = batch_norm_train(y, bn, group)
    return leaky_relu(y)


@torch.no_grad()
def fold_conv_bn(conv: Conv, bn: Optional[nn.BatchNorm2d],
                 dtype: torch.dtype):
    """-> (HWIO kernel in ``dtype``, f32 bias) of conv followed by eval BN:
    ``w * g/sqrt(var+eps)`` and ``(b - mean) * g/sqrt(var+eps) + beta``.
    Eval constants: no autograd graph, and tensors of their own (without
    BN the bias would otherwise be the parameter itself).  A graph kept
    alive on a parameter would hold its gradient accumulator on the stream
    it was made on, which a later captured train step cannot use."""
    w, b = conv.weight.float(), conv.bias.float()
    if bn is not None:
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
        w = w * s[:, None, None, None]
        b = (b - bn.running_mean.float()) * s + bn.bias.float()
    return hwio(w).to(dtype).contiguous(), b.clone()


class DecoderResBlock(nn.Module):
    def __init__(self, in_ch: int, conv_size: int, use_bn: bool = True):
        super().__init__()
        self.conv_0 = Conv(in_ch, conv_size, 3)
        self.conv_1 = Conv(conv_size, conv_size, 3)
        if use_bn:
            self.bn_0 = nn.BatchNorm2d(conv_size, eps=BN_EPS, momentum=0.1)
            self.bn_1 = nn.BatchNorm2d(conv_size, eps=BN_EPS, momentum=0.1)
        self.shortcut = (Conv(in_ch, conv_size, 1) if conv_size != in_ch
                         else None)

    def fold_bn(self, dtype: torch.dtype, prefix: str) -> Folded:
        return {f"{prefix}.conv_{k}": fold_conv_bn(
            getattr(self, f"conv_{k}"), getattr(self, f"bn_{k}", None), dtype)
            for k in (0, 1)}

    def forward(self, x, folded: Folded, prefix: str):
        y = conv3x3_small(x, *folded[f"{prefix}.conv_0"], leaky=LEAKY_SLOPE)
        y = conv3x3_small(y, *folded[f"{prefix}.conv_1"], leaky=LEAKY_SLOPE)
        sc = x if self.shortcut is None else self.shortcut(x)
        return sc + y

    def forward_train(self, x, group=None):
        y = conv_bn_lrelu_train(self.conv_0, getattr(self, "bn_0", None), x,
                                group)
        y = conv_bn_lrelu_train(self.conv_1, getattr(self, "bn_1", None), y,
                                group)
        sc = x if self.shortcut is None else self.shortcut(x)
        return sc + y


class Decoder(nn.Module):
    """``forward(features) -> logits (N, H, W, num_classes)`` f32;
    ``features`` is the generator pyramid, NHWC, lowest resolution first."""

    def __init__(self, features_cfg: Sequence[int], in_channels: Sequence[int],
                 start_res: int = 0, use_bn: bool = True,
                 use_dropout: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_cfg = tuple(features_cfg)
        self.in_channels = tuple(in_channels)
        self.start_res = start_res
        self.use_bn = use_bn
        self.use_dropout = use_dropout  # the identity in eval mode
        self.compute_dtype = compute_dtype
        f = self.features_cfg
        last = len(self.in_channels) - 1
        for i in range(start_res, last + 1):
            self.add_module(f"cvt_{i}_conv", Conv(self.in_channels[i], f[i], 3))
            if use_bn:
                self.add_module(f"cvt_{i}_bn", nn.BatchNorm2d(
                    f[i], eps=BN_EPS, momentum=0.1))
            # the running prediction (f[i] channels) joins the converted
            # feature from the second scale on
            c_in = f[i] * (2 if i > start_res else 1)
            if i < last:
                self.add_module(f"main_{i}",
                                DecoderResBlock(c_in, f[i + 1], use_bn))
            else:
                self.add_module(f"main_{i}_conv", Conv(c_in, f[i + 1], 3))

    def reset_parameters(self, gen: torch.Generator):
        """The JAX init: every conv kernel Xavier(in, 2.34), biases 0, BN
        scale 1, shift 0, running mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def fold_bn(self, dtype: Optional[torch.dtype] = None) -> Folded:
        """Eval-mode (kernel, bias) of every 3x3 conv with its BN folded in,
        kernels HWIO in ``dtype`` (default: the compute dtype)."""
        dtype = dtype or self.compute_dtype
        last = len(self.in_channels) - 1
        out = {}
        for i in range(self.start_res, last + 1):
            out[f"cvt_{i}"] = fold_conv_bn(getattr(self, f"cvt_{i}_conv"),
                                           getattr(self, f"cvt_{i}_bn", None),
                                           dtype)
            if i < last:
                out.update(getattr(self, f"main_{i}").fold_bn(dtype,
                                                              f"main_{i}"))
            else:
                out[f"main_{i}_conv"] = fold_conv_bn(
                    getattr(self, f"main_{i}_conv"), None, dtype)
        return out

    def dropout_shapes(self, feature_shapes: Sequence[Sequence[int]]
                       ) -> List[Tuple[int, ...]]:
        """The shape of each train-mode dropout draw (one per ``cvt_i``, in
        forward's order), for NHWC features of ``feature_shapes``."""
        f = self.features_cfg
        return [(*feature_shapes[i][:3], f[i])
                for i in range(self.start_res, len(self.in_channels))]

    def draw_dropout(self, feature_shapes, generator: torch.Generator,
                     out: Optional[List[torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
        """The uniform draws of train-mode dropout, made from ``generator``
        up front in the order and shapes in which the forward would make
        them (``torch.rand``), into ``out``'s tensors when given (then
        ``feature_shapes`` is not read)."""
        if out is None:
            out = [torch.empty(s, device=generator.device)
                   for s in self.dropout_shapes(feature_shapes)]
        for u in out:
            u.uniform_(0.0, 1.0, generator=generator)  # what torch.rand draws
        return out

    def forward(self, inputs: List[torch.Tensor],
                folded: Optional[Folded] = None,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                dropout_u: Optional[List[torch.Tensor]] = None,
                group=None):
        """Eval mode: ``folded`` is ``fold_bn(dtype)``, computed here when
        not given.  Train mode: ``dropout_u`` (``draw_dropout``'s draws) or
        else ``generator`` gives the dropout bits (on the features'
        device), and ``group`` (a process group) makes every batch norm's
        statistics those of the global batch.  Activations run in ``dtype``
        (default: the compute dtype)."""
        dtype = dtype or self.compute_dtype
        if self.training:
            return self._forward_train(inputs, dtype, generator, dropout_u,
                                       group)
        folded = folded if folded is not None else self.fold_bn(dtype)
        last = len(self.in_channels) - 1
        prev = pred = None
        for i in range(self.start_res, last + 1):
            x = inputs[i].to(dtype).contiguous()
            x = conv3x3_small(x, *folded[f"cvt_{i}"], leaky=LEAKY_SLOPE)
            if i > self.start_res:
                x = torch.cat([prev, x], dim=-1)
            if i < last:
                x = upsample_nearest_2x(x)
                pred = getattr(self, f"main_{i}")(x, folded, f"main_{i}")
            else:
                pred = conv3x3_small(x, *folded[f"main_{i}_conv"])
            prev = pred
        return pred.float()

    def forward_int8(self, inputs: List[torch.Tensor], q: "quant.QuantState",
                     dtype: Optional[torch.dtype] = None):
        """Eval forward with every conv in s8 (``q`` from
        ``ops/quant.py::prepare_decoder_int8``); logits (N, H, W, classes)
        f32.  Each conv's output is dequantized into ``dtype``, where the
        leaky, concat and residual add run as on the float path.  A block
        stage (``i >= q.first_block``) runs conv_0 on the coarse grid with
        4 x Cout channels and one depth-to-space; the shortcut runs on the
        coarse grid on conv_0's quantized input, then the nearest-2x
        upsample (the same integers)."""
        dtype = dtype or self.compute_dtype
        last = len(self.in_channels) - 1
        prev = None
        for i in range(self.start_res, last + 1):
            x = quant.qconv3x3(inputs[i].to(dtype), q[f"cvt_{i}"], "leaky",
                               dtype)
            if i > self.start_res:
                x = torch.cat([prev, x], dim=-1)
            if i == last:
                return quant.qconv3x3(x, q[f"main_{i}_conv"], None,
                                      dtype).float()
            name = f"main_{i}"
            k0 = q[f"{name}.conv_0"]
            xq = quant.quantize_act(x, k0.inv)
            if i >= q.first_block:
                y = quant.depth_to_space(quant.qconv3x3(
                    None, k0, "leaky", dtype, xq=xq))
            else:
                y = quant.qconv3x3(None, k0, "leaky", dtype,
                                   xq=upsample_nearest_2x(xq))
            y = quant.qconv3x3(y, q[f"{name}.conv_1"], "leaky", dtype)
            sc = q.get(f"{name}.shortcut")
            if sc is not None:  # conv_0's scale (check_shortcut_scales)
                x = quant.qconv1x1(None, sc, dtype, xq=xq)
            prev = upsample_nearest_2x(x) + y

    def _forward_train(self, inputs, dtype, generator, dropout_u=None,
                       group=None):
        if self.use_dropout and generator is None and dropout_u is None:
            raise ValueError("train mode with dropout needs a "
                             "torch.Generator for the dropout bits")
        last = len(self.in_channels) - 1
        prev = pred = None
        for i in range(self.start_res, last + 1):
            x = inputs[i].to(dtype).contiguous()
            x = conv_bn_lrelu_train(getattr(self, f"cvt_{i}_conv"),
                                    getattr(self, f"cvt_{i}_bn", None), x,
                                    group)
            if self.use_dropout:
                x = dropout(x, generator, uniform=None if dropout_u is None
                            else dropout_u[i - self.start_res])
            if i > self.start_res:
                x = torch.cat([prev, x], dim=-1)
            if i < last:
                x = upsample_nearest_2x(x)
                pred = getattr(self, f"main_{i}").forward_train(x, group)
            else:
                pred = conv3x3_train(getattr(self, f"main_{i}_conv"), x)
            prev = pred
        return pred.float()


def decoder_from_config(cfg: SolverConfig,
                        compute_dtype: torch.dtype = torch.float32) -> Decoder:
    return Decoder(features_cfg=cfg.features, in_channels=cfg.in_channels,
                   start_res=cfg.start_res, use_bn=cfg.use_bn,
                   use_dropout=cfg.use_dropout, compute_dtype=compute_dtype)

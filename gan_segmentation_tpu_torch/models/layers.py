"""Weight-scaled generator layers (PyTorch counterparts of
``gan_segmentation_tpu/models/layers.py``).

Activations are NHWC.  Parameters are stored in PyTorch's layouts (dense
(out, in), conv OIHW, transposed conv (Cin, Cout, kh, kw)) at unit scale;
the wscale multiplier ``gain / sqrt(fan_in) * lr_mult`` is applied at run
time, as in the JAX package, so ``core/params_bridge.py`` maps layouts only.
Parameters are f32; each layer computes in its ``compute_dtype``.
Random init mirrors the JAX init: dense N(0, 1/lr_mult), conv N(0, 1),
biases, noise scales zero.

Int8 (``ops/quant.py``): ``Conv2DW`` and ``Conv2DTransposeW`` take an
optional ``q`` (the site's ``QConv``, the JAX package's ``quant``
collection entry) and then run s8: the input quantized against its static
scale, the kernel quantized from ``int8_kernel()`` (f32, the JAX package's
orientation and composition).  Calibration records each conv input's
absmax (``ops/quant.py::record_absmax``, the JAX package's ``qstats``
sow).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.adain_fused import adain_apply
from ..ops import quant
from ..ops.blur import blur_3x3
from ..ops.conv import (_UP2, compose_kernel_2d, conv2d, conv_transpose2d,
                        upsample2x_conv2d)
from ..ops.wscale import wscale_std

SQRT2 = math.sqrt(2)


def leaky_relu(x, slope: float = 0.2):
    return torch.where(x >= 0, x, slope * x)


def hwio(w_oihw):
    """OIHW -> HWIO view (the layout of the ops and kernels)."""
    return w_oihw.permute(2, 3, 1, 0)


class DenseW(nn.Module):
    """`networks_stylegan.py:479-531`.  ``lr_mult`` scales both the weight
    and the bias at run time."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 use_wscale: bool = True, gain: float = SQRT2,
                 lr_mult: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lr_mult = lr_mult
        self.scale = lr_mult * (wscale_std((in_features, features), gain)
                                if use_wscale else 1.0)
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / self.lr_mult, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        cd = self.compute_dtype
        # inputs rounded to the compute dtype, products summed in f32
        y = F.linear(x.to(cd).float(), (self.weight * self.scale).to(cd).float())
        if self.bias is not None:
            y = y + self.bias * self.lr_mult
        return y.to(cd)


class Conv2DW(nn.Module):
    """`networks_stylegan.py:446-457`: conv with run-time wscale.
    ``up2x`` computes ``conv(upsample_nearest_2x(x))``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 padding: int = 1, use_bias: bool = True,
                 use_wscale: bool = True, gain: float = SQRT2,
                 lr_mult: float = 1.0, up2x: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.padding = padding
        self.up2x = up2x
        self.lr_mult = lr_mult
        self.scale = lr_mult * (wscale_std((k, k, in_ch, features), gain)
                                if use_wscale else 1.0)
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def effective_weight(self):
        """The wscaled HWIO kernel in the compute dtype."""
        return hwio(self.weight * self.scale).to(self.compute_dtype)

    def int8_kernel(self):
        """The f32 kernel the int8 site quantizes: the wscaled HWIO kernel,
        with ``up2x`` composed with the nearest-2x filter into the 4x4
        kernel over the zero-inserted input (the JAX package's
        ``compose_kernel_2d(k_eff, _UP2)``)."""
        k = hwio(self.weight * self.scale).float()
        return compose_kernel_2d(k, _UP2) if self.up2x else k

    def forward(self, x, q=None):
        """``q``: the site's int8 state (``ops/quant.py::QConv``), or None
        for the float conv."""
        cd = self.compute_dtype
        x = x.to(cd)
        if q is not None:  # up2x (sub-pixel) or to_rgb (1x1): conv_2's
            # 3x3 runs kernel 1's s8 body in StyleBlock
            if self.up2x:
                return quant.qsubpixel(x, q, cd)
            return quant.qconv1x1(x, q, cd)
        b = None if self.bias is None else (self.bias * self.lr_mult).to(cd)
        if self.up2x:
            return upsample2x_conv2d(x, self.effective_weight(), b,
                                     padding=self.padding)
        return conv2d(x, self.effective_weight(), b, padding=self.padding)


class Conv2DTransposeW(nn.Module):
    """`networks_stylegan.py:460-476`: the k4 s2 p1 fused-upscale deconv.
    Its wscale fan-in counts the INPUT channels, as mxnet does."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, use_wscale: bool = True,
                 gain: float = SQRT2, lr_mult: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.scale = lr_mult * (wscale_std((k, k, in_ch, features), gain)
                                if use_wscale else 1.0)
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(in_ch, features, k, k))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=gen)

    def int8_kernel(self):
        """The f32 kernel the int8 site quantizes: the JAX package's flipped
        conv-equivalent HWIO kernel (k4 s2 p1: a 4x4 conv over the
        2-dilated input, padding 2)."""
        return (self.weight * self.scale).permute(2, 3, 0, 1).flip(0, 1)

    def forward(self, x, q=None):
        """``q``: the site's int8 state, or None for the float deconv."""
        if q is not None:
            return quant.qsubpixel(x.to(self.compute_dtype), q,
                                   self.compute_dtype)
        # back to the JAX package's flipped conv-equivalent HWIO kernel
        w = (self.weight * self.scale).permute(2, 3, 0, 1).flip(0, 1)
        return conv_transpose2d(x.to(self.compute_dtype),
                                w.to(self.compute_dtype),
                                stride=self.stride, padding=self.padding)


class Bias(nn.Module):
    """Broadcast per-channel bias (`networks_stylegan.py:534-545`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return x + self.bias.to(x.dtype)


class AddNoise(nn.Module):
    """Per-channel-scaled spatial gaussian noise (`networks_stylegan.py:
    267-305`).  The noise is (N, H, W, 1) f32: given explicitly, or drawn
    from the ``torch.Generator`` passed in."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale_factors = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.scale_factors.zero_()

    @staticmethod
    def draw(x, generator: Optional[torch.Generator]):
        n, h, w, _ = x.shape
        return torch.randn((n, h, w, 1), generator=generator,
                           device=x.device, dtype=torch.float32)

    def forward(self, x, noise=None, generator=None):
        if noise is None:
            noise = self.draw(x, generator)
        return x + (noise * self.scale_factors).to(x.dtype)


class AdaIN(nn.Module):
    """Instance norm + per-style affine (`networks_stylegan.py:239-264`):
    ``instance_norm(x) * (ys + 1) + yb`` with ``(ys, yb) = affine(w)``; the
    affine's gain is 1.  The apply is one pass over x
    (``kernels/adain_fused.py::adain_apply``)."""

    def __init__(self, channels: int, w_dim: int, use_wscale: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = channels
        self.affine = DenseW(w_dim, 2 * channels, use_bias=True, gain=1.0,
                             use_wscale=use_wscale,
                             compute_dtype=compute_dtype)

    def forward(self, x, w):
        xf = x.float()
        return self.apply_stats(x.contiguous(), xf.sum(dim=(1, 2)),
                                (xf * xf).sum(dim=(1, 2)), w,
                                count=x.shape[1] * x.shape[2])

    def apply_stats(self, x, mean, var, w, count: int = 0):
        """The same, from statistics computed elsewhere: (mean, var) as
        kernel 1 returns them, or with ``count`` > 0 the sums of v and v^2
        over ``count`` pixels as pass A
        (``adain_fused.noise_bias_lrelu_stats``) returns them."""
        y = self.affine(w)
        c = self.channels
        return adain_apply(x, mean, var, y[:, :c], y[:, c:], count=count)


class Blur(nn.Module):
    """[1,2,1] depthwise blur (`networks_stylegan.py:200-236`)."""

    def forward(self, x):
        return blur_3x3(x)


def minibatch_std_layer(x, group_size: int):
    """`networks_stylegan.py:327-345` (discriminator-side): append a feature
    map holding the per-group mean feature stddev, NHWC (the JAX package's
    ``minibatch_std_layer``, on no path of the port)."""
    n, h, w, c = x.shape
    if n % group_size:
        raise ValueError(f"batch {n} is not a multiple of the group size "
                         f"{group_size}")
    y = x.float().reshape(group_size, n // group_size, h, w, c)
    y = y - y.mean(dim=0, keepdim=True)
    y = (y * y).mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(1, 2, 3), keepdim=True)            # (M, 1, 1, 1)
    y = y.repeat(group_size, h, w, 1).to(x.dtype)      # (N, H, W, 1)
    return torch.cat([x, y], dim=-1)


def normal_with_l2_norm(sigma: float = 0.01):
    """`networks_stylegan.py:548-555`: an initializer drawing N(0, sigma),
    then scaling the whole array to unit L2 norm.  ``init(generator, shape,
    dtype)``: the draws come from the ``torch.Generator`` given (the JAX
    package's takes a PRNG key)."""

    def init(generator: torch.Generator, shape, dtype=torch.float32):
        arr = sigma * torch.randn(shape, generator=generator,
                                  device=generator.device, dtype=dtype)
        return arr / (torch.linalg.vector_norm(arr) + 1e-12)

    return init

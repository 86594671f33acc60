"""Convolutions on NHWC activations with HWIO weights.

The JAX package's layouts (``gan_segmentation_tpu/ops/conv.py``) are kept at
these functions; inside, an NHWC tensor viewed as NCHW is PyTorch's
``channels_last`` layout, so ``F.conv2d`` reads and writes it without copies.
These ops were composed by XLA on the TPU (no Pallas kernel), so they run
through ``F.conv2d`` / ``F.conv_transpose2d`` here.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .resize import upsample_nearest_2x


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def conv2d(x, w, b=None, *, stride: int = 1, padding=0, groups: int = 1,
           dilation: int = 1):
    """x: (N,H,W,C), w: (kh,kw,Cin/groups,Cout); cross-correlation with
    zero padding, as mxnet ``Convolution``.  ``padding`` is one int for
    both sides of both spatial dims, or a (begin, end) pair."""
    return conv2d_oihw(x, _oihw(w), b, stride=stride, padding=padding,
                       groups=groups, dilation=dilation)


def conv2d_oihw(x, w, b=None, *, stride: int = 1, padding=0,
                groups: int = 1, dilation: int = 1):
    """``conv2d`` with the kernel as PyTorch keeps it, (Cout, Cin/groups,
    kh, kw)."""
    x = _nchw(x)
    if not isinstance(padding, int):
        beg, end = padding
        if beg != end:
            x, padding = F.pad(x, (beg, end, beg, end)), 0
        else:
            padding = beg
    y = _nhwc(F.conv2d(x, w, stride=stride, padding=padding,
                       dilation=dilation, groups=groups))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def depthwise_conv2d(x, w, b=None, *, stride: int = 1, padding: int = 0):
    """w is (kh, kw, 1, C): one filter per input channel."""
    c = x.shape[-1]
    if w.shape[2] != 1 or w.shape[3] != c:
        raise ValueError(f"depthwise kernel {tuple(w.shape)} for {c} channels")
    return conv2d(x, w, b, stride=stride, padding=padding, groups=c)


def upsample2x_conv2d(x, w, b=None, *, padding: int = 1):
    """``conv2d(upsample_nearest_2x(x), w, padding)`` — the composition the
    JAX package runs as one input-dilated conv (exact up to reassociation,
    `gan_segmentation_tpu/ops/conv.py::upsample2x_conv2d`)."""
    return conv2d(upsample_nearest_2x(x), w, b, padding=padding)


def conv_transpose2d(x, w, b=None, *, stride: int = 2, padding: int = 1):
    """mxnet ``Deconvolution(kernel=k, stride, pad)``; ``w`` is (kh, kw, Cin,
    Cout) in the JAX package's conv-equivalent, spatially FLIPPED
    orientation, so PyTorch's weight is ``w[::-1, ::-1]`` as (Cin, Cout, kh,
    kw)."""
    wt = w.flip(0, 1).permute(2, 3, 0, 1)
    y = _nhwc(F.conv_transpose2d(_nchw(x), wt, stride=stride,
                                 padding=padding))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def compose_kernel_2d(w, f):
    """Compose a constant 2-D filter into an HWIO kernel (a copy of
    ``gan_segmentation_tpu/ops/conv.py::compose_kernel_2d``, pinned to it by
    ``tests/test_torch_quant.py``): ``correlate(correlate(x, w), f) ==
    correlate(x, compose_kernel_2d(w, f))`` with the two paddings summed,
    exact where the intermediate's zero padding is genuinely zero (the
    nearest-2x upsample).  The full 2-D convolution ``C[m] = sum_{k+j=m}
    w[k] * f[j]``, shape (kh+fh-1, kw+fw-1, ci, co)."""
    kh, kw, ci, co = w.shape
    f = torch.as_tensor(np.asarray(f), dtype=w.dtype, device=w.device)
    fh, fw = f.shape
    wb = w.permute(2, 3, 0, 1).reshape(ci * co, 1, kh, kw)
    fk = f.flip(0, 1)[None, None]  # correlate with flipped f == convolve
    out = F.conv2d(wb, fk, padding=(fh - 1, fw - 1))
    return out.reshape(ci, co, kh + fh - 1, kw + fw - 1).permute(2, 3, 0, 1)


# the nearest-2x upsample as a filter over the zero-inserted input
_UP2 = np.ones((2, 2), np.float32)

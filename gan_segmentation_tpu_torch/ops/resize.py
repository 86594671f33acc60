"""Resize ops on NHWC tensors.

``bilinear_resize`` is mxnet ``contrib.BilinearResize2D``: ALIGN-CORNERS
sampling (``scale = (in - 1) / (out - 1)``), which is
``F.interpolate(mode="bilinear", align_corners=True)``;
``tests/test_torch_deeplab.py`` holds it to the JAX package's two
gather-and-lerp passes within 1e-5, the sizes 1 -> n and n -> 1 included.
On a CUDA device its gradient is the transposed resize as two products
with the interpolation matrices: ``F.interpolate``'s backward there adds
with atomics, so no two runs of a train step (eager or a CUDA graph's
replay) would give the same gradients.
"""

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int, device: torch.device):
    """(n_out, n_in) f32 weights of align-corners linear interpolation,
    built once per size and device (a CUDA graph's capture reads them)."""
    with torch.inference_mode(False), torch.no_grad():
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        pos = torch.arange(n_out, dtype=torch.float64, device=device) * scale
        lo = pos.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(max=n_in - 1)
        frac = pos - lo
        rows = torch.arange(n_out, device=device)
        m = torch.zeros((n_out, n_in), dtype=torch.float64, device=device)
        m.index_put_((rows, lo), 1.0 - frac, accumulate=True)
        m.index_put_((rows, hi), frac, accumulate=True)
        return m.float()


class _BilinearAC(torch.autograd.Function):
    """NCHW align-corners bilinear resize whose backward is
    ``A_h^T @ grad @ A_w`` (fixed-order products, no atomics)."""

    @staticmethod
    def forward(ctx, x, out_h: int, out_w: int):
        ctx.in_hw = x.shape[2:]
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=True)

    @staticmethod
    def backward(ctx, grad):
        (h, w), (oh, ow) = ctx.in_hw, grad.shape[2:]
        ah = _interp_matrix(h, oh, grad.device)
        aw = _interp_matrix(w, ow, grad.device)
        return torch.matmul(torch.matmul(ah.t(), grad.float()), aw), None, \
            None


def upsample_nearest_2x(x):
    """(N,H,W,C) -> (N,2H,2W,C), nearest neighbour (mxnet ``UpSampling``)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def upsample_nearest(x, scale: int):
    """(N,H,W,C) -> (N,scale*H,scale*W,C), nearest neighbour, any integer
    factor (``gan_segmentation_tpu/ops/resize.py::upsample_nearest``)."""
    if scale == 1:
        return x
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return x.reshape(n, scale * h, scale * w, c)


def bilinear_resize(x, out_h: int, out_w: int):
    """Align-corners bilinear resize, (N,H,W,C) -> (N,out_h,out_w,C),
    computed in f32 and cast back; the identity when the size stays."""
    n, h, w, c = x.shape
    if h == out_h and w == out_w:
        return x
    xf = x.float().permute(0, 3, 1, 2)
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        y = _BilinearAC.apply(xf, out_h, out_w)
    else:
        y = F.interpolate(xf, size=(out_h, out_w), mode="bilinear",
                          align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x, keepdims: bool = True):
    """mxnet ``GlobalAvgPool2D``: the mean over H, W in f32, in x's dtype."""
    return torch.mean(x.float(), dim=(1, 2), keepdim=keepdims).to(x.dtype)

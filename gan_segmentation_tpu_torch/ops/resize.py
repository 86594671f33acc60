"""Resize ops on NHWC tensors.

``bilinear_resize`` is mxnet ``contrib.BilinearResize2D``: ALIGN-CORNERS
sampling (``scale = (in - 1) / (out - 1)``), which is
``F.interpolate(mode="bilinear", align_corners=True)``;
``tests/test_torch_deeplab.py`` holds it to the JAX package's two
gather-and-lerp passes within 1e-5, the sizes 1 -> n and n -> 1 included.
"""

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x):
    """(N,H,W,C) -> (N,2H,2W,C), nearest neighbour (mxnet ``UpSampling``)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def bilinear_resize(x, out_h: int, out_w: int):
    """Align-corners bilinear resize, (N,H,W,C) -> (N,out_h,out_w,C),
    computed in f32 and cast back; the identity when the size stays."""
    n, h, w, c = x.shape
    if h == out_h and w == out_w:
        return x
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x, keepdims: bool = True):
    """mxnet ``GlobalAvgPool2D``: the mean over H, W in f32, in x's dtype."""
    return torch.mean(x.float(), dim=(1, 2), keepdim=keepdims).to(x.dtype)

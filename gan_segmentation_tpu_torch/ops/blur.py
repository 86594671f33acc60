"""The [1,2,1] x [1,2,1] / 16 depthwise blur after every generator upsample
(`networks_stylegan.py:200-236`), stride 1, pad 1."""

import torch

from .conv import depthwise_conv2d


def blur_kernel(channels: int, dtype=torch.float32, device=None):
    """(3, 3, 1, C) depthwise HWIO kernel, sum == 1 per channel."""
    k = torch.tensor([1.0, 2.0, 1.0])
    k2d = torch.outer(k, k)
    k2d = k2d / k2d.sum()
    w = k2d[:, :, None, None].expand(3, 3, 1, channels)
    return w.to(dtype=dtype, device=device).contiguous()


def blur_3x3(x):
    return depthwise_conv2d(x, blur_kernel(x.shape[-1], x.dtype, x.device),
                            padding=1)

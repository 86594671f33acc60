"""The [1,2,1] x [1,2,1] / 16 depthwise blur after every generator upsample
(`networks_stylegan.py:200-236`), stride 1, pad 1.  ``blur_3x3`` builds its
kernel once per (channels, dtype, device): built per call it is a copy from
host memory, which a CUDA graph cannot capture."""

import functools

import torch

from .conv import depthwise_conv2d


def blur_kernel(channels: int, dtype=torch.float32, device=None):
    """(3, 3, 1, C) depthwise HWIO kernel, sum == 1 per channel."""
    k = torch.tensor([1.0, 2.0, 1.0])
    k2d = torch.outer(k, k)
    k2d = k2d / k2d.sum()
    w = k2d[:, :, None, None].expand(3, 3, 1, channels)
    return w.to(dtype=dtype, device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _cached_kernel(channels: int, dtype, device):
    with torch.inference_mode(False):  # usable outside inference mode too
        return blur_kernel(channels, dtype, device)


def blur_3x3(x):
    return depthwise_conv2d(
        x, _cached_kernel(x.shape[-1], x.dtype, x.device), padding=1)

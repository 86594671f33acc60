"""Normalization primitives on NHWC tensors (statistics always in f32).

- ``pixel_norm``: x * rsqrt(mean(x^2 over channels) + 1e-8).
- ``instance_norm``: per-(N, C) standardization over H, W with one-pass
  moments and the variance clamped at 0, eps 1e-5.
- ``instance_norm_apply``: the same normalization from statistics computed
  elsewhere — kernel 1 (`kernels/conv_in_stats.py`) returns an UNclamped
  variance, so the clamp lives here.
"""

import torch


def pixel_norm(x, eps: float = 1e-8, dim: int = -1):
    xf = x.float()
    denom = torch.rsqrt(torch.mean(xf * xf, dim=dim, keepdim=True) + eps)
    return (xf * denom).to(x.dtype)


def instance_norm_apply(x, mean, var, eps: float = 1e-5):
    """(x - mean) * rsqrt(max(var, 0) + eps); mean and var are (N, C) f32."""
    mean = mean[:, None, None, :]
    var = torch.clamp_min(var, 0.0)[:, None, None, :]
    return ((x.float() - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm(x, eps: float = 1e-5):
    """(N, H, W, C): standardize each (n, c) slice over H, W.  No affine."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    var = (xf * xf).mean(dim=(1, 2)) - mean * mean
    return instance_norm_apply(x, mean, var, eps)

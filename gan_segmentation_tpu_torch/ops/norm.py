"""Normalization primitives on NHWC tensors (statistics always in f32).

- ``pixel_norm``: x * rsqrt(mean(x^2 over channels) + 1e-8).
- ``instance_norm``: per-(N, C) standardization over H, W with one-pass
  moments and the variance clamped at 0, eps 1e-5.
- ``instance_norm_apply``: the same normalization from statistics computed
  elsewhere — kernel 1 (`kernels/conv_in_stats.py`) returns an UNclamped
  variance, so the clamp lives here.
- ``batch_norm_train`` / ``batch_norm``: the JAX package's ``BatchNorm``
  (momentum 0.9, i.e. PyTorch's 0.1), whose train mode folds the BIASED
  batch variance into the running variance; the first is the formula
  written out (the decoder's), the second goes through ``F.batch_norm``
  (the DeepLab stack's, 57 of them in a resnet50 DeepLabV3+).
"""

import torch
import torch.nn.functional as F
from torch import nn


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


def batch_norm_train(x, bn: nn.BatchNorm2d):
    """Train-mode batch norm of NHWC ``x`` as the JAX package's
    ``BatchNorm`` computes it, updating ``bn``'s running statistics in
    place.

    Statistics in f32 over (N, H, W): ``mean = E[x]`` and the BIASED
    variance ``max(E[x^2] - mean^2, 0)`` (the JAX side's fast variance).
    The running update is ``ra = 0.9 ra + 0.1 stat`` with that biased variance;
    ``nn.BatchNorm2d``'s train mode would fold in the unbiased variance
    instead, which at batch 1 and 4x4 is 16/15 of it.  Output
    ``(x - mean) * rsqrt(var + eps) * scale + shift`` in x's dtype."""
    xf = x.float()
    dims = (0, 1, 2)
    mean = xf.mean(dim=dims)
    var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
    with torch.no_grad():
        keep = 1.0 - bn.momentum
        bn.running_mean.mul_(keep).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(keep).add_(var, alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean) * mul + bn.bias).to(x.dtype)


def batch_norm(x, bn: nn.BatchNorm2d, train: bool):
    """Batch norm of NHWC ``x`` in x's dtype with f32 parameters and
    statistics, through ``F.batch_norm`` (one fused forward and one fused
    backward kernel).

    Eval mode normalises with the running statistics.  Train mode
    normalises with the batch's and updates the running ones as the JAX
    package does.  ``F.batch_norm`` would fold in the UNBIASED variance
    ``n/(n-1) var``, and autograd keeps the buffers it is given for the
    backward, so it is given two scratch (C,) buffers with momentum 1,
    which come back holding the batch mean and the unbiased variance; the
    running statistics then take ``ra = 0.9 ra + 0.1 stat`` with the
    variance scaled by ``(n-1)/n``.  No second pass over ``x``.  A single
    value per channel (``n == 1``, the ASPP pooling branch at batch 1),
    which ``F.batch_norm`` refuses, takes the written-out formula."""
    if not train:
        y = F.batch_norm(x.permute(0, 3, 1, 2), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, False, 0.0,
                         bn.eps)
        return y.permute(0, 2, 3, 1)
    n = x.numel() // x.shape[-1]
    if n == 1:
        return batch_norm_train(x, bn)
    mean, var = torch.zeros_like(bn.running_mean), torch.zeros_like(
        bn.running_var)
    y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, bn.weight, bn.bias,
                     True, 1.0, bn.eps)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var * ((n - 1) / n), bn.momentum)
        bn.num_batches_tracked.add_(1)
    return y.permute(0, 2, 3, 1)

"""Normalization primitives on NHWC tensors (statistics always in f32).

- ``pixel_norm``: x * rsqrt(mean(x^2 over channels) + 1e-8).
- ``instance_norm``: per-(N, C) standardization over H, W with one-pass
  moments and the variance clamped at 0, eps 1e-5.
- ``instance_norm_apply``: the same normalization from statistics computed
  elsewhere (kernel 1, `kernels/conv_in_stats.py`, returns an UNclamped
  variance, so the clamp lives here).  The generator applies AdaIN in one
  pass with the same arithmetic (`kernels/adain_fused.py::adain_apply`);
  these two are the references its tests hold it to.
- ``batch_norm_train`` / ``batch_norm``: the JAX package's ``BatchNorm``
  (momentum 0.9, i.e. PyTorch's 0.1), whose train mode folds the BIASED
  batch variance into the running variance; the first is the formula
  written out (the decoder's), the second goes through ``F.batch_norm``
  (the DeepLab stack's, 57 of them in a resnet50 DeepLabV3+).
- ``group`` (a ``torch.distributed`` process group, or None): the
  statistics of train mode span the GLOBAL batch of every process of the
  group, as the JAX package's ``BatchNorm`` does under a data mesh (the
  reference's SyncBatchNorm), through ``batch_norm_global``: forward, one
  ``all_reduce`` of (sum x, sum x^2, count); backward, one of (sum dy,
  sum dy * xhat).  The running variance stays the biased one, which is
  why ``nn.SyncBatchNorm`` (unbiased) is not used.  On the CPU it is the
  formula written out (``GlobalBatchNorm``); on a card the per-process
  work goes through torch's fused batch-norm primitives
  (``FusedGlobalBatchNorm``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..core.distributed import all_reduce as _all_reduce


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


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of NHWC ``x`` over the global batch of
    ``group``, written out.  -> (y in x's dtype, mean, biased var), the
    statistics f32 and not differentiable.  The input gradient uses the
    global sums of dy and dy * xhat; the scale and shift gradients are this
    process's own sums (the step averages them over the processes with
    every other gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        c = x.shape[-1]
        dims = tuple(range(x.dim() - 1))
        sums = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                          xf.new_full((1,), xf.numel() // c)])
        sums = _all_reduce(sums, group)
        count = sums[2 * c]
        mean = sums[:c] / count
        var = torch.clamp_min(sums[c:2 * c] / count - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean) * invstd
        ctx.save_for_backward(xhat, invstd, weight, count)
        ctx.group, ctx.dtype = group, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return (xhat * weight + bias).to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight, count = ctx.saved_tensors
        dyf = dy.float()
        c = xhat.shape[-1]
        dims = tuple(range(xhat.dim() - 1))
        sum_dy = dyf.sum(dim=dims)
        sum_dy_xhat = (dyf * xhat).sum(dim=dims)
        g = _all_reduce(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        dx = (dyf - g[:c] / count - xhat * (g[c:] / count)) * (
            invstd * weight)
        return dx.to(ctx.dtype), sum_dy_xhat, sum_dy, None, None


class FusedGlobalBatchNorm(torch.autograd.Function):
    """``GlobalBatchNorm`` on a card through torch's fused primitives:
    ``batch_norm_stats`` (this process's mean and variance, one pass),
    ``batch_norm_elemt``, ``batch_norm_backward_reduce`` and
    ``batch_norm_backward_elemt``, with the same two ``all_reduce`` calls.
    x's layout is NHWC, which the primitives read as channels-last NCHW."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[-1]
        xc = x.contiguous().permute(0, 3, 1, 2)
        n = x.numel() // c
        mean_r, istd_r = torch.batch_norm_stats(xc, 0.0)
        mean_r, istd_r = mean_r.float(), istd_r.float()
        var_r = torch.where(istd_r > 0, istd_r.reciprocal().square(),
                            torch.zeros_like(istd_r))
        sums = torch.cat([mean_r * n, (var_r + mean_r * mean_r) * n,
                          mean_r.new_full((1,), n)])
        sums = _all_reduce(sums, group)
        count = sums[2 * c]
        mean = sums[:c] / count
        var = torch.clamp_min(sums[c:2 * c] / count - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        y = torch.batch_norm_elemt(xc, weight, bias, mean, invstd, eps)
        ctx.save_for_backward(xc, mean, invstd, weight,
                              count.to(torch.int32).reshape(1))
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.permute(0, 2, 3, 1), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xc, mean, invstd, weight, count = ctx.saved_tensors
        c = xc.shape[1]
        dyc = dy.contiguous().permute(0, 3, 1, 2)
        sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
            dyc, xc, mean, invstd, weight, True, True, True)
        g = _all_reduce(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
        dx = torch.batch_norm_backward_elemt(
            dyc, xc, mean, invstd, weight, g[:c].contiguous(),
            g[c:].contiguous(), count)
        return dx.permute(0, 2, 3, 1), dw, db, None, None


def batch_norm_global(x, bn: nn.BatchNorm2d, group, fused=None):
    """Train-mode batch norm of NHWC ``x`` over the global batch of
    ``group``, updating ``bn``'s running statistics with the global mean
    and BIASED variance.  ``fused``: the card's version (default: on a CUDA
    tensor), else the written-out one."""
    fused = x.is_cuda if fused is None else fused
    fn = FusedGlobalBatchNorm if fused else GlobalBatchNorm
    y, mean, var = fn.apply(x, bn.weight, bn.bias, bn.eps, group)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked.add_(1)
    return y


def batch_norm_train(x, bn: nn.BatchNorm2d, group=None):
    """Train-mode batch norm of NHWC ``x`` as the JAX package's
    ``BatchNorm`` computes it, updating ``bn``'s running statistics in
    place.

    Statistics in f32 over (N, H, W): ``mean = E[x]`` and the BIASED
    variance ``max(E[x^2] - mean^2, 0)`` (the JAX side's fast variance).
    The running update is ``ra = 0.9 ra + 0.1 stat`` with that biased variance;
    ``nn.BatchNorm2d``'s train mode would fold in the unbiased variance
    instead, which at batch 1 and 4x4 is 16/15 of it.  Output
    ``(x - mean) * rsqrt(var + eps) * scale + shift`` in x's dtype.
    ``group``: over the global batch (``batch_norm_global``)."""
    if group is not None:
        return batch_norm_global(x, bn, group)
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


def batch_norm(x, bn: nn.BatchNorm2d, train: bool, group=None):
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
    which ``F.batch_norm`` refuses, takes the written-out formula.
    ``group``: train mode over the global batch (``batch_norm_global``)."""
    if train and group is not None:
        return batch_norm_global(x, bn, group)
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

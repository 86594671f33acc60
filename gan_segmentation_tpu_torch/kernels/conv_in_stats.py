"""Kernel 1: conv3x3 + noise + bias + leaky-relu with instance-norm statistics.

CUDA source: ``csrc/conv_in_stats.cu``, bound as the custom op
``torch.ops.gst.conv3x3_in_stats`` (``kernels/ops.py``): bf16 runs the
tensor-core implicit GEMM of ``csrc/conv3x3_tc.cuh`` (launch plan:
``tc_plan.plan``), f32 the 3xTF32 one of ``csrc/conv3x3_tf32.cuh``
(``tc_plan.plan_f32``).  Replaces
the TPU kernel
``experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats``
and keeps its contract: NHWC / HWIO, stride 1, pad 1, ``w`` the effective
(wscaled) kernel, ``noise`` (N, H, W) f32, ``nscale`` and ``bias`` (Cout,) f32;
``y`` in x's dtype; ``mean`` and ``var`` (N, Cout) f32 taken from the f32
epilogue values, with ``var = E[y^2] - mean^2`` NOT clamped — the consumer
(`ops.norm.instance_norm_apply`) clamps.  Unlike Pallas, any H and W run.
"""

import torch
import torch.nn.functional as F

from . import _build


def conv3x3_noise_bias_lrelu_instats_plain(x, w, noise, nscale, bias, *,
                                           leaky: float = 0.2):
    """The plain PyTorch version: the CPU path and the kernel's reference."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).float()
    y = y + noise.float()[..., None] * nscale.float() + bias.float()
    y = torch.where(y >= 0, y, leaky * y)
    mean = y.mean(dim=(1, 2))
    var = (y * y).mean(dim=(1, 2)) - mean * mean
    return y.to(x.dtype), mean, var


def check_args(x, w, noise, nscale, bias):
    """Raise unless the arguments are what the kernel takes (one device,
    contiguous, the contract's shapes and dtypes); -> (n, h, w, cin,
    cout)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, wd, cin = x.shape
    if w.dim() != 4:
        raise ValueError(f"w must be HWIO, got shape {tuple(w.shape)}")
    cout = w.shape[3]
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    dev = x.device
    _build.check(x, "x", (n, h, wd, cin), x.dtype, dev)
    _build.check(w, "w", (3, 3, cin, cout), x.dtype, dev)
    _build.check(noise, "noise", (n, h, wd), torch.float32, dev)
    _build.check(nscale, "nscale", (cout,), torch.float32, dev)
    _build.check(bias, "bias", (cout,), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, h, wd, cin, cout


def conv3x3_noise_bias_lrelu_instats(x, w, noise, nscale, bias, *,
                                     leaky: float = 0.2):
    """-> (y, mean, var), through the custom op
    ``torch.ops.gst.conv3x3_in_stats`` (``kernels/ops.py``).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    check_args(x, w, noise, nscale, bias)
    return torch.ops.gst.conv3x3_in_stats(x, w, noise, nscale, bias,
                                          float(leaky))


conv3x3_noise_bias_lrelu_instats.launches = 0  # counted in kernels/ops.py

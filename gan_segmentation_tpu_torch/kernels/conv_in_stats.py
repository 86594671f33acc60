"""Kernel 1: conv3x3 + noise + bias + leaky-relu with instance-norm statistics.

CUDA sources: ``csrc/conv_in_stats.cu`` and ``csrc/conv_in_stats_f32.cu``,
bound as the custom op ``torch.ops.gst.conv3x3_in_stats``
(``kernels/ops.py``), each dtype on the body its rule picks: bf16 the
Hopper body of ``csrc/conv3x3_sm90.cuh`` (``tc_plan.plan_bf16``), else the
tensor-core implicit GEMM of ``csrc/conv3x3_tc.cuh`` (``tc_plan.plan``);
f32 the Hopper body's 3xTF32 form with this kernel's epilogue (entry 9:
taps streamed by TMA from a K-major layout of w made each call, split-K
within 8 chunks a chain; ``tc_plan.plan_f32_body(noise=True)`` over
``plan_tf32_in_stats``), else the 3xTF32 one of ``csrc/conv3x3_tf32.cuh``
(``tc_plan.plan_f32``) where TMA's rules refuse the call.  Replaces
the TPU kernel
``experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats``
and keeps its contract: NHWC / HWIO, stride 1, pad 1, ``w`` the effective
(wscaled) kernel, ``noise`` (N, H, W) f32, ``nscale`` and ``bias`` (Cout,) f32;
``y`` in x's dtype; ``mean`` and ``var`` (N, Cout) f32 taken from the f32
epilogue values, with ``var = E[y^2] - mean^2`` NOT clamped — the consumer
(`ops.norm.instance_norm_apply`) clamps.  Unlike Pallas, any H and W run.

``conv3x3_noise_bias_lrelu_instats_s8`` is its s8 body (int8-full
generation, ``torch.ops.gst.conv3x3_in_stats_s8``): x s8, w s8 laid out
(3, 3, Cout, Cin), exact s32 sums, ``v = float(acc) * deq + noise * nscale
+ bias``, leaky, the statistics from the f32 v, y in bf16 or f32.  The
JAX package casts the dequantized conv to the compute dtype before the
noise; here, as in the bf16 body, the epilogue stays f32.

``conv3x3_noise_bias_lrelu_instats_rows`` is its row-band form
(``generate --spatial``, ``torch.ops.gst.conv3x3_in_stats_rows``, CUDA
source ``csrc/conv_in_stats_rows.cu``; bf16 and f32): x carries the band's
rows and one halo row above and below them, so the conv pads W only; it
returns the band's sums of v and v^2, which ``core/spatial.py`` adds over
the bands.
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


def conv3x3_noise_bias_lrelu_instats_rows_plain(x, w, noise, nscale, bias, *,
                                                leaky: float = 0.2):
    """The plain version of the row-band form: ``F.conv2d`` with padding
    (0, 1) over x's H_out + 2 rows, then kernel 1's f32 epilogue; -> (y,
    sum of v, sum of v^2) over the band's pixels, (N, Cout) f32 each."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(0, 1))
    y = y.permute(0, 2, 3, 1).float()
    y = y + noise.float()[..., None] * nscale.float() + bias.float()
    y = torch.where(y >= 0, y, leaky * y)
    return y.to(x.dtype), y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))


def check_args_rows(x, w, noise, nscale, bias):
    """``check_args`` of the row-band form: x holds the band's rows and a
    halo row above and below them, noise the band's rows; -> (n, h_out,
    w, cin, cout)."""
    if x.dim() != 4 or x.shape[1] < 3:
        raise ValueError(f"x must be NHWC with the band's rows and two halo "
                         f"rows, got shape {tuple(x.shape)}")
    n, h_in, wd, cin = x.shape
    h = h_in - 2
    if noise.dim() != 3 or tuple(noise.shape) != (n, h, wd):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{(n, h, wd)}")
    _, _, _, _, cout = _build.check_conv3x3(x, w, None)
    dev = x.device
    _build.check(noise, "noise", (n, h, wd), torch.float32, dev)
    _build.check(nscale, "nscale", (cout,), torch.float32, dev)
    _build.check(bias, "bias", (cout,), torch.float32, dev)
    return n, h, wd, cin, cout


def conv3x3_noise_bias_lrelu_instats_rows(x, w, noise, nscale, bias, *,
                                          leaky: float = 0.2):
    """Kernel 1 over one row band (``generate --spatial``,
    ``core/spatial.py``): x (N, H_out + 2, W, Cin) carries the halo rows
    (no pad in H), noise (N, H_out, W); -> (y (N, H_out, W, Cout), sum of
    v, sum of v^2 over the band), through the custom op
    ``torch.ops.gst.conv3x3_in_stats_rows``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    check_args_rows(x, w, noise, nscale, bias)
    return torch.ops.gst.conv3x3_in_stats_rows(x, w, noise, nscale, bias,
                                               float(leaky))


conv3x3_noise_bias_lrelu_instats_rows.launches = 0  # counted in kernels/ops.py


def conv3x3_noise_bias_lrelu_instats_s8_plain(
        x, w, deq, noise, nscale, bias, *, leaky: float = 0.2,
        out_dtype: torch.dtype = torch.bfloat16):
    """The plain PyTorch version of the s8 body: the exact integer conv,
    then the kernel's f32 ops in its order."""
    from .small_conv import conv3x3_s8_acc
    return s8_in_stats_epilogue_plain(conv3x3_s8_acc(x, w), deq, noise,
                                      nscale, bias, leaky=leaky,
                                      out_dtype=out_dtype)


def s8_in_stats_epilogue_plain(acc, deq, noise, nscale, bias, *,
                               leaky: float = 0.2,
                               out_dtype: torch.dtype = torch.bfloat16):
    """The s8 body's epilogue on the f32 of the exact sums ``acc`` ->
    (y, mean, var)."""
    y = acc * deq
    y = y + noise[..., None] * nscale + bias
    y = torch.where(y >= 0, y, leaky * y)
    mean = y.mean(dim=(1, 2))
    var = (y * y).mean(dim=(1, 2)) - mean * mean
    return y.to(out_dtype), mean, var


def check_args_s8(x, w, deq, noise, nscale, bias):
    """``check_args`` of the s8 body; -> (n, h, w, cin, cout)."""
    n, h, wd, cin, cout = _build.check_conv3x3_s8(x, w, deq, bias)
    dev = x.device
    _build.check(noise, "noise", (n, h, wd), torch.float32, dev)
    _build.check(nscale, "nscale", (cout,), torch.float32, dev)
    _build.check(bias, "bias", (cout,), torch.float32, dev)
    return n, h, wd, cin, cout


def conv3x3_noise_bias_lrelu_instats_s8(x, w, deq, noise, nscale, bias, *,
                                        leaky: float = 0.2,
                                        out_dtype: torch.dtype =
                                        torch.bfloat16):
    """-> (y, mean, var) of the s8 body, through the custom op
    ``torch.ops.gst.conv3x3_in_stats_s8``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    check_args_s8(x, w, deq, noise, nscale, bias)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    return torch.ops.gst.conv3x3_in_stats_s8(x, w, deq, noise, nscale, bias,
                                             float(leaky),
                                             out_dtype == torch.float32)


conv3x3_noise_bias_lrelu_instats_s8.launches = 0  # counted in kernels/ops.py

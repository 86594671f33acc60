"""Kernels 1, 2 and 3 (bf16 / f32 and their s8 bodies) and the s8 quantize
pass as ``torch.library`` custom ops, so that a tracer (``torch.export``,
``core/export.py``) can pass through them and a saved program names them:
``torch.ops.gst.conv3x3_small``, ``torch.ops.gst.conv3x3_in_stats``,
``torch.ops.gst.conv3x3_bil``, ``torch.ops.gst.conv3x3_small_s8``,
``torch.ops.gst.conv3x3_in_stats_s8``, ``torch.ops.gst.quantize_s8``, and
the row-band forms of kernels 1 and 2 (``generate --spatial``)
``torch.ops.gst.conv3x3_small_rows`` and
``torch.ops.gst.conv3x3_in_stats_rows``.

- CPU: the plain PyTorch version (``*_plain`` beside each wrapper).
- CUDA: the hand-written kernel through the ``ctypes`` library of
  ``_build``, launched on the current stream on the body its rule picks
  (``tc_plan.plan_bf16``, ``plan_s8``, ``plan_f32_body``: the Hopper
  body's ``gst_*_sm90`` entries, its f32 forms ``gst_*_f32_sm90``, or the
  mma.sync bodies'); it raises
  when the launch
  fails and never falls back to the plain version.  Each launch adds one
  to its wrapper's ``launches`` (``small_conv.conv3x3_small``,
  ``conv_in_stats.conv3x3_noise_bias_lrelu_instats``,
  ``bil_conv.conv3x3_bil``, the ``_s8`` and ``_rows`` twins,
  ``quantize.quantize_s8``), the one counter a run reads whether the call
  came through the wrapper or from an exported program.
- Fake (``register_fake``): the output shapes and dtypes, from the inputs'
  alone; the library is not touched.

The wrappers check their arguments before they call the op.  A program
loaded from a file calls the op directly, so the CUDA implementations
check again: the kernels index raw pointers.
"""

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import _build, bil_conv, conv_in_stats, quantize, small_conv


@torch.library.custom_op("gst::conv3x3_small", mutates_args=(),
                         device_types="cpu")
def conv3x3_small_op(x: Tensor, w: Tensor, b: Optional[Tensor], act: str,
                     leaky: float) -> Tensor:
    """y = conv3x3(x, w) [+ b] then ``act`` ("none", "relu" or "leaky" with
    slope ``leaky``); NHWC / HWIO, y in x's dtype."""
    return small_conv.conv3x3_small_plain(
        x, w, b, relu=act == "relu", leaky=leaky if act == "leaky" else None)


@conv3x3_small_op.register_fake
def _(x, w, b, act, leaky):
    return x.new_empty((*x.shape[:3], w.shape[3]))


@conv3x3_small_op.register_kernel("cuda")
def _(x, w, b, act, leaky):
    n, h, wd, cin, cout = _build.check_conv3x3(x, w, b)
    dev = x.device
    lib = _build.library()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    p, plan, ws = _build.tc_launch_args(x, n, h, wd, cin, cout,
                                        tensors=(w,))
    with torch.cuda.device(dev):
        rc = _entry(lib, "gst_conv3x3_small", p)(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), None if ws is None else ws.data_ptr(), n, h, wd,
            cin, cout, _build.DTYPE_CODES[x.dtype],
            small_conv._ACT_CODES[act], float(leaky), plan,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "conv3x3_small")
    small_conv.conv3x3_small.launches += 1
    return y


@torch.library.custom_op("gst::conv3x3_in_stats", mutates_args=(),
                         device_types="cpu")
def conv3x3_in_stats_op(x: Tensor, w: Tensor, noise: Tensor, nscale: Tensor,
                        bias: Tensor, leaky: float
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (y, mean, var): conv3x3 + noise * nscale + bias + leaky, and the
    instance-norm statistics of y (f32, var not clamped)."""
    return conv_in_stats.conv3x3_noise_bias_lrelu_instats_plain(
        x, w, noise, nscale, bias, leaky=leaky)


@conv3x3_in_stats_op.register_fake
def _(x, w, noise, nscale, bias, leaky):
    n, cout = x.shape[0], w.shape[3]
    stats = (n, cout)
    return (x.new_empty((*x.shape[:3], cout)),
            x.new_empty(stats, dtype=torch.float32),
            x.new_empty(stats, dtype=torch.float32))


@conv3x3_in_stats_op.register_kernel("cuda")
def _(x, w, noise, nscale, bias, leaky):
    n, h, wd, cin, cout = conv_in_stats.check_args(x, w, noise, nscale, bias)
    dev = x.device
    lib = _build.library()
    plan, plan_c, ws = _build.tc_launch_args(x, n, h, wd, cin, cout,
                                             noise=True,
                                             tensors=(w, noise))
    # the partial axis is the plan's tile count (f32 on the Hopper body:
    # the workspace holds the K-major taps it streams, then its split-K
    # partials)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    partial = torch.empty((n, plan.tiles, 2, cout), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _entry(lib, "gst_conv3x3_in_stats", plan)(
            x.data_ptr(), w.data_ptr(), noise.data_ptr(), nscale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), partial.data_ptr(),
            None if ws is None else ws.data_ptr(), n, h, wd, cin, cout,
            _build.DTYPE_CODES[x.dtype], float(leaky), plan_c,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "conv3x3_noise_bias_lrelu_instats")
    conv_in_stats.conv3x3_noise_bias_lrelu_instats.launches += 1
    # second pass: the per-tile partial sums, reduced over the tile axis in a
    # fixed order (no atomics, so the statistics are deterministic)
    sums = partial.sum(dim=1)
    mean = sums[:, 0] / (h * wd)
    var = sums[:, 1] / (h * wd) - mean * mean
    return y, mean, var


@torch.library.custom_op("gst::conv3x3_small_rows", mutates_args=(),
                         device_types="cpu")
def conv3x3_small_rows_op(x: Tensor, w: Tensor, b: Optional[Tensor], act: str,
                          leaky: float) -> Tensor:
    """Kernel 2 over a row band: x (N, H + 2, W, Cin) with its halo rows ->
    y (N, H, W, Cout), the conv padded in W only."""
    return small_conv.conv3x3_small_rows_plain(
        x, w, b, relu=act == "relu", leaky=leaky if act == "leaky" else None)


@conv3x3_small_rows_op.register_fake
def _(x, w, b, act, leaky):
    return x.new_empty((x.shape[0], x.shape[1] - 2, x.shape[2], w.shape[3]))


@conv3x3_small_rows_op.register_kernel("cuda")
def _(x, w, b, act, leaky):
    n, h, wd, cin, cout = small_conv.check_args_rows(x, w, b)
    dev = x.device
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    p, plan, ws = _build.tc_launch_args(x, n, h, wd, cin, cout,
                                        tensors=(w,), rows=True)
    with torch.cuda.device(dev):
        rc = _entry(_build.library(), "gst_conv3x3_small_rows", p)(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), None if ws is None else ws.data_ptr(), n, h, wd,
            cin, cout, _build.DTYPE_CODES[x.dtype],
            small_conv._ACT_CODES[act], float(leaky), plan, _stream(dev))
    _build.check_launch(rc, "conv3x3_small_rows")
    small_conv.conv3x3_small_rows.launches += 1
    return y


@torch.library.custom_op("gst::conv3x3_in_stats_rows", mutates_args=(),
                         device_types="cpu")
def conv3x3_in_stats_rows_op(x: Tensor, w: Tensor, noise: Tensor,
                             nscale: Tensor, bias: Tensor, leaky: float
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel 1 over a row band: x (N, H + 2, W, Cin) with its halo rows,
    noise (N, H, W) -> (y, sum of v, sum of v^2 over the band), the sums
    (N, Cout) f32."""
    return conv_in_stats.conv3x3_noise_bias_lrelu_instats_rows_plain(
        x, w, noise, nscale, bias, leaky=leaky)


@conv3x3_in_stats_rows_op.register_fake
def _(x, w, noise, nscale, bias, leaky):
    n, cout = x.shape[0], w.shape[3]
    return (x.new_empty((n, x.shape[1] - 2, x.shape[2], cout)),
            x.new_empty((n, cout), dtype=torch.float32),
            x.new_empty((n, cout), dtype=torch.float32))


@conv3x3_in_stats_rows_op.register_kernel("cuda")
def _(x, w, noise, nscale, bias, leaky):
    n, h, wd, cin, cout = conv_in_stats.check_args_rows(x, w, noise, nscale,
                                                        bias)
    dev = x.device
    plan, plan_c, ws = _build.tc_launch_args(x, n, h, wd, cin, cout,
                                             noise=True,
                                             tensors=(w, noise), rows=True)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    partial = torch.empty((n, plan.tiles, 2, cout), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _entry(_build.library(), "gst_conv3x3_in_stats_rows", plan)(
            x.data_ptr(), w.data_ptr(), noise.data_ptr(), nscale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), partial.data_ptr(),
            None if ws is None else ws.data_ptr(), n, h, wd, cin, cout,
            _build.DTYPE_CODES[x.dtype], float(leaky), plan_c, _stream(dev))
    _build.check_launch(rc, "conv3x3_noise_bias_lrelu_instats_rows")
    conv_in_stats.conv3x3_noise_bias_lrelu_instats_rows.launches += 1
    sums = partial.sum(dim=1)  # the tile axis, in a fixed order
    return y, sums[:, 0].clone(), sums[:, 1].clone()  # no aliased outputs


@torch.library.custom_op("gst::conv3x3_bil", mutates_args=(),
                         device_types="cpu")
def conv3x3_bil_op(x: Tensor, w: Tensor, b: Optional[Tensor], act: str,
                   leaky: float) -> Tensor:
    """Kernel 3: y = conv3x3(x, w) [+ b] then ``act`` for B*Cin, B*Cout <=
    128; NHWC / HWIO, y in x's dtype."""
    return bil_conv.conv3x3_bil_plain(
        x, w, b, relu=act == "relu", leaky=leaky if act == "leaky" else None)


@conv3x3_bil_op.register_fake
def _(x, w, b, act, leaky):
    return x.new_empty((*x.shape[:3], w.shape[3]))


@conv3x3_bil_op.register_kernel("cuda")
def _(x, w, b, act, leaky):
    n, h, wd, cin, cout = bil_conv.check_args(x, w, b)
    dev = x.device
    lib = _build.library()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    # f32: the body plan_f32_body picks (the Hopper body's entry takes a
    # workspace); bf16: the FFMA core, no plan
    p, plan, ws = (_build.bil_launch_args(x, n, h, wd, cin, cout)
                   if x.dtype == torch.float32 else (None, None, None))
    with torch.cuda.device(dev):
        common = (None if b is None else b.data_ptr(), y.data_ptr())
        if p is not None and p.sm90:
            rc = lib.gst_conv3x3_bil_sm90(
                x.data_ptr(), w.data_ptr(), *common, ws.data_ptr()
                if ws is not None else None, n, h, wd, cin, cout,
                _build.DTYPE_CODES[x.dtype], small_conv._ACT_CODES[act],
                float(leaky), plan, _stream(dev))
        else:
            rc = lib.gst_conv3x3_bil(
                x.data_ptr(), w.data_ptr(), *common, n, h, wd, cin, cout,
                _build.DTYPE_CODES[x.dtype], small_conv._ACT_CODES[act],
                float(leaky), plan, _stream(dev))
    _build.check_launch(rc, "conv3x3_bil")
    bil_conv.conv3x3_bil.launches += 1
    return y


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _entry(lib, name, plan):
    """The C entry point of the body the plan names
    (``_build.entry_name``)."""
    return getattr(lib, _build.entry_name(name, plan))


@torch.library.custom_op("gst::quantize_s8", mutates_args=(),
                         device_types="cpu")
def quantize_s8_op(x: Tensor, inv: Tensor) -> Tensor:
    """s8 = clip(round(x * inv), -127, 127); inv a (1,) f32 tensor."""
    return quantize.quantize_s8_plain(x, inv)


@quantize_s8_op.register_fake
def _(x, inv):
    return x.new_empty(x.shape, dtype=torch.int8)


@quantize_s8_op.register_kernel("cuda")
def _(x, inv):
    quantize.check_args(x, inv)
    dev = x.device
    y = torch.empty(x.shape, dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().gst_quantize_s8(
            x.data_ptr(), inv.data_ptr(), y.data_ptr(), x.numel(),
            _build.DTYPE_CODES[x.dtype], _stream(dev))
    _build.check_launch(rc, "quantize_s8")
    quantize.quantize_s8.launches += 1
    return y


def _out_dtype(out_f32: bool):
    return torch.float32 if out_f32 else torch.bfloat16


@torch.library.custom_op("gst::conv3x3_small_s8", mutates_args=(),
                         device_types="cpu")
def conv3x3_small_s8_op(x: Tensor, w: Tensor, deq: Tensor, b: Optional[Tensor],
                        act: str, leaky: float, out_f32: bool) -> Tensor:
    """The s8 body of kernel 2: y = act(conv3x3_s8(x, w) * deq [+ b]), w
    (3, 3, Cout, Cin) s8, y in f32 (``out_f32``) or bf16."""
    return small_conv.conv3x3_small_s8_plain(
        x, w, deq, b, relu=act == "relu",
        leaky=leaky if act == "leaky" else None,
        out_dtype=_out_dtype(out_f32))


@conv3x3_small_s8_op.register_fake
def _(x, w, deq, b, act, leaky, out_f32):
    return x.new_empty((*x.shape[:3], w.shape[2]), dtype=_out_dtype(out_f32))


@conv3x3_small_s8_op.register_kernel("cuda")
def _(x, w, deq, b, act, leaky, out_f32):
    n, h, wd, cin, cout = _build.check_conv3x3_s8(x, w, deq, b)
    dev = x.device
    out = _out_dtype(out_f32)
    y = torch.empty((n, h, wd, cout), dtype=out, device=dev)
    p, plan, ws = _build.tc_launch_args(x, n, h, wd, cin, cout,
                                        tensors=(w,))
    with torch.cuda.device(dev):
        rc = _entry(_build.library(), "gst_conv3x3_small_s8", p)(
            x.data_ptr(), w.data_ptr(), deq.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), n, h, wd, cin, cout,
            _build.DTYPE_CODES[out], small_conv._ACT_CODES[act], float(leaky),
            plan, _stream(dev))
    _build.check_launch(rc, "conv3x3_small_s8")
    small_conv.conv3x3_small_s8.launches += 1
    return y


@torch.library.custom_op("gst::conv3x3_in_stats_s8", mutates_args=(),
                         device_types="cpu")
def conv3x3_in_stats_s8_op(x: Tensor, w: Tensor, deq: Tensor, noise: Tensor,
                           nscale: Tensor, bias: Tensor, leaky: float,
                           out_f32: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """The s8 body of kernel 1: -> (y, mean, var)."""
    return conv_in_stats.conv3x3_noise_bias_lrelu_instats_s8_plain(
        x, w, deq, noise, nscale, bias, leaky=leaky,
        out_dtype=_out_dtype(out_f32))


@conv3x3_in_stats_s8_op.register_fake
def _(x, w, deq, noise, nscale, bias, leaky, out_f32):
    n, cout = x.shape[0], w.shape[2]
    stats = (n, cout)
    return (x.new_empty((*x.shape[:3], cout), dtype=_out_dtype(out_f32)),
            x.new_empty(stats, dtype=torch.float32),
            x.new_empty(stats, dtype=torch.float32))


@conv3x3_in_stats_s8_op.register_kernel("cuda")
def _(x, w, deq, noise, nscale, bias, leaky, out_f32):
    n, h, wd, cin, cout = conv_in_stats.check_args_s8(x, w, deq, noise,
                                                      nscale, bias)
    dev = x.device
    out = _out_dtype(out_f32)
    plan, plan_c, ws = _build.tc_launch_args(x, n, h, wd, cin, cout,
                                             noise=True,
                                             tensors=(w, noise))
    y = torch.empty((n, h, wd, cout), dtype=out, device=dev)
    partial = torch.empty((n, plan.tiles, 2, cout), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _entry(_build.library(), "gst_conv3x3_in_stats_s8", plan)(
            x.data_ptr(), w.data_ptr(), deq.data_ptr(), noise.data_ptr(),
            nscale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            partial.data_ptr(), None if ws is None else ws.data_ptr(), n, h,
            wd, cin, cout, _build.DTYPE_CODES[out], float(leaky), plan_c,
            _stream(dev))
    _build.check_launch(rc, "conv3x3_noise_bias_lrelu_instats_s8")
    conv_in_stats.conv3x3_noise_bias_lrelu_instats_s8.launches += 1
    sums = partial.sum(dim=1)  # the tile axis, in a fixed order
    mean = sums[:, 0] / (h * wd)
    var = sums[:, 1] / (h * wd) - mean * mean
    return y, mean, var

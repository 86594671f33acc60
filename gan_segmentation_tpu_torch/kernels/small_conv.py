"""Kernel 2: direct 3x3 conv with a fused bias and relu / leaky epilogue.

CUDA source: ``csrc/small_conv.cu``, bound as the custom op
``torch.ops.gst.conv3x3_small`` (``kernels/ops.py``): bf16 runs the Hopper
body of ``csrc/conv3x3_sm90.cuh`` or the tensor-core implicit GEMM of
``csrc/conv3x3_tc.cuh`` (rule: ``tc_plan.plan_bf16``), f32 the Hopper
body's 3xTF32 form (``csrc/small_conv_f32.cu``, ``tc_plan.plan_tf32``) or
the mma.sync 3xTF32 one of ``csrc/conv3x3_tf32.cuh``
(``tc_plan.plan_f32``; rule: ``tc_plan.plan_f32_body``).  Replaces
the TPU kernel
``experiments/pallas_archive/small_conv.py::conv3x3_small`` and keeps its
contract: NHWC / HWIO, stride 1, pad 1, f32 accumulation, output in x's
dtype, ``b`` optional (Cout,) f32.  Unlike Pallas, any H and W run.

``conv3x3_small_s8`` is its s8 body (int8 generation,
``torch.ops.gst.conv3x3_small_s8``): x s8 NHWC, w s8 laid out (3, 3, Cout,
Cin), exact s32 sums, then ``float(acc) * deq + b`` and the activation in
f32, y in bf16 or f32.  Its plain version is the exact integer
convolution (a float64 ``F.conv2d`` of the s8 values: every sum is an
integer below 2^53) followed by the same f32 ops in the same order.

``conv3x3_small_rows`` is its row-band form (``generate --spatial``,
``torch.ops.gst.conv3x3_small_rows``, CUDA source
``csrc/small_conv_rows.cu``; bf16 and f32): x carries the band's rows and
one halo row above and below them, so the conv pads W only.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_ACT_CODES = {"none": 0, "relu": 1, "leaky": 2}


def _act(relu: bool, leaky: Optional[float]) -> str:
    if relu and leaky is not None:
        raise ValueError("pass relu or leaky, not both")
    return "relu" if relu else ("leaky" if leaky is not None else "none")


def conv3x3_small_plain(x, w, b=None, *, relu: bool = False,
                        leaky: Optional[float] = None):
    """The plain PyTorch version: the CPU path and the kernel's reference."""
    act = _act(relu, leaky)
    acc = torch.promote_types(x.dtype, torch.float32)  # f32, or f64 as given
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).to(acc)
    if b is not None:
        y = y + b.to(acc)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky":
        y = torch.where(y >= 0, y, leaky * y)
    return y.to(x.dtype)


def conv3x3_small(x, w, b=None, *, relu: bool = False,
                  leaky: Optional[float] = None):
    """y = conv3x3(x, w) [+ b] [relu | leaky], through the custom op
    ``torch.ops.gst.conv3x3_small`` (``kernels/ops.py``).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    act = _act(relu, leaky)
    _build.check_conv3x3(x, w, b)
    return torch.ops.gst.conv3x3_small(x, w, b, act, float(leaky or 0.0))


conv3x3_small.launches = 0  # the CUDA launches, counted in kernels/ops.py


def conv3x3_small_rows_plain(x, w, b=None, *, relu: bool = False,
                             leaky: Optional[float] = None):
    """The plain version of the row-band form: ``F.conv2d`` with padding
    (0, 1) over x's H_out + 2 rows, then the bias and activation."""
    act = _act(relu, leaky)
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(0, 1))
    y = y.permute(0, 2, 3, 1).to(acc)
    if b is not None:
        y = y + b.to(acc)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky":
        y = torch.where(y >= 0, y, leaky * y)
    return y.to(x.dtype)


def check_args_rows(x, w, b):
    """``_build.check_conv3x3`` of the row-band form (x holds the band's
    rows and a halo row above and below them); -> (n, h_out, w, cin,
    cout)."""
    if x.dim() != 4 or x.shape[1] < 3:
        raise ValueError(f"x must be NHWC with the band's rows and two halo "
                         f"rows, got shape {tuple(x.shape)}")
    n, h_in, wd, cin, cout = _build.check_conv3x3(x, w, b)
    return n, h_in - 2, wd, cin, cout


def conv3x3_small_rows(x, w, b=None, *, relu: bool = False,
                       leaky: Optional[float] = None):
    """Kernel 2 over one row band (``generate --spatial``,
    ``core/spatial.py``): x (N, H_out + 2, W, Cin) carries the halo rows
    (no pad in H) -> y (N, H_out, W, Cout), through the custom op
    ``torch.ops.gst.conv3x3_small_rows``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    act = _act(relu, leaky)
    check_args_rows(x, w, b)
    return torch.ops.gst.conv3x3_small_rows(x, w, b, act,
                                            float(leaky or 0.0))


conv3x3_small_rows.launches = 0  # counted in kernels/ops.py


def conv3x3_s8_acc(x, w):
    """The exact s32 sums of an s8 3x3 conv (x NHWC, w (3, 3, Cout, Cin)),
    as f32 (each integer rounded to the nearest f32, as the kernel's
    ``__int2float_rn``): a float64 ``F.conv2d``, exact since every partial
    sum is an integer far below 2^53."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(2, 3, 0, 1).double(), padding=1)
    return y.permute(0, 2, 3, 1).float()


def conv3x3_small_s8_plain(x, w, deq, b=None, *, relu: bool = False,
                           leaky: Optional[float] = None,
                           out_dtype: torch.dtype = torch.bfloat16):
    """The plain PyTorch version of the s8 body: the CPU path and the
    kernel's reference."""
    return s8_epilogue_plain(conv3x3_s8_acc(x, w), deq, b, relu=relu,
                             leaky=leaky, out_dtype=out_dtype)


def s8_epilogue_plain(acc, deq, b=None, *, relu: bool = False,
                      leaky: Optional[float] = None,
                      out_dtype: torch.dtype = torch.bfloat16):
    """The s8 body's epilogue on the f32 of the exact sums ``acc``: ``acc *
    deq`` [+ b], the activation, the cast; each step rounded in f32."""
    act = _act(relu, leaky)
    y = acc * deq
    if b is not None:
        y = y + b
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky":
        y = torch.where(y >= 0, y, leaky * y)
    return y.to(out_dtype)


def conv3x3_small_s8(x, w, deq, b=None, *, relu: bool = False,
                     leaky: Optional[float] = None,
                     out_dtype: torch.dtype = torch.bfloat16):
    """y = act(conv3x3_s8(x, w) * deq [+ b]) in ``out_dtype`` (bf16 or
    f32), through the custom op ``torch.ops.gst.conv3x3_small_s8``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    act = _act(relu, leaky)
    _build.check_conv3x3_s8(x, w, deq, b)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    return torch.ops.gst.conv3x3_small_s8(x, w, deq, b, act,
                                          float(leaky or 0.0),
                                          out_dtype == torch.float32)


conv3x3_small_s8.launches = 0  # the CUDA launches, counted in kernels/ops.py

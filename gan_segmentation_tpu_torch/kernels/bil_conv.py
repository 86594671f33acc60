"""Kernel 3: 3x3 conv of a small batch (the train step's 38 f32 convs).

CUDA sources: ``csrc/bil_conv_sm90.cu`` and ``csrc/bil_conv.cu``, bound as
the custom op ``torch.ops.gst.conv3x3_bil`` (``kernels/ops.py``).  f32
runs the body ``tc_plan.plan_f32_body(kernel3=True)`` picks: the Hopper
body's 3xTF32 form (``csrc/conv3x3_sm90.cuh``, plan ``tc_plan.plan_tf32``:
TMA halos, resident K-major tf32 taps, wgmma, split-K) wherever TMA's
rules take the shape, else the mma.sync 3xTF32 implicit GEMM of
``csrc/conv3x3_tf32.cuh`` (``tc_plan.plan_f32``, no split); bf16 the FFMA
core of ``csrc/conv3x3_core.cuh``, one block serving every sample.
Replaces the TPU kernel
``experiments/pallas_archive/bil_conv.py::conv3x3_bil`` and keeps its
contract: NHWC / HWIO, stride 1, pad 1, f32 accumulation, output in x's
dtype, ``b`` optional (Cout,) f32, relu or leaky epilogue, and
``B * Cin <= 128`` and ``B * Cout <= 128`` (a violation raises
``ValueError`` on every device).  Unlike Pallas, any H runs: ragged row
tiles are masked.  The kernel reads x in place (no batch-into-channels
relayout in memory) and never builds the block-diagonal weight matrix.
"""

from typing import Optional

import torch

from . import _build
from .small_conv import _act, conv3x3_small_plain

MAX_LANES = 128

# (n, h, w, cin, cout) at the edges of the contract and of the f32 plan, the
# one list that the plan's CPU tests, the card's tests and chip_smoke.py
# check: B*C = 128 with C 2 / 16 / 64, Cout 2 and Cin 2 at batch 1, ragged
# 13 x 21, 17-wide and 20-wide tiles, B = 1 at 1024^2 with 128 channels
# either side, 4^2 images packed into a tile, B = 128 with one channel, a
# large batch of 2-channel 9^2 samples, B = 1 with 128 channels at 16^2
EDGE_SHAPES = (
    (64, 32, 32, 2, 2), (8, 1024, 1024, 16, 16), (2, 64, 64, 64, 64),
    (1, 64, 64, 32, 2), (1, 64, 64, 2, 32), (8, 13, 21, 16, 16),
    (1, 1024, 1024, 128, 128), (1, 1024, 1024, 2, 128), (8, 4, 4, 16, 16),
    (128, 5, 7, 1, 1), (4, 10, 17, 12, 5), (1, 33, 20, 128, 32),
    (1, 16, 16, 128, 128), (8, 64, 64, 16, 16), (64, 9, 9, 2, 2),
    (2, 12, 40, 64, 64), (1, 4, 4, 32, 2), (1, 1024, 1024, 16, 64))


def fits(n: int, cin: int, cout: int) -> bool:
    """Whether (batch, Cin, Cout) is inside the kernel's contract."""
    return n * cin <= MAX_LANES and n * cout <= MAX_LANES


def conv3x3_bil_plain(x, w, b=None, *, relu: bool = False,
                      leaky: Optional[float] = None):
    """The plain PyTorch version (the same function as kernel 2's): the CPU
    path and the kernel's reference."""
    return conv3x3_small_plain(x, w, b, relu=relu, leaky=leaky)


def check_args(x, w, b):
    """``_build.check_conv3x3`` and the contract; -> (n, h, w, cin,
    cout)."""
    n, h, wd, cin, cout = _build.check_conv3x3(x, w, b)
    if not fits(n, cin, cout):
        raise ValueError(f"conv3x3_bil needs B*Cin <= {MAX_LANES} and "
                         f"B*Cout <= {MAX_LANES}; got B={n}, Cin={cin}, "
                         f"Cout={cout}")
    return n, h, wd, cin, cout


def conv3x3_bil(x, w, b=None, *, relu: bool = False,
                leaky: Optional[float] = None):
    """y = conv3x3(x, w) [+ b] [relu | leaky] for ``B*Cin, B*Cout <= 128``,
    through the custom op ``torch.ops.gst.conv3x3_bil``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    act = _act(relu, leaky)
    check_args(x, w, b)
    return torch.ops.gst.conv3x3_bil(x, w, b, act, float(leaky or 0.0))


conv3x3_bil.launches = 0  # the CUDA launches, counted in kernels/ops.py

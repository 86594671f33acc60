"""Kernel 3: 3x3 conv of a small batch, one block serving every sample.

CUDA source: ``csrc/bil_conv.cu``.  Replaces the TPU kernel
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
from .small_conv import _ACT_CODES, _act, conv3x3_small_plain

MAX_LANES = 128


def fits(n: int, cin: int, cout: int) -> bool:
    """Whether (batch, Cin, Cout) is inside the kernel's contract."""
    return n * cin <= MAX_LANES and n * cout <= MAX_LANES


def conv3x3_bil_plain(x, w, b=None, *, relu: bool = False,
                      leaky: Optional[float] = None):
    """The plain PyTorch version (the same function as kernel 2's): the CPU
    path and the kernel's reference."""
    return conv3x3_small_plain(x, w, b, relu=relu, leaky=leaky)


def conv3x3_bil(x, w, b=None, *, relu: bool = False,
                leaky: Optional[float] = None):
    """y = conv3x3(x, w) [+ b] [relu | leaky] for ``B*Cin, B*Cout <= 128``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    act = _act(relu, leaky)
    n, h, wd, cin, cout = _build.check_conv3x3(x, w, b)
    if not fits(n, cin, cout):
        raise ValueError(f"conv3x3_bil needs B*Cin <= {MAX_LANES} and "
                         f"B*Cout <= {MAX_LANES}; got B={n}, Cin={cin}, "
                         f"Cout={cout}")
    if x.device.type == "cpu":
        return conv3x3_bil_plain(x, w, b, relu=relu, leaky=leaky)
    dev = x.device
    lib = _build.library()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_conv3x3_bil(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), n, h, wd, cin, cout, _build.DTYPE_CODES[x.dtype],
            _ACT_CODES[act], float(leaky or 0.0),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "conv3x3_bil")
    conv3x3_bil.launches += 1
    return y


conv3x3_bil.launches = 0

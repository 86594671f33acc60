"""The quantize pass of int8 generation: static per-tensor s8 quantization
of an activation, ``y = clip(round(x * inv), -127, 127)``.

CUDA source: ``csrc/quantize_s8.cu``, bound as the custom op
``torch.ops.gst.quantize_s8`` (``kernels/ops.py``).  It replaces the
quantization of the JAX package's int8 convs
(``gan_segmentation_tpu/ops/quant.py::quantize_act``), which XLA computed
on the TPU without a Pallas kernel: the product in f32, round half to even
(``jnp.round``, ``torch.round``), saturation at +-127.  ``inv`` is a
one-element f32 tensor on x's device, so a CUDA graph reads the value a
requantization writes there.
"""

import torch

from . import _build


def quantize_s8_plain(x, inv):
    """The plain PyTorch version: the CPU path and the kernel's reference."""
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(
        torch.int8)


def check_args(x, inv):
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _build.check(x, "x", x.shape, x.dtype, x.device)
    _build.check(inv, "inv", (1,), torch.float32, x.device)


def quantize_s8(x, inv):
    """s8 of x against the scale ``inv`` (shape (1,), f32), through the
    custom op ``torch.ops.gst.quantize_s8``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    check_args(x, inv)
    return torch.ops.gst.quantize_s8(x, inv)


quantize_s8.launches = 0  # the CUDA launches, counted in kernels/ops.py

"""The synthesis block's per-pixel chain as two passes: noise, bias, leaky
relu and the instance-norm sums in one (pass A), the AdaIN apply in the
other (pass B).

CUDA source: ``csrc/adain_fused.cu``, bound as the custom ops
``torch.ops.gst.noise_bias_lrelu_stats`` and ``torch.ops.gst.adain_apply``
(``kernels/ops.py``).  They replace no Pallas kernel: the JAX package's
``AddNoise`` -> ``Bias`` -> ``leaky_relu`` -> ``AdaIN`` chain
(``gan_segmentation_tpu/models/layers.py``) was left to XLA, which fused
it on the TPU.  ``models/stylegan.py::StyleBlock`` runs pass A between the
blur and conv_2, and pass B twice a block: after pass A (``adain_1``) and
after kernel 1 (``adain_2``); ``core/spatial.py`` runs both over row
bands.

Numerics.  Each value is computed in f32 in the order the plain versions
below write it and rounded once to x's dtype (bf16 or f32); the noise,
the statistics and the affine's arithmetic stay f32.  Pass A's sums are
those of the values as stored (``y.float()``), so the apply normalizes
exactly what was measured.  Pass B clamps the variance at 0 and takes eps
1e-5, with one-pass moments ``E[v^2] - mean^2``: from (mean, var) as
kernel 1 returns them, or (``count`` > 0) from pass A's sums over
``count`` pixels.  On the CPU each op runs its plain version.
"""

import functools

import torch

from . import _build

# a block's least work: about 32 elements a thread of 256
_BLOCK_ELEMS = 8192
# blocks per SM the tile split aims at
_BLOCKS_PER_SM = 8


def noise_bias_lrelu_stats_plain(x, noise, nscale, bias, *,
                                 leaky: float = 0.2):
    """The plain version of pass A: the CPU path and the kernel's
    reference.  -> (y in x's dtype, sum of y, sum of y^2 over H, W as
    (N, C) f32)."""
    v = x.float() + noise[..., None] * nscale + bias
    v = torch.where(v >= 0, v, leaky * v)
    y = v.to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))


def adain_apply_plain(x, mean, var, ys, yb, *, eps: float = 1e-5,
                      count: int = 0):
    """The plain version of pass B: ``(x - mean) * rsqrt(max(var, 0) +
    eps) * (ys + 1) + yb`` in f32, rounded once to x's dtype.  ``count`` >
    0: ``mean`` and ``var`` are the sums of v and v^2 over ``count``
    pixels."""
    if count:
        mean = mean / count
        var = var / count - mean * mean
    r = torch.rsqrt(torch.clamp_min(var, 0.0) + eps)
    t = (x.float() - mean[:, None, None, :]) * r[:, None, None, :]
    t = t * (ys.float() + 1.0)[:, None, None, :]
    return (t + yb.float()[:, None, None, :]).to(x.dtype)


def _check_x(x):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    _build.check(x, "x", x.shape, x.dtype, x.device)
    if x.shape[3] > 1024:
        raise ValueError(f"at most 1024 channels, got {x.shape[3]}")
    return x.shape


def check_stats_args(x, noise, nscale, bias):
    """Raise unless pass A takes these (x NHWC bf16 / f32, noise (N, H, W)
    f32, nscale and bias (C,) f32, one device, contiguous); -> (n, h, w,
    c)."""
    n, h, w, c = _check_x(x)
    _build.check(noise, "noise", (n, h, w), torch.float32, x.device)
    _build.check(nscale, "nscale", (c,), torch.float32, x.device)
    _build.check(bias, "bias", (c,), torch.float32, x.device)
    return n, h, w, c


def check_apply_args(x, mean, var, ys, yb):
    """Raise unless pass B takes these (x NHWC bf16 / f32 contiguous, mean
    and var (N, C) f32 contiguous, ys and yb (N, C) in x's dtype with unit
    channel stride: the affine's halves as views); -> (n, h, w, c)."""
    n, h, w, c = _check_x(x)
    _build.check(mean, "mean", (n, c), torch.float32, x.device)
    _build.check(var, "var", (n, c), torch.float32, x.device)
    for t, name in ((ys, "ys"), (yb, "yb")):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (n, c):
            raise ValueError(f"{name} must be an ({n}, {c}) tensor")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if c > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit channel stride")
    return n, h, w, c


@functools.lru_cache(maxsize=None)
def tile_plan(n: int, p: int, c: int, sms: int):
    """(pixels a block, blocks an image) of a pass over ``n`` images of
    ``p`` pixels and ``c`` channels on ``sms`` SMs: about
    ``_BLOCKS_PER_SM`` blocks an SM over the batch, none with fewer than
    ``_BLOCK_ELEMS`` elements unless the image has fewer."""
    least_px = max(1, _BLOCK_ELEMS // c)
    want = max(1, -(-_BLOCKS_PER_SM * sms // n))
    tiles = max(1, min(want, -(-p // least_px)))
    tile_px = -(-p // tiles)
    return tile_px, -(-p // tile_px)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_tiles(x):
    """``tile_plan`` for x (N, H, W, C) on its card."""
    n, h, w, c = x.shape
    return tile_plan(n, h * w, c, _sms(x.device.index))


def noise_bias_lrelu_stats(x, noise, nscale, bias, *, leaky: float = 0.2):
    """Pass A: -> (y, sum of y, sum of y^2) through the custom op
    ``torch.ops.gst.noise_bias_lrelu_stats``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    check_stats_args(x, noise, nscale, bias)
    return torch.ops.gst.noise_bias_lrelu_stats(x, noise, nscale, bias,
                                                float(leaky))


noise_bias_lrelu_stats.launches = 0  # counted in kernels/ops.py


def adain_apply(x, mean, var, ys, yb, *, eps: float = 1e-5, count: int = 0):
    """Pass B through the custom op ``torch.ops.gst.adain_apply``: (mean,
    var) as kernel 1 returns them, or with ``count`` > 0 the sums of v and
    v^2 over ``count`` pixels as pass A returns them.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    check_apply_args(x, mean, var, ys, yb)
    return torch.ops.gst.adain_apply(x, mean, var, ys, yb, float(eps),
                                     int(count))


adain_apply.launches = 0  # counted in kernels/ops.py

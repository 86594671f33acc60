"""Int8 generation: post-training quantization of the decoder and the
generator (PyTorch counterpart of ``gan_segmentation_tpu/ops/quant.py``).

The scheme is the JAX package's, site by site:

- **weights**: per-output-channel symmetric int8, ``scale = max(absmax,
  1e-12) / 127``, ``q = clip(round(k / scale), +-127)`` (``quantize_weight``);
- **activations**: one static scale per conv input, from the absmax of
  that input over fixed calibration batches (``quantize_act``, the
  ``quantize_s8`` kernel on a card);
- **conv**: s8 x s8 -> s32, exact, then ``float(acc) * deq + bias`` in f32,
  cast to the compute dtype; the elementwise tail (leaky, concat, residual
  add) is the float path's.

Every 3x3 site runs an s8 body of kernels 1 and 2 (``csrc/conv3x3_tc.cuh``):

- the decoder's 3x3 convs on its own layout.  The JAX int8 decoder rides
  the space-to-depth tail (``ops/s2d_decoder.py``), which the port does not
  have; its integers are those of the natural layout except at the block
  stages' ``conv_0``, whose s2d kernel sums the taps that read the same
  coarse pixel and is quantized per (channel, output parity).  Here that
  site runs on the coarse grid with 4 x Cout channels in the JAX order
  ``c * 4 + parity`` and one depth-to-space copy (``depth_to_space``), so
  the port computes the JAX package's int8 model;
- the generator's ``conv_2`` (kernel 1's s8 body) and its up-sampling
  convs, the nearest-2x ``conv_1`` (a composed 4x4 kernel over the
  zero-inserted input, ``compose_kernel_2d``) and the k4 s2 p1 ``deconv_1``,
  in sub-pixel form: the four output parities of the 4x4 kernel are a 3x3
  conv over the coarse input with 4 x Cout channels (``subpixel_kernel``),
  the same integer products.

The 1x1 sites (the decoder's shortcut, the generator's ``to_rgb``) are
plain integer matrix products (``torch._int_mm`` on a card), as the JAX
package left them to XLA.

Calibration uses a fixed stream disjoint from the emission stream
(``calibration_batches``), so ``generate --resume`` keeps its byte
identity.  The XLA formulation policy of the JAX module (``INT8_FORM``,
``INT8_CHUNK_MB``, the im2col chunking) only picks between XLA emitters and
never changes a value; it has no counterpart here.
"""

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv_in_stats import conv3x3_noise_bias_lrelu_instats_s8
from ..kernels.quantize import quantize_s8
from ..kernels.small_conv import conv3x3_small, conv3x3_small_s8

_EPS = 1e-12
LEAKY_SLOPE = 0.2
CALIB_BATCH = 4
CALIB_BATCHES = 2


def calibration_batches(latent_size: int, device, batch: int = CALIB_BATCH,
                        n: int = CALIB_BATCHES
                        ) -> Tuple[List[torch.Tensor], List[torch.Generator]]:
    """The fixed calibration stream of every int8 entry point: ``n`` z
    batches of ``batch`` drawn from ``torch.Generator``s seeded 100 + i,
    and noise generators seeded 200 + i.  The JAX package draws its own
    (``PRNGKey(100 + i)``, ``PRNGKey(200 + i)``); threefry is not torch's,
    so the two streams differ, and tests hand both packages the same z and
    noise.  The emission stream (``ImageGenerator``'s seed) is untouched."""
    device = torch.device(device)
    zs = [torch.randn((batch, latent_size), device=device,
                      generator=torch.Generator(device).manual_seed(100 + i))
          for i in range(n)]
    gens = [torch.Generator(device).manual_seed(200 + i) for i in range(n)]
    return zs, gens


def quantize_weight(k) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel (any rank, output channels last) -> (int8 kernel, f32
    per-out-channel scale)."""
    k = k.float()
    absmax = k.abs().amax(dim=tuple(range(k.dim() - 1)))
    scale = torch.clamp_min(absmax, _EPS) / 127.0
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_act(x, inv):
    """Static per-tensor activation quantization (symmetric, saturating):
    ``clip(round(x.f32 * inv), +-127)``; ``inv`` a (1,) f32 tensor."""
    return quantize_s8(x.contiguous(), inv)


# ------------------------------------------------------- weight transforms
# Copies of ``gan_segmentation_tpu/ops/s2d_decoder.py``'s (weight transforms
# only; the s2d layout walk is not ported), pinned by the tests.

# For a conv over upsample_nearest_2x(x): fine output parity a reads coarse
# rows i-1+dy with fine kernel row ky, as (ky, dy) pairs.
_ROW_UP = {0: ((0, 0), (1, 1), (2, 1)),
           1: ((0, 1), (1, 1), (2, 2))}

# For a 4x4 kernel over the 2-dilated input padded by 2 (the composed
# nearest-2x conv, the k4 s2 p1 deconv): output parity a reads coarse rows
# i-1+dy with kernel row ky, as (ky, dy) pairs.
_ROW_DIL = {0: ((0, 0), (2, 1)),
            1: ((1, 1), (3, 2))}


def _plan(num_feats: int, start_res: int, n_block_stages: int):
    """(num_feats, start_res, first_block) of the JAX s2d tail: the resblock
    stages i >= first_block are its block stages, whose conv_0 runs on the
    coarse grid here too."""
    if num_feats - start_res < 2:
        raise ValueError("int8 needs a resblock and a final stage (decoder "
                         "too shallow)")
    n_block = max(1, min(n_block_stages, num_feats - 1 - start_res))
    return num_feats, start_res, num_feats - 1 - n_block


def upsample_conv_kernel_s2d(w):
    """(3, 3, Ci, Co) kernel of conv(upsample2x(x)) -> (3, 3, Ci, 4 Co)
    kernel over x, output channel c * 4 + parity; the taps that read the
    same coarse pixel are summed (in w's dtype)."""
    ci, co = w.shape[2], w.shape[3]
    out = w.new_zeros((3, 3, ci, 4 * co))
    for a in (0, 1):
        for b in (0, 1):
            p = a * 2 + b
            for ky, dy in _ROW_UP[a]:
                for kx, dx in _ROW_UP[b]:
                    out[dy, dx, :, p::4] += w[ky, kx]
    return out


def subpixel_kernel(k):
    """(4, 4, Ci, Co) kernel over the 2-dilated input with padding 2 ->
    (3, 3, Ci, 4 Co) kernel over the coarse input with padding 1, output
    channel c * 4 + parity: each entry placed once (an s8 kernel stays the
    same integers), zeros elsewhere."""
    ci, co = k.shape[2], k.shape[3]
    out = k.new_zeros((3, 3, ci, 4 * co))
    for a in (0, 1):
        for b in (0, 1):
            p = a * 2 + b
            for ky, dy in _ROW_DIL[a]:
                for kx, dx in _ROW_DIL[b]:
                    out[dy, dx, :, p::4] = k[ky, kx]
    return out


def depth_to_space(x):
    """(N, H, W, 4C), channel c * 4 + parity (parity = a * 2 + b for fine
    pixel (2i + a, 2j + b)) -> (N, 2H, 2W, C)."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, 2 * h, 2 * w, c)


# ------------------------------------------------------------- int8 state
class QConv(nn.Module):
    """One int8 conv site: ``w`` int8 in the layout its product takes (3x3:
    (3, 3, Cout, Cin), the kernels' [tap][Cout][Cin]; 1x1: (Cin, Cout8),
    Cout padded to a multiple of 8 for ``torch._int_mm``), ``deq`` (Cout,)
    f32, ``b`` (Cout,) f32 or None, ``inv`` (1,) f32 = 1 / the input's
    scale.  Buffers, so a CUDA graph reads the tensors a requantization
    overwrites, and an export carries them."""

    def __init__(self, w, deq, b, inv):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("deq", deq)
        self.register_buffer("b", b)
        self.register_buffer("inv", inv)

    @property
    def cout(self) -> int:
        return self.deq.shape[0]


class QuantState(nn.Module):
    """The int8 sites of a model by name (``"cvt_3"``, ``"main_5.conv_0"``,
    ``"block_4.conv_2"``, ...); ``first_block`` (decoder) is the first
    resblock stage whose conv_0 runs on the coarse grid."""

    def __init__(self, sites: Mapping[str, QConv],
                 first_block: Optional[int] = None):
        super().__init__()
        self.names = tuple(sites)
        self.first_block = first_block
        self.sites = nn.ModuleDict({k.replace(".", "__"): v
                                    for k, v in sites.items()})

    def __getitem__(self, name: str) -> QConv:
        return self.sites[name.replace(".", "__")]

    def get(self, name: str) -> Optional[QConv]:
        key = name.replace(".", "__")
        return self.sites[key] if key in self.sites else None

    @torch.no_grad()
    def copy_(self, other: "QuantState") -> "QuantState":
        """Overwrite every tensor with ``other``'s, in place."""
        if self.names != other.names:
            raise ValueError("int8 states of different sites")
        mine = dict(self.named_buffers())
        for k, v in other.named_buffers():
            mine[k].copy_(v)
        return self


def record_absmax(absmax: Optional[dict], name: str, x) -> None:
    """Calibration: max-reduce ``|x|`` into ``absmax[name]`` (a dict of f32
    scalar tensors) when ``absmax`` is given."""
    if absmax is not None:
        v = x.float().abs().amax()
        absmax[name] = torch.maximum(absmax[name], v) if name in absmax else v


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor([v], dtype=torch.float32, device=device)


def qconv3x3(x, q: QConv, act: Optional[str], out_dtype, xq=None):
    """The 3x3 site: quantize x (unless ``xq`` is given), kernel 2's s8
    body, dequantize, bias, activation ("leaky" or None)."""
    if xq is None:
        xq = quantize_act(x, q.inv)
    return conv3x3_small_s8(xq, q.w, q.deq, q.b,
                            leaky=LEAKY_SLOPE if act == "leaky" else None,
                            out_dtype=out_dtype)


def matmul_s8(a, b):
    """(M, K) s8 @ (K, N) s8 -> (M, N) s32, exact: ``torch._int_mm`` on a
    card (K and N multiples of 8, M > 16), a float64 product on the CPU."""
    if a.device.type != "cuda":
        return (a.double() @ b.double()).round().to(torch.int32)
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b)[:m]


def qconv1x1(x, q: QConv, out_dtype, xq=None):
    """The 1x1 site: quantize x (unless ``xq`` is given), one integer
    matrix product over the pixels, ``float(acc) * deq + b``."""
    if xq is None:
        xq = quantize_act(x, q.inv)
    n, h, w, cin = xq.shape
    acc = matmul_s8(xq.reshape(n * h * w, cin), q.w)[:, :q.cout]
    y = acc.float() * q.deq
    if q.b is not None:
        y = y + q.b
    return y.reshape(n, h, w, q.cout).to(out_dtype)


def qsubpixel(x, q: QConv, out_dtype):
    """A 4x4 kernel over the 2-dilated x (``subpixel_kernel``): the coarse
    3x3 s8 conv with 4 x Cout channels, then depth-to-space."""
    return depth_to_space(qconv3x3(x, q, None, out_dtype))


def qconv3x3_in_stats(x, q: QConv, noise, nscale, bias, out_dtype):
    """The generator's conv_2 site: kernel 1's s8 body -> (y, mean, var)."""
    return conv3x3_noise_bias_lrelu_instats_s8(
        quantize_act(x, q.inv), q.w, q.deq, noise, nscale, bias,
        leaky=LEAKY_SLOPE, out_dtype=out_dtype)


def _layout3x3(wq):
    """HWIO int8 (3, 3, Cin, Cout) -> the kernels' (3, 3, Cout, Cin)."""
    return wq.permute(0, 1, 3, 2).contiguous()


def _layout1x1(wq):
    """(1, 1, Cin, Cout) int8 -> (Cin, Cout8), zero columns to a multiple
    of 8."""
    w = wq[0, 0]
    pad = -w.shape[1] % 8
    return F.pad(w, (0, pad)).contiguous() if pad else w.contiguous()


# ----------------------------------------------------------------- decoder
def _fold(conv, bn):
    """(f32 HWIO kernel, f32 bias) of a conv and its eval BN, folded as the
    JAX package's ``prepare_s2d`` folds: ``mul = scale * rsqrt(var + eps)``,
    ``k * mul``, ``b * mul + (shift - mean * mul)``."""
    from ..models.decoder import BN_EPS
    k = conv.weight.detach().float().permute(2, 3, 1, 0)
    b = conv.bias.detach().float().clone()
    if bn is not None:
        mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
        k = k * mul
        b = b * mul + (bn.bias.float() - bn.running_mean.float() * mul)
    return k, b


def decoder_site_weights(dec, n_block_stages: int = 3):
    """({site: (f32 HWIO kernel, f32 bias)}, first_block) of the decoder's
    int8 model, in forward order, BN folded in f32; a block stage's conv_0
    as ``upsample_conv_kernel_s2d`` (its taps summed in f32) with its bias
    tiled to c * 4 + parity.  The shortcut's kernel is 1x1."""
    last = len(dec.in_channels) - 1
    _, sres, first_block = _plan(last + 1, dec.start_res, n_block_stages)
    out = {}
    for i in range(sres, last + 1):
        out[f"cvt_{i}"] = _fold(getattr(dec, f"cvt_{i}_conv"),
                                getattr(dec, f"cvt_{i}_bn", None))
        if i == last:
            out[f"main_{i}_conv"] = _fold(getattr(dec, f"main_{i}_conv"),
                                          None)
            continue
        blk = getattr(dec, f"main_{i}")
        for k in (0, 1):
            w, b = _fold(getattr(blk, f"conv_{k}"), getattr(blk, f"bn_{k}",
                                                            None))
            if k == 0 and i >= first_block:
                w, b = upsample_conv_kernel_s2d(w), b.repeat_interleave(4)
            out[f"main_{i}.conv_{k}"] = (w, b)
        if blk.shortcut is not None:
            out[f"main_{i}.shortcut"] = _fold(blk.shortcut, None)
    return out, first_block


@torch.no_grad()
def collect_calibration(dec, inputs: Sequence[torch.Tensor], dtype,
                        n_block_stages: int = 3, weights=None
                        ) -> Dict[str, torch.Tensor]:
    """absmax of every int8 site's input over ONE batch of features:
    ``{site: f32 scalar tensor}``, on the float path of the int8 model's
    own folded weights (``decoder_site_weights``, cast to ``dtype``), the
    JAX package's ``apply_s2d_prepared`` walk over this layout: a block
    stage's conv_0 on the coarse grid with its summed kernel.  The 3x3
    convs run kernel 2 in ``dtype``."""
    from .conv import conv2d
    from .resize import upsample_nearest_2x
    weights, first_block = weights or decoder_site_weights(dec,
                                                           n_block_stages)
    kb = {k: (w.to(dtype).contiguous(), b.to(dtype).float())
          for k, (w, b) in weights.items()}
    rec: Dict[str, torch.Tensor] = {}

    def conv(site, x, act="leaky"):
        record_absmax(rec, site, x)
        return conv3x3_small(x, *kb[site],
                             leaky=LEAKY_SLOPE if act == "leaky" else None)

    last = len(dec.in_channels) - 1
    prev = None
    for i in range(dec.start_res, last + 1):
        x = conv(f"cvt_{i}", inputs[i].to(dtype).contiguous())
        if i > dec.start_res:
            x = torch.cat([prev, x], dim=-1)
        if i == last:
            record_absmax(rec, f"main_{i}_conv", x)
            break
        name = f"main_{i}"
        if i >= first_block:
            y = depth_to_space(conv(f"{name}.conv_0", x))
        else:
            y = conv(f"{name}.conv_0", upsample_nearest_2x(x))
        y = conv(f"{name}.conv_1", y)
        sc = x
        if f"{name}.shortcut" in kb:
            record_absmax(rec, f"{name}.shortcut", x)
            w, b = kb[f"{name}.shortcut"]
            sc = conv2d(x, w, b.to(dtype))
        prev = upsample_nearest_2x(sc) + y
    return rec


def check_shortcut_scales(scales: Mapping[str, float]) -> None:
    """A resblock's shortcut reads conv_0's input (or its coarse pixels,
    which hold the same absmax), so ``Decoder.forward_int8`` quantizes that
    input once for both; ``scales`` ({site: absmax or inv}) must give the
    two sites one value."""
    for site, v in scales.items():
        if site.endswith(".shortcut"):
            k0 = site[:-len("shortcut")] + "conv_0"
            if float(v) != float(scales[k0]):
                raise ValueError(f"{site} and {k0} read one input but have "
                                 f"the scales {float(v)} and "
                                 f"{float(scales[k0])}")


def decoder_sites(dec, n_block_stages: int = 3) -> List[str]:
    """The decoder's int8 sites, in forward order."""
    return list(decoder_site_weights(dec, n_block_stages)[0])


@torch.no_grad()
def prepare_decoder_int8(dec, calib_inputs: Sequence[Sequence[torch.Tensor]],
                         dtype, n_block_stages: int = 3,
                         stats: Optional[Mapping[str, float]] = None
                         ) -> QuantState:
    """Quantize the decoder for ``Decoder.forward_int8``: the JAX package's
    ``prepare_s2d_int8`` over the natural layout.  ``calib_inputs``: a few
    feature pyramids (the absmax is max-reduced over them), or ``stats``
    ({site: absmax}) given instead.  Fold order as the JAX package: BN in
    f32, block conv_0's taps summed in f32, cast to ``dtype``, then
    ``quantize_weight`` of the rounded values; biases the f32 of the
    rounded ones; ``inv = 1 / s_in`` and ``deq = s_w * s_in`` with ``s_in =
    max(absmax, 1e-12) / 127``."""
    weights = decoder_site_weights(dec, n_block_stages)
    if stats is None:
        if not calib_inputs:
            raise ValueError("need at least one calibration pyramid")
        stats = {}
        for feats in calib_inputs:
            for site, v in collect_calibration(dec, feats, dtype,
                                               weights=weights).items():
                stats[site] = max(stats.get(site, 0.0), float(v))
    check_shortcut_scales(stats)
    sites = {}
    for site, (w, b) in weights[0].items():
        wq, wscale = quantize_weight(w.to(dtype))
        s_in = max(float(stats[site]), _EPS) / 127.0
        dev = w.device
        sites[site] = QConv(
            _layout1x1(wq) if w.shape[0] == 1 else _layout3x3(wq),
            wscale * _f32(s_in, dev), b.to(dtype).float(),
            _f32(np.float32(1.0 / s_in), dev))
    return QuantState(sites, weights[1])


# --------------------------------------------------------------- generator
def generator_sites(model) -> List[str]:
    """The generator's int8 sites, in forward order: every synthesis conv
    (``block_r.conv_1`` / ``deconv_1``, ``block_r.conv_2``) and ``to_rgb``.
    The mapping network and the style affines stay float."""
    out = []
    for res in range(2, model.cfg.max_res_log2 + 1):
        blk = getattr(model, f"block_{res}")
        if not blk.first:
            out.append(f"block_{res}.{blk.up_name}")
        out.append(f"block_{res}.conv_2")
    out.append(f"to_rgb_{model.cfg.max_res_log2}")
    return out


@torch.no_grad()
def calibrate_generator(model, calib_zs: Sequence[torch.Tensor],
                        noises: Sequence[Mapping[str, torch.Tensor]]
                        ) -> Dict[str, float]:
    """absmax of every int8 site's input (``generator_sites``) over the
    calibration batches, on the float path."""
    stats: Dict[str, torch.Tensor] = {}
    for z, noise in zip(calib_zs, noises):
        model(z, noise=noise, absmax=stats)
    return {k: float(v) for k, v in stats.items()}


def generator_quant_scales(stats: Mapping[str, float]) -> Dict[str, float]:
    """absmax -> the static input scales, ``inv_in = 127 / absmax`` (f32),
    as the JAX package's ``quant`` collection holds them."""
    return {k: float(np.float32(127.0 / max(float(v), _EPS)))
            for k, v in stats.items()}


@torch.no_grad()
def layer_int8(layer, inv: float) -> QConv:
    """The int8 state of one generator conv (``Conv2DW`` or
    ``Conv2DTransposeW``) with input scale ``inv``: its kernel quantized
    from ``int8_kernel()`` (f32, as the JAX package does at trace time),
    ``deq = s_w / inv``; a 4x4 kernel (the composed nearest-2x conv, the k4
    s2 p1 deconv) in sub-pixel form, a 1x1 one for the integer product."""
    inv = _f32(inv, layer.weight.device)
    k = layer.int8_kernel()
    wq, wscale = quantize_weight(k)
    deq = wscale / inv
    b = None
    if getattr(layer, "bias", None) is not None:
        b = (layer.bias * layer.lr_mult).to(layer.compute_dtype).float()
    if k.shape[0] == 4:
        return QConv(_layout3x3(subpixel_kernel(wq)),
                     deq.repeat_interleave(4), b, inv)
    w = _layout1x1(wq) if k.shape[0] == 1 else _layout3x3(wq)
    return QConv(w, deq, b, inv)


def generator_int8_state(model, invs: Mapping[str, float]) -> QuantState:
    """The generator's int8 state from its weights and the input scales
    ``invs`` ({site: inv_in}, ``generator_quant_scales``)."""
    return QuantState({site: layer_int8(model.get_submodule(site), invs[site])
                       for site in generator_sites(model)})


def conv3x3_s8_shapes(gcfg, scfg, batch: int, quant: str = "int8-full",
                      n_block_stages: int = 3):
    """{kernel: [(n, h, w, cin, cout), ...]} of every s8 3x3 call of one
    generate batch under ``quant``: kernel 2's s8 body (``small_conv_s8``)
    at the decoder's 3x3 sites and, under int8-full, the generator's
    up-sampling convs in sub-pixel form; kernel 1's (``conv_in_stats_s8``)
    at every conv_2.  Pure shapes, for the launch plans and the card's
    checks."""
    sy, sx = gcfg.base_scale_y, gcfg.base_scale_x
    f, ins = list(scfg.features), list(scfg.in_channels)
    last = len(ins) - 1
    _, sres, first_block = _plan(last + 1, scfg.start_res, n_block_stages)
    k2 = []
    for i in range(sres, last + 1):
        h, w = sy * 2 ** i, sx * 2 ** i
        k2.append((batch, h, w, ins[i], f[i]))
        c_in = f[i] * (2 if i > sres else 1)
        if i == last:
            k2.append((batch, h, w, c_in, f[i + 1]))
        elif i >= first_block:
            k2 += [(batch, h, w, c_in, 4 * f[i + 1]),
                   (batch, 2 * h, 2 * w, f[i + 1], f[i + 1])]
        else:
            k2 += [(batch, 2 * h, 2 * w, c_in, f[i + 1]),
                   (batch, 2 * h, 2 * w, f[i + 1], f[i + 1])]
    k1 = []
    if quant == "int8-full":
        for res in range(2, gcfg.max_res_log2 + 1):
            h, w, c = sy * 2 ** (res - 2), sx * 2 ** (res - 2), \
                gcfg.num_features(res)
            if res > 2:
                k2.append((batch, h // 2, w // 2, gcfg.num_features(res - 1),
                           4 * c))
            k1.append((batch, h, w, c, c))
    return {"conv_in_stats_s8": k1, "small_conv_s8": k2}


def quantize_generator(model, calib_zs, noises) -> QuantState:
    """Calibrate on the float path and quantize: the int8 state of every
    synthesis conv of the generator (``int8-full``)."""
    return generator_int8_state(model, generator_quant_scales(
        calibrate_generator(model, calib_zs, noises)))

"""``generate --spatial N``: each image's rows split into bands over the N
cards of one row of the generation grid (PyTorch counterpart of the
JAX package's ``(data, space)`` mesh: ``gan_segmentation_tpu/core/mesh.py::
make_mesh_2d``, ``spatial_mesh`` and ``constrain_spatial``, and the spatial
branch of ``train/generator.py::FusedPipeline``).  There XLA's SPMD
partitioner shards H, inserts the convs' halo exchanges and turns the
instance-norm sums into all-reduces; here this module does each of those
by hand, for ``train/generator.py::GridProgram``.

The band rule (the port's own, not XLA's padding).  The generator's
activations double in height at every block.  Heights below N (the
mapping network and the first blocks, as far as they are that small) run
whole on the row's first card.  From the first height H0 >= N, band k
holds the rows ``tensor_split(range(H0), N)[k]`` (the first ``H0 % N``
bands one row more), and each later height doubles the bounds, so that a
nearest-2x upsample of band k at height h is exactly band k at 2h, and an
up-sampling conv's output band reads only its input band and one row on
either side.  Any N >= 2 works, an N that does not divide H0 (3) too; the
image needs at least N rows.  The decoder's stages take the same bands at
the same heights.

The halo exchange (``with_halo``).  A 3x3 conv (and the 3x3 blur, and an
up-sampling conv on the coarser grid) over band k reads one row of band
k - 1 and one of band k + 1: each band gets its neighbours' edge rows,
and rows of zeros at the image's top and bottom, so the conv pads W only
(the row-band forms of kernels 1 and 2, ``kernels/ops.py``).  Inside one
process a neighbour's row is a ``Tensor.to`` of another card's tensor
(within the card where the grid repeats one): PyTorch orders such a copy
by events between the two cards' current streams, on both sides, with no
global synchronize.  The nearest-2x upsample, the concat, the 1x1 convs
and the per-pixel tails (bias, noise, leaky, class mask, bit-packing,
uint8) need no halo.

Cross-band statistics (``band_moments``).  AdaIN's instance norm needs the
mean and variance of the whole image: each band gives its per-(image,
channel) sums of v and v^2 (kernel 1's row-band form returns them for
AdaIN 2, the block's first pass, ``kernels/adain_fused.py::
noise_bias_lrelu_stats``, for AdaIN 1), they are added on the row's first
card in band order (band 0 first) and the mean and variance (E[v^2] -
mean^2, clamped at 0 by the apply, ``adain_fused.adain_apply``) go back to
every card, so every card normalizes with the same numbers.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.adain_fused import noise_bias_lrelu_stats
from ..kernels.conv_in_stats import conv3x3_noise_bias_lrelu_instats_rows
from ..kernels.small_conv import conv3x3_small, conv3x3_small_rows
from ..ops.blur import _cached_kernel
from ..ops.resize import upsample_nearest_2x

Bounds = Tuple[Tuple[int, int], ...]


def band_rows(h: int, n: int) -> Bounds:
    """The (start, stop) rows of ``n`` bands of ``h`` rows:
    ``torch.tensor_split``'s sizes (the first ``h % n`` one row more)."""
    q, r = divmod(h, n)
    out, start = [], 0
    for k in range(n):
        stop = start + q + (k < r)
        out.append((start, stop))
        start = stop
    return tuple(out)


class BandPlan:
    """The band rule of one generator (``heights``: the rows of its
    activations, block by block) over ``n`` cards: ``bounds(h)`` is None for
    a height that runs whole, else each band's (start, stop) rows."""

    def __init__(self, heights: Sequence[int], n: int):
        if n < 2:
            raise ValueError(f"a band plan needs 2 or more bands, got {n}")
        first = [h for h in heights if h >= n]
        if not first:
            raise ValueError(f"--spatial {n}: the images have "
                             f"{max(heights)} rows, fewer than the bands")
        self.n = n
        self.first = first[0]
        self.heights = tuple(heights)

    @classmethod
    def of(cls, cfg, n: int) -> "BandPlan":
        """The plan of a ``GanConfig``'s generator."""
        return cls([cfg.base_scale_y * 2 ** (r - 2)
                    for r in range(2, cfg.max_res_log2 + 1)], n)

    def bounds(self, h: int) -> Optional[Bounds]:
        if h not in self.heights:
            raise ValueError(f"height {h} is none of the generator's "
                             f"{self.heights}")
        if h < self.first:
            return None
        f = h // self.first
        return tuple((a * f, b * f) for a, b in band_rows(self.first, self.n))


class Bands(NamedTuple):
    """An activation of one grid row: ``bounds`` None and ``parts`` = [the
    whole tensor on the row's first card], or one band per card."""
    parts: List[torch.Tensor]
    bounds: Optional[Bounds]


def whole(t: torch.Tensor) -> Bands:
    return Bands([t], None)


def as_bands(x: Bands, bounds: Optional[Bounds], devices) -> Bands:
    """``x`` laid out by ``bounds``: a whole tensor cut into bands, each
    copied to its card (no halo); a banded ``x`` must already have these
    bounds."""
    if bounds is None or x.bounds is not None:
        if x.bounds != bounds:
            raise ValueError(f"bands {x.bounds} where {bounds} are needed")
        return x
    t = x.parts[0]
    return Bands([t[:, a:b].to(d) for (a, b), d in zip(bounds, devices)],
                 bounds)


def with_halo(x: Bands, bounds: Bounds, devices) -> List[torch.Tensor]:
    """Each band of ``bounds`` with the row above and the row below it, a
    neighbour's edge row or zeros at the image's top and bottom: (N, rows
    + 2, W, C) per card, contiguous."""
    if x.bounds is None:  # cut from the whole tensor, padded once
        t = F.pad(x.parts[0], (0, 0, 0, 0, 1, 1))
        return [t[:, a:b + 2].to(d).contiguous()
                for (a, b), d in zip(bounds, devices)]
    if x.bounds != bounds:
        raise ValueError(f"bands {x.bounds} where {bounds} are needed")
    parts, out = x.parts, []
    last = len(parts) - 1
    for k, (p, d) in enumerate(zip(parts, devices)):
        edge = (p.shape[0], 1, *p.shape[2:])
        # contiguous edge rows: given a strided row (a view within one
        # card), torch.cat takes its generic kernel, 4x slower on the card
        # than the vectorized one (chip_smoke.halo_cat_ms)
        top = (parts[k - 1][:, -1:].to(d).contiguous() if k > 0
               else p.new_zeros(edge))
        bottom = (parts[k + 1][:, :1].to(d).contiguous() if k < last
                  else p.new_zeros(edge))
        out.append(torch.cat([top, p.contiguous(), bottom], dim=1))
    return out


def gather(x: Bands, device) -> torch.Tensor:
    """The whole tensor on ``device``: the bands concatenated along H."""
    if x.bounds is None:
        return x.parts[0].to(device)
    return torch.cat([p.to(device) for p in x.parts], dim=1)


def band_moments(sums: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 count: int, devices) -> List[Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """(mean, var) per (image, channel) of the whole image, on every card,
    from each band's (sum of v, sum of v^2): added on the first card in
    band order, so every card gets the same numbers; var = E[v^2] - mean^2,
    not clamped (``adain_fused.adain_apply`` clamps)."""
    dev0 = devices[0]
    s1 = s2 = None
    for a, b in sums:
        a, b = a.to(dev0), b.to(dev0)
        s1 = a if s1 is None else s1 + a
        s2 = b if s2 is None else s2 + b
    mean = s1 / count
    var = s2 / count - mean * mean
    return [(mean.to(d), var.to(d)) for d in devices]


def conv_rows(x, w, b=None, groups: int = 1):
    """NHWC x HWIO conv with padding (0, kw // 2): x carries its halo rows,
    so the conv pads W only (the plain convs of the band path: the
    up-sampling conv and the blur)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(0, w.shape[1] // 2), groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b.to(y.dtype)


def blur_rows(x):
    """``ops/blur.py::blur_3x3`` over a band with its halo rows."""
    c = x.shape[-1]
    return conv_rows(x, _cached_kernel(c, x.dtype, x.device), groups=c)


def up_weights(block):
    """(kernel, bias) of the block's up-sampling conv as ``up_rows`` takes
    them: the nearest-2x conv's effective HWIO kernel and scaled bias, or
    the deconv's kernel in PyTorch's (Cin, Cout, kh, kw) and no bias (its
    module adds none)."""
    conv = getattr(block, block.up_name)
    cd = conv.compute_dtype
    if block.up_name == "conv_1":
        return conv.effective_weight(), (
            None if conv.bias is None else (conv.bias * conv.lr_mult).to(cd))
    # Conv2DTransposeW.forward's kernel
    wt = (conv.weight * conv.scale).permute(2, 3, 0, 1).flip(0, 1)
    return wt.to(cd).flip(0, 1).permute(2, 3, 0, 1), None


def up_rows(block, x, weights=None):
    """The block's up-sampling conv over one band: ``x`` holds the band's
    rows of the coarser grid with a halo row on either side (rows a-1 ..
    b of the input for output rows 2a .. 2b-1) -> the band's rows.  The
    nearest-2x conv (8^2-64^2) drops the upsampled halo's outer rows and
    pads W only; the k4 s2 p1 deconv (from 128^2) pads H by 3, the rows
    whose outputs lie outside the band.  ``weights``: ``up_weights(block)``
    (made here when None)."""
    conv = getattr(block, block.up_name)
    w, b = up_weights(block) if weights is None else weights
    x = x.to(conv.compute_dtype)
    if block.up_name == "conv_1":
        return conv_rows(upsample_nearest_2x(x)[:, 1:-1], w, b)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=conv.stride,
                           padding=(conv.padding + 2, conv.padding))
    return y.permute(0, 2, 3, 1)


def block_weights(blocks, up: bool) -> List[tuple]:
    """Per band, the block's kernels that it derives from its parameters:
    (``up_weights`` where ``up``, else None; conv_2's effective kernel),
    made once a distinct module, so a grid that repeats a card makes them
    once a batch, not once a band."""
    made: Dict[int, tuple] = {}
    for blk in blocks:
        if id(blk) not in made:
            made[id(blk)] = (up_weights(blk) if up else None,
                             blk.conv_2.effective_weight().contiguous())
    return [made[id(blk)] for blk in blocks]


def noise_rows(noise: Optional[torch.Tensor], bounds: Bounds, devices):
    """Each band's rows of a noise drawn for the whole batch."""
    return [noise[:, a:b].to(d) for (a, b), d in zip(bounds, devices)]


def banded_block(blocks, devices, x: Bands, w1, w2, noise1, noise2,
                 bounds: Bounds) -> Bands:
    """One synthesis block (``models/stylegan.py::StyleBlock.forward``,
    float path) over the bands ``bounds``: ``blocks[k]`` and ``w1[k]``,
    ``w2[k]`` on ``devices[k]``; ``noise1`` and ``noise2`` the block's
    whole (N, H, W, 1) noise on the first card."""
    b0 = blocks[0]
    kernels = block_weights(blocks, up=not b0.first
                            and x.bounds is not None)
    if b0.first:  # the constant: cut into bands
        y = as_bands(x, bounds, devices).parts
    else:
        if x.bounds is None:  # the coarser grid runs whole: so does the conv
            up = whole(getattr(b0, b0.up_name)(x.parts[0]))
        else:
            coarse = tuple((a // 2, b // 2) for a, b in bounds)
            up = Bands([up_rows(blk, t, k[0]) for blk, t, k in zip(
                blocks, with_halo(x, coarse, devices), kernels)], bounds)
        y = [blur_rows(t) for t in with_halo(up, bounds, devices)]
    outs = [noise_bias_lrelu_stats(
        t.contiguous(), n[..., 0].contiguous(), blk.noise_1.scale_factors,
        blk.bias_1.bias, leaky=0.2)
        for blk, t, n in zip(blocks, y, noise_rows(noise1, bounds, devices))]
    h, w = noise1.shape[1:3]
    stats = band_moments([(s1, s2) for _, s1, s2 in outs], h * w, devices)
    y = [blk.adain_1.apply_stats(t, m, v, s)
         for blk, (t, _, _), (m, v), s in zip(blocks, outs, stats, w1)]
    outs = [conv3x3_noise_bias_lrelu_instats_rows(
        t, k[1], n[..., 0].contiguous(), blk.noise_2.scale_factors,
        blk.bias_2.bias, leaky=0.2)
        for blk, t, n, k in zip(blocks, with_halo(Bands(y, bounds), bounds,
                                                  devices),
                                noise_rows(noise2, bounds, devices), kernels)]
    stats = band_moments([(s1, s2) for _, s1, s2 in outs], h * w, devices)
    return Bands([blk.adain_2.apply_stats(t, m, v, s)
                  for blk, (t, _, _), (m, v), s in zip(blocks, outs, stats,
                                                       w2)], bounds)


def synthesize(models, devices, z, noise: Dict[str, torch.Tensor],
               plan: BandPlan) -> Tuple[Bands, List[Bands]]:
    """``StyleGanGenerator.forward`` (float path) over one grid row:
    ``models[k]`` on ``devices[k]``; z and the noise (drawn for the whole
    batch, ``StyleGanGenerator.draw_noise``) on the first card.  -> (rgb,
    the feature pyramid), each as bands where the plan bands its height."""
    m0 = models[0]
    cfg, cd = m0.cfg, m0.compute_dtype
    w = m0.mapping(z).float()
    y = whole(m0.constant_tensor.expand(
        z.shape[0], *m0.constant_tensor.shape[1:]).to(cd))
    psi, avg = m0.truncation_psi, m0.latent_avg
    features = []
    for res in range(2, cfg.max_res_log2 + 1):
        i = 2 * (res - 2)
        w1 = m0.lerp(psi[i], avg, w).to(cd)
        w2 = m0.lerp(psi[i + 1], avg, w).to(cd)
        n1, n2 = (noise[f"block_{res}.noise_{j}"] for j in (1, 2))
        bounds = plan.bounds(n1.shape[1])
        name = f"block_{res}"
        if bounds is None:
            y = whole(getattr(m0, name)(y.parts[0], w1, w2, (n1, n2)))
        else:
            y = banded_block([getattr(m, name) for m in models], devices, y,
                             [w1.to(d) for d in devices],
                             [w2.to(d) for d in devices], n1, n2, bounds)
        features.append(y)
    site = f"to_rgb_{cfg.max_res_log2}"
    rgb = Bands([getattr(m, site)(t) for m, t in zip(models, y.parts)],
                y.bounds)
    return rgb, features


def conv_small(x: Bands, bounds: Optional[Bounds], devices, wb,
               leaky: Optional[float]) -> Bands:
    """A decoder 3x3 conv through kernel 2: whole on the first card where
    ``bounds`` is None, else its row-band form on every card over
    ``with_halo``.  ``wb[k]``: (kernel, bias) on card k."""
    if bounds is None:
        return whole(conv3x3_small(x.parts[0].contiguous(), *wb[0],
                                   leaky=leaky))
    return Bands([conv3x3_small_rows(t, *p, leaky=leaky) for t, p in zip(
        with_halo(x, bounds, devices), wb)], bounds)


def decode(decoders, folded, devices, feats: List[Bands], dtype,
           plan: BandPlan, leaky: float = 0.2) -> Bands:
    """``models/decoder.py::Decoder.forward`` (eval, BN folded) over one
    grid row: ``decoders[k]`` and ``folded[k]`` (its ``fold_bn`` dict) on
    ``devices[k]``; ``feats`` the generator's pyramid as ``synthesize``
    gives it.  -> the f32 logits as bands."""
    d0 = decoders[0]
    last = len(d0.in_channels) - 1
    prev = None

    def per_band(x: Bands, fn):
        return Bands([fn(t) for t in x.parts], x.bounds)

    def conv(x, name, bounds, act=leaky):
        return conv_small(x, bounds, devices, [f[name] for f in folded],
                          act)

    for i in range(d0.start_res, last + 1):
        f = feats[i]
        x = per_band(f, lambda t: t.to(dtype).contiguous())
        x = conv(x, f"cvt_{i}", f.bounds)
        if i > d0.start_res:
            x = Bands([torch.cat([p, t], dim=-1)
                       for p, t in zip(prev.parts, x.parts)], x.bounds)
        if i == last:
            return per_band(conv(x, f"main_{i}_conv", x.bounds, None),
                            lambda t: t.float())
        h = 2 * (x.parts[0].shape[1] if x.bounds is None
                 else x.bounds[-1][1])
        bounds = plan.bounds(h)
        up = [upsample_nearest_2x(t) for t in x.parts]
        # a band's upsample is the band of the doubled bounds
        x = Bands(up, None if x.bounds is None else bounds)
        name = f"main_{i}"
        y = conv(x, f"{name}.conv_0", bounds)
        y = conv(y, f"{name}.conv_1", bounds)
        x = as_bands(x, bounds, devices)
        blocks = [getattr(d, name) for d in decoders]
        prev = Bands([(t if blk.shortcut is None else blk.shortcut(t)) + u
                      for blk, t, u in zip(blocks, x.parts, y.parts)],
                     bounds)

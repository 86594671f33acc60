"""The arithmetic of the DeepLab cell (``deeplab-r50-sync4``): its seeded
weights and crops, its model FLOP counted from the shapes, the device-trace
families its readers sum (NCCL's all-reduces and the batch norms), its host
span reading, and the gaps its check compares.

The model's shapes are the configuration's (``model``): the dilated
resnet50_v1s at output stride 8, ASPP, the decoder at stride 4 and the aux
head, as the plain reference (``configs/deeplab_sync_ref.py``) computes
them.  A multiply-add counts as 2 FLOP.
"""

import math
import statistics

import numpy as np

from . import counts, readers, spans

# the published init's lecun normal: a normal of variance 1 / fan_in cut at
# two standard deviations, whose own standard deviation this divides out
TRUNC_STD = 0.87962566103423978
# the label of the pixels the loss ignores (the padding of a crop)
IGNORE = -1
# c3's channels (layer3: 256 planes x 4), a quarter of which the aux head
# keeps
C3 = 1024


def out_size(n, stride):
    """A 3x3 conv's or pool's output size with padding 1, or a 1x1's."""
    return (n - 1) // stride + 1


def convs(model, crop):
    """Every conv of one sample's forward: (name, out_h * out_w, cin per
    group, cout, k, needs_dx); ``needs_dx``: its input needs a gradient
    (every conv but the stem's first, which reads the image)."""
    from_stem = [(f"stem_conv{k}", ci, co) for k, (ci, co) in enumerate(
        ((model["in_channels"], model["stem_width"]),
         (model["stem_width"], model["stem_width"]),
         (model["stem_width"], 2 * model["stem_width"])))]
    s = out_size(crop, 2)
    out = [(n, s * s, ci, co, 3, k > 0)
           for k, (n, ci, co) in enumerate(from_stem)]
    s = out_size(s, 2)                          # the max-pool
    ch = 2 * model["stem_width"]
    c1 = c3 = None
    for i, (blocks, planes) in enumerate(zip(model["layers"],
                                             (64, 128, 256, 512)), start=1):
        out_ch = 4 * planes
        for b in range(blocks):
            c_in = ch if b == 0 else out_ch
            stride = 2 if (i == 2 and b == 0) else 1
            so = out_size(s, stride)
            name = f"layer{i}_block{b}"
            out += [(f"{name}.conv1", s * s, c_in, planes, 1, True),
                    (f"{name}.conv2", so * so, planes, planes, 3, True),
                    (f"{name}.conv3", so * so, planes, out_ch, 1, True)]
            if b == 0 and (stride != 1 or ch != out_ch):
                out.append((f"{name}.downsample", so * so, ch, out_ch, 1,
                            True))
            s = so
        ch = out_ch
        if i == 1:
            c1 = (s, out_ch)
        if i == 3:
            c3 = (s, out_ch)
    s4, c4 = s, ch
    a, skip, ncls = (model["aspp_channels"], model["skip_channels"],
                     model["nclass"])
    n_rates = len(model["atrous_rates"])
    p4, p1 = s4 * s4, c1[0] * c1[0]
    out.append(("skip_project", p1, c1[1], skip, 1, True))
    out.append(("aspp.b0", p4, c4, a, 1, True))
    out += [(f"aspp.b{bi}", p4, c4, a, 3, True)
            for bi in range(1, n_rates + 1)]
    out.append(("aspp.pool", 1, c4, a, 1, True))
    out.append(("aspp.project", p4, a * (n_rates + 2), a, 1, True))
    for name, ci in (("head_sep0", a + skip), ("head_sep1", a)):
        out.append((f"{name}.depthwise", p1, 1, ci, 3, True))
        out.append((f"{name}.pointwise", p1, ci, a, 1, True))
    out.append(("head_classifier", p1, a, ncls, 1, True))
    if model["aux"]:
        p3 = c3[0] * c3[0]
        out.append(("auxlayer.conv0", p3, c3[1], c3[1] // 4, 3, True))
        out.append(("auxlayer.conv1", p3, c3[1] // 4, ncls, 1, True))
    return out


def train_flop_per_sample(model, crop):
    """Model FLOP of one sample of a train step: every conv's forward and
    weight gradient, and the input gradient of every conv whose input needs
    one (no recompute)."""
    flop = 0
    for _, px, ci, co, k, dx in convs(model, crop):
        one = 2 * px * ci * co * k * k
        flop += one * (3 if dx else 2)
    return flop


def mfu_pct(stretch, flop_per_sample, samples_per_unit):
    """The model FLOP of the samples this card completed in the stretch
    over its seconds, over one card's TF32 peak (the convs' precision), %."""
    if readers.empty(stretch) or stretch.seconds <= 0:
        return None
    rate = flop_per_sample * samples_per_unit * stretch.units / stretch.seconds
    return 100.0 * rate / counts.PEAK["tf32"]


# ------------------------------------------------------------ the trace

def is_nccl(name):
    return name.lower().startswith("nccl")


def is_bn(name):
    return "batch_norm" in name


def is_cat(name):
    return "CatArrayBatchedCopy" in name


def _kernels(stretch):
    from .trace import is_copy
    return [e for e in stretch.ops if not is_copy(e.name)]


def nccl_ms_per_unit(stretch):
    """Device ms a step in NCCL's kernels (the all-reduces: their wait for
    the other cards included)."""
    if readers.empty(stretch):
        return None
    ms = sum(e.end - e.start for e in _kernels(stretch) if is_nccl(e.name))
    return ms / 1e3 / stretch.units


def nccl_launches_per_unit(stretch):
    if readers.empty(stretch):
        return None
    return sum(is_nccl(e.name) for e in _kernels(stretch)) / stretch.units


def bn_ms_per_unit(stretch):
    """Device ms a step in the batch norms' kernels: PyTorch's
    ``batch_norm_*`` kernels (statistics, elemt, backward reduce and
    elemt) and the cats of their sums, a cat being a sum's where the next
    kernel is an NCCL all-reduce and the last batch-norm, library or NCCL
    kernel before it is a batch norm's (the gradients' flat buffer follows
    a library kernel, the model's own cats precede one)."""
    if readers.empty(stretch):
        return None
    from .trace import family
    ks = _kernels(stretch)
    us, anchor = 0.0, None
    for i, e in enumerate(ks):
        if is_bn(e.name):
            us += e.end - e.start
            anchor = "bn"
        elif is_nccl(e.name):
            anchor = "nccl"
        elif family(e.name) == "library":
            anchor = "library"
        elif (is_cat(e.name) and anchor == "bn" and i + 1 < len(ks)
              and is_nccl(ks[i + 1].name)):
            us += e.end - e.start
    return us / 1e3 / stretch.units


def head_step_host_ms(stretch):
    """The median over the first ``spans.HEAD_STEPS`` ``gst.dl.step``
    spans that start in the stretch of the step's host time less its graph
    call's (``gst.graph.*``), ms; the stretch starts on an empty launch
    queue, so these steps' launches wait for no room in it."""
    found = spans.starting_inside(stretch, "gst.dl.step")
    if found is None:
        return None
    steps = sorted(found, key=lambda e: e.start)[:spans.HEAD_STEPS]
    graph = [e for e in stretch.host if e.name.startswith("gst.graph.")]
    return statistics.median(spans.own_us(s, spans.within(graph, s))
                             for s in steps) / 1e3


# ------------------------------------------------------------ the inputs

def weights(torch, ref_spec, device, stream):
    """Every parameter and buffer of ``ref_spec`` (the reference's ``spec``)
    on ``device``: conv kernels lecun normal (variance 1 / fan_in, fan_in =
    Cin per group x kh x kw, cut at two standard deviations) drawn from
    the seed's ``torch.Generator`` ``stream``, the rest
    as the published init leaves them (batch norm's scale 1, shift 0,
    running mean 0 and variance 1, biases 0)."""
    out = {}
    for name, shape, kind in ref_spec:
        if kind == "conv":
            std = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD
            t = torch.empty(shape, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=stream)
        elif kind in ("bn_weight", "var"):
            t = torch.ones(shape, device=device)
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t
    return out


def crop_pool(torch, seed, rank, size, crop, band_max, nclass):
    """A rank's resident host pool of ``size`` crops from the seed and the
    rank: (images (size, crop, crop, 3) uint8, masks (size, crop, crop)
    int8).  Each image is a smooth random field (a 6 x 6 grid of colours
    resized bilinearly) under a brightness and contrast of its own, so
    that crops differ in their global content as photographs do, plus
    noise; its mask is class 1 inside an ellipse of
    random centre and radii, class 0 outside, and -1 over a band of
    0-``band_max`` rows at the bottom and columns at the right, where the
    image is black (the padding of a crop larger than its scaled image)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, rank])
    gain = rng.uniform(0.25, 1.0, (size, 1, 1, 1))
    grid = (rng.uniform(0.0, 255.0, (size, 3, 6, 6)) * gain
            + rng.uniform(0.0, 1.0, (size, 1, 1, 1)) * 255.0 * (1.0 - gain))
    field = torch.nn.functional.interpolate(
        torch.from_numpy(grid), size=(crop, crop), mode="bilinear",
        align_corners=True)
    noise = rng.normal(0.0, 24.0, (size, crop, crop, 3))
    images = np.clip(field.permute(0, 2, 3, 1).numpy() + noise, 0,
                     255).astype(np.uint8)
    masks = np.zeros((size, crop, crop), np.int8)
    yy, xx = np.mgrid[0:crop, 0:crop]
    for i in range(size):
        cy, cx = rng.uniform(0.2, 0.8, 2) * crop
        ry, rx = rng.uniform(0.15, 0.45, 2) * crop
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        masks[i][inside] = min(1, nclass - 1)
        bh, bw = rng.integers(0, band_max + 1, 2)
        if bh:
            images[i, crop - bh:] = 0
            masks[i, crop - bh:] = IGNORE
        if bw:
            images[i, :, crop - bw:] = 0
            masks[i, :, crop - bw:] = IGNORE
    return images, masks


def pool_batch(pool, per_card, step):
    """Step ``step``'s host batch of ``per_card`` crops from a pool:
    consecutive crops, round the pool."""
    images, masks = pool
    idx = [(per_card * step + j) % len(images) for j in range(per_card)]
    return images[idx], masks[idx]


def dropout_shapes(model, crop, per_card):
    """The shapes of a step's dropout draws on one card, in the forward's
    order (the ASPP's output, the aux head's hidden layer), NHWC."""
    s = crop
    for _ in range(3):
        s = (s + 1) // 2
    shapes = [(per_card, s, s, model["aspp_channels"])]
    if model["aux"]:
        shapes.append((per_card, s, s, C3 // 4))
    return shapes


# ------------------------------------------------------------ the check

def gap_of_norms(got, want, leaves):
    """(the largest over ``leaves`` of |‖got‖ - ‖want‖| over the larger of
    ‖want‖ of the leaf and of the median leaf, that leaf)."""
    norms = {k: float(want[k].norm()) for k in leaves}
    med = float(np.median(list(norms.values())))
    worst, at = 0.0, None
    for k in leaves:
        gap = abs(float(got[k].norm()) - norms[k]) / max(norms[k], med,
                                                          1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def gap_of_differences(got, want, leaves):
    """(the largest over ``leaves`` of ‖got - want‖ over the larger of
    ‖want‖ of the leaf and of the median leaf, that leaf)."""
    norms = {k: float(want[k].norm()) for k in leaves}
    med = float(np.median(list(norms.values())))
    worst, at = 0.0, None
    for k in leaves:
        gap = float((got[k] - want[k]).norm()) / max(norms[k], med, 1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def whole_gap(got, want, leaves):
    """‖got - want‖ over ‖want‖, every leaf of ``leaves`` in one vector."""
    num = sum(float((got[k] - want[k]).double().square().sum())
              for k in leaves)
    den = sum(float(want[k].double().square().sum()) for k in leaves)
    return math.sqrt(num / max(den, 1e-300))

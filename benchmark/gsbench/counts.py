"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes of each hand-written kernel's calls, and the model FLOPs of a
configuration, all counted from the configuration's shapes.

Copied from the port's own sound arithmetic (``chip_smoke.py::
{conv_floors, bound, PEAK, HBM_RATE, kernel1_shapes, kernel2_shapes,
bil_shapes}``) so that a later change to the program cannot move the
yardstick.  A kernel's bound counts each input byte read once and each
output byte written once; bf16 runs at the bf16 peak, f32 as 3xTF32 (three
TF32 products per f32 product at the TF32 peak), as the port's f32 bodies
compute it.  A multiply-add counts as 2 FLOP.
"""

# NVIDIA H100 SXM data sheet, dense rates: HBM bytes/s and operations/s
HBM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}

# kernel 3's contract (``kernels/bil_conv.py::MAX_LANES``): batch x Cin and
# batch x Cout at most 128 lanes; the other train-mode 3x3 convs run kernel 2
BIL_MAX_LANES = 128


def precision_rate(precision):
    """(operations per FLOP, peak operations/s) of a stated precision: bf16
    at its peak, f32 as 3xTF32 (3 TF32 operations per FLOP)."""
    if precision == "bf16":
        return 1, PEAK["bf16"]
    if precision == "f32":
        return 3, PEAK["tf32"]
    raise ValueError(f"no peak for precision {precision!r}")


def effective_peak(precision):
    """FLOP/s at the stated precision's peak (f32: 495 / 3 TFLOP/s)."""
    per_flop, rate = precision_rate(precision)
    return rate / per_flop


def conv_floors(n, h, w, cin, cout, elem, extra_bytes=0):
    """(bytes, FLOP) of one 3x3 conv: x, w and y each moved once (``elem``
    bytes an element) plus ``extra_bytes`` (bias, noise, statistics)."""
    nbytes = elem * (n * h * w * (cin + cout) + 9 * cin * cout) + extra_bytes
    return nbytes, 18 * n * h * w * cin * cout


def bound_ms(nbytes, flop, precision):
    """The least ms of a call: the larger of its bytes over HBM and its
    FLOP at the precision's rate."""
    per_flop, rate = precision_rate(precision)
    return max(nbytes / HBM_RATE, flop * per_flop / rate) * 1e3


def num_features(gan, res_log2):
    """`networks_stylegan.py:114-116`."""
    fmaps = int(gan["fmap_base"] / (2.0 ** ((res_log2 - 1)
                                            * gan["fmap_decay"])))
    return min(fmaps, gan["fmap_max"])


def kernel1_calls(gan, batch):
    """(n, h, w, cin, cout) of kernel 1's calls in one batch: the conv_2 of
    every synthesis block (conv3x3 + noise + bias + leaky + statistics)."""
    out = []
    for res in range(2, gan["max_res_log2"] + 1):
        c = num_features(gan, res)
        s = 2 ** res
        out.append((batch, gan["base"] * s // 4, gan["base"] * s // 4, c, c))
    return out


def kernel1_bound_ms(gan, batch, precision):
    """Σ over one batch's kernel-1 calls of the call's bound: x, w, y, the
    f32 noise, noise scale and bias in, the f32 statistics out."""
    elem = 2 if precision == "bf16" else 4
    total = 0.0
    for n, h, w, cin, cout in kernel1_calls(gan, batch):
        nbytes, flop = conv_floors(n, h, w, cin, cout, elem,
                                   4 * (n * h * w + 2 * cout + 2 * n * cout))
        total += bound_ms(nbytes, flop, precision)
    return total


def decoder_convs(dec, res0, batch):
    """Every conv of the decoder on a pyramid whose first level is
    ``res0`` x ``res0``: (name, n, h, w, cin, cout, k, needs_dx), k the
    kernel size (3, or 1 for a shortcut); ``needs_dx``: its input needs a
    gradient in training (every conv but the ``cvt_i``, which read the
    pyramid)."""
    f, cin = dec["features"], dec["in_channels"]
    start = dec.get("start_res", 0)
    last = len(cin) - 1
    out = []
    for i in range(start, last + 1):
        r = res0 * 2 ** i
        out.append((f"cvt_{i}", batch, r, r, cin[i], f[i], 3, False))
        c_in = f[i] * (2 if i > start else 1)
        if i < last:
            out.append((f"main_{i}.conv_0", batch, 2 * r, 2 * r, c_in,
                        f[i + 1], 3, True))
            out.append((f"main_{i}.conv_1", batch, 2 * r, 2 * r, f[i + 1],
                        f[i + 1], 3, True))
            if c_in != f[i + 1]:
                out.append((f"main_{i}.shortcut", batch, 2 * r, 2 * r, c_in,
                            f[i + 1], 1, True))
        else:
            out.append((f"main_{i}_conv", batch, r, r, c_in, f[i + 1], 3,
                        True))
    return out


def kernel2_calls(dec, res0, batch):
    """(n, h, w, cin, cout) of kernel 2's calls in an eval-mode decoder
    batch: every 3x3 conv, BN folded, bias and leaky fused."""
    return [c[1:6] for c in decoder_convs(dec, res0, batch) if c[6] == 3]


def kernel2_bound_ms(dec, res0, batch, precision):
    """Σ over the eval decoder's kernel-2 calls of the call's bound (x, w,
    y and the f32 bias)."""
    elem = 2 if precision == "bf16" else 4
    total = 0.0
    for n, h, w, cin, cout in kernel2_calls(dec, res0, batch):
        nbytes, flop = conv_floors(n, h, w, cin, cout, elem, 4 * cout)
        total += bound_ms(nbytes, flop, precision)
    return total


def kernel3_calls(dec, res0, batch):
    """(label, n, h, w, cin, cout, bias) of kernel 3's calls in one train
    step: the forward 3x3 convs inside its contract (with bias) and every
    input gradient of a 3x3 conv (Cin and Cout swapped, no bias)."""
    out = []
    for name, n, h, w, cin, cout, k, dx in decoder_convs(dec, res0, batch):
        if k != 3:
            continue
        fits = n * cin <= BIL_MAX_LANES and n * cout <= BIL_MAX_LANES
        if fits:
            out.append((f"{name} fwd", n, h, w, cin, cout, True))
        if dx and fits:
            out.append((f"{name} dX", n, h, w, cout, cin, False))
    return out


def kernel3_bound_ms(dec, res0, batch, precision="f32"):
    """Σ over one train step's kernel-3 calls of the call's bound."""
    elem = 2 if precision == "bf16" else 4
    total = 0.0
    for _, n, h, w, cin, cout, bias in kernel3_calls(dec, res0, batch):
        nbytes, flop = conv_floors(n, h, w, cin, cout, elem,
                                   4 * cout if bias else 0)
        total += bound_ms(nbytes, flop, precision)
    return total


def generator_flop(gan, batch=1):
    """Model FLOP of one generator forward: the mapping's dense layers,
    every AdaIN affine, every synthesis conv (the nearest-2x conv on the
    up-sampled grid, the k4 s2 transposed conv on its input's pixels), the
    [1,2,1] blur as a depthwise 3x3 conv, and to_rgb."""
    lat = gan["latent_size"]
    flop = 8 * 2 * lat * lat                       # mapping
    top = gan["max_res_log2"]
    for res in range(2, top + 1):
        c = num_features(gan, res)
        s = gan["base"] * 2 ** res // 4
        flop += 2 * 2 * lat * 2 * c                # two AdaIN affines
        if res > 2:
            c_in = num_features(gan, res - 1)
            if res >= gan.get("fused_upscale_from", 7):
                flop += 2 * 16 * c_in * c * (s // 2) ** 2   # deconv k4 s2
            else:
                flop += 2 * 9 * c_in * c * s * s   # conv3x3 after up-2x
            flop += 2 * 9 * c * s * s              # blur (depthwise)
        flop += 2 * 9 * c * c * s * s              # conv_2
    c_top = num_features(gan, top)
    s_top = gan["base"] * 2 ** top // 4
    flop += 2 * c_top * gan["channels"] * s_top * s_top   # to_rgb 1x1
    return batch * flop


def decoder_flop(dec, res0, batch=1, train=False):
    """Model FLOP of the decoder on one batch: every 3x3 and 1x1 conv;
    ``train``: forward, the weight gradient of every conv and the input
    gradient of every conv whose input needs one (no recompute)."""
    flop = 0
    for _, n, h, w, cin, cout, k, dx in decoder_convs(dec, res0, batch):
        one = 2 * k * k * cin * cout * n * h * w
        flop += one
        if train:
            flop += one + (one if dx else 0)
    return flop


def generate_flop_per_sample(cfg):
    """Model FLOP of one (image, mask) pair of a generate configuration."""
    return (generator_flop(cfg["gan"]) +
            decoder_flop(cfg["decoder"], cfg["gan"]["base"]))


def train_flop_per_sample(cfg):
    """Model FLOP of one sample of a decoder train step."""
    return decoder_flop(cfg["decoder"], cfg["pyramid"]["base"], train=True)

"""Independent pure-numpy transliteration of the reference forward math.

A frozen copy of ``tests/ref_numpy.py``, which the benchmark's tests hold
its plain reference to. It re-derives the generator + decoder forward passes DIRECTLY
from the reference sources — mapping/truncation/synthesis
(the reference's `networks_stylegan.py:128-197`), the custom layers
(`:200-565`), and the Decoder (`networks_seg.py:49-114`) —
sharing NO code with `gan_segmentation_tpu` (numpy only; no jax, no
package imports). It consumes the raw mxnet-named weight dicts (the same
ones the converters eat) in the reference's own NCHW layout, so
`tests/test_numpy_parity.py` can assert per-block agreement between this
and the converted-weights package forward.

Everything here is eval-mode and noise-free by contract: the parity tests
zero the `*_noise_*_scale_factors` entries so the stochastic AddNoise term
(`networks_stylegan.py:267-305`) contributes exactly 0 in both
implementations (its scale-multiply semantics are unit-tested separately).
"""

import numpy as np

# -------------------------------------------------------------------------
# primitives (all NCHW, float32)
# -------------------------------------------------------------------------


def conv2d(x, w, b=None, stride=1, pad=0):
    """Plain cross-correlation, mxnet ``F.Convolution`` semantics
    (`networks_stylegan.py:414-416`). x (N,C,H,W), w (O,I,kh,kw)."""
    n, c, h, ww = x.shape
    o, i, kh, kw = w.shape
    assert i == c, (i, c)
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (ww + 2 * pad - kw) // stride + 1
    out = np.zeros((n, o, ho, wo), np.float32)
    for ki in range(kh):
        for kj in range(kw):
            patch = xp[:, :, ki:ki + ho * stride:stride,
                       kj:kj + wo * stride:stride]
            out += np.einsum("nchw,oc->nohw", patch, w[:, :, ki, kj],
                             optimize=True)
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out.astype(np.float32)


def deconv2d_k4s2p1(x, w):
    """mxnet ``Deconvolution`` kernel 4, stride 2, pad 1, no bias — the
    fused-upscale block0 (`networks_stylegan.py:16-17,460-476`). Weight is
    mxnet deconv layout (I, O, kh, kw); output spatial = 2x input.

    Transposed conv == zero-dilate the input by the stride, pad by
    ``k - 1 - p``, and cross-correlate with the HW-flipped kernel
    transposed to (O, I, kh, kw)."""
    n, i, h, ww = x.shape
    xd = np.zeros((n, i, 2 * h - 1, 2 * ww - 1), np.float32)
    xd[:, :, ::2, ::2] = x
    wt = np.transpose(w[:, :, ::-1, ::-1], (1, 0, 2, 3))
    out = conv2d(xd, wt, pad=2)  # k-1-p = 4-1-1 = 2; out = 2h
    assert out.shape[2] == 2 * h, out.shape
    return out


def upsample_nearest_2x(x):
    """``F.UpSampling(scale=2, sample_type='nearest')``
    (`networks_stylegan.py:308-315`)."""
    return x.repeat(2, axis=2).repeat(2, axis=3)


def blur_121(x):
    """Depthwise [1,2,1] x [1,2,1] blur, kernel normalized to sum 1, pad 1
    (`networks_stylegan.py:200-236`)."""
    k1 = np.array([1.0, 2.0, 1.0], np.float32)
    k = np.outer(k1, k1)
    k /= k.sum()
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    h, w = x.shape[2], x.shape[3]
    out = np.zeros_like(x)
    for ki in range(3):
        for kj in range(3):
            out += k[ki, kj] * xp[:, :, ki:ki + h, kj:kj + w]
    return out


def leaky_relu(x, slope=0.2):
    return np.where(x >= 0, x, slope * x).astype(np.float32)


def pixel_norm(x, eps=1e-8):
    """x * rsqrt(mean(x^2, channel axis) + eps)
    (`networks_stylegan.py:558-565`); on the 2-D mapping input the channel
    axis is axis 1."""
    return (x / np.sqrt(np.mean(np.square(x), axis=1, keepdims=True) + eps)
            ).astype(np.float32)


def instance_norm(x, eps=1e-5):
    """mxnet ``nn.InstanceNorm(center=False, scale=False)`` — per-(N,C)
    spatial standardization with biased variance, eps 1e-5 (mxnet default;
    `networks_stylegan.py:246-247`)."""
    mean = x.mean(axis=(2, 3), keepdims=True)
    var = np.square(x - mean).mean(axis=(2, 3), keepdims=True)
    return ((x - mean) / np.sqrt(var + eps)).astype(np.float32)


def batch_norm_eval(x, gamma, beta, mean, var, eps=1e-5):
    """mxnet ``nn.BatchNorm`` inference: running-stat standardize + affine
    (`networks_seg.py:17-18`; eps 1e-5 mxnet default)."""
    inv = 1.0 / np.sqrt(var + eps)
    return ((x - mean.reshape(1, -1, 1, 1)) * (gamma * inv).reshape(1, -1, 1, 1)
            + beta.reshape(1, -1, 1, 1)).astype(np.float32)


def dense_w(x, weight, bias=None, use_wscale=True, gain=np.sqrt(2.0),
            lr_mult=1.0):
    """``DenseW`` (`networks_stylegan.py:479-531`): runtime wscale
    ``weight * gain/sqrt(fan_in) * lr_mult`` (fan_in = in_units), bias
    scaled by lr_mult, then FullyConnected. Weight is (units, in)."""
    w = weight
    if use_wscale:
        w = w * np.float32(gain / np.sqrt(weight.shape[1]))
    w = w * np.float32(lr_mult)
    y = x @ w.T
    if bias is not None:
        y = y + bias * np.float32(lr_mult)
    return y.astype(np.float32)


def conv_w_scale(weight, kh, kw, in_ch, use_wscale=True, gain=np.sqrt(2.0),
                 lr_mult=1.0):
    """The _ConvW runtime weight scale (`networks_stylegan.py:398-416`):
    std = gain / sqrt(kh*kw*in_channels), applied at forward time."""
    w = weight
    if use_wscale:
        w = w * np.float32(gain / np.sqrt(kh * kw * in_ch))
    return (w * np.float32(lr_mult)).astype(np.float32)


def adain(x, w_latent, affine_weight, affine_bias, use_wscale=True):
    """AdaIN (`networks_stylegan.py:239-264`): affine DenseW(2C, gain=1)
    on w; split (N,2C)->(N,2,C) so ys is the FIRST C and yb the second;
    out = instance_norm(x) * (ys + 1) + yb."""
    y = dense_w(w_latent, affine_weight, affine_bias,
                use_wscale=use_wscale, gain=1.0)
    c = x.shape[1]
    ys = y[:, :c].reshape(-1, c, 1, 1)
    yb = y[:, c:].reshape(-1, c, 1, 1)
    return (instance_norm(x) * (ys + 1.0) + yb).astype(np.float32)


# -------------------------------------------------------------------------
# generator (`networks_stylegan.py:76-197`)
# -------------------------------------------------------------------------

def num_features(res_log2, fmap_base=8192, fmap_decay=1.0, fmap_max=512):
    """`networks_stylegan.py:114-116` with the pipeline constants from
    `image_generator.py:52-54`."""
    return min(int(fmap_base / (2.0 ** ((res_log2 - 1) * fmap_decay))),
               fmap_max)


def mapping_forward(p, z, use_wscale=True):
    """PixelNorm + 8 x (DenseW(512, gain sqrt2, lr_mult 0.01) + lrelu 0.2)
    (`networks_stylegan.py:128-139`, lr_mult at `image_generator.py:42`)."""
    x = pixel_norm(z.astype(np.float32))
    for i in range(8):
        x = dense_w(x, p[f"mp_dense_{i}_weight"], p[f"mp_dense_{i}_bias"],
                    use_wscale=use_wscale, gain=np.sqrt(2.0), lr_mult=0.01)
        x = leaky_relu(x)
    return x


def _truncate(psi, latent_avg, w):
    """lerp: latent_avg * (1 - psi) + w * psi
    (`networks_stylegan.py:158-163`)."""
    return (latent_avg.reshape(1, -1) * (1.0 - psi)
            + w * psi).astype(np.float32)


def _style_block(p, scale, y, w1, w2, res_log2, in_ch, use_wscale=True):
    """StyleGeneratorBlock.hybrid_forward (`networks_stylegan.py:56-73`):
    [upsample -> conv3x3 | deconv k4s2p1] -> blur -> (noise) -> bias ->
    lrelu -> AdaIN(w1) -> conv3x3 -> (noise) -> bias -> lrelu -> AdaIN(w2).

    res_log2 == 2 has no first conv and no blur (`:147-151`); the
    fused-upscale deconv gate is res_log2 >= 7 (`:154`). Noise terms are
    exact zeros under the zeroed-scale contract (module docstring), so the
    AddNoise draw is skipped entirely."""
    c = num_features(res_log2)
    if res_log2 >= 3:
        if res_log2 >= 7:
            w = p[f"{scale}_deconv_1_weight"] * np.float32(
                np.sqrt(2.0) / np.sqrt(4 * 4 * in_ch) if use_wscale else 1.0)
            y = deconv2d_k4s2p1(y, w)
        else:
            y = upsample_nearest_2x(y)
            y = conv2d(y, conv_w_scale(p[f"{scale}_conv_1_weight"], 3, 3,
                                       in_ch, use_wscale), pad=1)
        y = blur_121(y)
    # block1: AddNoise (zeroed) -> Bias -> lrelu  (`:37-41`)
    y = y + p[f"{scale}_bias_1_bias"].reshape(1, -1, 1, 1)
    y = leaky_relu(y)
    y = adain(y, w1, p[f"{scale}_adain_1_dense_affine_weight"],
              p[f"{scale}_adain_1_dense_affine_bias"], use_wscale)
    # block2: conv3x3 -> AddNoise (zeroed) -> Bias -> lrelu  (`:45-52`)
    y = conv2d(y, conv_w_scale(p[f"{scale}_conv_2_weight"], 3, 3, c,
                               use_wscale), pad=1)
    y = y + p[f"{scale}_bias_2_bias"].reshape(1, -1, 1, 1)
    y = leaky_relu(y)
    y = adain(y, w2, p[f"{scale}_adain_2_dense_affine_weight"],
              p[f"{scale}_adain_2_dense_affine_bias"], use_wscale)
    return y


def generator_forward(p, z, max_res_log2, use_wscale=True):
    """Generator.hybrid_forward (`networks_stylegan.py:165-197`).

    Returns ``(rgb, features, w)`` in NCHW; ``features[i]`` is the block
    output at resolution 2^(i+2), ``w`` the raw mapping output.

    Asserts every ``*_noise_*_scale_factors`` entry is zero — the
    noise-free contract under which this transliteration is exact.
    """
    for name, v in p.items():
        if name.endswith("_scale_factors"):
            assert not np.any(v), f"{name} must be zeroed for parity runs"

    w = mapping_forward(p, z, use_wscale)
    psi = p["truncation_psi"].astype(np.float32)
    latent_avg = p["latent_avg"].astype(np.float32)

    batch = z.shape[0]
    const = p["constant_tensor"].astype(np.float32)
    y = np.broadcast_to(const, (batch,) + const.shape[1:]).astype(np.float32)

    features = []
    for res in range(2, max_res_log2 + 1):
        w1 = _truncate(psi[2 * (res - 2)], latent_avg, w)
        w2 = _truncate(psi[2 * (res - 2) + 1], latent_avg, w)
        in_ch = num_features(res - 1) if res > 2 else num_features(res)
        y = _style_block(p, 2 ** res, y, w1, w2, res, in_ch, use_wscale)
        features.append(y)

    top = 2 ** max_res_log2
    rgb = conv2d(y, conv_w_scale(p[f"{top}_conv_to_rgb_weight"], 1, 1,
                                 num_features(max_res_log2), use_wscale,
                                 gain=1.0),
                 b=p[f"{top}_conv_to_rgb_bias"])
    return rgb, features, w


# -------------------------------------------------------------------------
# decoder (`networks_seg.py:49-114`), eval mode
# -------------------------------------------------------------------------

def decoder_forward(features, p, cfg):
    """Decoder.hybrid_forward (`networks_seg.py:98-114`) on the gluon
    creation-order named dict (conv{k}_*, batchnorm{k}_* in the layer
    creation order of `networks_seg.py:64-94`): all cvt blocks first, then
    the main blocks. Eval mode: BN uses running stats, Dropout is a no-op.

    ``features``: NCHW feature pyramid (the generator's); ``cfg``: any
    object with ``features`` / ``in_channels`` / ``start_res`` / ``use_bn``
    attributes mirroring the solver config lists (`seg_solver.py:119-129`)
    — duck-typed so this module needs no package import.
    Returns ``(logits, stage_outputs)``.
    """
    dec_features, in_channels = cfg.features, cfg.in_channels
    start_res, use_bn = cfg.start_res, cfg.use_bn
    n = len(in_channels)
    conv_idx = bn_idx = 0

    def conv(x, pad, k_unused=None):
        nonlocal conv_idx
        w = p[f"conv{conv_idx}_weight"]
        b = p[f"conv{conv_idx}_bias"]
        conv_idx += 1
        return conv2d(x, w, b, pad=pad)

    def bn(x):
        nonlocal bn_idx
        y = batch_norm_eval(x, p[f"batchnorm{bn_idx}_gamma"],
                            p[f"batchnorm{bn_idx}_beta"],
                            p[f"batchnorm{bn_idx}_running_mean"],
                            p[f"batchnorm{bn_idx}_running_var"])
        bn_idx += 1
        return y

    # pass 1 — cvt blocks (conv3x3 -> BN -> lrelu -> [dropout])
    # (`networks_seg.py:64-79`), consuming params in creation order
    cvt = []
    for i in range(start_res, n):
        x = conv(features[i], pad=1)
        if use_bn:
            x = bn(x)
        cvt.append(leaky_relu(x))

    # pass 2 — main blocks (`networks_seg.py:81-114`)
    prev = None
    stages = []
    for i in range(start_res, n):
        x = cvt[i - start_res]
        if i > start_res:
            x = np.concatenate([prev, x], axis=1)  # prev FIRST (`:109`)
        if i < n - 1:
            x = upsample_nearest_2x(x)
            # DecoderResBlock (`networks_seg.py:7-46`): 2x(conv-BN-lrelu),
            # then shortcut (1x1 conv iff in_c != conv_size) + base
            y = conv(x, pad=1)
            if use_bn:
                y = bn(y)
            y = leaky_relu(y)
            y = conv(y, pad=1)
            if use_bn:
                y = bn(y)
            y = leaky_relu(y)
            in_c = x.shape[1]
            if dec_features[i + 1] != in_c:
                sc = conv(x, pad=0)
            else:
                sc = x
            prev = sc + y
        else:
            prev = conv(x, pad=1)  # final plain 3x3 -> num_classes (`:89-93`)
        stages.append(prev)
    return prev, stages

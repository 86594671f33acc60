"""The plain reference of both configurations: the StyleGAN (v1) generator
with its feature pyramid, the segmentation decoder in eval and train mode,
its loss and an Adam step, in plain PyTorch, float32, NCHW.

It follows the published sources directly: NVlabs/stylegan
``training/networks_stylegan.py`` G_style (mapping 8 x 512, lr_mult 0.01,
truncation lerp per style layer, synthesis blocks [nearest-2x conv3x3 |
k4 s2 transposed conv] -> blur -> noise -> bias -> lrelu -> AdaIN ->
conv3x3 -> noise -> bias -> lrelu -> AdaIN, runtime wscale) as the
reference repository's mxnet port writes it (``networks_stylegan.py``),
and its decoder (``networks_seg.py:49-114``: cvt conv3x3 + BN + lrelu
[+ dropout 0.5], progressive fusion with residual blocks, a final conv3x3
to the classes) and solver (``seg_solver.py``: softmax cross entropy over
every pixel with ignored pixels weighted 0, Adam).  It is a torch rewrite
of the repository's pure-numpy oracle (``tests/ref_numpy.py``; a frozen
copy beside this benchmark's tests holds it) with the noise term and the
train mode added.  It imports nothing of the program.

Parameters come as one dict keyed by the program's parameter names (the
JAX package's names; layouts: dense (out, in), conv OIHW, transposed conv
(in, out, kh, kw), constant (1, H, W, C)), made by the benchmark.  The
caller sets float32 matmuls and convolutions to full precision
(``full_precision``); the lower-precision control turns TF32 on.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

LEAKY = 0.2
IN_EPS = 1e-5
BN_EPS = 1e-5
PIXEL_EPS = 1e-8
SQRT2 = math.sqrt(2.0)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions in full precision (``tf32``
    False) or in TF32 (the control), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def full_precision():
    return precision(False)


def num_features(gan, res_log2):
    fmaps = int(gan["fmap_base"] / (2.0 ** ((res_log2 - 1)
                                            * gan["fmap_decay"])))
    return min(fmaps, gan["fmap_max"])


def leaky(x):
    return torch.where(x >= 0, x, LEAKY * x)


def dense(x, weight, bias, gain, lr_mult=1.0):
    """DenseW: weight (out, in) scaled at run time by gain / sqrt(in) x
    lr_mult; bias x lr_mult."""
    scale = gain / math.sqrt(weight.shape[1]) * lr_mult
    return x @ (weight * scale).t() + bias * lr_mult


def wconv(x, weight, gain=SQRT2, padding=1):
    """Conv2DW without bias: OIHW weight scaled by gain / sqrt(kh kw Cin)."""
    o, i, kh, kw = weight.shape
    return F.conv2d(x, weight * (gain / math.sqrt(kh * kw * i)),
                    padding=padding)


def blur(x):
    """The [1,2,1] x [1,2,1] / 16 depthwise blur, padding 1."""
    k = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k = torch.outer(k, k)
    k = (k / k.sum()).expand(x.shape[1], 1, 3, 3)
    return F.conv2d(x, k, padding=1, groups=x.shape[1])


def instance_norm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + IN_EPS)


def adain(x, w, weight, bias):
    """instance_norm(x) * (ys + 1) + yb, (ys, yb) the affine of w (gain 1),
    ys the first C outputs."""
    y = dense(w, weight, bias, gain=1.0)
    c = x.shape[1]
    return instance_norm(x) * (y[:, :c, None, None] + 1.0) + \
        y[:, c:, None, None]


def mapping(p, gan, z):
    x = z / torch.sqrt(z.square().mean(dim=1, keepdim=True) + PIXEL_EPS)
    for i in range(8):
        x = leaky(dense(x, p[f"mapping.dense_{i}.weight"],
                        p[f"mapping.dense_{i}.bias"], SQRT2,
                        gan["mapping_lr_mult"]))
    return x


def noise_term(noise, scale):
    """(N, H, W, 1) noise times the per-channel scale, NCHW."""
    return noise.permute(0, 3, 1, 2) * scale[None, :, None, None]


def generator_forward(p, gan, z, noise):
    """-> (rgb NCHW, [features NCHW per resolution]).  ``noise`` maps
    ``block_{res}.noise_{1|2}`` to (N, H, W, 1) noise."""
    w = mapping(p, gan, z)
    psi, avg = p["truncation_psi"], p["latent_avg"]
    y = p["constant_tensor"].permute(0, 3, 1, 2).expand(
        z.shape[0], -1, -1, -1)
    feats = []
    for res in range(2, gan["max_res_log2"] + 1):
        blk = f"block_{res}"
        i = 2 * (res - 2)
        w1 = avg[None] * (1.0 - psi[i]) + w * psi[i]
        w2 = avg[None] * (1.0 - psi[i + 1]) + w * psi[i + 1]
        if res > 2:
            if res >= gan["fused_upscale_from"]:
                wt = p[f"{blk}.deconv_1.weight"]
                scale = SQRT2 / math.sqrt(16 * wt.shape[0])
                y = F.conv_transpose2d(y, wt * scale, stride=2, padding=1)
            else:
                y = wconv(F.interpolate(y, scale_factor=2, mode="nearest"),
                          p[f"{blk}.conv_1.weight"])
            y = blur(y)
        y = y + noise_term(noise[f"{blk}.noise_1"],
                           p[f"{blk}.noise_1.scale_factors"])
        y = leaky(y + p[f"{blk}.bias_1.bias"][None, :, None, None])
        y = adain(y, w1, p[f"{blk}.adain_1.affine.weight"],
                  p[f"{blk}.adain_1.affine.bias"])
        y = wconv(y, p[f"{blk}.conv_2.weight"])
        y = y + noise_term(noise[f"{blk}.noise_2"],
                           p[f"{blk}.noise_2.scale_factors"])
        y = leaky(y + p[f"{blk}.bias_2.bias"][None, :, None, None])
        y = adain(y, w2, p[f"{blk}.adain_2.affine.weight"],
                  p[f"{blk}.adain_2.affine.bias"])
        feats.append(y)
    top = gan["max_res_log2"]
    rgb = wconv(y, p[f"to_rgb_{top}.weight"], gain=1.0, padding=0) + \
        p[f"to_rgb_{top}.bias"][None, :, None, None]
    return rgb, feats


def to_uint8(rgb, imrange=(-1.0, 1.0)):
    """NCHW (-1, 1) -> NHWC uint8, truncating as the reference's astype."""
    lo, hi = imrange
    x = torch.clamp((rgb - lo) / (hi - lo), 0.0, 1.0) * 255.0
    return x.permute(0, 2, 3, 1).to(torch.uint8)


def class_mask(logits):
    """NCHW logits -> (N, H, W) uint8 class: a strict > for two classes."""
    if logits.shape[1] == 2:
        return (logits[:, 1] > logits[:, 0]).to(torch.uint8)
    return torch.argmax(logits, dim=1).to(torch.uint8)


def conv(p, name, x):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p[f"{name}.bias"], padding=w.shape[-1] // 2)


def batch_norm(p, name, x, train):
    """Eval: the running statistics.  Train: the batch's, over (N, H, W),
    with the biased variance."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    inv = p[f"{name}.weight"] / torch.sqrt(var + BN_EPS)
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + \
        p[f"{name}.bias"][None, :, None, None]


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def decoder_forward(p, dec, feats, train=False, dropout_u=None):
    """Logits NCHW of the decoder over NCHW ``feats`` (lowest resolution
    first).  ``train``: batch statistics and, with ``dropout_u`` (one
    (N, H, W, C) uniform draw per cvt level), dropout 0.5 that keeps
    where u < 0.5 and scales by 2."""
    f, cin = dec["features"], dec["in_channels"]
    start = dec.get("start_res", 0)
    last = len(cin) - 1
    prev = None
    for i in range(start, last + 1):
        x = conv(p, f"cvt_{i}_conv", feats[i])
        if dec["use_bn"]:
            x = batch_norm(p, f"cvt_{i}_bn", x, train)
        x = leaky(x)
        if train and dropout_u is not None:
            u = dropout_u[i - start].permute(0, 3, 1, 2)
            x = torch.where(u < 0.5, x / 0.5, torch.zeros_like(x))
        if i > start:
            x = torch.cat([prev, x], dim=1)
        if i < last:
            x = up2(x)
            m = f"main_{i}"
            y = x
            for k in (0, 1):
                y = conv(p, f"{m}.conv_{k}", y)
                if dec["use_bn"]:
                    y = batch_norm(p, f"{m}.bn_{k}", y, train)
                y = leaky(y)
            sc = conv(p, f"{m}.shortcut", x) if f"{m}.shortcut.weight" in p \
                else x
            prev = sc + y
        else:
            prev = conv(p, f"main_{i}_conv", x)
    return prev


def loss(logits, labels):
    """Softmax cross entropy per pixel, weight 0 where the label is -1
    (ignored), the mean over every pixel (ignored ones included), then over
    the batch.  ``labels`` (N, H, W)."""
    logp = torch.log_softmax(logits, dim=1)
    safe = labels.long().clamp(0, logits.shape[1] - 1)
    ce = -torch.gather(logp, 1, safe[:, None])[:, 0]
    return (ce * (labels > -1).float()).mean(dim=(1, 2)).mean()


def trainable(dec_params):
    """The decoder's trainable leaves: every entry but batch norm's running
    statistics and counter."""
    return [k for k in dec_params
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))]


def train_steps(p, dec, batches, lr, betas=(0.9, 0.999), eps=1e-8,
                loss_fn=loss, moments=None, done=0):
    """Adam steps of the decoder from parameters ``p`` over ``batches``, a
    list of (feats NCHW, labels (N, H, W), dropout_u).  ``moments``: Adam's
    (first, second) moments by leaf after ``done`` steps (default: zeros
    and 0).  -> (losses, the gradient of each leaf at the first step, the
    leaves after the last step, the (first, second) moments after it).
    ``loss_fn(logits, labels)``: the loss (a fault planted in it stands in
    for the program's)."""
    names = trainable(p)
    leaves = {k: p[k].detach().clone() for k in names}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    else:
        m = {k: moments[0][k].detach().clone() for k in names}
        v = {k: moments[1][k].detach().clone() for k in names}
    b1, b2 = betas
    losses, first_grad = [], None
    for t, (feats, labels, dropout_u) in enumerate(batches, start=done + 1):
        params = dict(p)
        for k in names:
            leaves[k].requires_grad_(True)
            params[k] = leaves[k]
        out = decoder_forward(params, dec, feats, train=True,
                              dropout_u=dropout_u)
        value = loss_fn(out, labels)
        grads = torch.autograd.grad(value, [leaves[k] for k in names])
        losses.append(float(value.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                leaf = leaves[k].detach()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v[k] / (1 - b2 ** t)
                leaves[k] = leaf - lr * mhat / (torch.sqrt(vhat) + eps)
    return (losses, first_grad, {k: t.detach() for k, t in leaves.items()},
            (m, v))

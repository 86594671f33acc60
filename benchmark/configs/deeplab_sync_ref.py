"""The plain reference of ``deeplabv3plus-r50-480``: one SGD train step of
DeepLabV3+ over a dilated resnet50_v1s on a whole batch, in plain PyTorch,
float32, NCHW.

It follows the published description: DeepLabV3+ (Chen et al.,
arXiv:1802.02611) as gluoncv 0.5.0 builds ``deeplabv3_plus`` over
``resnet50_v1s``, with the reference experiment's head
(``experiments/rgb_segmentation/01_hair_deeplabv3_ffhq_pretrain_gan/
main.py:34-116``: 2 classes, aux head at 0.5, SGD 0.005 poly 0.9, momentum
0.9, weight decay 2e-4, the head at 10 times the rate).

- Backbone: the deep stem (3x3 convs 3 -> 64 stride 2, 64 -> 64, 64 -> 128,
  each with batch norm and relu), a 3x3 max-pool of stride 2 with one pixel
  of padding, and four stages of bottlenecks (1x1, 3x3, 1x1; planes 64,
  128, 256, 512, expansion 4), a 1x1 conv with batch norm on the residual
  of each stage's first block.  Output stride 8: layer3 and layer4 keep
  stride 1 and dilate their 3x3 convs by 2 and 4, except each stage's first
  block, which takes 1 and 2 (gluoncv's first-block rule).
- ASPP on c4: a 1x1 branch, three 3x3 branches dilated 12 / 24 / 36
  (padding = rate), and a pooled branch (global average, 1x1 conv, batch
  norm, relu) spread over the map; each branch with batch norm and relu,
  concatenated in that order, projected by a 1x1 conv with batch norm,
  relu and dropout 0.5.  gluoncv resizes the pooled 1x1 map bilinearly,
  which on one pixel is the same broadcast.
- The decoder: c1 projected to 32 channels (1x1, batch norm, relu), the
  ASPP output resized to c1's size, the two concatenated, two
  depthwise-separable convs (a 3x3 depthwise conv with batch norm and
  relu, a 1x1 pointwise conv with batch norm and relu; the depthwise conv
  padded by TensorFlow's "same" rule, which puts the odd pixel at the end)
  and a 1x1 classifier with a bias.
- The aux head on c3: a 3x3 conv to a quarter of the channels, batch norm,
  relu, dropout 0.1 and a 1x1 conv with a bias.
- Both heads' logits resized to the input's size; every resize is
  bilinear with aligned corners (mxnet ``BilinearResize2D``).
- Loss: each head's per-pixel softmax cross entropy weighted 0 where the
  label is -1, averaged over every pixel of a sample, the ignored ones
  included (gluon ``SoftmaxCELoss``), the aux head's times 0.5; the step's
  loss is the mean over the batch.
- Batch norm: train mode, the statistics of the whole batch given (what
  synchronized batch norm computes over the processes), eps 1e-5; the
  running statistics take 0.9 of themselves and 0.1 of the batch's mean and
  biased variance.
- SGD: ``g + wd * w`` for every parameter, batch norm's scale and shift
  included (the JAX package's ``add_decayed_weights``, which the port's
  trainer states); ``buf = momentum * buf + g`` (``g`` on the first step);
  ``w - lr * buf`` with ``lr = base * mult * (1 - step / total) ** 0.9`` at
  the count of steps taken before, ``mult`` 10 outside the backbone.

Departures from the published model, each the port's too: the input is a
uint8 crop, normalised here with ImageNet's mean and standard deviation;
dropout keeps a unit where a given uniform draw is under 1 - rate and
scales it by 1 / (1 - rate), the draws made by the caller (mxnet draws its
own Bernoulli bits).  It imports nothing of the program.

Parameters and buffers come as one dict keyed by the program's names
(``spec``), conv weights OIHW.  The caller runs it in full f32
(``full_precision``: TF32 off for matmuls and cuDNN).
"""

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EXPANSION = 4
PLANES = (64, 128, 256, 512)
ASPP_CHANNELS = 256
SKIP_CHANNELS = 32


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions in full precision (``tf32`` False)
    or in TF32, restored on exit."""
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


def stages(model):
    """(stage, blocks, planes, stride, dilation of block 0, of the rest)."""
    out = []
    for i, (n, planes) in enumerate(zip(model["layers"], PLANES), start=1):
        stride = 2 if i == 2 else 1
        dil = {3: 2, 4: 4}.get(i, 1)
        first = 1 if dil <= 2 else dil // 2
        out.append((i, n, planes, stride, first, dil))
    return out


def spec(model):
    """(name, shape, kind) of every parameter and buffer, in the program's
    names; kind: "conv" (OIHW), "bias", "bn_weight", "bn_bias", "mean",
    "var", "count"."""
    out = []

    def conv(name, cout, cin, k, bias=False):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_weight"),
                    (f"{name}.bias", (c,), "bn_bias"),
                    (f"{name}.running_mean", (c,), "mean"),
                    (f"{name}.running_var", (c,), "var"),
                    (f"{name}.num_batches_tracked", (), "count")])

    sw, cin = model["stem_width"], model["in_channels"]
    for k, (ci, co) in enumerate(((cin, sw), (sw, sw), (sw, 2 * sw))):
        conv(f"backbone.stem_conv{k}", co, ci, 3)
        bn(f"backbone.stem_bn{k}", co)
    ch = 2 * sw
    for i, n, planes, stride, _, _ in stages(model):
        out_ch = planes * EXPANSION
        for b in range(n):
            name = f"backbone.layer{i}_block{b}"
            c_in = ch if b == 0 else out_ch
            conv(f"{name}.conv1", planes, c_in, 1)
            bn(f"{name}.bn1", planes)
            conv(f"{name}.conv2", planes, planes, 3)
            bn(f"{name}.bn2", planes)
            conv(f"{name}.conv3", out_ch, planes, 1)
            bn(f"{name}.bn3", out_ch)
            if b == 0 and (stride != 1 or ch != out_ch):
                conv(f"{name}.downsample_conv", out_ch, ch, 1)
                bn(f"{name}.downsample_bn", out_ch)
        ch = out_ch
    c1, c3, c4 = PLANES[0] * EXPANSION, PLANES[2] * EXPANSION, ch
    a = ASPP_CHANNELS
    conv("skip_project.conv", SKIP_CHANNELS, c1, 1)
    bn("skip_project.bn", SKIP_CHANNELS)
    conv("aspp.b0_conv", a, c4, 1)
    bn("aspp.b0_bn", a)
    for bi in range(1, len(model["atrous_rates"]) + 1):
        conv(f"aspp.b{bi}_conv", a, c4, 3)
        bn(f"aspp.b{bi}_bn", a)
    conv("aspp.pool_conv", a, c4, 1)
    bn("aspp.pool_bn", a)
    conv("aspp.project_conv", a, a * (len(model["atrous_rates"]) + 2), 1)
    bn("aspp.project_bn", a)
    for name, ci in (("head_sep0", a + SKIP_CHANNELS), ("head_sep1", a)):
        out.append((f"{name}.depthwise.weight", (ci, 1, 3, 3), "conv"))
        bn(f"{name}.depthwise_bn", ci)
        conv(f"{name}.pointwise", a, ci, 1)
        bn(f"{name}.pointwise_bn", a)
    conv("head_classifier", model["nclass"], a, 1, bias=True)
    if model["aux"]:
        conv("auxlayer.conv0", c3 // 4, c3, 3)
        bn("auxlayer.bn0", c3 // 4)
        conv("auxlayer.conv1", model["nclass"], c3 // 4, 1, bias=True)
    return out


def trainable(model):
    """The names of the parameters (conv weights and biases, batch norm's
    scale and shift)."""
    return [n for n, _, kind in spec(model)
            if kind in ("conv", "bias", "bn_weight", "bn_bias")]


def same_padding(k, dilation):
    """TensorFlow's "same" padding of a dilated kernel: (begin, end)."""
    total = k + (k - 1) * (dilation - 1) - 1
    return total // 2, total - total // 2


class Net:
    """One train-mode forward over ``p`` (the parameters); the batch's
    statistics of each batch norm are kept in ``stats`` by name."""

    def __init__(self, p, model):
        self.p, self.model, self.stats = p, model, {}

    def conv(self, name, x, stride=1, padding=0, dilation=1, groups=1):
        return F.conv2d(x, self.p[f"{name}.weight"],
                        self.p.get(f"{name}.bias"), stride, padding,
                        dilation, groups)

    def bn(self, name, x):
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        self.stats[name] = (mean, var)
        return F.batch_norm(x, None, None, self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], True, 0.0, BN_EPS)

    def cbr(self, conv, bn, x, **kw):
        return F.relu(self.bn(bn, self.conv(conv, x, **kw)))

    def bottleneck(self, name, x, stride, dilation):
        out = self.cbr(f"{name}.conv1", f"{name}.bn1", x)
        out = self.cbr(f"{name}.conv2", f"{name}.bn2", out, stride=stride,
                       padding=dilation, dilation=dilation)
        out = self.bn(f"{name}.bn3", self.conv(f"{name}.conv3", out))
        res = x
        if f"{name}.downsample_conv.weight" in self.p:
            res = self.bn(f"{name}.downsample_bn",
                          self.conv(f"{name}.downsample_conv", x,
                                    stride=stride))
        return F.relu(out + res)

    def backbone(self, x):
        for k in range(3):
            x = self.cbr(f"backbone.stem_conv{k}", f"backbone.stem_bn{k}", x,
                         stride=2 if k == 0 else 1, padding=1)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps = {}
        for i, n, _, stride, first, dil in stages(self.model):
            for b in range(n):
                x = self.bottleneck(f"backbone.layer{i}_block{b}", x,
                                    stride if b == 0 else 1,
                                    first if b == 0 else dil)
            taps[i] = x
        return taps[1], taps[3], taps[4]

    def aspp(self, x, u):
        rates = self.model["atrous_rates"]
        branches = [self.cbr("aspp.b0_conv", "aspp.b0_bn", x)]
        for bi, rate in enumerate(rates, start=1):
            branches.append(self.cbr(f"aspp.b{bi}_conv", f"aspp.b{bi}_bn", x,
                                     padding=rate, dilation=rate))
        pool = self.cbr("aspp.pool_conv", "aspp.pool_bn",
                        x.mean(dim=(2, 3), keepdim=True))
        branches.append(pool.expand(-1, -1, *x.shape[2:]))
        y = self.cbr("aspp.project_conv", "aspp.project_bn",
                     torch.cat(branches, dim=1))
        return dropout(y, 0.5, u)

    def separable(self, name, x):
        c = x.shape[1]
        beg, end = same_padding(3, 1)
        x = F.pad(x, (beg, end, beg, end))
        x = F.relu(self.bn(f"{name}.depthwise_bn",
                           self.conv(f"{name}.depthwise", x, groups=c)))
        return self.cbr(f"{name}.pointwise", f"{name}.pointwise_bn", x)

    def forward(self, x, dropout_u):
        """NCHW normalised images -> (main logits, aux logits) NCHW at the
        input's size; ``dropout_u``: the ASPP's and the aux head's uniform
        draws (NCHW)."""
        size = x.shape[2:]
        c1, c3, c4 = self.backbone(x)
        c1p = self.cbr("skip_project.conv", "skip_project.bn", c1)
        y = resize(self.aspp(c4, dropout_u[0]), c1p.shape[2:])
        y = self.separable("head_sep1", self.separable(
            "head_sep0", torch.cat([y, c1p], dim=1)))
        out = resize(self.conv("head_classifier", y), size)
        a = self.cbr("auxlayer.conv0", "auxlayer.bn0", c3, padding=1)
        a = self.conv("auxlayer.conv1", dropout(a, 0.1, dropout_u[1]))
        return out, resize(a, size)


def resize(x, size):
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def dropout(x, rate, u):
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def normalize(images):
    """(N, H, W, 3) uint8 -> (N, 3, H, W) f32 ImageNet-normalised."""
    x = images.float().permute(0, 3, 1, 2) / 255.0
    mean = x.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = x.new_tensor(IMAGENET_STD)[:, None, None]
    return (x - mean) / std


def sample_ce(logits, labels):
    """Per-sample mean over every pixel of the cross entropy, 0 where the
    label is -1."""
    logp = torch.log_softmax(logits, dim=1)
    picked = logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    return -(picked * (labels >= 0)).mean(dim=(1, 2))


def train_step(p, model, hyper, images, labels, dropout_u, done,
               momenta=None):
    """One SGD step on the whole batch from parameters and buffers ``p``
    after ``done`` steps, with the momentum buffers ``momenta`` (None
    before the first step).  ``images`` (N, H, W, 3) uint8, ``labels``
    (N, H, W) integers with -1 ignored, ``dropout_u`` the two uniform draws
    (N, C, H/8, W/8).  -> (per-sample losses, the gradients, the new
    parameters and buffers, the new momentum buffers), by name."""
    names = trainable(model)
    leaves = {k: p[k].detach().clone().requires_grad_(True) for k in names}
    net = Net(dict(p, **leaves), model)
    out, aux = net.forward(normalize(images), dropout_u)
    labels = labels.long()
    per_sample = (sample_ce(out, labels)
                  + hyper["aux_weight"] * sample_ce(aux, labels))
    grads = dict(zip(names, torch.autograd.grad(
        per_sample.mean(), [leaves[k] for k in names])))
    frac = min(max(done / hyper["total_steps"], 0.0), 1.0)
    rate = hyper["base_lr"] * (1.0 - frac) ** hyper["power"]
    new, bufs = dict(p), {}
    with torch.no_grad():
        for k in names:
            g = grads[k] + hyper["wd"] * p[k]
            bufs[k] = (g if momenta is None
                       else hyper["momentum"] * momenta[k] + g)
            mult = 1.0 if k.startswith("backbone.") else hyper["head_lr_mult"]
            new[k] = p[k] - rate * mult * bufs[k]
        for name, (mean, var) in net.stats.items():
            new[f"{name}.running_mean"] = torch.lerp(
                p[f"{name}.running_mean"], mean, BN_MOMENTUM)
            new[f"{name}.running_var"] = torch.lerp(
                p[f"{name}.running_var"], var, BN_MOMENTUM)
            new[f"{name}.num_batches_tracked"] = (
                p[f"{name}.num_batches_tracked"] + 1)
    return per_sample.detach(), grads, new, bufs

"""Seeded weights and inputs, made by the benchmark on the device.

Every parameter of the generator and the decoder is drawn from the run's
seed with a ``torch.Generator`` on the device, in two large calls (one
normal, one uniform draw), and sliced: the same seed gives the same
weights.  Kernels and dense weights take the published init's scale
(N(0, 1) under the runtime wscale, the mapping's N(0, 1 / lr_mult), the
decoder's Xavier(in, 2.34) uniform); everything the published init leaves
at 0 or 1 (noise scales, biases, latent_avg, psi, batch norm's scale,
shift and running statistics) is moved off it, as ``chip_smoke.py::
perturb`` does, so that the noise, the truncation and the fold do visible
work.  Both the program and the reference are given these tensors.
"""

import math

import torch

from . import counts

# streams of the seed: one torch.Generator each, so that adding a draw to
# one leaves the others unchanged
STREAMS = {"generator": 1, "decoder": 2, "inputs": 3, "dropout": 4}


def generator(seed, stream, device):
    """The ``torch.Generator`` of ``stream`` for ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + STREAMS[stream]) % 2 ** 63)
    return g


def generator_spec(gan):
    """(name, shape, kind) of every generator parameter, in the program's
    names; kind: "weight" N(0, 1), "mapping" N(0, 1 / lr_mult), "small"
    0.1 N(0, 1), "near_one" 0.75 + 0.25 tanh(N(0, 1))."""
    lat = gan["latent_size"]
    c0 = counts.num_features(gan, 2)
    b = gan["base"]
    spec = [("constant_tensor", (1, b, b, c0), "weight"),
            ("latent_avg", (lat,), "small"),
            ("truncation_psi", ((gan["max_res_log2"] - 1) * 2,), "near_one")]
    for i in range(8):
        spec += [(f"mapping.dense_{i}.weight", (lat, lat), "mapping"),
                 (f"mapping.dense_{i}.bias", (lat,), "small")]
    for res in range(2, gan["max_res_log2"] + 1):
        blk, c = f"block_{res}", counts.num_features(gan, res)
        if res > 2:
            c_in = counts.num_features(gan, res - 1)
            if res >= gan["fused_upscale_from"]:
                spec.append((f"{blk}.deconv_1.weight", (c_in, c, 4, 4),
                             "weight"))
            else:
                spec.append((f"{blk}.conv_1.weight", (c, c_in, 3, 3),
                             "weight"))
        spec.append((f"{blk}.conv_2.weight", (c, c, 3, 3), "weight"))
        for j in (1, 2):
            spec += [(f"{blk}.noise_{j}.scale_factors", (c,), "small"),
                     (f"{blk}.bias_{j}.bias", (c,), "small"),
                     (f"{blk}.adain_{j}.affine.weight", (2 * c, lat),
                      "weight"),
                     (f"{blk}.adain_{j}.affine.bias", (2 * c,), "small")]
    top = gan["max_res_log2"]
    c_top = counts.num_features(gan, top)
    spec += [(f"to_rgb_{top}.weight", (gan["channels"], c_top, 1, 1),
              "weight"),
             (f"to_rgb_{top}.bias", (gan["channels"],), "small")]
    return spec


def decoder_spec(dec):
    """(name, shape, kind) of every decoder parameter and batch-norm
    statistic, in the program's names; kind as ``generator_spec``'s, with
    "xavier" uniform(+-sqrt(2.34 / fan_in)) and "count" (0)."""
    spec = []

    def conv(name, cin, cout, k):
        spec.extend([(f"{name}.weight", (cout, cin, k, k), "xavier"),
                     (f"{name}.bias", (cout,), "small")])

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "near_one"),
                     (f"{name}.bias", (c,), "small"),
                     (f"{name}.running_mean", (c,), "small"),
                     (f"{name}.running_var", (c,), "near_one"),
                     (f"{name}.num_batches_tracked", (), "count")])

    f, cin = dec["features"], dec["in_channels"]
    start = dec.get("start_res", 0)
    last = len(cin) - 1
    for i in range(start, last + 1):
        conv(f"cvt_{i}_conv", cin[i], f[i], 3)
        if dec["use_bn"]:
            bn(f"cvt_{i}_bn", f[i])
        c_in = f[i] * (2 if i > start else 1)
        if i < last:
            conv(f"main_{i}.conv_0", c_in, f[i + 1], 3)
            if dec["use_bn"]:
                bn(f"main_{i}.bn_0", f[i + 1])
            conv(f"main_{i}.conv_1", f[i + 1], f[i + 1], 3)
            if dec["use_bn"]:
                bn(f"main_{i}.bn_1", f[i + 1])
            if c_in != f[i + 1]:
                conv(f"main_{i}.shortcut", c_in, f[i + 1], 1)
        else:
            conv(f"main_{i}_conv", c_in, f[i + 1], 3)
    return spec


def make(spec, gen, device, mapping_lr_mult=1.0):
    """{name: f32 tensor on ``device``} for ``spec``, from one normal and
    one uniform draw of ``gen``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    normal = torch.empty(total, device=device).normal_(generator=gen)
    uniform = torch.empty(total, device=device).uniform_(
        -1.0, 1.0, generator=gen)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        r = normal[at:at + size].view(shape)
        u = uniform[at:at + size].view(shape)
        at += size
        if kind == "weight":
            t = r.clone()
        elif kind == "mapping":
            t = r / mapping_lr_mult
        elif kind == "small":
            t = 0.1 * r
        elif kind == "near_one":
            t = 0.75 + 0.25 * torch.tanh(r)
        elif kind == "xavier":
            t = u * math.sqrt(2.34 / math.prod(shape[1:]))
        elif kind == "count":
            t = torch.zeros((), dtype=torch.long, device=device)
        else:
            raise ValueError(kind)
        out[name] = t.contiguous()
    return out


def generator_weights(gan, seed, device):
    return make(generator_spec(gan), generator(seed, "generator", device),
                device, gan["mapping_lr_mult"])


def decoder_weights(dec, seed, device):
    return make(decoder_spec(dec), generator(seed, "decoder", device),
                device)

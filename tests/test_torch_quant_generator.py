"""The port's int8 generator (the int8 modes of
gan_segmentation_tpu_torch/models/{layers,stylegan}.py, ops/quant.py's
generator section, core/params_bridge.py::generator_quant_invs) against
the JAX package's ``quant`` collection on the CPU, f32, at a narrow width
that reaches the k4 s2 p1 deconv (128^2), on the same z and noise (numpy,
injected into the JAX modules).  Tolerances: each int8 site within 1e-4
relative L2; each synthesis block within 1e-3 when fed the JAX block's
input; the calibration absmax within 1e-5 relative.  Chained, int8 codes
that flip at rounding ties make the two int8 generators drift apart with
depth (``test_int8_full_generator_matches_jax``), so the chained pyramid,
image and the end-to-end logits are held to fixed limits set about 1.5x
above their measured drift (``CHAINED_LIMITS``), and to lie closer to the
JAX int8 outputs than those lie to the float ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gan_segmentation_tpu.core.config import GanConfig as JGanConfig
from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.models import layers as jl
from gan_segmentation_tpu.models.decoder import decoder_from_config as jdec
from gan_segmentation_tpu.models.stylegan import StyleBlock as JBlock
from gan_segmentation_tpu.models.stylegan import \
    StyleGanGenerator as JStyleGan
from gan_segmentation_tpu.ops import quant as jq
from gan_segmentation_tpu.ops import s2d_decoder as js2d

from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import (
    decoder_int8_state, decoder_state_dict, generator_quant_invs,
    generator_state_dict)
from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
from gan_segmentation_tpu_torch.models.decoder import decoder_from_config
from gan_segmentation_tpu_torch.models.stylegan import StyleGanGenerator
from gan_segmentation_tpu_torch.ops import quant as tq
from test_torch_quant import T, _decoder_vars, rel_l2

torch.set_num_threads(2)  # the test workers share the host's cores

NARROW = dict(max_res_log2=7, fmap_base=512, fmap_max=64, latent_size=64,
              dtype="fp32")


# Chained int8-full against JAX's, relative L2 (measured: pyramid levels
# 4^2-128^2 2.18e-5, 9.30e-4, 9.24e-3, 3.26e-2, 3.97e-2, 5.14e-2; image
# 6.36e-2; the tiny pipeline's logits 3.01e-2)
CHAINED_LIMITS = dict(levels=(4e-5, 1.5e-3, 1.5e-2, 5e-2, 6e-2, 8e-2),
                      image=1e-1, logits=4.5e-2)


@pytest.fixture(scope="module")
def generators():
    """The narrow JAX generator (it reaches the k4 s2 p1 deconv at 128^2),
    a parameter tree drawn with numpy, and the port's generator on it."""
    model = JStyleGan(JGanConfig(**NARROW))
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, NARROW["latent_size"]), jnp.float32))["params"]
    rng = np.random.RandomState(7)

    def draw(path, p):
        leaf = path[-1].key
        scale = {"scale_factors": 0.3, "bias": 0.1, "latent_avg": 1.0}.get(
            leaf, 100.0 if path[0].key == "mapping" else 1.0)
        if leaf == "truncation_psi":
            return rng.uniform(0.5, 1.0, p.shape).astype(np.float32)
        return (scale * rng.randn(*p.shape)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [draw(path, p) for path, p in flat])
    port = StyleGanGenerator(GanConfig(**NARROW)).eval()
    port.load_state_dict(generator_state_dict(params))
    return model, params, port


def _noise(rng, n):
    return {f"block_{r}.noise_{k}": rng.randn(n, 2 ** r, 2 ** r, 1).astype(
        np.float32) for r in range(2, NARROW["max_res_log2"] + 1)
        for k in (1, 2)}


def _inject(noise):
    """The JAX generator's noise inputs taken from ``noise`` (numpy, or
    traced arrays inside jit)."""
    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, jl.AddNoise) and \
                context.method_name == "__call__":
            key = ".".join(context.module.path)
            return next_fun(*args, noise=jnp.asarray(noise[key]), **kwargs)
        return next_fun(*args, **kwargs)
    return nn.intercept_methods(inject)


def _batches(seed, n=2, batch=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, NARROW["latent_size"]).astype(np.float32),
             _noise(rng, batch)) for _ in range(n)]


@pytest.fixture(scope="module")
def calibrated(generators):
    """The JAX ``calibrate_generator`` over two batches (one call each, so
    each traces with its own injected noise; max-reduced as it reduces
    batches) and its ``quant`` collection."""
    model, params, _ = generators
    calib = _batches(30)
    stats = None
    for z, noise in calib:
        with _inject(noise):
            got = jq.calibrate_generator(model, params, [jnp.asarray(z)],
                                         [jax.random.PRNGKey(0)])
        stats = got if stats is None else jax.tree_util.tree_map(
            np.maximum, stats, got)
    return calib, stats, jq.generator_quant_scales(stats)


def test_generator_calibration_matches_jax(generators, calibrated):
    _, _, port = generators
    calib, stats, _ = calibrated
    want = {k.rsplit(".", 1)[0]: float(v) for k, v in
            _flat(stats).items()}
    got = tq.calibrate_generator(
        port, [T(z) for z, _ in calib],
        [{k: T(v) for k, v in n.items()} for _, n in calib])
    assert list(got) == tq.generator_sites(port) and set(got) == set(want)
    for k, v in got.items():
        assert abs(v - want[k]) <= 1e-5 * want[k], (k, v, want[k])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("site", ["block_3.conv_1", "block_7.deconv_1",
                                  "block_4.conv_2", "to_rgb_7"])
def test_generator_int8_site_matches_jax(generators, site):
    """Each int8 site alone, the JAX module applied with a ``quant``
    collection against the port's layer with its int8 state, on the same
    input and scale: within 1e-4 relative L2.  conv_2 is held through a
    plain Conv2DW (the JAX block's conv, without noise); the port runs it
    in its kernel-1 body in the end-to-end test."""
    model, params, port = generators
    layer = port.get_submodule(site)
    block, name = (site.split(".") + [None])[:2]
    p = params[block] if name is None else params[block][name]
    jlayer = {"conv_1": lambda: jl.Conv2DW(
        p["weight"].shape[-1], 3, use_bias=False, up2x=True),
        "deconv_1": lambda: jl.Conv2DTransposeW(p["weight"].shape[-1]),
        "conv_2": lambda: jl.Conv2DW(p["weight"].shape[-1], 3,
                                     use_bias=False),
        None: lambda: jl.Conv2DW(p["weight"].shape[-1], 1, padding=0,
                                 use_bias=True, gain=1.0)}[name]()
    cin = p["weight"].shape[2]
    x = np.random.RandomState(8).randn(2, 8, 8, cin).astype(np.float32)
    inv = np.float32(127.0 / np.abs(x).max())
    want = np.asarray(jlayer.apply({"params": p, "quant": {"inv_in": inv}},
                                   jnp.asarray(x)))
    q = tq.layer_int8(layer, float(inv))
    with torch.no_grad():
        if name == "conv_2":
            got = tq.qconv3x3(T(x), q, None, torch.float32)
        else:
            got = layer(T(x), q)
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), want) <= 1e-4, rel_l2(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _jax_forward(model):
    """The JAX generator's forward with its noise as an argument, jitted
    once per model (and variables structure)."""
    def fwd(v, zz, noise):
        with _inject(noise):
            return model.apply(v, zz, capture_intermediates=lambda m, _:
                               isinstance(m, JBlock),
                               mutable=["intermediates"])
    return jax.jit(fwd)


def _jax_int8(model, params, quant, z, noise):
    """(rgb, features, each block's output) of the JAX generator with a
    ``quant`` collection (None: the float path), noise injected."""
    variables = {"params": params}
    if quant is not None:
        variables["quant"] = quant
    (rgb, feats), inter = _jax_forward(model)(variables, jnp.asarray(z),
                                              noise)
    blocks = {k: np.asarray(v["__call__"][0])
              for k, v in inter["intermediates"].items()}
    return np.asarray(rgb), [np.asarray(f) for f in feats], blocks


def test_int8_full_generator_matches_jax(generators, calibrated):
    """The int8-full generator on the same z, noise and quant collection
    (carried across by ``generator_quant_invs``).  Teacher-forced, each
    synthesis block fed the JAX block's input gives the JAX block's
    output within 1e-3 relative L2 (to_rgb within 1e-4); conv_2 runs
    kernel 1's s8 body (its plain version here, which keeps f32 through
    the noise and bias where JAX casts first: the same in f32).  Chained,
    the two int8 generators drift apart with depth: their float paths
    differ by ~1e-6, which moves a few activations across a rounding tie
    of their int8 codes, and every flip feeds the next block; so the
    chained pyramid and image are held to ``CHAINED_LIMITS``, and to lie
    closer to the JAX int8 output than the JAX int8 output lies to the
    float one, level by level."""
    model, params, port = generators
    _, _, quant = calibrated
    (z, noise), = _batches(40, n=1)
    rgb, feats, blocks = _jax_int8(model, params, quant, z, noise)
    frgb, ffeats, _ = _jax_int8(model, params, None, z, noise)
    state = tq.generator_int8_state(port, generator_quant_invs(quant))
    nz = {k: T(v) for k, v in noise.items()}
    before = k1m.conv3x3_noise_bias_lrelu_instats_s8.launches
    with torch.no_grad():
        trgb, tfeats = port(T(z), nz, quant=state)
        w = port.mapping(T(z)).float()
        x = port.constant_tensor.expand(len(z), -1, -1, -1)
        psi, avg = port.truncation_psi, port.latent_avg
        for res in range(2, NARROW["max_res_log2"] + 1):
            name, i = f"block_{res}", 2 * (res - 2)
            got = port.get_submodule(name)(
                x, port.lerp(psi[i], avg, w), port.lerp(psi[i + 1], avg, w),
                (nz[f"{name}.noise_1"], nz[f"{name}.noise_2"]),
                quant=state, name=name)
            assert rel_l2(got.numpy(), blocks[name]) <= 1e-3, name
            x = T(blocks[name])
        site = f"to_rgb_{NARROW['max_res_log2']}"
        got = port.get_submodule(site)(x, state[site])
    assert rel_l2(got.numpy(), rgb) <= 1e-4, rel_l2(got.numpy(), rgb)
    assert k1m.conv3x3_noise_bias_lrelu_instats_s8.launches == before
    assert len(tfeats) == len(CHAINED_LIMITS["levels"])
    for i, (a, b, f) in enumerate(zip(tfeats, feats, ffeats)):
        assert rel_l2(a.numpy(), b) <= CHAINED_LIMITS["levels"][i], (
            i, rel_l2(a.numpy(), b))
        assert rel_l2(a.numpy(), b) < rel_l2(b, f), i
    assert rel_l2(trgb.numpy(), rgb) <= CHAINED_LIMITS["image"], rel_l2(
        trgb.numpy(), rgb)
    assert rel_l2(trgb.numpy(), rgb) < rel_l2(rgb, frgb)


def _psnr(a, b):
    """PSNR in dB of two (-1, 1) images as the pipeline's uint8."""
    u8 = [(np.clip((np.asarray(x) + 1) / 2, 0, 1) * 255).astype(np.uint8)
          .astype(np.float64) for x in (a, b)]
    mse = ((u8[0] - u8[1]) ** 2).mean()
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def test_tiny_int8_full_pipeline_matches_jax(generators, calibrated):
    """End to end at the narrow width: the int8-full generator and an int8
    decoder (calibrated by the JAX package on its int8 generator's
    pyramids, carried across) on the same z and noise.  The port's int8
    decoder on the JAX int8 pyramid equals the JAX int8 logits within
    1e-3 (argmax >= 99.9%); chained behind its own int8 generator, its
    logits lie within ``CHAINED_LIMITS["logits"]`` of the JAX int8 logits
    and closer to them than those lie to the JAX float pipeline's, and
    the masks agree with JAX's int8 masks at least
    as well as JAX's int8 masks agree with its float ones; and int8 moves
    the port's masks (within 0.01 of the pixels) and image (within 1 dB of
    PSNR) from its float outputs as far as it moves the JAX package's."""
    model, params, port = generators
    calib, _, quant = calibrated
    jcfg = JSolverConfig(max_res_log2=7, features=[16] * 5 + [8, 2],
                         in_channels=[64, 64, 64, 32, 16, 8])
    dmodel = jdec(jcfg)
    v = _decoder_vars(dmodel, jcfg, 3)
    qtree = jax.device_get(jq.prepare_s2d_int8(
        dmodel, v, [_jax_int8(model, params, quant, z, n)[1]
                    for z, n in calib], 3))
    (z, noise), = _batches(41, n=1)
    jrgb, jfeats, _ = _jax_int8(model, params, quant, z, noise)
    frgb, ffeats, _ = _jax_int8(model, params, None, z, noise)
    want = np.asarray(jax.jit(lambda q, f: jq.apply_s2d_int8(
        dmodel, q, f, 3, fine_logits=True))(qtree, jfeats))
    flt = np.asarray(jax.jit(lambda vv, f: js2d.decoder_apply_s2d(
        dmodel, vv, f, fine_logits=True))(v, ffeats))
    dec = decoder_from_config(SolverConfig(
        max_res_log2=7, features=[16] * 5 + [8, 2],
        in_channels=[64, 64, 64, 32, 16, 8])).eval()
    dec.load_state_dict(decoder_state_dict(v["params"], v["batch_stats"]))
    dstate = decoder_int8_state(qtree, dec, 3)
    gstate = tq.generator_int8_state(port, generator_quant_invs(quant))
    tn = {k: T(a) for k, a in noise.items()}
    with torch.no_grad():
        forced = dec.forward_int8([T(f) for f in jfeats], dstate,
                                  torch.float32).numpy()
        rgb, feats = port(T(z), tn, quant=gstate)
        got = dec.forward_int8(feats, dstate, torch.float32).numpy()
        prgb, pfeats = port(T(z), tn)
        pflt = dec(pfeats).numpy()
    assert rel_l2(forced, want) <= 1e-3, rel_l2(forced, want)
    assert (forced.argmax(-1) == want.argmax(-1)).mean() >= 0.999
    assert rel_l2(got, want) <= CHAINED_LIMITS["logits"], rel_l2(got, want)
    assert rel_l2(got, want) < rel_l2(want, flt)
    assert ((got.argmax(-1) == want.argmax(-1)).mean()
            >= (want.argmax(-1) == flt.argmax(-1)).mean())
    # int8 moves the port's masks and image from its float ones as far as
    # the JAX package's int8 moves its own (tests/int8_quality_vs_jax.py
    # measures the same at the full width)
    agree = (got.argmax(-1) == pflt.argmax(-1)).mean()
    jagree = (want.argmax(-1) == flt.argmax(-1)).mean()
    assert abs(agree - jagree) <= 0.01, (agree, jagree)
    assert abs(_psnr(rgb.numpy(), prgb.numpy())
               - _psnr(jrgb, frgb)) <= 1.0



"""The port's readers of foreign checkpoints (gan_segmentation_tpu_torch:
core/mx_params.py, core/decoder_convert.py, core/checkpoint.py, and their
use in ImageGenerator and SegSolver.load) against the JAX package on the
same files, f32 on the CPU.

- The copied code (the mxnet reader, both converters) must give exactly the
  original's arrays, errors included.
- A file loaded by both packages must give the same forward: features and
  logits within rtol 1e-4 plus 1e-5 of the tensor's largest magnitude
  (``_assert_close``).  Both sides sum up to 9*512 products per value in
  f32 in different orders, through up to 13 convs, so an element near 0
  carries the rounding of partial sums as large as the tensor's largest
  values (the synthetic weights give logits of ~30: a fixed atol of 1e-5
  misses 1% of them by up to 3e-4).  The uint8 image agrees within 1 LSB,
  and ``predict`` masks are equal off near-ties (margin > 1e-3), as
  tests/test_torch_pipeline.py states it.
- The hand-written msgpack decoder must restore what the JAX package's
  serialization library restores.

No real StyleGAN or decoder checkpoint is in the repository: the files are
synthetic, written in the reference's format by tests/test_mx_params.py::
write_mx_file and named by tests/test_decoder_convert.py's synthesizers.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from test_decoder_convert import (synth_reference_decoder,
                                  synth_reference_decoder_dotted)
from test_mx_params import make_reference_named_params, write_mx_file

import chip_smoke
from gan_segmentation_tpu.core import checkpoint as jcheckpoint
from gan_segmentation_tpu.core import decoder_convert as jdc
from gan_segmentation_tpu.core import mx_params as jmx
from gan_segmentation_tpu.core.config import GanConfig as JGanConfig
from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.models import layers as jl
from gan_segmentation_tpu.models.decoder import \
    decoder_from_config as jdecoder_from_config
from gan_segmentation_tpu.models.stylegan import \
    StyleGanGenerator as JStyleGan
from gan_segmentation_tpu.train import generator as jgen
from gan_segmentation_tpu.train.solver import SegSolver as JSegSolver

from gan_segmentation_tpu_torch.core import checkpoint as tcheckpoint
from gan_segmentation_tpu_torch.core import decoder_convert as tdc
from gan_segmentation_tpu_torch.core import mx_params as tmx
from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import (
    decoder_state_dict, generator_state_dict)
from gan_segmentation_tpu_torch.models.decoder import decoder_from_config
from gan_segmentation_tpu_torch.models.stylegan import (StyleGanGenerator,
                                                        init_generator)
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")


def _assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=err_msg,
                               atol=1e-5 * float(np.abs(want).max()))

NARROW = dict(max_res_log2=7, fmap_base=512, fmap_max=64, latent_size=64,
              dtype="fp32")


def _assert_trees_equal(a, b, path=""):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ------------------------------------------------------------ mxnet reader
@pytest.mark.parametrize("dim_fmt", ["q", "I"])
def test_mx_reader_matches_original(tmp_path, rng, dim_fmt):
    arrays = [rng.randn(3, 4).astype(np.float32),
              rng.randn(2, 2, 3, 3).astype(np.float16),
              rng.randint(0, 9, (7,)).astype(np.int32),
              np.float32(rng.randn(1))]
    path = str(tmp_path / "a.params")
    write_mx_file(path, arrays, ["arg:w1", "aux:w2", "plain", "one"], dim_fmt)
    assert tmx.is_mx_params_file(path) and jmx.is_mx_params_file(path)
    got, want = tmx.load_mx_ndarray_file(path), jmx.load_mx_ndarray_file(path)
    assert list(got) == list(want) == ["w1", "w2", "plain", "one"]
    _assert_trees_equal(got, want)
    other = tmp_path / "b.params"
    other.write_bytes(b"\x81\xa1a\x01")
    for p in (str(other), str(tmp_path / "missing")):
        assert tmx.is_mx_params_file(p) is jmx.is_mx_params_file(p) is False


def _malformed(tmp_path, kind):
    ok = tmp_path / "ok.params"
    write_mx_file(ok, [np.zeros((2, 3), np.float32)], ["w"])
    data = bytearray(ok.read_bytes())
    if kind == "magic":
        data = struct.pack("<QQQ", 0xDEAD, 0, 0)
    elif kind == "torn header":
        data = data[:12]
    elif kind == "truncated":
        data = data[:len(data) - 40]
    elif kind == "type_flag":
        data[60:64] = struct.pack("<i", 11)
    elif kind == "sparse":
        idx = data.index(struct.pack("<I", 0xF993FAC9))
        data[idx + 4: idx + 8] = struct.pack("<i", 1)
    elif kind == "names":
        write_mx_file(ok, [np.zeros((2,), np.float32)], [])
        data = ok.read_bytes()
    bad = tmp_path / "bad.params"
    bad.write_bytes(bytes(data))
    return str(bad)


@pytest.mark.parametrize("kind", ["magic", "torn header", "truncated",
                                  "type_flag", "sparse", "names"])
def test_malformed_mx_files_raise_like_the_original(tmp_path, kind):
    path = _malformed(tmp_path, kind)
    with pytest.raises(ValueError) as want:
        jmx.load_mx_ndarray_file(path)
    with pytest.raises(ValueError) as got:
        tmx.load_mx_ndarray_file(path)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- generator
def _narrow_named_params(cfg, rng):
    """The reference's names and layouts for a generator of any widths
    (tests/test_mx_params.py::make_reference_named_params fixes the latent
    size at 512): OIHW convs, (I, O, kh, kw) deconvs from 128^2 on,
    (1, C, 1, 1) noise scales and biases, (out, in) dense weights."""
    lat = cfg.latent_size

    def r(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    p = {"constant_tensor": r(1, cfg.num_features(2), 4, 4),
         "latent_avg": r(lat),
         "truncation_psi": rng.uniform(0.5, 1.0, cfg.num_style_layers
                                       ).astype(np.float32)}
    for i in range(8):
        p[f"mp_dense_{i}_weight"] = r(lat, lat, scale=100.0)
        p[f"mp_dense_{i}_bias"] = r(lat, scale=0.1)
    for res in range(2, cfg.max_res_log2 + 1):
        s, c, cin = 2 ** res, cfg.num_features(res), cfg.num_features(res - 1)
        if res >= 7:
            p[f"{s}_deconv_1_weight"] = r(cin, c, 4, 4)
        elif res >= 3:
            p[f"{s}_conv_1_weight"] = r(c, cin, 3, 3)
        p[f"{s}_conv_2_weight"] = r(c, c, 3, 3)
        for j in (1, 2):
            p[f"{s}_noise_{j}_scale_factors"] = r(1, c, 1, 1, scale=0.3)
            p[f"{s}_bias_{j}_bias"] = r(1, c, 1, 1, scale=0.1)
            p[f"{s}_adain_{j}_dense_affine_weight"] = r(2 * c, lat)
            p[f"{s}_adain_{j}_dense_affine_bias"] = r(2 * c, scale=0.1)
    top = 2 ** cfg.max_res_log2
    p[f"{top}_conv_to_rgb_weight"] = r(3, cfg.num_features(cfg.max_res_log2),
                                       1, 1)
    p[f"{top}_conv_to_rgb_bias"] = r(3, scale=0.1)
    p["16_conv_2_std"] = np.asarray([0.3], np.float32)  # ignored extras
    return p


@pytest.mark.parametrize("res_log2", [4, 7])
def test_convert_stylegan_params_matches_original(res_log2):
    cfg = GanConfig(max_res_log2=res_log2)
    named = make_reference_named_params(JGanConfig(max_res_log2=res_log2))
    _assert_trees_equal(tmx.convert_stylegan_params(named, cfg),
                        jmx.convert_stylegan_params(named, cfg))


def test_mx_generator_file_gives_the_jax_forward(tmp_path, rng):
    """One file, both loaders, the same z and injected noise: the deconv
    (flipped once by each of the two maps on the port's route) and every
    other layout show in the features and the image."""
    jcfg, cfg = JGanConfig(**NARROW), GanConfig(**NARROW)
    named = _narrow_named_params(cfg, rng)
    path = str(tmp_path / "stylegan-narrow.params")
    write_mx_file(path, list(named.values()), list(named))
    jparams = jmx.load_generator_params(path, jcfg)
    state = tmx.load_generator_params(path, cfg)
    _assert_states_equal(state, generator_state_dict(jparams))
    # the mxnet layouts the port keeps arrive untouched
    np.testing.assert_array_equal(state["block_7.deconv_1.weight"].numpy(),
                                  named["128_deconv_1_weight"])
    np.testing.assert_array_equal(state["mapping.dense_3.weight"].numpy(),
                                  named["mp_dense_3_weight"])

    z = rng.randn(2, cfg.latent_size).astype(np.float32)
    noise = {f"block_{r}.noise_{k}": rng.randn(2, 2 ** r, 2 ** r, 1).astype(
        np.float32) for r in range(2, cfg.max_res_log2 + 1) for k in (1, 2)}

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, jl.AddNoise) and \
                context.method_name == "__call__":
            key = ".".join(context.module.path)
            return next_fun(*args, noise=jnp.asarray(noise[key]), **kwargs)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        rgb, feats = JStyleGan(jcfg).apply(
            {"params": jparams}, z, rngs={"noise": jax.random.PRNGKey(0)})
    port = StyleGanGenerator(cfg).eval()
    port.load_state_dict(state)
    with torch.no_grad():
        trgb, tfeats = port(torch.from_numpy(z),
                            {k: torch.from_numpy(v) for k, v in noise.items()})
    for i, (t, j) in enumerate(zip(tfeats, feats)):
        _assert_close(t.numpy(), j, f"f{i}")
    lsb = np.abs(tgen._to_uint8(trgb).numpy().astype(int)
                 - np.asarray(jgen._to_uint8(rgb)).astype(int))
    assert lsb.max() <= 1


@pytest.fixture(scope="module")
def res5_gan_dir(tmp_path_factory):
    """``stylegan-bedrooms.params`` in mxnet's format for the full-width
    res-32 generator; the noise scales are zero, so that the two packages'
    noise streams (which differ) do not matter."""
    d = tmp_path_factory.mktemp("gan")
    named = make_reference_named_params(JGanConfig(max_res_log2=5), seed=3)
    for k in named:
        if "noise" in k:
            named[k] = np.zeros_like(named[k])
        elif k.startswith("mp_dense") and k.endswith("weight"):
            named[k] = named[k] * 100.0   # the trained scale under lr_mult
    write_mx_file(d / "stylegan-bedrooms.params", list(named.values()),
                  list(named))
    return d, named


def test_image_generator_loads_the_mx_file_like_jax(res5_gan_dir, rng):
    gan_dir, named = res5_gan_dir
    kw = dict(gan="bedrooms", gan_dir=str(gan_dir), batch_size=2,
              dtype="fp32", max_res_log2=5)
    jg = jgen.ImageGenerator(**kw)
    tg = tgen.ImageGenerator(device=CPU, **kw)
    assert tg.gan == jg.gan == "bedrooms"
    np.testing.assert_allclose(
        tg.model.truncation_psi.detach().numpy(), 0.7)
    z = rng.randn(2, 512).astype(np.float32)
    jimg, jfeats = jg._fwd(jg.params, jnp.asarray(z), jax.random.PRNGKey(0))
    with torch.no_grad():
        rgb, tfeats = tg.model(torch.from_numpy(z))
    timg = tgen._to_uint8(rgb, tg.cfg.imrange)
    assert len(tfeats) == len(jfeats) == 4
    for i, (t, j) in enumerate(zip(tfeats, jfeats)):
        _assert_close(t.numpy(), j, f"f{i}")
    assert timg.dtype == torch.uint8 and tuple(timg.shape) == (2, 32, 32, 3)
    lsb = np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert lsb.max() <= 1 and timg.numpy().std() > 1


def test_image_generator_loads_a_msgpack_tree(tmp_path, rng):
    """``stylegan-<gan>.params`` as the JAX package's msgpack pytree."""
    cfg = GanConfig(max_res_log2=4, dtype="fp32")
    tree = jmx.convert_stylegan_params(
        make_reference_named_params(JGanConfig(max_res_log2=4)), cfg)
    jcheckpoint.save_msgpack(str(tmp_path / "stylegan-cars.params"), tree)
    _assert_trees_equal(
        tcheckpoint.load_checkpoint(str(tmp_path / "stylegan-cars.params")),
        tree)
    tg = tgen.ImageGenerator(gan="cars", gan_dir=str(tmp_path), dtype="fp32",
                             max_res_log2=4, device=CPU)
    _assert_states_equal(tg.model.state_dict(), generator_state_dict(tree))
    imgs, feats, _ = tg.sample_batch(2)
    assert tuple(imgs.shape) == (2, 16, 16, 3)
    assert all(bool(torch.isfinite(f).all()) for f in feats)


# ----------------------------------------------------------------- decoder
def _synth_decoder(cfg, dotted, seed=0):
    """Either naming scheme, honouring ``cfg.use_bn`` (with it off the
    dotted ``base_layers`` indices shift: conv, lrelu, conv, lrelu)."""
    if cfg.use_bn:
        synth = (synth_reference_decoder_dotted if dotted
                 else synth_reference_decoder)
        p = synth(cfg, seed)
        rs = np.random.RandomState(seed + 1)
        for k in p:  # the synthesizers leave gamma 1, beta 0, var 1
            if k.endswith(("gamma", "running_var")):
                p[k] = rs.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
            elif k.endswith("beta"):
                p[k] = (0.1 * rs.randn(*p[k].shape)).astype(np.float32)
        return p
    rs = np.random.RandomState(seed)
    p, names = {}, iter(range(1000))

    def conv(dotted_name, cout, cin, k):
        base = dotted_name if dotted else f"conv{next(names)}"
        sep = "." if dotted else "_"
        p[f"{base}{sep}weight"] = rs.randn(cout, cin, k, k).astype(
            np.float32) * 0.1
        p[f"{base}{sep}bias"] = rs.randn(cout).astype(np.float32) * 0.01

    n, f = len(cfg.in_channels), cfg.features
    for i in range(cfg.start_res, n):
        conv(f"cvt_block_{i}.0", f[i], cfg.in_channels[i], 3)
    for i in range(cfg.start_res, n - 1):
        in_c = f[i] if i == cfg.start_res else 2 * f[i]
        base = f"main_block_{i}.1"
        conv(f"{base}.base_layers.0", f[i + 1], in_c, 3)
        conv(f"{base}.base_layers.2", f[i + 1], f[i + 1], 3)
        if f[i + 1] != in_c:
            conv(f"{base}.shortcut.0", f[i + 1], in_c, 1)
    conv(f"main_block_{n - 1}.0", f[n], 2 * f[n - 1], 3)
    return p


def _pyramid(rs, cfg, n=1):
    return [rs.randn(n, 2 ** (i + 2), 2 ** (i + 2), c).astype(np.float32)
            for i, c in enumerate(cfg.in_channels)]


@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "no-bn"])
@pytest.mark.parametrize("dotted", [True, False], ids=["dotted", "legacy"])
def test_decoder_convert_matches_original_and_jax_forward(dotted, use_bn, rng):
    cfg = SolverConfig(max_res_log2=5, use_bn=use_bn)
    jcfg = JSolverConfig(max_res_log2=5, use_bn=use_bn)
    named = _synth_decoder(cfg, dotted)
    assert any("." in k for k in named) == dotted
    params, stats = jdc.convert_decoder_params(named, jcfg)
    got_params, got_stats = tdc.convert_decoder_params(named, cfg)
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_stats, stats)
    assert bool(stats) == use_bn

    state = tdc.load_decoder_state_dict(named, cfg)
    _assert_states_equal(state, decoder_state_dict(params, stats))
    model = decoder_from_config(cfg).eval()
    model.load_state_dict(state)          # strict: every BN has its counter
    feats = _pyramid(rng, cfg, n=2)
    with torch.no_grad():
        got = model([torch.from_numpy(f) for f in feats]).numpy()
    variables = {"params": params}
    if use_bn:
        variables["batch_stats"] = stats
    want = jdecoder_from_config(jcfg).apply(
        variables, [jnp.asarray(f) for f in feats], False)
    assert got.shape == (2, 32, 32, 2)
    _assert_close(got, want)


@pytest.mark.parametrize("dotted,missing", [
    (False, "conv4_weight"), (False, "batchnorm2_gamma"),
    (True, "main_block_1.1.shortcut.0.weight"),
    (True, "cvt_block_2.1.running_var")])
def test_decoder_convert_strict_reports_misses(dotted, missing):
    cfg = SolverConfig(max_res_log2=5)
    named = _synth_decoder(cfg, dotted)
    del named[missing]
    with pytest.raises(KeyError) as want:
        jdc.convert_decoder_params(named, cfg, strict=True)
    with pytest.raises(KeyError) as got:
        tdc.convert_decoder_params(named, cfg, strict=True)
    assert str(got.value) == str(want.value) and missing in str(got.value)
    _assert_trees_equal(tdc.convert_decoder_params(named, cfg, strict=False),
                        jdc.convert_decoder_params(named, cfg, strict=False))
    with pytest.raises(KeyError):   # and the solver's load stays strict
        tdc.load_decoder_state_dict(named, cfg)


def _confident_masks_equal(port, jax_solver, feats):
    """``predict`` of both solvers on one pyramid: logits close, masks
    equal wherever the margin exceeds 1e-3."""
    logits = port.predict_logits(feats).numpy()
    want = np.asarray(jax_solver.predict_logits(feats))
    _assert_close(logits, want)
    confident = np.abs(logits[..., 1] - logits[..., 0]) > 1e-3
    got_mask, want_mask = port.predict(feats), jax_solver.predict(feats)
    assert got_mask.shape == np.asarray(want_mask).shape
    np.testing.assert_array_equal(got_mask[..., 0][confident],
                                  np.asarray(want_mask)[..., 0][confident])
    assert confident.mean() > 0.9


@pytest.mark.parametrize("dotted", [True, False], ids=["dotted", "legacy"])
def test_solver_loads_an_mxnet_checkpoint_like_jax(tmp_path, rng, dotted):
    cfg, jcfg = SolverConfig(max_res_log2=5), JSolverConfig(max_res_log2=5)
    named = _synth_decoder(cfg, dotted, seed=4)
    write_mx_file(tmp_path / "decoder.params", list(named.values()),
                  list(named))
    port = SegSolver(5, "", str(tmp_path), cfg=cfg, device=CPU)
    js = JSegSolver(5, "", str(tmp_path), cfg=jcfg)
    assert port.is_trained and js.is_trained
    assert port.params_file == js.params_file == "decoder.params"
    _confident_masks_equal(port, js, [f[0] for f in _pyramid(rng, cfg)])


def test_solver_loads_the_jax_packages_checkpoint(tmp_path, rng):
    """``checkpoint_last.params`` as the JAX ``SegSolver.save`` writes it
    (msgpack of params and batch_stats), with statistics off their init."""
    jcfg, cfg = JSolverConfig(max_res_log2=5), SolverConfig(max_res_log2=5)
    js = JSegSolver(5, "", str(tmp_path / "none"), cfg=jcfg)
    js.checkpoints_dir = str(tmp_path)
    js.batch_stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        js.batch_stats)
    js._predict_fn = None
    js.save()
    assert (tmp_path / "checkpoint_last.params").is_file()
    port = SegSolver(5, "", str(tmp_path), cfg=cfg, seed=9, device=CPU)
    assert port.is_trained and port.params_file == "checkpoint_last.params"
    _assert_states_equal(port.model.state_dict(), decoder_state_dict(
        jax.device_get(js.params), jax.device_get(js.batch_stats)))
    _confident_masks_equal(port, js, [f[0] for f in _pyramid(rng, cfg)])
    # the port's own checkpoint, once written, comes first
    port.reinit()
    port.save()
    again = SegSolver(5, "", str(tmp_path), cfg=cfg, device=CPU)
    assert again.params_file == "checkpoint_last.pt"


# ----------------------------------------------------------------- msgpack
def test_msgpack_decoder_matches_the_library(rng):
    tree = {"params": {"conv": {"kernel": rng.randn(3, 3, 4, 5).astype(
        np.float32), "steps": np.arange(7, dtype=np.int32)},
        "empty": {}, "f64": rng.randn(2, 0, 3)},
        "scalar": np.float32(2.5), "int": 7, "neg": -3, "big": 2 ** 40,
        "small": -2 ** 40, "float": 1.5, "none": None, "flag": True,
        "list": [1, 2, "x", [3.5]], "complex": 3 + 4j, "bytes": b"xyz",
        "long": "s" * 300, "wide": {str(i): i for i in range(20)},
        "u8": rng.randint(0, 255, (70000,)).astype(np.uint8),
        "rank0": np.array(3, dtype=np.int64)}
    data = serialization.msgpack_serialize(tree)
    _assert_trees_equal(tcheckpoint.unpackb(data),
                        serialization.msgpack_restore(data))


@pytest.mark.parametrize("data,match", [
    (serialization.msgpack_serialize({"a": np.ones(4)})[:-5], "truncated"),
    (b"\xc7\x01\x09x", "unknown msgpack ext type 9"),
    (b"\xd4\x2ax", "unknown msgpack ext type 42"),
    (b"\xc1", "invalid msgpack type byte"),
    (b"\x01\x02", "trailing"),
    (serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
               "chunks": {"0": np.ones(2)}}}), "chunks"),
    (b"\xc7\x03\x01\x92\x90\x01", "malformed ndarray payload"),
    (b"\xc7\x0f\x01\x93\x91\x02\xa7float99\xc4\x02ab", "float99"),
    (b"\xc7\x0f\x01\x93\x91\x02\xa7float32\xc4\x02ab", "holds 2 bytes")],
    ids=["truncated", "ext8", "fixext", "reserved", "trailing", "chunked",
         "payload", "dtype", "size"])
def test_msgpack_decoder_refuses(tmp_path, data, match):
    with pytest.raises(ValueError, match=match):
        tcheckpoint.unpackb(data)
    path = tmp_path / "c.params"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        tcheckpoint.load_checkpoint(str(path))


def test_load_checkpoint_detects_the_format(tmp_path, rng):
    arr = rng.randn(2, 3).astype(np.float32)
    write_mx_file(tmp_path / "a.params", [arr], ["w"])
    jcheckpoint.save_msgpack(str(tmp_path / "b.params"), {"w": arr})
    for name in ("a.params", "b.params"):
        _assert_trees_equal(
            tcheckpoint.load_checkpoint(str(tmp_path / name)),
            jcheckpoint.load_checkpoint(str(tmp_path / name)))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        tcheckpoint.load_checkpoint(str(tmp_path / "orbax"))


# --------------------------------------- the card script's synthetic files
def test_chip_smoke_writes_what_the_readers_read(tmp_path):
    """chip_smoke.py's inverse maps and writer (its phase 6 on the card), at
    a narrow size on the CPU: generator and decoder files load back to the
    source's state, through the JAX package's reader as well."""
    cfg = GanConfig(**NARROW)
    src = init_generator(cfg, seed=1)
    chip_smoke.perturb(torch, src, 2)
    state = src.state_dict()
    assert float(state["block_3.noise_1.scale_factors"].abs().min()) > 0
    path = str(tmp_path / "stylegan-narrow.params")
    chip_smoke.write_mx_file(path, chip_smoke.generator_mx_arrays(state, cfg))
    _assert_states_equal(tmx.load_generator_params(path, cfg), state)
    _assert_states_equal(generator_state_dict(
        jmx.load_generator_params(path, JGanConfig(**NARROW))), state)

    scfg = SolverConfig(max_res_log2=5)
    solver = SegSolver(5, "", str(tmp_path / "none"), cfg=scfg, device=CPU)
    chip_smoke.perturb(torch, solver.model, 3)
    dstate = solver.model.state_dict()
    assert not torch.equal(dstate["main_1.bn_0.running_var"],
                           torch.ones(32))
    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    chip_smoke.write_mx_file(str(ckpt / "checkpoint_last.params"),
                             chip_smoke.decoder_mx_arrays(dstate, scfg))
    loaded = SegSolver(5, "", str(ckpt), cfg=scfg, seed=5, device=CPU)
    assert loaded.is_trained
    _assert_states_equal(loaded.model.state_dict(), dstate)

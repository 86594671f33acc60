"""The port's fused slice (gan_segmentation_tpu_torch/train/generator.py)
against the JAX package's FusedPipeline._fused on the same z and bridged
parameters, f32 on the CPU (JAX side: dtype "fp32", inference_dtype f32,
s2d off).  The generator is narrow and reaches the fused-upscale blocks;
its noise scales stay at their init of zero, so the noise streams of the
two packages (which differ) do not matter.  uint8 images agree to within 1
LSB; masks agree wherever the decision is not a near-tie (margin > 1e-3).
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.core.config import GanConfig as JGanConfig
from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.models.stylegan import \
    StyleGanGenerator as JStyleGan
from gan_segmentation_tpu.train import generator as jgen
from gan_segmentation_tpu.train.solver import SegSolver as JSegSolver

from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import (
    decoder_state_dict, generator_state_dict)
from gan_segmentation_tpu_torch.models.stylegan import StyleGanGenerator
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")
NARROW = dict(max_res_log2=7, fmap_base=512, fmap_max=64, latent_size=64,
              dtype="fp32")
FEATURES = [16, 16, 16, 16, 16, 8]
IN_CHANNELS = [64, 64, 64, 32, 16, 8]


@pytest.fixture(scope="module")
def jax_gen_params():
    """A parameter tree of the narrow JAX generator's shapes, drawn with
    numpy: conv and dense weights as the init draws them, noise scales and
    biases at the init's zero."""
    model = JStyleGan(JGanConfig(**NARROW))
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64), jnp.float32))["params"]
    rng = np.random.RandomState(0)

    def draw(path, p):
        leaf = path[-1].key
        if leaf in ("scale_factors", "bias", "latent_avg"):
            return np.zeros(p.shape, np.float32)
        if leaf == "truncation_psi":
            return np.ones(p.shape, np.float32)
        std = 100.0 if path[0].key == "mapping" else 1.0
        return (std * rng.randn(*p.shape)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [draw(path, p) for path, p in flat])


def _pipelines(params, nclass, tmp_path):
    jg = jgen.ImageGenerator(gan="bedrooms", batch_size=2, dtype="fp32",
                             max_res_log2=7, params=params)
    jg.cfg = JGanConfig(**NARROW)
    jg.model = JStyleGan(jg.cfg, jnp.float32)
    jcfg = JSolverConfig(max_res_log2=7, num_classes=nclass,
                         features=FEATURES + [nclass],
                         in_channels=IN_CHANNELS)
    js = JSegSolver(7, str(tmp_path), str(tmp_path / "none"), cfg=jcfg)
    jpipe = jgen.FusedPipeline(jg, js, inference_dtype=jnp.float32,
                               s2d=False)

    tg = tgen.ImageGenerator(gan="bedrooms", batch_size=2, dtype="fp32",
                             max_res_log2=7, gan_dir=str(tmp_path),
                             device=CPU)
    tg.cfg = GanConfig(**NARROW)
    tg.model = StyleGanGenerator(tg.cfg).eval()
    tg.model.load_state_dict(generator_state_dict(params))
    tcfg = SolverConfig(max_res_log2=7, num_classes=nclass,
                        features=FEATURES + [nclass], in_channels=IN_CHANNELS)
    ts = SegSolver(7, str(tmp_path), str(tmp_path / "none"), cfg=tcfg,
                   device=CPU)
    ts.model.load_state_dict(decoder_state_dict(
        jax.device_get(js.params), jax.device_get(js.batch_stats)))
    tpipe = tgen.FusedPipeline(tg, ts, inference_dtype=torch.float32)
    return jpipe, tpipe


@pytest.mark.parametrize("nclass", [2, 3])
def test_fused_slice_matches_jax(jax_gen_params, nclass, tmp_path):
    jpipe, tpipe = _pipelines(jax_gen_params, nclass, tmp_path)
    z = np.random.RandomState(nclass).randn(2, 64).astype(np.float32)
    jimg, jmask = jpipe._fused(jpipe._gen_params, jpipe._prepared(),
                               jnp.asarray(z), jax.random.PRNGKey(0))
    timg, tmask = tpipe._fused(torch.from_numpy(z), torch.Generator())
    assert tpipe._pack_masks == (nclass == 2)
    assert timg.dtype == torch.uint8 and tuple(timg.shape) == (2, 128, 128, 3)
    lsb = np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert lsb.max() <= 1

    with torch.no_grad():
        _, feats = tpipe.gen.model(torch.from_numpy(z))
        logits = tpipe.solver.model(feats).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 1e-3
    jm, tm = np.asarray(jmask), tmask.numpy()
    if nclass == 2:
        assert tm.shape == (2, 128, 16)
        jm, tm = np.unpackbits(jm, axis=-1), np.unpackbits(tm, axis=-1)
    assert tm.shape == (2, 128, 128)
    np.testing.assert_array_equal(tm[confident], jm[confident])
    assert confident.mean() > 0.9


def test_to_uint8_truncates_like_jax(rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 997),
                        [-1.0, 1.0, 0.0, 2 * 100.5 / 255 - 1]])
    x = x.astype(np.float32).reshape(1, 1, -1, 1)
    got = tgen._to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgen._to_uint8(x)))


@pytest.mark.parametrize("nclass", [2, 3])
def test_class_mask_ties_like_jax(rng, nclass):
    logits = rng.randint(0, 3, (2, 5, 8, nclass)).astype(np.float32)
    got = tgen.class_mask(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgen.class_mask(logits)))


def test_pack_mask_bits_is_np_unpackbits_order(rng):
    mask = rng.randint(0, 2, (2, 3, 16)).astype(np.uint8)
    packed = tgen.pack_mask_bits(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(np.unpackbits(packed, axis=-1), mask)


def _tiny_generator(**kw):
    return tgen.ImageGenerator(gan="bedrooms", batch_size=2, dtype="fp32",
                               max_res_log2=3, gan_dir="/nonexistent",
                               device=CPU, **kw)


def test_skip_batches_fast_forwards_the_stream():
    full = _tiny_generator(seed=3)
    batches = [full.sample_batch()[0] for _ in range(4)]
    resumed = _tiny_generator(seed=3)
    resumed.skip_batches(2)
    for want in batches[2:]:
        assert torch.equal(resumed.sample_batch()[0], want)
    assert not torch.equal(batches[0], batches[1])
    assert not torch.equal(_tiny_generator(seed=4).sample_batch()[0],
                           batches[0])


def test_generate_batches_trims_and_packs(tmp_path):
    solver = SegSolver(3, "", str(tmp_path), device=CPU)
    pipe = tgen.FusedPipeline(_tiny_generator(), solver,
                              inference_dtype=torch.float32)
    batches = list(pipe.generate_batches(3))
    assert [b[0].shape[0] for b in batches] == [2, 1]
    for imgs, masks, packed in batches:
        assert packed and imgs.shape[1:] == (8, 8, 3)
        assert masks.shape[1:] == (8, 1)
    pairs = list(pipe.generate_pairs(3))
    assert len(pairs) == 3 and pairs[0][1].shape == (8, 8)
    assert set(np.unique(pairs[0][1])) <= {0, 1}


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(s2d=True),
                                dict(quant="int4")])
def test_pipeline_refuses_what_is_not_ported(kw, tmp_path):
    """The space-to-depth tail is not ported; a mesh is a list of devices
    (``tests/test_torch_scale_out.py`` runs one), and anything else is
    refused; an unknown quant mode is refused, as the JAX package refuses
    it (int8 runs in ``tests/test_torch_quant_pipeline.py``)."""
    solver = SegSolver(3, "", str(tmp_path), device=CPU)
    err = {"mesh": TypeError, "s2d": NotImplementedError,
           "quant": ValueError}[next(iter(kw))]
    with pytest.raises(err):
        tgen.FusedPipeline(_tiny_generator(), solver, **kw)


@pytest.mark.parametrize("content,match", [
    (struct.pack("<QQQ", 0x112, 0, 3), "truncated"),   # a torn mxnet file
    (b"\0", "parameter tree"),                         # msgpack, but no tree
    (b"\xc1junk", "msgpack")])                         # neither format
def test_mxnet_generator_weights_raise(tmp_path, content, match):
    """An existing ``stylegan-<gan>.params`` is loaded, never passed over:
    one that cannot be read raises ``ValueError`` (a good one loads:
    tests/test_torch_convert.py)."""
    (tmp_path / "stylegan-bedrooms.params").write_bytes(content)
    with pytest.raises(ValueError, match=match):
        tgen.ImageGenerator(gan="bedrooms", max_res_log2=3,
                            gan_dir=str(tmp_path), device=CPU)

"""The port's generator (gan_segmentation_tpu_torch/models/stylegan.py)
against the JAX package's StyleGanGenerator on bridged parameters, f32 on
the CPU, at a narrow size that still reaches the fused-upscale deconv
(res >= 128).  The noise scales are non-zero and the noise is injected on
both sides: the port takes it explicitly; the JAX side gets it through a
flax method interceptor keyed by module path.  Tolerance rtol 1e-4, atol
1e-4, as in tests/test_numpy_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gan_segmentation_tpu.core.config import GanConfig as JGanConfig
from gan_segmentation_tpu.models import layers as jl
from gan_segmentation_tpu.models.stylegan import MappingNetwork as JMap
from gan_segmentation_tpu.models.stylegan import \
    StyleGanGenerator as StyleGanGenerator_jax

from gan_segmentation_tpu_torch.core.config import GanConfig
from gan_segmentation_tpu_torch.core.params_bridge import generator_state_dict
from gan_segmentation_tpu_torch.kernels.conv_in_stats import (
    conv3x3_noise_bias_lrelu_instats)
from gan_segmentation_tpu_torch.models.stylegan import (StyleGanGenerator,
                                                        init_generator)

torch.set_num_threads(2)  # the test workers share the host's cores

NARROW = dict(max_res_log2=7, fmap_base=512, fmap_max=64, latent_size=64,
              dtype="fp32")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_generator():
    """The JAX generator and a parameter tree of its init's shapes, drawn
    with numpy (the flax init itself runs op by op and takes ~25 s here)."""
    model = StyleGanGenerator_jax(JGanConfig(**NARROW))
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, NARROW["latent_size"]), jnp.float32))["params"]
    rng = np.random.RandomState(5)

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
    return model, params


def _noise(rng, n):
    return {f"block_{r}.noise_{k}": rng.randn(n, 2 ** r, 2 ** r, 1).astype(
        np.float32) for r in range(2, NARROW["max_res_log2"] + 1)
        for k in (1, 2)}


def test_generator_matches_jax(jax_generator):
    model, params = jax_generator
    rng = np.random.RandomState(1)
    z = rng.randn(2, NARROW["latent_size"]).astype(np.float32)
    noise = _noise(rng, 2)
    used = set()

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, jl.AddNoise) and \
                context.method_name == "__call__":
            key = ".".join(context.module.path)
            used.add(key)
            return next_fun(*args, noise=jnp.asarray(noise[key]), **kwargs)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        rgb, feats = model.apply({"params": params}, z,
                                 rngs={"noise": jax.random.PRNGKey(9)})
    assert used == set(noise)

    port = StyleGanGenerator(GanConfig(**NARROW)).eval()
    port.load_state_dict(generator_state_dict(params))
    launches = conv3x3_noise_bias_lrelu_instats.launches
    with torch.no_grad():
        trgb, tfeats = port(torch.from_numpy(z),
                            {k: torch.from_numpy(v) for k, v in noise.items()})
    assert conv3x3_noise_bias_lrelu_instats.launches == launches  # CPU: plain
    assert len(tfeats) == len(feats) == 6
    for i, (t, j) in enumerate(zip(tfeats, feats)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=f"f{i}",
                                   **TOL)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(rgb), **TOL)


def test_mapping_network_matches_jax(jax_generator):
    model, params = jax_generator
    z =np.random.RandomState(2).randn(3, 64).astype(np.float32)
    want = JMap(model.cfg).apply({"params": params["mapping"]}, z)
    port = StyleGanGenerator(GanConfig(**NARROW))
    port.load_state_dict(generator_state_dict(params))
    with torch.no_grad():
        got = port.mapping(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_mirrors_the_jax_tree(jax_generator):
    """Same names and shapes as the bridged JAX tree, and the JAX init's
    distributions: dense N(0, 1/lr_mult), conv N(0, 1), constant N(0, 1),
    biases / noise scales / latent_avg 0, truncation psi 1."""
    _, params = jax_generator
    want = {k: tuple(v.shape) for k, v in generator_state_dict(params).items()}
    port = init_generator(GanConfig(**NARROW), seed=0)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    sd = port.state_dict()
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "scale_factors", "latent_avg"):
            assert not v.any(), k
        elif leaf == "truncation_psi":
            assert bool((v == 1).all())
    assert 80 < float(sd["mapping.dense_0.weight"].std()) < 120
    assert 0.9 < float(sd["block_4.conv_2.weight"].std()) < 1.1
    again = init_generator(GanConfig(**NARROW), seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_fold_blur_is_refused():
    with pytest.raises(NotImplementedError):
        StyleGanGenerator(GanConfig(**NARROW, fold_blur=True))

"""The parameter bridge and each generator layer of the port against its
flax counterpart (gan_segmentation_tpu/models/layers.py) on bridged
parameters, f32 on the CPU.  Every parameter, biases and noise scales
included, is drawn non-zero so that a dropped term shows.  Tolerance 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.models import layers as jl

from gan_segmentation_tpu_torch.core import params_bridge
from gan_segmentation_tpu_torch.models import layers as tl

torch.set_num_threads(2)  # the test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)


def _randomized(module, rng, *inputs):
    """flax params of ``module`` with every leaf redrawn from numpy."""
    params = module.init(jax.random.PRNGKey(0), *inputs)["params"]
    return jax.tree_util.tree_map(
        lambda p: (0.5 * rng.randn(*p.shape)).astype(np.float32),
        jax.device_get(params))


def _bridged(torch_module, params, name="layer"):
    """Load flax ``params`` into ``torch_module`` through the bridge, under
    the module name the generator would give it."""
    sd = params_bridge.generator_state_dict({name: params})
    torch_module.load_state_dict({k.split(".", 1)[1]: v
                                  for k, v in sd.items()})
    return torch_module


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lr_mult,use_bias", [(0.01, True), (1.0, False)])
def test_dense_w(rng, lr_mult, use_bias):
    x = rng.randn(3, 12).astype(np.float32)
    jm = jl.DenseW(7, use_bias=use_bias, lr_mult=lr_mult)
    p = _randomized(jm, rng, x)
    tm = _bridged(tl.DenseW(12, 7, use_bias=use_bias, lr_mult=lr_mult), p)
    _close(tm(torch.from_numpy(x)), jm.apply({"params": p}, x))


@pytest.mark.parametrize("k,padding,up2x,gain", [(3, 1, False, 2 ** 0.5),
                                                 (3, 1, True, 2 ** 0.5),
                                                 (1, 0, False, 1.0)])
def test_conv2d_w(rng, k, padding, up2x, gain):
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    jm = jl.Conv2DW(3, k, padding=padding, up2x=up2x, gain=gain)
    p = _randomized(jm, rng, x)
    tm = _bridged(tl.Conv2DW(4, 3, k, padding=padding, up2x=up2x, gain=gain),
                  p)
    _close(tm(torch.from_numpy(x)), jm.apply({"params": p}, x))


def test_conv2d_transpose_w(rng):
    """Orientation trap: flax keeps the flipped conv-equivalent kernel."""
    x = rng.randn(2, 5, 4, 6).astype(np.float32)
    jm = jl.Conv2DTransposeW(3)
    p = _randomized(jm, rng, x)
    tm = _bridged(tl.Conv2DTransposeW(6, 3), p, name="deconv_1")
    assert tuple(tm.weight.shape) == (6, 3, 4, 4)
    _close(tm(torch.from_numpy(x)), jm.apply({"params": p}, x))


def test_bias(rng):
    x = rng.randn(2, 3, 3, 5).astype(np.float32)
    p = _randomized(jl.Bias(), rng, x)
    _close(_bridged(tl.Bias(5), p)(torch.from_numpy(x)),
           jl.Bias().apply({"params": p}, x))


def test_add_noise_explicit(rng):
    x = rng.randn(2, 4, 3, 5).astype(np.float32)
    noise = rng.randn(2, 4, 3, 1).astype(np.float32)
    p = _randomized(jl.AddNoise(), rng, x, noise)
    tm = _bridged(tl.AddNoise(5), p)
    _close(tm(torch.from_numpy(x), torch.from_numpy(noise)),
           jl.AddNoise().apply({"params": p}, x, noise))


def test_add_noise_draws_from_the_generator(rng):
    x = torch.zeros(2, 4, 3, 5)
    tm = tl.AddNoise(5)
    with torch.no_grad():
        tm.scale_factors.fill_(1.0)
    a = tm(x, generator=torch.Generator().manual_seed(3)).detach()
    b = tm(x, generator=torch.Generator().manual_seed(3)).detach()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.std()) > 0.5  # unit-variance noise, scale 1
    torch.testing.assert_close(a[..., 0], a[..., 4], rtol=0, atol=0)


def test_adain(rng):
    x = (rng.randn(2, 5, 4, 6) * 2 + 1).astype(np.float32)
    w = rng.randn(2, 9).astype(np.float32)
    jm = jl.AdaIN(6)
    p = _randomized(jm, rng, x, w)
    tm = _bridged(tl.AdaIN(6, 9), p)
    want = jm.apply({"params": p}, x, w)
    _close(tm(torch.from_numpy(x), torch.from_numpy(w)), want)
    # the kernel-1 form: statistics handed in
    xt = torch.from_numpy(x)
    mean = xt.mean(dim=(1, 2))
    var = (xt * xt).mean(dim=(1, 2)) - mean * mean
    _close(tm.apply_stats(xt, mean, var, torch.from_numpy(w)), want)


def test_blur_layer(rng):
    x = rng.randn(1, 6, 6, 3).astype(np.float32)
    _close(tl.Blur()(torch.from_numpy(x)), jl.Blur().apply({}, x))


def test_leaky_relu(rng):
    x = rng.randn(100).astype(np.float32)
    _close(tl.leaky_relu(torch.from_numpy(x)), jl.leaky_relu(jnp.asarray(x)))


def test_bridge_layouts(rng):
    w = rng.randn(4, 4, 3, 5).astype(np.float32)
    t = params_bridge.deconv_weight(w)
    assert t[1, 2, 0, 3] == w[3, 0, 1, 2]
    c = params_bridge.conv_weight(w)
    assert c[2, 1, 0, 3] == w[0, 3, 1, 2]
    d = params_bridge.dense_weight(w[0, 0])
    assert d[4, 2] == w[0, 0, 2, 4]

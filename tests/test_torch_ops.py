"""The port's plain ops (gan_segmentation_tpu_torch/ops) against the JAX
package's (gan_segmentation_tpu/ops) on the same numpy inputs, f32 on the
CPU.  Tolerance 1e-5 (rtol and atol): the same math, summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.ops import blur as jblur
from gan_segmentation_tpu.ops import conv as jconv
from gan_segmentation_tpu.ops import norm as jnorm
from gan_segmentation_tpu.ops import resize as jresize
from gan_segmentation_tpu.ops import wscale as jwscale

from gan_segmentation_tpu_torch.ops import blur, conv, norm, resize, wscale

torch.set_num_threads(2)  # the test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _x(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_pixel_norm(rng):
    z = _x(rng, 4, 32) * 3
    _close(norm.pixel_norm(torch.from_numpy(z)), jnorm.pixel_norm(z))


def test_instance_norm(rng):
    x = _x(rng, 2, 8, 6, 5) * 2 + 1
    _close(norm.instance_norm(torch.from_numpy(x)), jnorm.instance_norm(x))


def test_instance_norm_of_a_constant_slice(rng):
    """One-pass moments can give a slightly negative variance; both clamp."""
    x = np.full((1, 4, 4, 3), 0.3, np.float32)
    got = norm.instance_norm(torch.from_numpy(x))
    assert torch.isfinite(got).all()
    _close(got, jnorm.instance_norm(x))


def test_instance_norm_apply_clamps_the_variance(rng):
    x = torch.from_numpy(_x(rng, 1, 2, 2, 3))
    mean = torch.zeros(1, 3)
    var = torch.full((1, 3), -1e-3)
    got = norm.instance_norm_apply(x, mean, var)
    torch.testing.assert_close(got, x * (1e-5) ** -0.5)


def test_blur(rng):
    x = _x(rng, 2, 9, 7, 4)
    _close(blur.blur_3x3(torch.from_numpy(x)), jblur.blur_3x3(jnp.asarray(x)))


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1)])
def test_conv2d(rng, stride, padding, k):
    x, w, b = _x(rng, 2, 9, 8, 5), _x(rng, k, k, 5, 6), _x(rng, 6)
    _close(conv.conv2d(*map(torch.from_numpy, (x, w, b)), stride=stride,
                       padding=padding),
           jconv.conv2d(x, w, b, stride=stride, padding=padding))


def test_depthwise_conv2d(rng):
    x, w = _x(rng, 1, 6, 6, 4), _x(rng, 3, 3, 1, 4)
    _close(conv.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                 padding=1),
           jconv.depthwise_conv2d(x, w, padding=1))


def test_upsample2x_conv2d(rng):
    x, w, b = _x(rng, 2, 5, 4, 3), _x(rng, 3, 3, 3, 4), _x(rng, 4)
    _close(conv.upsample2x_conv2d(*map(torch.from_numpy, (x, w, b))),
           jconv.upsample2x_conv2d(x, w, b))


def test_conv_transpose2d(rng):
    """The JAX kernel is stored flipped (conv-equivalent); an orientation
    slip shows as a mismatch here, not as a shape error."""
    x, w, b = _x(rng, 2, 5, 4, 3), _x(rng, 4, 4, 3, 6), _x(rng, 6)
    _close(conv.conv_transpose2d(*map(torch.from_numpy, (x, w, b))),
           jconv.conv_transpose2d(x, w, b, stride=2, padding=1))


def test_upsample_nearest_2x(rng):
    x = _x(rng, 2, 3, 5, 4)
    got = resize.upsample_nearest_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jresize.upsample_nearest_2x(x)))


@pytest.mark.parametrize("shape,gain", [((3, 3, 16, 8), 2 ** 0.5),
                                        ((4, 4, 32, 16), 2 ** 0.5),
                                        ((64, 128), 1.0)])
def test_wscale(shape, gain):
    assert wscale.he_fan_in(shape) == jwscale.he_fan_in(shape)
    assert wscale.wscale_std(shape, gain) == pytest.approx(
        jwscale.wscale_std(shape, gain), rel=1e-12)

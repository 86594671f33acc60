"""The port's twins of six JAX-package helpers that no path of either
package runs but the JAX tests cover, each held to its original on the
CPU: ``ops/resize.py::upsample_nearest``, ``utils/io.py::{list_subdirs,
list_images}``, ``models/layers.py::{minibatch_std_layer,
normal_with_l2_norm}`` and ``utils/profiling.py::Speedometer``.  The
copies of modules that import no jax (``utils/io.py``) and the meter run
the same code, so they agree exactly; the tensor ops agree to f32
rounding (1e-6), and the initializer's draws differ by generator, so its
contract is held instead (shape, unit norm, the draws' scale)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.models import layers as jlayers
from gan_segmentation_tpu.ops import resize as jresize
from gan_segmentation_tpu.utils import io as jio
from gan_segmentation_tpu.utils import profiling as jprof

from gan_segmentation_tpu_torch.models import layers as tlayers
from gan_segmentation_tpu_torch.ops import resize as tresize
from gan_segmentation_tpu_torch.utils import io as tio
from gan_segmentation_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_upsample_nearest_any_factor(scale):
    x = np.random.RandomState(scale).randn(2, 3, 5, 4).astype(np.float32)
    want = np.asarray(jresize.upsample_nearest(jnp.asarray(x), scale))
    got = tresize.upsample_nearest(torch.from_numpy(x), scale).numpy()
    assert got.shape == (2, 3 * scale, 5 * scale, 4)
    np.testing.assert_array_equal(got, want)
    if scale == 2:
        np.testing.assert_array_equal(
            got, tresize.upsample_nearest_2x(torch.from_numpy(x)).numpy())


@pytest.fixture
def tree(tmp_path):
    for d in ("b", "a", "c/inner"):
        os.makedirs(tmp_path / d)
    for f in ("x.JPG", "y.png", "notes.txt", "b/z.jpeg", "b/w.bmp",
              "c/inner/v.ppm", "c/u.gif", "a/t.Png"):
        (tmp_path / f).write_bytes(b"")
    os.symlink(tmp_path / "b", tmp_path / "link")
    return str(tmp_path)


def test_list_subdirs_and_images(tree):
    assert tio.list_subdirs(tree) == jio.list_subdirs(tree)
    assert sorted(tio.list_subdirs(tree)) == ["a", "b", "c", "link"]
    assert tio.list_images(tree) == jio.list_images(tree)
    assert "x.JPG" in tio.list_images(tree)
    assert "notes.txt" not in tio.list_images(tree)
    exts = (".png",)
    assert tio.list_images(tree, exts) == jio.list_images(tree, exts)


@pytest.mark.parametrize("n,group", [(4, 2), (6, 3), (4, 4), (2, 1)])
def test_minibatch_std_layer(n, group):
    x = np.random.RandomState(n + group).randn(n, 4, 3, 5).astype(np.float32)
    want = np.asarray(jlayers.minibatch_std_layer(jnp.asarray(x), group))
    got = tlayers.minibatch_std_layer(torch.from_numpy(x), group).numpy()
    assert got.shape == (n, 4, 3, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="group size"):
        tlayers.minibatch_std_layer(torch.from_numpy(x), n + 1)


@pytest.mark.parametrize("sigma", [0.01, 1.0])
def test_normal_with_l2_norm(sigma):
    """Unit L2 norm over the whole array, as the JAX initializer; an
    explicit generator makes the draws repeatable; before the scaling they
    are N(0, sigma), which the norm of the JAX array's shape shows."""
    shape = (64, 32)
    want = np.asarray(jlayers.normal_with_l2_norm(sigma)(
        jax.random.PRNGKey(0), shape))
    init = tlayers.normal_with_l2_norm(sigma)
    got = init(torch.Generator().manual_seed(0), shape)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-6
    assert abs(float(np.linalg.norm(want)) - 1.0) < 1e-6
    again = init(torch.Generator().manual_seed(0), shape)
    assert torch.equal(got, again)
    # the entries' spread: 1 / sqrt(numel) for both, whatever sigma
    assert abs(float(got.std()) * np.sqrt(got.numel()) - 1) < 0.05
    assert abs(float(want.std()) * np.sqrt(want.size) - 1) < 0.05


def test_speedometer_matches(monkeypatch):
    """Both meters read the same clock: the same rates at the same calls."""
    clock = iter(np.arange(0.0, 100.0, 0.25))
    now = {"t": 0.0}

    def tick():
        return now["t"]

    monkeypatch.setattr(jprof.time, "time", tick)
    monkeypatch.setattr(tprof.time, "time", tick)
    a, b = jprof.Speedometer(4, n_chips=2), tprof.Speedometer(4, n_chips=2)
    out = []
    for _ in range(12):
        now["t"] = next(clock)
        out.append((a.update(8), b.update(8)))
    assert [x for x, _ in out] == [y for _, y in out]
    assert [x is not None for x, _ in out] == [i % 4 == 3 for i in range(12)]
    assert tprof.Speedometer(n_chips=0).n_chips == 1

"""The port's native image IO (``gan_segmentation_tpu_torch/native``) against
the JAX package's (``gan_segmentation_tpu/native``), of which it is a copy:
the same C++ source, and byte-identical files from the same seeded arrays."""

import filecmp
import os

import numpy as np
import pytest

from gan_segmentation_tpu import native as jnative
from gan_segmentation_tpu_torch import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    """Both libraries, built (g++, libjpeg, libpng) or the test skips."""
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("native toolchain unavailable")
    return jnative, tnative


def _arrays(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 56, 3), np.uint8)
    smooth = (np.indices((40, 56)).sum(0)[..., None]
              * np.array([1.0, 0.7, 0.4]) % 256).astype(np.uint8)
    mask = rng.integers(0, 4, (33, 48), np.uint8)
    bits = rng.integers(0, 2, (16, 64), np.uint8)
    return img, smooth, mask, bits


def test_imgio_source_is_the_jax_packages():
    a = os.path.join(REPO, "gan_segmentation_tpu", "native", "imgio.cc")
    b = os.path.join(REPO, "gan_segmentation_tpu_torch", "native", "imgio.cc")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_public_names_match():
    for name in ("PairWriter", "native_available", "read_pair", "write_jpeg",
                 "write_png_gray", "build_library"):
        assert callable(getattr(tnative, name)), name
    assert not tnative.build_library().startswith(
        os.path.dirname(jnative.__file__))


@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_bytes_match(tmp_path, both, seed):
    img, smooth, _, _ = _arrays(seed)
    for i, arr in enumerate((img, smooth)):
        for q in (95, 80):
            ja, ta = tmp_path / f"j{i}{q}.jpg", tmp_path / f"t{i}{q}.jpg"
            jnative.write_jpeg(ja, arr, quality=q)
            tnative.write_jpeg(ta, arr, quality=q)
            assert filecmp.cmp(ja, ta, shallow=False)
            back, none = tnative.read_pair(ta)
            jback, _ = jnative.read_pair(ja)
            assert none is None and np.array_equal(back, jback)


@pytest.mark.parametrize("packed", [False, True])
def test_png_bytes_match_and_read_back(tmp_path, both, packed):
    _, _, mask, bits = _arrays(3)
    if packed:
        arr, want, kw = np.packbits(bits, axis=-1), bits, dict(
            packed=True, width=bits.shape[1])
    else:
        arr, want, kw = mask, mask, {}
    ja, ta = tmp_path / "j.png", tmp_path / "t.png"
    jnative.write_png_gray(ja, arr, **kw)
    tnative.write_png_gray(ta, arr, **kw)
    assert filecmp.cmp(ja, ta, shallow=False)
    none, back = tnative.read_pair(mask_path=ta)
    assert none is None and np.array_equal(back, want)


def test_pair_writer_bytes_match(tmp_path, both):
    img, smooth, _, _ = _arrays(5)
    rng = np.random.default_rng(9)
    packed = np.packbits(rng.integers(0, 2, (40, 56), np.uint8), axis=-1)
    for mod, tag in ((jnative, "j"), (tnative, "t")):
        os.makedirs(tmp_path / tag)
        with mod.PairWriter(threads=2, queue_cap=3) as writer:
            for i, arr in enumerate((img, smooth, img)):
                writer.submit(tmp_path / tag / f"img_{i:06d}.jpg",
                              tmp_path / tag / f"mask_{i:06d}.png", img=arr,
                              mask=packed, mask_packed=True, mask_width=56)
        assert writer.submitted == 3
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for name in names:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name
    for i, arr in enumerate((img, smooth, img)):
        got, m = tnative.read_pair(tmp_path / "t" / f"img_{i:06d}.jpg",
                                   tmp_path / "t" / f"mask_{i:06d}.png")
        want, jm = jnative.read_pair(tmp_path / "j" / f"img_{i:06d}.jpg",
                                     tmp_path / "j" / f"mask_{i:06d}.png")
        assert np.array_equal(got, want) and got.shape == arr.shape
        assert np.array_equal(m, np.unpackbits(packed, axis=-1))
        assert np.array_equal(m, jm)


def test_read_pair_scaled_matches(tmp_path, both):
    img, _, _, _ = _arrays(7)
    big = np.kron(img, np.ones((4, 4, 1), np.uint8))  # 160 x 224
    mask = np.kron(np.random.default_rng(8).integers(0, 2, (40, 56), np.uint8),
                   np.ones((4, 4), np.uint8))
    tnative.write_jpeg(tmp_path / "i.jpg", big)
    tnative.write_png_gray(tmp_path / "m.png", mask)
    for denom in (1, 2, 4):
        got = tnative.read_pair(tmp_path / "i.jpg", tmp_path / "m.png", denom)
        want = jnative.read_pair(tmp_path / "i.jpg", tmp_path / "m.png",
                                 denom)
        assert got[0].shape == (160 // denom, 224 // denom, 3)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[1], mask[::denom, ::denom])


def test_validation_matches(tmp_path, both):
    for mod in (jnative, tnative):
        with pytest.raises(ValueError):
            mod.write_jpeg(tmp_path / "x.jpg", np.zeros((4, 4), np.uint8))
        with pytest.raises(ValueError):
            mod.write_png_gray(tmp_path / "x.png", np.zeros((4, 4), np.uint8),
                               packed=True, width=64)
        with pytest.raises(RuntimeError):
            mod.read_pair(tmp_path / "missing.jpg")

"""The port's annotation run (gan_segmentation_tpu_torch: apps/
annotator.py, utils/viz.py, ImageGenerator.get_images) on the CPU.

- The copied numpy code (``utils/viz.py``, ``StrokeBuffer``,
  ``save_annotation``) gives exactly what the JAX package's gives on the
  same input, and the triples it writes are read by both packages'
  ``CollectionDataset`` alike.
- ``get_images`` keeps the reference's iterator: full batches trimmed,
  numpy out, f32 features even from the bf16 generator, the whole trimmed
  batch's z with ``return_latents``.
- The whole run goes through the annotator's own handlers under the
  tk stub of ``chip_smoke.py`` (the very drive its phase 7 runs on the
  card at ffhq 1024^2), here at res 32 with 2 epochs: draw, OK, Retrain
  with its preview, Generate.  The device is the CPU through the
  test-only override of ``core.dtypes.cuda_device``, where every kernel
  wrapper takes its plain version.
"""

import pickle
import random

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import FakeEvent, FakeWidget
from gan_segmentation_tpu.apps import annotator as jann
from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.data.collection import \
    CollectionDataset as JCollectionDataset
from gan_segmentation_tpu.utils import viz as jviz

from gan_segmentation_tpu_torch.apps import annotator as tann
from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.data.collection import CollectionDataset
from gan_segmentation_tpu_torch.train.generator import ImageGenerator
from gan_segmentation_tpu_torch.utils import viz as tviz

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")


# ------------------------------------------------------------ copied code
@pytest.mark.parametrize("num_cls", [1, 2, 21, 256])
def test_voc_palette_matches_jax(num_cls):
    assert tviz.getvocpallete(num_cls) == jviz.getvocpallete(num_cls)


def test_visualize_mask_matches_jax(rng):
    mask = rng.randint(-1, 7, (9, 11))
    for num_classes in (2, 5, 21):
        np.testing.assert_array_equal(
            tviz.visualize_mask(mask, num_classes),
            jviz.visualize_mask(mask, num_classes))


@pytest.mark.parametrize("kw", [{}, dict(alpha=0.3),
                                dict(skip_background=False)])
def test_get_draw_mask_matches_jax(rng, kw):
    img = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    mask = rng.randint(0, 3, (12, 10))
    got, want = tviz.get_draw_mask(img, mask, **kw), jviz.get_draw_mask(
        img, mask, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for (i, c), (j, d) in zip(tviz.get_seg_color_map(),
                              jviz.get_seg_color_map()):
        assert i == j and np.array_equal(c, d)


def test_morph_mask_matches_jax(rng):
    pytest.importorskip("cv2")
    mask = (rng.rand(40, 40) > 0.6).astype(np.uint8)
    np.testing.assert_array_equal(tviz.morph_mask(mask),
                                  jviz.morph_mask(mask))


def _strokes(buffer_cls):
    """A positive drag, a negative dot, an undo, a second positive drag."""
    b = buffer_cls()
    seen = []
    seen.append(b.undo_last_action())            # nothing to undo yet
    b.mouse_down((5, 6), 7.9, False)
    b.add_point((12, 14), 7.9, False)
    b.add_point((20, 9), 7.9, False)
    b.mouse_up()
    b.mouse_down((30, 30), 12.0, True)
    b.mouse_up()
    seen.append(len(b.history))
    seen.append(b.undo_last_action())            # drops the negative dot
    seen.append(b.undo_last_action())            # a second undo drops none
    b.mouse_down((40, 8), 5.0, True)
    b.add_point((44, 20), 5.0, True)
    b.mouse_up()
    seen.append(b.has_changes)
    return b, seen


def test_stroke_buffer_matches_jax():
    got, got_seen = _strokes(tann.StrokeBuffer)
    want, want_seen = _strokes(jann.StrokeBuffer)
    assert got_seen == want_seen == [0, 4, 1, 0, True]
    assert [(s.line, s.start_cap, s.end_cap) for s in got.history] == \
        [(s.line, s.start_cap, s.end_cap) for s in want.history]
    a, b = got.rasterize(64, 48), want.rasterize(64, 48)
    assert a.shape == (48, 64) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) == {0, 128, 255}
    got.reset()
    assert got.history == [] and not got.has_changes
    assert not got.rasterize(8, 8).any()
    assert (tann.POSITIVE_COLOR, tann.NEGATIVE_COLOR) == (
        jann.POSITIVE_COLOR, jann.NEGATIVE_COLOR)


def test_saved_triples_are_read_by_both_packages(tmp_path, rng):
    pytest.importorskip("cv2")
    cfg, jcfg = SolverConfig(max_res_log2=4), JSolverConfig(max_res_log2=4)
    feats = [rng.randn(2 ** (i + 2), 2 ** (i + 2), c).astype(np.float32)
             for i, c in enumerate(cfg.in_channels)]
    img = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    gray = rng.choice(np.array([0, 128, 255], np.uint8), (16, 16))
    for mod, sub in ((tann, "port"), (jann, "jax")):
        (tmp_path / sub).mkdir()
        mod.save_annotation(str(tmp_path / sub), 7, img, img, gray, feats)
    for name in ("mask_000007.png", "img_000007.jpg", "vis_img_000007.jpg",
                 "feat_000007.pickle"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    with open(tmp_path / "port" / "feat_000007.pickle", "rb") as fp:
        chw = pickle.load(fp)
    assert [a.shape for a in chw] == [(512, 4, 4), (512, 8, 8), (512, 16, 16)]
    assert all(a.dtype == np.float32 for a in chw)
    ours = CollectionDataset(str(tmp_path / "port"), cfg).get_item(0)
    theirs = JCollectionDataset(str(tmp_path / "port"), jcfg).get_item(0)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert set(np.unique(ours[1])) == {-1, 0, 1}
    for a, b, f in zip(ours[2], theirs[2], feats):
        np.testing.assert_array_equal(a, f)
        np.testing.assert_array_equal(b, f)


# -------------------------------------------------------------- get_images
@pytest.mark.parametrize("return_latents", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_get_images_trims_full_batches(return_latents, dtype):
    gen = ImageGenerator(gan="bedrooms", batch_size=3, dtype=dtype,
                         return_latents=return_latents, max_res_log2=3,
                         gan_dir="/nonexistent", device=CPU, seed=2)
    assert gen.gan == "bedrooms" and gen.return_latents == return_latents
    out = list(gen.get_images(5))
    assert len(out) == 5 and gen._batch_index == 2
    for k, sample in enumerate(out):
        assert len(sample) == (3 if return_latents else 2)
        img, feats = sample[:2]
        assert isinstance(img, np.ndarray) and img.dtype == np.uint8
        assert img.shape == (8, 8, 3)
        assert [f.shape for f in feats] == [(4, 4, 512), (8, 8, 512)]
        assert all(f.dtype == np.float32 for f in feats)
        if return_latents:   # the z of the sample's whole trimmed batch
            assert sample[2].shape == ((3, 512) if k < 3 else (2, 512))
            assert sample[2].dtype == np.float32
    # the stream is the sampler's: the same seed gives the same batches
    again = ImageGenerator(gan="bedrooms", batch_size=3, dtype=dtype,
                           max_res_log2=3, gan_dir="/nonexistent",
                           device=CPU, seed=2)
    imgs, feats, z = again.sample_batch()
    for k in range(3):
        np.testing.assert_array_equal(out[k][0], imgs[k].numpy())
        np.testing.assert_array_equal(out[k][1][1],
                                      feats[1][k].float().numpy())
    if return_latents:
        np.testing.assert_array_equal(out[0][2], z.numpy())
    assert list(gen.get_images(0)) == []


# ----------------------------------------------------------- the whole run
def test_full_annotator_control_flow(tmp_path, monkeypatch):
    """Construct, 4 annotations (the last saved by Retrain), Retrain of 2
    epochs, Generate of 5 pairs: every assertion of
    ``chip_smoke.drive_annotator`` (Generate disabled at first, files, >=
    2 preview redraws, falling loss, last preview = predict, buttons, a
    pipeline built before Retrain refolded, Generate's masks equal a fresh
    pipeline's on the saved checkpoint).  The JAX package reads what the
    run wrote."""
    pytest.importorskip("cv2")
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    seen = chip_smoke.drive_annotator(
        str(tmp_path), "bedrooms", str(tmp_path / "none"), batch=2,
        n_images=4, n_generate=5, epochs=2, max_res_log2=5)
    assert seen["res"] == 32 and len(seen["ids"]) == 4
    assert seen["marks"] == {}                      # no counters asked for
    assert (tmp_path / "checkpoints" / "checkpoint_last.pt").is_file()
    jds = JCollectionDataset(str(tmp_path / "data"),
                             JSolverConfig(max_res_log2=5))
    ds = CollectionDataset(str(tmp_path / "data"),
                           SolverConfig(max_res_log2=5))
    assert len(jds) == len(ds) == 4
    for i in range(4):
        ours, theirs = ds.get_item(i), jds.get_item(i)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
        for a, b in zip(ours[2], theirs[2]):
            np.testing.assert_array_equal(a, b)


def test_annotator_saves_the_rasterized_strokes(tmp_path, monkeypatch):
    """The handlers with the real rasterizer (PIL): a positive drag, a
    ctrl (negative) dot undone by ctrl-z, the brush wheel, OK, Skip, Reset
    (tests/test_annotator_drive.py drives the JAX package's so)."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    random.seed(0)
    with chip_smoke.stub_tk():
        a = tann.SegmentationAnnotator(
            FakeWidget(), str(tmp_path), gan_dir=str(tmp_path / "none"),
            gan="bedrooms", n_generate=1, gan_batch_size=2, max_res_log2=5)
        assert a.generate_btn.state == "disabled"
        for sub in ("data", "checkpoints", "dataset"):
            assert (tmp_path / sub).is_dir()
        chip_smoke.drag(a, [(4, 4), (10, 10), (16, 16)])
        assert len(a.strokes.history) == 3
        a.on_key_down(FakeEvent(keycode=37))           # ctrl down
        assert a.ctrl
        chip_smoke.drag(a, [(24, 6)])
        assert a.strokes.history[-1].start_cap[4] == tann.NEGATIVE_COLOR
        alive = len(a.can.alive)
        a.on_key_down(FakeEvent(keycode=52))           # z while ctrl held
        assert len(a.strokes.history) == 3 and len(a.can.alive) < alive
        a.on_key_up(FakeEvent(keycode=37))
        assert not a.ctrl
        w0 = a.width
        a.on_mouse_wheel(FakeEvent(num=4))
        assert a.width > w0
        a.on_mouse_wheel(FakeEvent(num=5))
        assert abs(a.width - w0) < 1e-6
        a.on_mouse_leave(FakeEvent(3, 3))
        assert a.cursor is None

        img_id, img = a.image_id, a.img_orig
        a.ok_btn.invoke()
        data = tmp_path / "data"
        mask = cv2.imread(str(data / f"mask_{img_id:06d}.png"),
                          cv2.IMREAD_GRAYSCALE)
        assert mask.shape == img.shape[:2] == (32, 32)
        assert (mask == 255).any() and not (mask == 128).any()  # undo held
        assert set(np.unique(mask)) <= {0, 255}
        assert a.image_id != img_id and not a.strokes.has_changes

        n_files = len(list(data.iterdir()))
        a.skip_btn.invoke()
        assert len(list(data.iterdir())) == n_files == 4
        chip_smoke.drag(a, [(8, 8)])
        a.reset_btn.invoke()
        assert not a.strokes.has_changes and a.strokes.history == []

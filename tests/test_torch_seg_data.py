"""The port's data pipeline of the DeepLab experiments
(gan_segmentation_tpu_torch: data/{augment,segmentation,batchify}.py,
utils/image.py, core/yaml_config.py, the metrics of metrics/seg_metrics.py)
against the JAX package's copies on the same inputs.

- augmentation ops and both composers: byte-equal outputs under the same
  ``np.random.RandomState`` seed, and the same draws left in the stream;
- datasets: byte-equal items on the same files (transform on and off, scale
  factor 0.5, the ``train_epoch_len`` draws with ``rng_seed``,
  ``return_path``, ``max_samples``, the native reader);
- metrics: equal within 1e-7.
"""

import numpy as np
import pytest
import torch

from test_deeplab import make_rgb_dataset

from gan_segmentation_tpu.core import yaml_config as jyaml
from gan_segmentation_tpu.data import augment as jaug
from gan_segmentation_tpu.data import batchify as jbat
from gan_segmentation_tpu.data import segmentation as jseg
from gan_segmentation_tpu.metrics import seg_metrics as jmet
from gan_segmentation_tpu.utils import image as jimage

from gan_segmentation_tpu_torch import native as tnative
from gan_segmentation_tpu_torch.core import yaml_config as tyaml
from gan_segmentation_tpu_torch.data import augment as taug
from gan_segmentation_tpu_torch.data import batchify as tbat
from gan_segmentation_tpu_torch.data import segmentation as tseg
from gan_segmentation_tpu_torch.metrics import seg_metrics as tmet
from gan_segmentation_tpu_torch.utils import image as timage

torch.set_num_threads(2)  # the test workers share the host's cores


def _same(got, want, what=""):
    """Byte-equal arrays (or nested tuples / lists of them, or strings)."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    if isinstance(want, str):
        assert got == want, what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _sample(seed, h=37, w=45):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = rs.randint(-1, 3, (h, w)).astype(np.int32)
    return img, mask


# ------------------------------------------------------------ augmentation
OPS = {
    "hflip": lambda m: m.HorizontalFlip(),
    "hflip_p1": lambda m: m.HorizontalFlip(p=1.0),
    "ssr": lambda m: m.ShiftScaleRotate(scale_limit=(-0.25, 0.25),
                                        rotate_limit=15, p=1),
    "ssr_scalar_fill3": lambda m: m.ShiftScaleRotate(scale_limit=0.3,
                                                     mask_fill=3, p=0.7),
    "pad": lambda m: m.PadIfNeeded(48, 52),
    "pad_fill": lambda m: m.PadIfNeeded(40, 40, mask_fill=5),
    "pad_none": lambda m: m.PadIfNeeded(8, 8),
    "random_crop": lambda m: m.RandomCrop(24, 30),
    "center_crop": lambda m: m.CenterCrop(24, 31),
    "blur": lambda m: m.GaussianBlur(p=1.0),
    "blur_half": lambda m: m.GaussianBlur(p=0.5, sigma_max=2.0),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_augment_ops_match_jax(name):
    for seed in range(4):
        img, mask = _sample(seed)
        rs_j, rs_t = (np.random.RandomState(100 + seed) for _ in range(2))
        want = OPS[name](jaug)(img.copy(), mask.copy(), rs_j)
        got = OPS[name](taug)(img.copy(), mask.copy(), rs_t)
        _same(got, want, f"{name} seed {seed}")
        assert rs_t.rand() == rs_j.rand(), f"{name}: another number of draws"


COMPOSERS = {
    "train_ignore_-1": lambda m: m.RGBSegmentationAug([
        m.HorizontalFlip(), m.ShiftScaleRotate(rotate_limit=15, p=1),
        m.PadIfNeeded(48, 48), m.RandomCrop(40, 40)], ignore_class=-1,
        seed=3),
    "val_ignore_-1": lambda m: m.RGBSegmentationAug([
        m.PadIfNeeded(48, 48), m.CenterCrop(40, 40)], ignore_class=-1),
    "train_ignore_7": lambda m: m.RGBSegmentationAug([
        m.ShiftScaleRotate(rotate_limit=30, p=1), m.PadIfNeeded(50, 50),
        m.RandomCrop(44, 44), m.GaussianBlur()], ignore_class=7, seed=4),
    "psp_train": lambda m: m.OriginalRGBSegmentationAug(40, 36, "train",
                                                        seed=5),
    "psp_val": lambda m: m.OriginalRGBSegmentationAug(40, 36, "val"),
}


@pytest.mark.parametrize("name", sorted(COMPOSERS))
def test_augment_composers_match_jax(name):
    """Each composer on its own ``RandomState`` over several calls, then
    with an explicit one; the mask_fill rule of ``RGBSegmentationAug``."""
    jc, tc = COMPOSERS[name](jaug), COMPOSERS[name](taug)
    for seed in range(5):
        img, mask = _sample(seed, 35 + seed, 47 - seed)
        _same(tc(img.copy(), mask.copy()), jc(img.copy(), mask.copy()),
              f"{name} call {seed}")
    img, mask = _sample(9)
    _same(tc(img, mask, np.random.RandomState(8)),
          jc(img, mask, np.random.RandomState(8)), name)
    if hasattr(jc, "ops"):
        assert [getattr(o, "mask_fill", None) for o in tc.ops] == \
            [getattr(o, "mask_fill", None) for o in jc.ops]


# ---------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("segdata")
    make_rgb_dataset(root, "train_generated", 6, size=48, seed=1)
    make_rgb_dataset(root, "val", 3, size=40, seed=2)
    # multi-class labels for the LSUN / glasses / car conventions
    import cv2
    d = root / "labels"
    d.mkdir()
    rs = np.random.RandomState(3)
    for i in range(3):
        cv2.imwrite(str(d / f"img_{i:06d}.jpg"),
                    rs.randint(0, 256, (32, 40, 3)).astype(np.uint8))
        cv2.imwrite(str(d / f"mask_{i:06d}.png"),
                    rs.randint(0, 6, (32, 40)).astype(np.uint8))
    return root


def _items(ds):
    return [ds[i] for i in range(len(ds))]


DATASETS = {
    "ffhq_val_transform": ("FFHQHairSegmentation", dict(split="val")),
    "ffhq_val_uint8_half": ("FFHQHairSegmentation", dict(
        split="val", transform=None, scale_factor=0.5)),
    "ffhq_train_epoch_len": ("FFHQHairSegmentation", dict(
        split="train", subdir="train_generated", train_epoch_len=9,
        rng_seed=7, transform=None)),
    "ffhq_train_paths": ("FFHQHairSegmentation", dict(
        split="train", subdir="train_generated", return_path=True,
        max_samples=4, rng_seed=2, decimation_factor=2)),
    "car": ("CarSegmentation", dict(split="val", subdir="labels")),
    "glasses": ("GlassesSegmentation", dict(split="test", subdir="labels",
                                            transform=None)),
    "lsun": ("LSUNBedroomsSegmentation", dict(
        split="val", subdir="labels", num_classes=6,
        not_ignore_classes=[1, 3, 4])),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_match_jax(data_root, name):
    cls, kw = DATASETS[name]
    jds = getattr(jseg, cls)(str(data_root), **kw)
    tds = getattr(tseg, cls)(str(data_root), **kw)
    assert len(tds) == len(jds) > 0
    assert (tds.num_class, tds.pred_offset, tds.classes) == \
        (jds.num_class, jds.pred_offset, jds.classes)
    got, want = _items(tds), _items(jds)
    _same(got, want, name)
    if kw.get("transform", "default") is None:
        assert got[0][0].dtype == np.uint8  # normalised on the device
    if name == "ffhq_val_transform":
        assert -1 in np.unique(got[0][1])  # 255 -> ignore


def test_dataset_with_augmentator_matches_jax(data_root):
    def make(seg, aug):
        return seg.FFHQHairSegmentation(
            str(data_root), split="train", subdir="train_generated",
            scale_factor=0.5, train_epoch_len=5, rng_seed=1, transform=None,
            augmentator=aug.RGBSegmentationAug([
                aug.HorizontalFlip(), aug.ShiftScaleRotate(p=1),
                aug.PadIfNeeded(32, 32), aug.RandomCrop(28, 28)],
                ignore_class=-1, seed=11))

    _same(_items(make(tseg, taug)), _items(make(jseg, jaug)))


def test_native_reader(data_root):
    """The port's native reader where its library builds here, else the cv2
    fallback: either way the items equal the JAX package's with the same
    flag (its own native reader, or its cv2 fallback)."""
    kw = dict(split="val", scale_factor=0.5, transform=None,
              native_reader=True)
    tds = tseg.FFHQHairSegmentation(str(data_root), **kw)
    jds = jseg.FFHQHairSegmentation(str(data_root), **kw)
    assert tds._native_denom == (2 if tnative.native_available() else 0)
    if tds._native_denom != jds._native_denom:  # one side lacks libjpeg
        jds = jseg.FFHQHairSegmentation(str(data_root), **dict(
            kw, native_reader=bool(tds._native_denom)))
        if tds._native_denom:  # compare the decode with the port's own
            img, mask = tnative.read_pair(tds.images[0], tds.masks[0], 2)
            assert img.shape[:2] == mask.shape == (20, 20)
            return
    _same(_items(tds), _items(jds))


def test_images_directory_matches_jax(tmp_path):
    import cv2
    rs = np.random.RandomState(4)
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"im_{i}.png"),
                    rs.randint(0, 256, (12, 16, 3)).astype(np.uint8))
        depth = rs.randint(0, 3000, (12, 16)).astype(np.uint16)
        depth[0, :3] = 0
        cv2.imwrite(str(tmp_path / f"im_{i}.depth.tiff"), depth)
    for kw in (dict(), dict(depth_mask="*.depth.tiff", depth_k=500.0,
                            depth_mean=0.4, depth_std=0.2)):
        jd = jseg.ImagesDirectory(str(tmp_path), 3, images_mask="im_?.png",
                                  **kw)
        td = tseg.ImagesDirectory(str(tmp_path), 3, images_mask="im_?.png",
                                  **kw)
        assert (len(td), td.num_class, td.pred_offset) == \
            (len(jd), jd.num_class, jd.pred_offset) == (2, 3, 1)
        _same(_items(td), _items(jd))


def test_imagenet_constants_and_transforms(rng):
    _same(tseg.IMAGENET_MEAN, jseg.IMAGENET_MEAN)
    _same(tseg.IMAGENET_STD, jseg.IMAGENET_STD)
    img = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    x = tseg.imagenet_transform(img)
    _same(x, jseg.imagenet_transform(img))
    _same(tseg.imagenet_denormalize(x), jseg.imagenet_denormalize(x))


# --------------------------------------------- batchify, image, yaml config
def test_batchify_matches_jax(rng):
    for axis, ret in (((0,), False), ((0, 2), True), (2, False)):
        grow = [(1 if a in np.atleast_1d(axis) else 0) for a in range(3)]
        data = [rng.randn(3 + i * grow[0], 4, 2 + i * grow[2]).astype(
            np.float32) for i in range(3)]
        _same(tbat.MultiPad(axis=axis, pad_val=-1, ret_length=ret)(data),
              jbat.MultiPad(axis=axis, pad_val=-1, ret_length=ret)(data))
    same = [rng.randn(2, 3) for _ in range(4)]
    _same(tbat.Stack()(same), jbat.Stack()(same))
    pairs = [(rng.randn(2), i) for i in range(3)]
    _same(tbat.Tuple(tbat.Stack(), tbat.Stack())(pairs),
          jbat.Tuple(jbat.Stack(), jbat.Stack())(pairs))
    _same(tbat.Tuple([tbat.Stack(), tbat.Stack()])(pairs),
          jbat.Tuple([jbat.Stack(), jbat.Stack()])(pairs))
    x = rng.randn(5, 9, 3)
    for mult, axes in ((4, (0, 1)), (3, (1,)), (1, (0, 1))):
        _same(tbat.pad_to_multiple(x, mult, axes, value=2),
              jbat.pad_to_multiple(x, mult, axes, value=2))


@pytest.mark.parametrize("bbox", [[2, 3, 5, 4], [-3, -2, 8, 9], [5, 4, 9, 9],
                                  [0, 0, 10, 12]])
def test_crop_image_matches_jax(rng, bbox):
    img = rng.randint(0, 255, (12, 10, 3)).astype(np.uint8)
    _same(timage.crop_image(img, bbox), jimage.crop_image(img, bbox))
    _same(timage.crop_image(img[..., 0], bbox),
          jimage.crop_image(img[..., 0], bbox))


@pytest.mark.parametrize("kw", [dict(), dict(fit_whole=True),
                                dict(use_nn_interpolation=True)])
def test_prepare_crop_matches_jax(rng, kw):
    img = rng.randint(0, 255, (30, 20, 3)).astype(np.uint8)
    for size in ((16, 16), (24, 12), (20, 30)):
        _same(timage.prepare_crop(img, size, **kw),
              jimage.prepare_crop(img, size, **kw))


def test_yaml_config_matches_jax(tmp_path):
    path = tmp_path / "c.yml"
    path.write_text("A: 1\nB:\n  x: 2\n  y: [1, 2]\n")
    path2 = tmp_path / "d.yml"
    path2.write_text("B:\n  x: 5\nC: hi\n")
    for mod in (jyaml, tyaml):
        mod.cfg.clear()
    for p in (path, path2):
        want, got = dict(jyaml.load_config(str(p))), dict(
            tyaml.load_config(str(p)))
        assert got == want
    assert tyaml.cfg.B.x == 5 and tyaml.cfg.B.y == [1, 2]
    with pytest.raises(AttributeError):
        tyaml.cfg.missing
    for mod in (jyaml, tyaml):
        mod.cfg.clear()


# ----------------------------------------------------------------- metrics
def _labels_and_scores(rng, n=2, h=9, w=11, c=2):
    labels = rng.randint(-1, c, (n, h, w))
    scores = rng.rand(n, h, w, c).astype(np.float32)
    scores[0, 0, 0] = 0.5  # a tie
    return labels, scores


def _same_metric(got, want):
    gn, gv = got.get()
    wn, wv = want.get()
    assert gn == wn
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-7)


METRICS = {
    "segmetric": lambda m, c: m.SegMetric(c),
    "segmetric_bg_full": lambda m, c: m.SegMetric(
        c, skip_bg=False, full_output=True, class_names=[
            f"k{i}" for i in range(c)]),
    "segmetric_threshold_dice": lambda m, c: m.SegMetric(
        c, threshold=0.3, compute_dice=True, full_output=True),
    "segmetric_auc": lambda m, c: m.SegMetric(
        c, compute_auc=True, compute_dice=True, full_output=True),
    "full": lambda m, c: m.SegMetricFull(c, full_output=True),
    "detailed": lambda m, c: m.SegmentationMetricDetailed(
        c, class_names=[f"k{i}" for i in range(c)]),
    "pixacc_miou": lambda m, c: m.SegmentationMetric(c),
    "pixacc_miou_threshold": lambda m, c: m.SegmentationMetric(
        c, threshold=1e-15, skip_bg=False),
}


@pytest.mark.parametrize("nclass", [2, 3])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax(rng, name, nclass):
    jm, tm = METRICS[name](jmet, nclass), METRICS[name](tmet, nclass)
    assert getattr(tm, "compute_auc", False) == getattr(jm, "compute_auc",
                                                        False)
    for _ in range(3):
        labels, scores = _labels_and_scores(rng, c=nclass)
        jm.update([labels], [scores])
        tm.update([torch.from_numpy(labels)], [torch.from_numpy(scores)])
    # integer label maps pass through as predictions
    labels, scores = _labels_and_scores(rng, c=nclass)
    jm.update(labels, scores.argmax(-1))
    tm.update(labels, scores.argmax(-1))
    _same_metric(tm, jm)
    tm.reset()
    jm.reset()
    _same_metric(tm, jm)


@pytest.mark.parametrize("threshold", [None, 0.4])
def test_batch_helpers_match_jax(rng, threshold):
    labels, scores = _labels_and_scores(rng, c=2)
    assert tmet.batch_pix_accuracy(scores, labels, threshold) == \
        jmet.batch_pix_accuracy(scores, labels, threshold)
    for nclass in (2, 4):
        got = tmet.batch_intersection_union(scores, labels, nclass,
                                            threshold)
        want = jmet.batch_intersection_union(scores, labels, nclass,
                                             threshold)
        _same(list(got), list(want))
    assert tmet.CLASS_MAPS == jmet.CLASS_MAPS
    for kind in jmet.CLASS_MAPS:
        assert tmet.get_classes_names(kind) == jmet.get_classes_names(kind)

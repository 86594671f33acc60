"""The port's copies of the collection dataset, the file lister and the
evaluate metric (gan_segmentation_tpu_torch/{data,utils,metrics}) against
the JAX package's originals: the same fixture directory and the same random
labels and logits must give identical outputs (no tolerance: the copies
run the same numpy code)."""

import pickle

import numpy as np
import pytest
import torch

from gan_segmentation_tpu.data import collection as jcol
from gan_segmentation_tpu.metrics import seg_metrics as jmet
from gan_segmentation_tpu.utils.io import \
    list_files_with_ext as jax_list_files_with_ext

from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.data import collection as tcol
from gan_segmentation_tpu_torch.metrics import seg_metrics as tmet
from gan_segmentation_tpu_torch.utils.io import list_files_with_ext

IN_CHANNELS = [32, 16, 8]


def _sample(rs, i):
    feats = [rs.randn(2 ** (k + 2), 2 ** (k + 2), c).astype(np.float32)
             for k, c in enumerate(IN_CHANNELS)]
    trimap = (feats[-1][..., 0] > 0).astype(np.int32)
    trimap[:2] = -1
    img = rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    return img, trimap, feats


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    """The same samples written by the port's and by the JAX package's
    ``save_annotation_sample``."""
    ours = tmp_path_factory.mktemp("ours")
    theirs = tmp_path_factory.mktemp("theirs")
    rs = np.random.RandomState(0)
    for i in range(5):
        img, trimap, feats = _sample(rs, i)
        tcol.save_annotation_sample(str(ours), i, img, trimap, feats)
        jcol.save_annotation_sample(str(theirs), i, img, trimap, feats)
    return ours, theirs


def test_save_annotation_sample_writes_the_same_files(fixture_dirs):
    ours, theirs = fixture_dirs
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    assert len(names) == 15
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name


def test_save_annotation_sample_raw_mask(tmp_path):
    tri = np.array([[0, 1], [2, 1]], np.int32)
    feats = [np.zeros((2, 2, 4), np.float32)]
    tcol.save_annotation_sample(str(tmp_path), 0, np.zeros((2, 2, 3),
                                                           np.uint8),
                                tri, feats, raw_mask=True)
    ds = tcol.CollectionDataset(str(tmp_path), preprocess_mask=False)
    np.testing.assert_array_equal(ds[0][1], tri)
    with pytest.raises(ValueError, match="negative"):
        tcol.save_annotation_sample(str(tmp_path), 1, np.zeros((2, 2, 3),
                                                               np.uint8),
                                    tri - 1, feats, raw_mask=True)


def test_list_files_with_ext_matches_jax(tmp_path):
    for rel in ("b.pickle", "a.PICKLE", "c.jpg", "sub/d.pickle",
                "sub/deeper/e.pickle", "f.pickle.bak"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"x")
    (tmp_path / "dir.pickle").mkdir()
    for exts in ([".pickle"], [".jpg", ".pickle"], [".png"]):
        for recursive in (False, True):
            assert list_files_with_ext(str(tmp_path), exts, recursive) == \
                jax_list_files_with_ext(str(tmp_path), exts, recursive)
    assert list_files_with_ext(str(tmp_path), [".pickle"])[:2] == \
        ["a.PICKLE", "b.pickle"]


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("load_to_memory", [False, True])
@pytest.mark.parametrize("output_idx", [False, True])
def test_collection_dataset_matches_jax(fixture_dirs, load_to_memory,
                                        output_idx):
    ours, _ = fixture_dirs
    cfg = SolverConfig(max_res_log2=4, features=[8, 8, 8, 2],
                       in_channels=IN_CHANNELS)
    kw = dict(load_to_memory=load_to_memory, output_idx=output_idx)
    a = tcol.CollectionDataset(str(ours), cfg, **kw)
    b = jcol.CollectionDataset(str(ours), cfg, **kw)
    assert len(a) == len(b) == 5
    for i in range(len(a)):
        _assert_same(a[i], b[i])
        assert a.get_imname(i) == b.get_imname(i)
    for bs, shuffle, drop in ((2, True, True), (2, False, False),
                              (1, True, True)):
        _assert_same(list(a.batches(bs, shuffle=shuffle, seed=3,
                                    drop_last=drop)),
                     list(b.batches(bs, shuffle=shuffle, seed=3,
                                    drop_last=drop)))
    img, mask, feats = a[0][-3:]
    assert img.shape == (16, 16, 3) and img.dtype == np.float32
    assert mask.dtype == np.int32 and set(np.unique(mask)) <= {-1, 0, 1}
    assert (mask[:2] == -1).all()
    assert [f.shape for f in feats] == [(4, 4, 32), (8, 8, 16), (16, 16, 8)]


def test_collection_dataset_options_match_jax(fixture_dirs):
    ours, _ = fixture_dirs
    for kw in (dict(max_samples=3, seed=1), dict(not_ignore_classes=[1]),
               dict(preprocess_mask=False)):
        a = tcol.CollectionDataset(str(ours), **kw)
        b = jcol.CollectionDataset(str(ours), **kw)
        assert len(a) == len(b)
        for i in range(len(a)):
            _assert_same(a[i], b[i])


def test_gray_trimap_roundtrip_matches_jax():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _assert_same(tcol.trimap_from_gray(gray), jcol.trimap_from_gray(gray))
    tri = tcol.trimap_from_gray(gray)
    _assert_same(tcol.gray_from_trimap(tri), jcol.gray_from_trimap(tri))


def test_to_nhwc_feature_matches_jax(rng, tmp_path):
    cube = rng.randn(128, 128, 128).astype(np.float32)
    chw = rng.randn(32, 8, 8).astype(np.float32)
    hwc = rng.randn(8, 8, 32).astype(np.float32)
    for arr, expected in ((cube, 128), (cube, None), (chw, 32), (chw, None),
                          (hwc, 32), (hwc[None], 32), (chw[None], None)):
        _assert_same(tcol.to_nhwc_feature(arr, expected),
                     jcol.to_nhwc_feature(arr, expected))
    np.testing.assert_array_equal(tcol.to_nhwc_feature(cube, 128),
                                  cube.transpose(1, 2, 0))
    with pytest.raises(ValueError):
        tcol.to_nhwc_feature(hwc, 64)
    # a pickle with the wrong number of scales for the config raises
    tcol.save_annotation_sample(str(tmp_path), 0, np.zeros((8, 8, 3),
                                                           np.uint8),
                                np.zeros((8, 8), np.int32), [hwc])
    with open(tmp_path / "feat_000000.pickle", "rb") as fp:
        assert pickle.load(fp)[0].shape == (32, 8, 8)  # stored CHW
    cfg = SolverConfig(max_res_log2=4, features=[8, 8, 8, 2],
                       in_channels=IN_CHANNELS)
    with pytest.raises(ValueError, match="feature scales"):
        tcol.CollectionDataset(str(tmp_path), cfg)


@pytest.mark.parametrize("nclass", [2, 3])
@pytest.mark.parametrize("skip_bg", [True, False])
@pytest.mark.parametrize("threshold", [None, 0.5])
def test_segmentation_metric_matches_jax(nclass, skip_bg, threshold):
    rs = np.random.RandomState(nclass)
    ours = tmet.SegmentationMetric(nclass, skip_bg=skip_bg,
                                   threshold=threshold)
    theirs = jmet.SegmentationMetric(nclass, skip_bg=skip_bg,
                                     threshold=threshold)
    for _ in range(3):
        labels = rs.randint(-1, nclass, (2, 9, 7))
        logits = rs.randn(2, 9, 7, nclass).astype(np.float32)
        ours.update([labels], [torch.from_numpy(logits)])
        theirs.update([labels], [logits])
        _assert_same(tmet.batch_pix_accuracy(logits, labels, threshold),
                     jmet.batch_pix_accuracy(logits, labels, threshold))
        _assert_same(tmet.batch_intersection_union(logits, labels, nclass,
                                                   threshold),
                     jmet.batch_intersection_union(logits, labels, nclass,
                                                   threshold))
    assert ours.get_name_value() == theirs.get_name_value()
    names = [n for n, _ in ours.get_name_value()]
    assert names == ["accuracy", "mean-iou"]
    ours.reset()
    assert ours.total_label == 0 and not ours.total_union.any()


def test_pred_label_matches_jax(rng):
    logits = rng.randn(2, 3, 5, 4).astype(np.float32)
    for pred, axis in ((logits, -1), (logits.transpose(0, 3, 1, 2), 1),
                       (rng.randint(0, 3, (2, 5, 5)), -1)):
        _assert_same(tmet._pred_label(pred, axis, 4, None),
                     jmet._pred_label(pred, axis, 4, None))
        _assert_same(tmet._to_np(torch.from_numpy(np.asarray(pred))),
                     jmet._to_np(pred))

"""Annotation collection dataset (feature-pyramid + trimap mask triples).

A copy of ``gan_segmentation_tpu/data/collection.py`` (that module imports
cv2 at the top, and the port keeps cv2 off its import path): ``cv2`` is
imported inside the functions that read or write images.
``tests/test_torch_data.py`` holds every function here to the original on
the same files.

- ``feat_*.pickle`` files name the samples; ``img_*.jpg`` / ``mask_*.png``
  sit beside them;
- trimap of the gray mask: >192 -> 1, 64..192 -> 0, <64 -> -1 (ignore);
- images come back (H, W, 3) RGB float32, masks (H, W) int32, features a
  list of (h, w, c) float32 arrays (pickles store CHW; the layout is
  decided per array against the config's channel table).
"""

import pickle
from os.path import join, splitext
from typing import List, Optional, Sequence

import numpy as np

from ..utils.io import list_files_with_ext


def trimap_from_gray(mask_gray: np.ndarray) -> np.ndarray:
    """Gray annotation -> {1, 0, -1} trimap."""
    out = np.where(mask_gray > 192, 1, np.where(mask_gray >= 64, 0, -1))
    return out.astype(np.int32)


def gray_from_trimap(trimap: np.ndarray) -> np.ndarray:
    """Inverse encoding used when writing masks: pos 255, neg 128,
    ignore 0."""
    out = np.zeros(trimap.shape, np.uint8)
    out[trimap == 1] = 255
    out[trimap == 0] = 128
    return out


def to_nhwc_feature(arr: np.ndarray,
                    expected_channels: Optional[int] = None) -> np.ndarray:
    """A feature map as CHW/NCHW or HWC/NHWC -> HWC float32.

    With ``expected_channels`` the layout is decided against the channel
    table.  A perfect cube (the 128-channel 128x128 scale of every pyramid)
    is ambiguous by shape and is read as CHW, the convention of every
    pickle writer (``save_annotation_sample`` and the annotators)."""
    if arr.ndim == 4:
        arr = arr[0]
    assert arr.ndim == 3, arr.shape
    d0, d1, d2 = arr.shape
    if expected_channels is not None:
        chw = d0 == expected_channels and d1 == d2
        hwc = d2 == expected_channels and d0 == d1
        if chw:
            arr = np.transpose(arr, (1, 2, 0))
        elif not hwc:
            raise ValueError(
                f"feature shape {arr.shape} matches neither CHW nor HWC "
                f"with {expected_channels} channels")
    elif d0 == d1 == d2 or (d1 == d2 and d0 != d1):
        arr = np.transpose(arr, (1, 2, 0))
    return np.ascontiguousarray(arr, np.float32)


class CollectionDataset:
    """Lazily loads (img, trimap-mask, feature-pyramid) triples."""

    def __init__(self, db_dir: str, cfg=None, is_validation: bool = False,
                 output_idx: bool = False, max_samples: Optional[int] = None,
                 allow_missed_mask: bool = False, load_to_memory: bool = True,
                 preprocess_mask: Optional[bool] = None,
                 not_ignore_classes: Optional[Sequence[int]] = None,
                 seed: int = 0):
        if cfg is not None:
            if preprocess_mask is None:
                preprocess_mask = getattr(cfg, "preprocess_mask", True)
            if not_ignore_classes is None:
                not_ignore_classes = getattr(cfg, "not_ignore_classes", None)
        self._preprocess_mask = (True if preprocess_mask is None
                                 else preprocess_mask)
        self._not_ignore_classes = not_ignore_classes
        self._expected_channels = None
        if cfg is not None:
            chans = getattr(cfg, "in_channels", None) or \
                getattr(cfg, "feature_channels", None)
            if chans:
                self._expected_channels = list(chans)
        self._allow_missed_mask = allow_missed_mask
        self._output_idx = output_idx
        self._db_dir = db_dir
        self._load_to_memory = load_to_memory

        feat_names = [f for f in list_files_with_ext(db_dir, [".pickle"])
                      if "feat" in f]
        if max_samples is not None and len(feat_names) > max_samples:
            rs = np.random.RandomState(seed)
            feat_names = list(rs.choice(feat_names, max_samples,
                                        replace=False))
        self._feat_names = feat_names
        self._samples = None
        if load_to_memory:
            self._samples = [self.load_sample(f) for f in feat_names]

    def __len__(self):
        return len(self._feat_names)

    def get_imname(self, idx: int) -> str:
        base = splitext(self._feat_names[idx])[0]
        return base.replace("feat", "img") + ".jpg"

    def load_sample(self, feature_name: str):
        import cv2

        base = splitext(feature_name)[0]
        imname = base.replace("feat", "img") + ".jpg"
        mask_name = base.replace("feat", "mask") + ".png"

        img = cv2.imread(join(self._db_dir, imname))
        assert img is not None, f"missing image {imname}"
        img = img[:, :, ::-1]  # BGR -> RGB

        mask = cv2.imread(join(self._db_dir, mask_name), 0)
        if mask is None and self._allow_missed_mask:
            mask = np.zeros(img.shape[:2], np.uint8)
        assert mask is not None, f"missing mask {mask_name}"

        with open(join(self._db_dir, feature_name), "rb") as fp:
            features = pickle.load(fp)
        expected = self._expected_channels
        if expected is not None and len(expected) != len(features):
            raise ValueError(
                f"{feature_name}: {len(features)} feature scales but the "
                f"config expects {len(expected)} ({expected})")
        features = [
            to_nhwc_feature(np.asarray(f),
                            expected[i] if expected is not None else None)
            for i, f in enumerate(features)]
        return mask, np.ascontiguousarray(img), features

    def get_item(self, idx: int):
        if self._samples is not None:
            mask, img, features = self._samples[idx]
        else:
            mask, img, features = self.load_sample(self._feat_names[idx])

        if self._preprocess_mask:
            mask = trimap_from_gray(mask)
        else:
            mask = mask.astype(np.int32)

        if self._not_ignore_classes is not None:
            keep = np.isin(mask, self._not_ignore_classes)
            mask = np.where(keep, mask, -1).astype(np.int32)

        img = img.astype(np.float32)
        if self._output_idx:
            return (np.int32(idx), img, mask, features)
        return (img, mask, features)

    def __getitem__(self, idx):
        return self.get_item(idx)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, part: slice = slice(None)):
        """Yield dicts of stacked numpy arrays: image (N,H,W,3), mask
        (N,H,W), features list[(N,h,w,c)], idx (N,).  ``part``: the share
        of each batch to load (a data-parallel process's slice of it)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        n = len(order)
        step = batch_size
        for s in range(0, n - (step - 1 if drop_last else 0), step):
            sel = order[s:s + step]
            if drop_last and len(sel) < step:
                return
            sel = sel[part]
            items = [self.get_item(i) for i in sel]
            if self._output_idx:
                idxs, imgs, masks, feats = zip(*items)
            else:
                imgs, masks, feats = zip(*items)
                idxs = sel
            yield {
                "idx": np.asarray(idxs, np.int32),
                "image": np.stack(imgs),
                "mask": np.stack(masks),
                "features": [np.stack([f[i] for f in feats])
                             for i in range(len(feats[0]))],
            }


def save_annotation_sample(db_dir: str, index: int, img_rgb: np.ndarray,
                           trimap: np.ndarray, features: List[np.ndarray],
                           raw_mask: bool = False):
    """Write one annotated triple in the reference's on-disk format:
    img_%06d.jpg (BGR on disk), mask_%06d.png (gray trimap encoding, or the
    class indices verbatim with ``raw_mask``), feat_%06d.pickle (a list of
    CHW float32 arrays)."""
    import cv2

    cv2.imwrite(join(db_dir, f"img_{index:06d}.jpg"), img_rgb[:, :, ::-1])
    if raw_mask:
        trimap = np.asarray(trimap)
        if trimap.min() < 0:
            # astype(uint8) would wrap ignore labels (-1) to class 255
            raise ValueError("raw_mask=True cannot encode negative labels "
                             f"(got min {int(trimap.min())}); ignore bands "
                             "are a binary-trimap concept")
        mask_u8 = trimap.astype(np.uint8)
    else:
        mask_u8 = gray_from_trimap(trimap)
    cv2.imwrite(join(db_dir, f"mask_{index:06d}.png"), mask_u8)
    chw = [np.ascontiguousarray(np.transpose(f, (2, 0, 1)), np.float32)
           for f in features]
    with open(join(db_dir, f"feat_{index:06d}.pickle"), "wb") as fp:
        pickle.dump(chw, fp)

"""Augmentation ops (albumentations equivalents) of the DeepLab experiments.

A copy of ``gan_segmentation_tpu/data/augment.py``, with ``cv2`` imported
inside the ops that call it; ``tests/test_torch_seg_data.py`` holds every op
and both composers byte-equal to the original under the same
``np.random.RandomState``.

The reference composes albumentations transforms (`01/main.py:85-95`):
HorizontalFlip, ShiftScaleRotate(scale ±0.25, rotate 15°, border constant),
PadIfNeeded(480), RandomCrop(480) for training and PadIfNeeded+CenterCrop for
validation, wrapped in ``RGBSegmentationAug`` whose relabeling trick maps
border/padded pixels to the ignore class (`rgb_segmentation.py:7-28`).
Unrolled, for ``ignore_class`` in {0, -1} border and padded mask pixels end
up **class 0 (background)**; for any other ignore id they become that id.
``mask_fill`` implements exactly that outcome.  Each op is
``op(img, mask, rs) -> (img, mask)`` with a numpy RandomState, drawing from
``rs`` in a fixed order; masks always use nearest-neighbour resampling.

``OriginalRGBSegmentationAug`` (`rgb_segmentation.py:31-104`, the manual
PSP-style val/train pipeline) is also provided.
"""

from typing import Optional, Sequence, Tuple

import numpy as np


class HorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, mask, rs):
        if rs.rand() < self.p:
            img = img[:, ::-1].copy()
            mask = mask[:, ::-1].copy()
        return img, mask


class ShiftScaleRotate:
    """albumentations-equivalent affine: shift ±shift_limit (fraction),
    scale 1+U(scale_limit), rotate ±rotate_limit degrees, constant border."""

    def __init__(self, shift_limit: float = 0.0625,
                 scale_limit: Tuple[float, float] = (-0.25, 0.25),
                 rotate_limit: float = 15.0, p: float = 1.0,
                 mask_fill: int = 0):
        self.shift_limit = shift_limit
        if isinstance(scale_limit, (int, float)):
            scale_limit = (-scale_limit, scale_limit)
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit
        self.p = p
        self.mask_fill = mask_fill

    def __call__(self, img, mask, rs):
        import cv2

        if rs.rand() >= self.p:
            return img, mask
        h, w = img.shape[:2]
        angle = rs.uniform(-self.rotate_limit, self.rotate_limit)
        scale = 1.0 + rs.uniform(self.scale_limit[0], self.scale_limit[1])
        dx = rs.uniform(-self.shift_limit, self.shift_limit) * w
        dy = rs.uniform(-self.shift_limit, self.shift_limit) * h
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, scale)
        m[0, 2] += dx
        m[1, 2] += dy
        img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        mask = cv2.warpAffine(mask.astype(np.float32), m, (w, h),
                              flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT,
                              borderValue=float(self.mask_fill))
        return img, mask.astype(np.int32)


class PadIfNeeded:
    """Center-pad to at least (min_height, min_width); image filled with 0,
    mask with ``mask_fill`` (see the module docstring)."""

    def __init__(self, min_height: int, min_width: int, mask_fill: int = 0):
        self.min_height = min_height
        self.min_width = min_width
        self.mask_fill = mask_fill

    def __call__(self, img, mask, rs):
        import cv2

        h, w = img.shape[:2]
        ph = max(0, self.min_height - h)
        pw = max(0, self.min_width - w)
        if ph == 0 and pw == 0:
            return img, mask
        top, left = ph // 2, pw // 2
        bot, right = ph - top, pw - left
        img = cv2.copyMakeBorder(img, top, bot, left, right,
                                 cv2.BORDER_CONSTANT, value=0)
        mask = cv2.copyMakeBorder(mask, top, bot, left, right,
                                  cv2.BORDER_CONSTANT,
                                  value=int(self.mask_fill))
        return img, mask


class RandomCrop:
    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, img, mask, rs):
        h, w = img.shape[:2]
        y = rs.randint(0, h - self.height + 1)
        x = rs.randint(0, w - self.width + 1)
        return (img[y:y + self.height, x:x + self.width],
                mask[y:y + self.height, x:x + self.width])


class CenterCrop:
    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, img, mask, rs):
        h, w = img.shape[:2]
        y = int(round((h - self.height) / 2.0))
        x = int(round((w - self.width) / 2.0))
        return (img[y:y + self.height, x:x + self.width],
                mask[y:y + self.height, x:x + self.width])


class GaussianBlur:
    def __init__(self, p: float = 0.5, sigma_max: float = 1.0 / 3):
        self.p = p
        self.sigma_max = sigma_max

    def __call__(self, img, mask, rs):
        if rs.rand() < self.p:
            # sigma_max is the actual bound; default 1/3 matches the PSP
            # pipeline's random()/3 (`rgb_segmentation.py:31-104`)
            sigma = rs.rand() * self.sigma_max
            if sigma > 1e-6:  # cv2 rejects sigma=0 with an auto kernel size
                import cv2
                img = cv2.GaussianBlur(img, (0, 0), sigma)
        return img, mask


class RGBSegmentationAug:
    """Composed pipeline with ignore-class semantics
    (`rgb_segmentation.py:7-28`)."""

    def __init__(self, augmentations_list: Sequence, ignore_class: int = -1,
                 seed: Optional[int] = None):
        self.ops = list(augmentations_list)
        self.ignore_class = ignore_class
        fill = 0 if ignore_class in (0, -1) else ignore_class
        for op in self.ops:
            if hasattr(op, "mask_fill"):
                op.mask_fill = fill
        self._rs = np.random.RandomState(seed)

    def reseed(self, seed: int) -> None:
        self._rs = np.random.RandomState(seed)

    def __call__(self, image, mask, rs: Optional[np.random.RandomState] = None):
        rs = rs or self._rs
        mask = np.asarray(mask, np.int32)
        for op in self.ops:
            image, mask = op(image, mask, rs)
        return image, mask


class OriginalRGBSegmentationAug:
    """Manual PSP-style scale/crop/blur pipeline
    (`rgb_segmentation.py:31-104`)."""

    def __init__(self, base_size: int, crop_size: int, mode: str,
                 seed: Optional[int] = None):
        assert mode in {"val", "train"}
        self.base_size = base_size
        self.crop_size = crop_size
        self.mode = mode
        self._rs = np.random.RandomState(seed)

    def reseed(self, seed: int) -> None:
        self._rs = np.random.RandomState(seed)

    def __call__(self, image, mask, rs=None):
        import cv2

        rs = rs or self._rs
        mask = np.asarray(mask, np.int32)
        if self.mode == "val":
            outsize = self.crop_size
            h, w = image.shape[:2]
            if w > h:
                oh = outsize
                ow = int(1.0 * w * oh / h)
            else:
                ow = outsize
                oh = int(1.0 * h * ow / w)
            image = cv2.resize(image, (ow, oh), interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask.astype(np.float32), (ow, oh),
                              interpolation=cv2.INTER_NEAREST).astype(np.int32)
            h, w = image.shape[:2]
            x1 = int(round((w - outsize) / 2.0))
            y1 = int(round((h - outsize) / 2.0))
            return (image[y1:y1 + outsize, x1:x1 + outsize],
                    mask[y1:y1 + outsize, x1:x1 + outsize])

        # train
        if rs.rand() < 0.5:
            image = image[:, ::-1].copy()
            mask = mask[:, ::-1].copy()
        crop_size = self.crop_size
        short_size = rs.randint(int(self.base_size * 0.8),
                                int(self.base_size * 1.6) + 1)
        h, w = image.shape[:2]
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        image = cv2.resize(image, (ow, oh), interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(mask.astype(np.float32), (ow, oh),
                          interpolation=cv2.INTER_NEAREST).astype(np.int32)
        if short_size < crop_size:
            padh = max(0, crop_size - oh)
            padw = max(0, crop_size - ow)
            image = cv2.copyMakeBorder(image, 0, padh, 0, padw,
                                       cv2.BORDER_CONSTANT, value=0)
            mask = cv2.copyMakeBorder(mask, 0, padh, 0, padw,
                                      cv2.BORDER_CONSTANT, value=0)
        h, w = image.shape[:2]
        x1 = rs.randint(0, w - crop_size + 1)
        y1 = rs.randint(0, h - crop_size + 1)
        image = image[y1:y1 + crop_size, x1:x1 + crop_size]
        mask = mask[y1:y1 + crop_size, x1:x1 + crop_size]
        if rs.rand() < 0.5:
            image = cv2.GaussianBlur(image, (0, 0), rs.rand() / 3)
        return image, mask

"""RGB segmentation datasets of the DeepLab experiments.

A copy of ``gan_segmentation_tpu/data/segmentation.py`` (cv2 imported where
it is called; the native path reads through the port's own
``native.read_pair``); ``tests/test_torch_seg_data.py`` holds every dataset
class byte-equal to the original on the same files.

Re-implements `deeplabv3plus/lib/data/segmentation/*`: directory-scanned
(img_*.jpg, mask_*.png) pairs with ``scale_factor`` resizing, the mask-value
conventions of each domain, and the reference's random-with-replacement
"epoch" (``train_epoch_len`` draws per epoch from ``random.Random(rng_seed)``,
`ffhq:57-58,88-92`).

Samples are (image HWC, mask HW int32).  With the default ``transform`` the
image is float32 ImageNet-normalized (`01/main.py:44-53`); with
``transform=None`` it stays **uint8**, and the trainer normalizes on the
device (``train.deeplab_trainer._device_normalize``, a quarter of the
bytes over the host link): the dtype is the contract.
"""

import random
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def imagenet_transform(img_uint8_rgb: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize, NHWC (channel-last) instead of the reference's
    CHW (`01/main.py:49-53`)."""
    x = img_uint8_rgb.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def imagenet_denormalize(img: np.ndarray) -> np.ndarray:
    return np.clip((img * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255)


class SegmentationDataset:
    """Base: scans ``<root>/<subdir>`` for img_*.jpg / mask_*.png pairs."""

    NUM_CLASS = 2

    def __init__(self, dataset_path, split="train", subdir=None,
                 transform: Optional[Callable] = imagenet_transform,
                 augmentator=None, return_path: bool = False,
                 decimation_factor: int = 1, scale_factor: float = 1.0,
                 train_epoch_len: int = -1, max_samples: Optional[int] = None,
                 rng_seed: Optional[int] = None, native_reader: bool = False):
        dataset_path = Path(dataset_path)
        if split not in ("train", "test", "val"):
            raise RuntimeError("Unknown dataset split.")
        self.split = split
        self.scale_factor = scale_factor
        self.train_epoch_len = train_epoch_len
        subdir = split if subdir is None else subdir

        images = sorted(dataset_path.joinpath(subdir).rglob("*.jpg"))
        if max_samples is not None:
            images = random.Random(rng_seed).sample(
                images, min(len(images), max_samples))
        if decimation_factor > 1:
            images = [x for x in images
                      if int(x.stem.split("_")[1]) % decimation_factor == 0]

        self.images: List[str] = [str(p) for p in images]
        self.masks = [p.replace("img_", "mask_").replace(".jpg", ".png")
                      for p in self.images]
        self.transform = transform
        self.augmentator = augmentator
        self.return_path = return_path
        self._rng = random.Random(rng_seed)
        assert len(self.images) == len(self.masks)

        # Opt-in native decode (``native.read_pair``): GIL-free JPEG/PNG
        # decode with the scale factor fused into the JPEG IDCT when
        # 1/scale_factor is in {1,2,4,8}.  Image pixels at scale<1 deviate
        # from the cv2 decode+INTER_LINEAR pipeline (DCT-domain box filter vs
        # bilinear).  Where the native library is unavailable (no libjpeg /
        # libpng on the host) every item takes cv2; a decode failure falls
        # back to cv2 per item.
        self._native_denom = 0
        if native_reader:
            from .. import native
            if native.native_available():
                inv = 1.0 / scale_factor
                if abs(inv - round(inv)) < 1e-9 and int(round(inv)) in (
                        1, 2, 4, 8):
                    self._native_denom = int(round(inv))

    # -- domain-specific mask handling -------------------------------------
    def _process_mask(self, mask: np.ndarray) -> np.ndarray:
        return mask

    def __len__(self):
        if self.split == "train" and self.train_epoch_len > 0:
            return self.train_epoch_len
        return len(self.images)

    @property
    def num_class(self):
        return self.NUM_CLASS

    @property
    def pred_offset(self):
        return 0

    @property
    def classes(self):
        return None

    def __getitem__(self, index):
        import cv2

        if self.split == "train" and self.train_epoch_len > 0:
            index = self._rng.randint(0, len(self.images) - 1)

        img = mask = None
        if self._native_denom:
            from .. import native
            try:
                img, mask = native.read_pair(self.images[index],
                                             self.masks[index],
                                             self._native_denom)
                mask = mask.astype(np.int32)
            except RuntimeError:
                img = mask = None  # per-item cv2 fallback
        if img is None:
            img = cv2.imread(self.images[index])
            assert img is not None, self.images[index]
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if self.scale_factor != 1.0:
                img = cv2.resize(img, (0, 0), fx=self.scale_factor,
                                 fy=self.scale_factor)
            mask = cv2.imread(self.masks[index], cv2.IMREAD_UNCHANGED)
            assert mask is not None, self.masks[index]
            mask = mask.astype(np.int32)
        if mask.shape[:2] != img.shape[:2]:
            mask = cv2.resize(mask, (img.shape[1], img.shape[0]),
                              interpolation=cv2.INTER_NEAREST)
        mask = self._process_mask(mask)

        if self.augmentator is not None:
            img, mask = self.augmentator(img, mask)

        if self.transform is not None:
            img = self.transform(img)
        # transform=None keeps the image uint8 (normalised on the device);
        # casting it to f32 here would skip that normalisation
        mask = np.asarray(mask, np.int32)

        if self.return_path:
            return img, mask, self.images[index]
        return img, mask


class FFHQHairSegmentation(SegmentationDataset):
    """`ffhq_hair_segmentation.py`: binary hair masks, 255 -> ignore (-1)."""

    NUM_CLASS = 2

    def _process_mask(self, mask):
        mask = mask.copy()
        mask[mask == 255] = -1  # `ffhq:69`
        return mask


class CarSegmentation(SegmentationDataset):
    """`car_segmentation.py`: binarize mask > 0 (`car:65`); fixed subdir
    naming (train/test/val)."""

    NUM_CLASS = 2

    def _process_mask(self, mask):
        return (mask > 0).astype(np.int32)


class GlassesSegmentation(SegmentationDataset):
    """`glasses_segmentation.py`: raw integer labels."""

    NUM_CLASS = 2


class LSUNBedroomsSegmentation(SegmentationDataset):
    """`lsun_bedrooms_segmentation.py`: ADE-style labels (default 150
    classes) with optional not_ignore filter (`lsun:66-69`)."""

    def __init__(self, dataset_path, split="train", num_classes=150,
                 not_ignore_classes: Optional[Sequence[int]] = None, **kw):
        self.NUM_CLASS = num_classes
        self._not_ignore_classes = not_ignore_classes
        super().__init__(dataset_path, split=split, **kw)

    def _process_mask(self, mask):
        if self._not_ignore_classes is not None:
            keep = np.isin(mask, self._not_ignore_classes)
            mask = np.where(keep, mask, -1).astype(np.int32)
        return mask


class ImagesDirectory:
    """`images_dir.py`: inference-only directory of images (optional inverse-
    depth channel), fake all-ignore targets."""

    def __init__(self, dataset_path, num_class, transform=imagenet_transform,
                 images_mask="*.png", depth_mask=None, pred_offset=1,
                 depth_k=None, depth_mean=None, depth_std=None):
        dataset_path = Path(dataset_path)
        self.images = sorted(str(x) for x in dataset_path.glob(images_mask))
        self.depths = None
        if depth_mask is not None:
            self.depths = sorted(str(x) for x in dataset_path.glob(depth_mask))
            assert len(self.images) == len(self.depths)
        self.depth_mean = depth_mean
        self.depth_std = depth_std
        self.depth_k = depth_k
        self.transform = transform
        self._pred_offset = pred_offset
        self.NUM_CLASS = num_class

    def __len__(self):
        return len(self.images)

    @property
    def pred_offset(self):
        return self._pred_offset

    @property
    def num_class(self):
        return self.NUM_CLASS

    def __getitem__(self, index):
        import cv2

        img = cv2.imread(self.images[index])
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self.transform is not None:
            img = self.transform(img)
        fake_target = -1 * np.ones(img.shape[:2], np.int32)
        if self.depths is not None:
            depth = cv2.imread(self.depths[index], cv2.IMREAD_UNCHANGED)
            depth = depth.astype(np.float32)
            depth[depth == 0] = self.depth_k / self.depth_mean
            depth = np.minimum(self.depth_k / (depth + 1), 1)
            depth = (depth - self.depth_mean) / self.depth_std
            return (img, depth[..., None]), fake_target, self.images[index]
        return img, fake_target, self.images[index]

"""Mask visualization (`deeplabv3plus/lib/utils/viz.py`, `utils.py:69-102`).

A copy of ``gan_segmentation_tpu/utils/viz.py`` (the port imports nothing
of that package); ``tests/test_torch_annotator.py`` pins the two together.
"""

from typing import List, Optional

import numpy as np


def getvocpallete(num_cls: int) -> List[int]:
    """VOC color palette (gluoncv ``_getvocpallete``)."""
    n = num_cls
    pallete = [0] * (n * 3)
    for j in range(n):
        lab = j
        pallete[j * 3 + 0] = 0
        pallete[j * 3 + 1] = 0
        pallete[j * 3 + 2] = 0
        i = 0
        while lab > 0:
            pallete[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            pallete[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            pallete[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return pallete


def visualize_mask(mask: np.ndarray, num_classes: int) -> np.ndarray:
    """int mask (H, W) -> RGB uint8 using the VOC palette. Ignore labels
    (-1) render as background (palette[0]), all other labels keep their own
    colors — `deeplabv3plus/lib/utils/viz.py:24-28` (``mask[mask == -1] = 0``;
    any offset, e.g. ``pred_offset``, is the caller's job)."""
    mask = np.asarray(mask, np.int32)
    mask = np.where(mask < 0, 0, mask)
    pal = np.asarray(getvocpallete(max(num_classes, int(mask.max()) + 1)),
                     np.uint8).reshape(-1, 3)
    return pal[np.clip(mask, 0, len(pal) - 1)]


def get_seg_color_map():
    """`utils.py:69-77`."""
    return [[0, np.array([0, 0, 0], np.uint8)],
            [1, np.array([13, 198, 20], np.uint8)],
            [2, np.array([54, 30, 211], np.uint8)]]


def get_draw_mask(img, mask, alpha=0.5, color_map=None, skip_background=True):
    """Overlay drawing (`utils.py:80-102`)."""
    if color_map is None:
        color_map = get_seg_color_map()
    out = np.array(img)
    for idx, color in color_map:
        if idx == 0 and skip_background:
            continue
        sel = mask == idx
        for c in range(3):
            out[..., c][sel] = (alpha * color[c]
                                + (1 - alpha) * out[..., c][sel])
    return out


def morph_mask(mask):
    """open/close cleanup (`utils.py:105-109`)."""
    import cv2
    kernel = np.ones((5, 5), np.uint8)
    mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
    return cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)

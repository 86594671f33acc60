"""Image crop helpers (`utils.py:118-178` in the reference).

A copy of ``gan_segmentation_tpu/utils/image.py``, with ``cv2`` imported by
``prepare_crop`` alone; ``tests/test_torch_seg_data.py`` pins the two
together.
"""

import numpy as np


def crop_image(img: np.ndarray, bbox) -> np.ndarray:
    """Crop [x, y, w, h] with zero-padding for out-of-bounds regions."""
    x_st, y_st = bbox[0], bbox[1]
    x_en = bbox[0] + bbox[2] - 1
    y_en = bbox[1] + bbox[3] - 1

    x_st_pad = int(max(0, -x_st))
    y_st_pad = int(max(0, -y_st))
    x_en_pad = int(max(0, x_en - img.shape[1] + 1))
    y_en_pad = int(max(0, y_en - img.shape[0] + 1))

    x_en = x_en + max(0, -x_st)
    y_en = y_en + max(0, -y_st)
    x_st = max(0, x_st)
    y_st = max(0, y_st)

    if y_st_pad or y_en_pad or x_st_pad or x_en_pad:
        assert img.ndim in (2, 3)
        pad_shape = (img.shape[0] + y_st_pad + y_en_pad,
                     img.shape[1] + x_st_pad + x_en_pad) + img.shape[2:]
        img_pad = np.zeros(pad_shape, img.dtype)
        img_pad[y_st_pad:y_st_pad + img.shape[0],
                x_st_pad:x_st_pad + img.shape[1]] = img
    else:
        img_pad = img
    return img_pad[y_st:y_en + 1, x_st:x_en + 1]


def prepare_crop(im: np.ndarray, prepare_sz, fit_whole: bool = False,
                 use_nn_interpolation: bool = False) -> np.ndarray:
    """Aspect-preserving center crop + resize to ``prepare_sz`` (w, h)."""
    import cv2
    if im.shape[0] == prepare_sz[1] and im.shape[1] == prepare_sz[0]:
        return im
    prepare_r = float(prepare_sz[0]) / prepare_sz[1]
    orig_r = float(im.shape[1]) / im.shape[0]
    do_fit_width = orig_r > prepare_r if fit_whole else orig_r < prepare_r
    if do_fit_width:
        crop_w = im.shape[1]
        crop_h = crop_w / prepare_r
    else:
        crop_h = im.shape[0]
        crop_w = crop_h * prepare_r
    crop_x = int((im.shape[1] - crop_w) / 2.0)
    crop_y = int((im.shape[0] - crop_h) / 2.0)
    im = crop_image(im, [crop_x, crop_y, int(crop_w), int(crop_h)])
    interp = cv2.INTER_NEAREST if use_nn_interpolation else cv2.INTER_LINEAR
    return cv2.resize(im, tuple(prepare_sz), interpolation=interp)

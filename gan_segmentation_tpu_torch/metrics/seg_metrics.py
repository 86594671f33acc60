"""Segmentation metrics of ``evaluate``: pixel accuracy and mean IoU.

A copy of the part of ``gan_segmentation_tpu/metrics/seg_metrics.py`` that
``SegSolver.evaluate`` uses (``SegmentationMetric`` with its helpers); the
other metric families wait for the DeepLab slice.  Accumulation is numpy;
predictions may be tensors on any device and are pulled to the host once
per update.  ``tests/test_torch_data.py`` pins the copy to the original.
"""

from typing import Optional

import numpy as np
import torch


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pred_label(pred, axis: int, nclass: int, threshold: Optional[float]):
    """argmax over channel, or threshold P(class1) in binary mode."""
    pred = _to_np(pred)
    if threshold is not None and nclass <= 2 and pred.ndim == 4:
        ch = pred[:, 1] if axis == 1 else pred[..., 1]
        return (ch > threshold).astype(np.int64)
    if pred.ndim == 4:
        return np.argmax(pred, axis=axis).astype(np.int64)
    return pred.astype(np.int64)


def batch_pix_accuracy(output, target, threshold: Optional[float] = None,
                       axis: int = -1):
    """(correct, labeled) pixel counts; labels < 0 are not counted."""
    output = _to_np(output)
    nclass = output.shape[1 if axis == 1 else -1] if output.ndim == 4 else 0
    use_thr = threshold is not None and output.ndim == 4 and nclass <= 2
    predict = _pred_label(output, axis, nclass if use_thr else 3,
                          threshold if use_thr else None) + 1
    target = _to_np(target).astype(np.int64) + 1
    pixel_labeled = int(np.sum(target > 0))
    pixel_correct = int(np.sum((predict == target) * (target > 0)))
    assert pixel_correct <= pixel_labeled
    return pixel_correct, pixel_labeled


def batch_intersection_union(output, target, nclass: int,
                             threshold: Optional[float] = None,
                             axis: int = -1):
    """Per-class (intersection, union) by the +1-shift histogram method."""
    output = _to_np(output)
    use_thr = threshold is not None and output.ndim == 4 and nclass <= 2
    predict = _pred_label(output, axis, nclass if use_thr else 3,
                          threshold if use_thr else None) + 1
    target = _to_np(target).astype(np.int64) + 1
    predict = predict * (target > 0).astype(predict.dtype)
    intersection = predict * (predict == target)
    area_inter, _ = np.histogram(intersection, bins=nclass, range=(1, nclass))
    area_pred, _ = np.histogram(predict, bins=nclass, range=(1, nclass))
    area_lab, _ = np.histogram(target, bins=nclass, range=(1, nclass))
    area_union = area_pred + area_lab - area_inter
    assert (area_inter <= area_union).all()
    return area_inter, area_union


class SegmentationMetric:
    """pixAcc and mIoU accumulator (threshold mode when ``threshold`` is
    given)."""

    def __init__(self, nclass: int, skip_bg: bool = True,
                 threshold: Optional[float] = None, axis: int = -1):
        self.nclass = nclass
        self.skip_bg = skip_bg
        self.threshold = threshold
        self.axis = axis
        self.reset()

    def reset(self):
        self.total_inter = np.zeros(self.nclass, np.int64)
        self.total_union = np.zeros(self.nclass, np.int64)
        self.total_correct = 0
        self.total_label = 0

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            corr, labeled = batch_pix_accuracy(pred, label, self.threshold,
                                               self.axis)
            inter, union = batch_intersection_union(pred, label, self.nclass,
                                                    self.threshold, self.axis)
            self.total_correct += corr
            self.total_label += labeled
            self.total_inter = self.total_inter + inter
            self.total_union = self.total_union + union

    def get(self):
        pix_acc = 1.0 * self.total_correct / (np.spacing(1) + self.total_label)
        iou = 1.0 * self.total_inter / (np.spacing(1) + self.total_union)
        iou = iou[self.total_union > 0]
        if self.skip_bg:
            iou = iou[1:]
        miou = float(iou.mean()) if iou.size else 0.0
        return ["accuracy", "mean-iou"], [float(pix_acc), miou]

    def get_name_value(self):
        names, values = self.get()
        return list(zip(names, values))

"""Segmentation metrics, numerically matching the reference.

A copy of ``gan_segmentation_tpu/metrics/seg_metrics.py`` (the port imports
nothing of that package); ``tests/test_torch_data.py`` and
``tests/test_torch_seg_data.py`` pin the copy to the original.  Both metric
families:

- `metrics.py` (decoder side): ``SegMetric`` (accuracy / recall / precision
  / IoU with skip_bg and ignore -1, `:49-216`), ``SegMetricFull`` (adds dice,
  macro-dice, AUC and AP, `:219-494`), ``SegmentationMetric`` (pixAcc + mIoU
  by the +1-shift histogram method, `:497-567`);
- `deeplabv3plus/lib/utils/metrics/segmentation.py`: the same pixAcc / mIoU
  with a **binary-threshold mode** (nclass == 2: the prediction is P(class 1)
  > threshold instead of the argmax, `:363-407`) and
  ``SegmentationMetricDetailed``.

Accumulation is numpy; predictions may be tensors on any device and are
pulled to the host once per update.  AUC and AP need sklearn, imported on
first use; without it they are left out, as in the original.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sklearn_scores():
    """(roc_auc_score, average_precision_score), or None without sklearn."""
    try:
        from sklearn.metrics import average_precision_score, roc_auc_score
    except ImportError:
        return None
    return roc_auc_score, average_precision_score


CLASS_MAPS = {
    "hair": ["background", "hair"],
    "hair_with_skin": ["background", "hair", "skin"],
    "face": ["background", "hair", "brows", "eyes", "nose", "mouth", "ears",
             "skin", "beard"],
    "glasses": ["background", "glasses"],
    "car": ["background", "cars"],
}


def get_classes_names(cls_type: str) -> Tuple[List[str], int]:
    names = CLASS_MAPS[cls_type]
    return names, len(names)


def _pred_label(pred, axis: int, nclass: int, threshold: Optional[float]):
    """argmax over channel, or threshold P(class1) in binary mode."""
    pred = _to_np(pred)
    if threshold is not None and nclass <= 2 and pred.ndim == 4:
        ch = pred[:, 1] if axis == 1 else pred[..., 1]
        return (ch > threshold).astype(np.int64)
    if pred.ndim == 4:
        return np.argmax(pred, axis=axis).astype(np.int64)
    return pred.astype(np.int64)


class SegMetric:
    """`metrics.py:49-216` (threshold=None) and the deeplab detailed variant
    (`segmentation.py:82-360`, threshold mode) in one accumulator."""

    def __init__(self, num_classes: int, class_names: Optional[Sequence[str]] = None,
                 axis: int = -1, full_output: bool = False, ignore_label: int = -1,
                 skip_bg: bool = True, compute_auc: bool = False,
                 compute_dice: bool = False, threshold: Optional[float] = None):
        self.axis = axis
        self.num_classes = num_classes
        self.full_output = full_output
        self.class_names = (list(class_names) if class_names is not None
                            else [str(i) for i in range(num_classes)])
        self.ignore_label = ignore_label
        self.skip_bg = skip_bg
        self.compute_auc = compute_auc and _sklearn_scores() is not None
        self.compute_dice = compute_dice
        self.threshold = threshold
        self.reset()

    @property
    def _cls_range(self) -> int:
        return self.num_classes - 1 if self.skip_bg else self.num_classes

    def reset(self):
        n = self._cls_range
        self.sum_corr = 0
        self.num_inst = 0
        self.sum_tp = np.zeros(n, np.int64)
        self.sum_fp = np.zeros(n, np.int64)
        self.sum_fn = np.zeros(n, np.int64)
        self.sum_num = np.zeros(n, np.int64)
        self.sum_dice = np.zeros(n, np.float64)
        self.num_dice = np.zeros(n, np.int64)
        self.stored_pred = [None] * n

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            prob = _to_np(pred)
            pred_label = _pred_label(prob, self.axis, self.num_classes,
                                     self.threshold)
            if label.ndim > 3:
                label = np.squeeze(label, axis=1)
            if pred_label.ndim > 3:
                pred_label = np.squeeze(pred_label, axis=1)
            label = label.astype(np.int64)
            valid = label != self.ignore_label

            lv = label[valid]
            pv = pred_label[valid]
            self.sum_corr += int((lv == pv).sum())
            self.num_inst += int(lv.size)

            for i in range(self._cls_range):
                cid = i + 1 if self.skip_bg else i
                mc = pv == cid
                mg = lv == cid
                tp = int(np.count_nonzero(mc & mg))
                fp = int(np.count_nonzero(mc & ~mg))
                fn = int(np.count_nonzero(~mc & mg))
                self.sum_tp[i] += tp
                self.sum_fp[i] += fp
                self.sum_fn[i] += fn
                self.sum_num[i] += int(np.count_nonzero(mg)) + int(np.count_nonzero(mc))
                if self.compute_dice:
                    if 2 * tp + fp + fn > 0:
                        self.sum_dice[i] += 2.0 * tp / (2 * tp + fp + fn)
                    self.num_dice[i] += 1
                if self.compute_auc and prob.ndim == 4:
                    ch = prob[:, cid] if self.axis == 1 else prob[..., cid]
                    y_score = ch[valid].reshape(-1)
                    y_true = (lv == cid).astype(np.int32).reshape(-1)
                    if self.stored_pred[i] is None:
                        self.stored_pred[i] = [y_true, y_score]
                    else:
                        self.stored_pred[i][0] = np.concatenate(
                            [self.stored_pred[i][0], y_true])
                        self.stored_pred[i][1] = np.concatenate(
                            [self.stored_pred[i][1], y_score])

    def get(self) -> Tuple[List[str], List[float]]:
        res = []
        acc = float(self.sum_corr) / self.num_inst if self.num_inst else 0.0
        res.append(("accuracy", acc))

        agg = {k: [] for k in
               ("recall", "precision", "iou", "dice", "macro_dice", "auc", "ap")}
        offset = 1 if self.skip_bg else 0
        for i in range(self._cls_range):
            name = self.class_names[i + offset]
            tp, fp, fn = self.sum_tp[i], self.sum_fp[i], self.sum_fn[i]
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            iou = tp / (tp + fp + fn) if tp + fp + fn > 0 else 0.0
            dice = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn > 0 else 0.0
            macro_dice = (self.sum_dice[i] / self.num_dice[i]
                          if self.num_dice[i] > 0 else 0.0)
            auc = ap = 0.0
            if self.compute_auc and self.stored_pred[i] is not None:
                y_true, y_prob = self.stored_pred[i]
                if len(np.unique(y_true)) > 1:
                    roc_auc_score, average_precision_score = _sklearn_scores()
                    auc = float(roc_auc_score(y_true, y_prob))
                    ap = float(average_precision_score(y_true, y_prob))
            if self.full_output:
                res.append((f"{name}-recall", recall))
                res.append((f"{name}-precision", precision))
                res.append((f"{name}-iou", iou))
                if self.compute_dice:
                    res.append((f"{name}-dice", dice))
                    res.append((f"{name}-macro-dice", macro_dice))
                if self.compute_auc:
                    res.append((f"{name}-auc-score", auc))
                    res.append((f"{name}-ap-score", ap))
            if self.sum_num[i] > 0:
                agg["recall"].append(recall)
                agg["precision"].append(precision)
                agg["iou"].append(iou)
                if self.compute_dice:
                    agg["dice"].append(dice)
                    agg["macro_dice"].append(macro_dice)
                if self.compute_auc:
                    agg["auc"].append(auc)
                    agg["ap"].append(ap)

        res.append(("mean-recall", float(np.mean(agg["recall"])) if agg["recall"] else 0.0))
        res.append(("mean-precision", float(np.mean(agg["precision"])) if agg["precision"] else 0.0))
        res.append(("mean-iou", float(np.mean(agg["iou"])) if agg["iou"] else 0.0))
        if self.compute_dice:
            res.append(("mean-dice", float(np.mean(agg["dice"])) if agg["dice"] else 0.0))
            res.append(("mean-macro-dice", float(np.mean(agg["macro_dice"])) if agg["macro_dice"] else 0.0))
        if self.compute_auc:
            mean_auc = float(np.mean(agg["auc"])) if agg["auc"] else 0.0
            mean_ap = float(np.mean(agg["ap"])) if agg["ap"] else 0.0
            res.append(("mean-auc", mean_auc))
            res.append(("mean-ap", mean_ap))
            res.append(("100*(1-mean-auc)", 100 * (1 - mean_auc)))
            res.append(("100*(1-mean-ap)", 100 * (1 - mean_ap)))
        names, values = zip(*res)
        return list(names), list(values)

    def get_name_value(self):
        names, values = self.get()
        return list(zip(names, values))


def SegMetricFull(num_classes, **kw):
    """`metrics.py:219-494` — SegMetric with dice/AUC tracking enabled."""
    kw.setdefault("compute_dice", True)
    return SegMetric(num_classes, **kw)


def SegmentationMetricDetailed(num_classes, class_names=("background", "foreground"),
                               **kw):
    """deeplab `segmentation.py:82-360`."""
    kw.setdefault("compute_dice", True)
    kw.setdefault("threshold", 0.5)
    return SegMetric(num_classes, class_names=class_names, **kw)


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

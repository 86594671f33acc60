"""Segmentation losses of the decoder's training (PyTorch counterpart of
``gan_segmentation_tpu/ops/losses.py:27-56``).

``weighted_softmax_ce`` is gluon ``SoftmaxCELoss(axis=-1)`` with an
explicit sample weight: per-pixel cross entropy times the weight, then the
mean over every non-batch dim, ignored pixels included (the reference's
gradient scale).  Logits are NHWC, labels (N, H, W) integers with ignore
label -1; labels are clipped into the class range for the pick, and the
loss is computed in float32.  The focal and valid-normalised losses wait
for the DeepLab slice.
"""

import torch


def _per_pixel_ce(logits, labels):
    """-log softmax(logits) picked at the clipped labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)


def weighted_softmax_ce(logits, labels, sample_weight):
    """Per-sample loss vector (N,)."""
    ce = _per_pixel_ce(logits, labels) * sample_weight.float()
    return ce.mean(dim=tuple(range(1, ce.dim())))


def softmax_ce_with_ignore(logits, labels, ignore_label: int = -1):
    """Weighted CE with weight = (label != ignore); (N,)."""
    return weighted_softmax_ce(logits, labels, labels != ignore_label)

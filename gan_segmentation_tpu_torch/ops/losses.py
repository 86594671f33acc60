"""Segmentation losses (PyTorch counterpart of
``gan_segmentation_tpu/ops/losses.py``).

``weighted_softmax_ce`` is gluon ``SoftmaxCELoss(axis=-1)`` with an
explicit sample weight: per-pixel cross entropy times the weight, then the
mean over every non-batch dim, ignored pixels included (the reference's
gradient scale).  Logits are NHWC, labels (N, H, W) integers with ignore
label -1; labels are clipped into the class range for the pick, and the
loss is computed in float32.

``softmax_ce_valid_norm`` divides the summed CE by the number of valid
pixels (mxnet ``SoftmaxOutput(normalization='valid')``'s gradient scale).
The focal variants renormalise ``beta = (1 - pt)^gamma`` over the LAST TWO
axes (per image for (N, H, W) values) so that it sums to the valid count,
then sum over every non-batch axis; they return the per-sample loss and the
mean multiplier.  ``seg_loss_with_aux`` is the DeepLab trainer's criterion,
``CE(pred) + aux_weight * CE(aux)``.

Data-parallel (``group``, a ``torch.distributed`` process group): a
normaliser that spans the batch spans the GLOBAL batch, as the JAX
functions compute it on a global array.  ``softmax_ce_valid_norm`` divides
by the valid pixels of every process, and returns this process's share so
that the mean over the processes (what the step's gradient average takes)
is the global loss; the focal variants' mean multiplier is the global
mean.  The per-sample losses need nothing: equal shards make the mean of
the processes' means the global mean.
"""

import torch
import torch.distributed as dist

from ..core.distributed import all_reduce


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


def _global_sum(value, group):
    """``value`` summed over ``group``'s processes, outside autograd."""
    return all_reduce(value.detach().clone(), group)


def softmax_ce_valid_norm(logits, labels, ignore_label: int = -1,
                          group=None):
    """Scalar CE normalised by the number of valid pixels (of the global
    batch with ``group``: P times this process's sum over the global
    count, so that the processes' mean is the global loss)."""
    mask = (labels != ignore_label).float()
    ce = _per_pixel_ce(logits, labels) * mask
    if group is None:
        return ce.sum() / mask.sum().clamp_min(1.0)
    count = _global_sum(mask.sum(), group).clamp_min(1.0)
    return ce.sum() * dist.get_world_size(group) / count


def _mean_multiplier(mult, group):
    """The mean of the per-sample multipliers, over the global batch with
    ``group`` (equal shards)."""
    if group is None:
        return mult.mean()
    return _global_sum(mult.mean(), group) / dist.get_world_size(group)


def _pt_softmax(logits, labels, ignore_label):
    """(softmax probability of the label with ignored pixels at 1, valid)."""
    probs = torch.softmax(logits.float(), dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    pt = torch.gather(probs, -1, safe.unsqueeze(-1)).squeeze(-1)
    valid = labels != ignore_label
    return torch.where(valid, pt, torch.ones_like(pt)), valid


def _renormalize(beta, count, eps):
    """``beta * mult`` with ``mult = sum(count) / (sum(beta) + eps)`` over
    the last two axes -> (beta, mult)."""
    t_sum = count.sum(dim=(-2, -1), keepdim=True)
    mult = t_sum / (beta.sum(dim=(-2, -1), keepdim=True) + eps)
    return beta * mult, mult


def _reduce(loss, count, eps, size_average):
    """Sum over the non-batch axes, over ``sum(count) + eps`` if asked."""
    nb = tuple(range(1, loss.dim()))
    total = loss.sum(dim=nb)
    return total / (count.sum(dim=nb) + eps) if size_average else total


def _clipped_log(pt, eps):
    return torch.log(torch.clamp_max(pt + eps, 1.0))


def normalized_focal_loss_softmax(logits, labels, *, gamma: float = 2.0,
                                  ignore_label: int = -1, eps: float = 1e-10,
                                  size_average: bool = True, group=None):
    """-> (per-sample loss (N,), mean multiplier)."""
    pt, valid = _pt_softmax(logits, labels, ignore_label)
    valid = valid.float()
    beta, mult = _renormalize((1.0 - pt) ** gamma, valid, eps)
    loss = -beta * _clipped_log(pt, eps)
    return _reduce(loss, valid, eps, size_average), _mean_multiplier(
        mult, group)


def area_normalized_focal_loss_softmax(logits, labels, area_weights, *,
                                       gamma: float = 2.0,
                                       area_gamma: float = 0.5,
                                       ignore_label: int = -1,
                                       eps: float = 1e-10,
                                       size_average: bool = True,
                                       group=None):
    """The focal beta also weighted by ``area_weights ** area_gamma``
    (per pixel) before the renormalisation."""
    pt, valid = _pt_softmax(logits, labels, ignore_label)
    valid = valid.float()
    beta = ((1.0 - pt) ** gamma) * (area_weights.float() ** area_gamma)
    beta, mult = _renormalize(beta, valid, eps)
    loss = -beta * _clipped_log(pt, eps)
    return _reduce(loss, valid, eps, size_average), _mean_multiplier(
        mult, group)


def _pt_sigmoid(logits, labels):
    pred = torch.sigmoid(logits.float())
    one_hot = labels > 0
    return torch.where(one_hot, pred, 1.0 - pred), one_hot


def normalized_focal_loss_sigmoid(logits, labels, *, alpha: float = 0.25,
                                  gamma: float = 2.0, eps: float = 1e-12,
                                  size_average: bool = True,
                                  scale: float = 1.0, normalize: bool = True,
                                  group=None):
    """Sigmoid focal loss with the per-sample beta renormalisation (over
    every pixel, ignored ones included); ``labels`` has the logits' shape.
    -> (per-sample loss, mean multiplier)."""
    pt, one_hot = _pt_sigmoid(logits, labels)
    alpha_w = torch.where(one_hot, alpha, 1.0 - alpha)
    beta = (1.0 - pt) ** gamma
    mult = torch.ones((), device=pt.device)
    if normalize:
        beta, mult = _renormalize(beta, torch.ones_like(pt), eps)
    sample_weight = (labels != -1).float()
    loss = -alpha_w * beta * _clipped_log(pt, eps) * sample_weight
    return (scale * _reduce(loss, sample_weight, eps, size_average),
            _mean_multiplier(mult, group))


def focal_loss_sigmoid(logits, labels, *, alpha: float = 0.25,
                       gamma: float = 2.0, eps: float = 1e-9,
                       size_average: bool = True, scale: float = 1.0):
    """Binary sigmoid focal loss, ignore label -1; averaged over the number
    of POSITIVE labels (``labels == 1``)."""
    pt, one_hot = _pt_sigmoid(logits, labels)
    t = (labels != -1).float()
    alpha_w = torch.where(one_hot, alpha * t, (1.0 - alpha) * t)
    loss = -alpha_w * (1.0 - pt) ** gamma * _clipped_log(pt, eps) * t
    return scale * _reduce(loss, (labels == 1).float(), eps, size_average)


def seg_loss_with_aux(pred, aux_pred, labels, *, aux_weight: float = 0.5,
                      ignore_label: int = -1):
    """CE(final) + aux_weight * CE(aux), ignore-weighted; (N,)."""
    w = labels != ignore_label
    return (weighted_softmax_ce(pred, labels, w)
            + aux_weight * weighted_softmax_ce(aux_pred, labels, w))

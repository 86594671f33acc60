"""The DeepLab trainer's step-level core (PyTorch counterpart of
``gan_segmentation_tpu/train/deeplab_trainer.py``'s ``_device_normalize``,
``_resolve_dtype``, ``poly_schedule``, ``make_optimizer`` and its train and
eval steps; the trainer, evaluator and tester classes, the batcher, the
checkpoints and the preemption resume are not ported yet).

One train step: ImageNet-normalise a raw uint8 batch on the device, cast it
to the compute dtype, forward in train mode with dropout from a
``torch.Generator``, outputs to f32, ``mean(seg_loss_with_aux)``, backward,
SGD update, running statistics updated by the forward.

Optimizer semantics are the JAX package's (optax ``add_decayed_weights``
before ``sgd``): ``g <- g + wd * w`` for EVERY parameter (batch-norm scales
and biases included), ``buf <- momentum * buf + g``, ``w <- w - lr(step) *
buf`` with ``lr(step) = base * mult * (1 - step / total) ** 0.9`` evaluated
at the count of steps taken BEFORE the update (0 on the first); ``mult`` is
1 for the backbone and ``HEAD_LR_MULT`` for everything else.  That is
``torch.optim.SGD(momentum, weight_decay)`` over two groups under a
``LambdaLR`` (``tests/test_torch_deeplab_step.py`` holds five steps to
optax).

Mixed precision as the JAX package has it: parameters, batch-norm
statistics, loss and gradients f32; with ``dtype=torch.bfloat16`` the
activations, and so every conv and batch norm's arithmetic, are bf16: each
conv casts its f32 kernel to the activation's dtype (the gradient comes
back through the cast in f32), ``F.batch_norm`` takes bf16 activations with
f32 parameters and statistics, the resizes and the global pool compute in
f32 and cast back.  No ``torch.autocast``: the dtype of every op is the one
written in the model.
"""

from typing import Callable, Optional, Tuple

import torch

from ..models.deeplab import HEAD_LR_MULT, head_param_groups
from ..ops.losses import seg_loss_with_aux

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _device_normalize(images):
    """ImageNet-normalise on the device when the feed is raw uint8 (a
    quarter of the f32 feed's bytes over the host link); a float feed is
    taken as already normalised."""
    if images.dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        return (images.float() / 255.0 - mean) / std
    return images


def _resolve_dtype(dtype) -> torch.dtype:
    """The reference's ``--dtype`` flag -> a compute dtype.  'float16' maps
    to bfloat16, which keeps f32's exponent range: the reference's fp16
    loss scaling is not needed."""
    if dtype is None or dtype in ("float32", "f32"):
        return torch.float32
    if isinstance(dtype, str):
        if dtype in ("float16", "fp16", "bfloat16", "bf16"):
            return torch.bfloat16
        resolved = getattr(torch, dtype, None)
        if not isinstance(resolved, torch.dtype):
            raise TypeError(f"unknown dtype: {dtype!r}")
        return resolved
    return dtype


def poly_schedule(base_lr: float, total_iters: int,
                  power: float = 0.9) -> Callable[[int], float]:
    """gluoncv ``LRScheduler(mode='poly')``: lr = base * (1 - i/N)^power."""

    def fn(step):
        frac = min(max(step / max(total_iters, 1), 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return fn


def make_optimizer(model, base_lr: float, total_iters: int, wd: float,
                   momentum: float, head_mult: float = HEAD_LR_MULT
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """SGD + momentum with the poly rate; everything outside
    ``model.backbone`` gets ``head_mult`` times the rate.  -> (optimizer,
    scheduler); call ``scheduler.step()`` after each ``optimizer.step()``."""
    base, head = head_param_groups(model)
    optimizer = torch.optim.SGD(
        [{"params": base, "lr": base_lr},
         {"params": head, "lr": base_lr * head_mult}],
        lr=base_lr, momentum=momentum, weight_decay=wd or 0.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, poly_schedule(1.0, total_iters))
    return optimizer, scheduler


def train_step(model, optimizer, scheduler, images, masks,
               generator: Optional[torch.Generator] = None, *,
               aux_weight: float = 0.5, dtype: torch.dtype = torch.float32,
               depth=None):
    """One SGD step on ``(images, masks)``: NHWC uint8 (or normalised float)
    images and (N, H, W) integer masks with ignore label -1, on the model's
    device.  -> (loss, logits of the main head), both f32 and detached."""
    model.train()
    x = _device_normalize(images).to(dtype)
    kwargs = {} if depth is None else {"depth": depth}
    optimizer.zero_grad(set_to_none=True)
    outputs = [o.float() for o in model(x, generator=generator, **kwargs)]
    loss = seg_loss_with_aux(outputs[0], outputs[1], masks,
                             aux_weight=aux_weight).mean()
    loss.backward()
    optimizer.step()
    scheduler.step()
    return loss.detach(), outputs[0].detach()


@torch.no_grad()
def eval_step(model, images, *, dtype: torch.dtype = torch.float32,
              depth=None):
    """Eval-mode forward -> the main head's logits, f32."""
    model.eval()
    x = _device_normalize(images).to(dtype)
    kwargs = {} if depth is None else {"depth": depth}
    return model(x, **kwargs)[0].float()

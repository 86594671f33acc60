"""The DeepLab train / eval engine (PyTorch counterpart of
``gan_segmentation_tpu/train/deeplab_trainer.py``).

- ``train_step`` / ``eval_step``: one SGD step and one eval forward.  A raw
  uint8 batch is ImageNet-normalised on the device and cast to the compute
  dtype; the train forward draws its dropout bits from a ``torch.Generator``;
  outputs go to f32, ``mean(criterion)`` (``seg_loss_with_aux``), backward,
  SGD update, running statistics updated by the forward.
- ``batch_iter``: the seeded batcher with its background prefetch thread
  and a decode thread pool.
- ``SegmentationTrainer``: epochs of ``train_step`` fed by ``batch_iter``,
  loss bookkeeping pulled once per log interval, TensorBoard scalars and
  image triptychs (when tensorboardX is installed), per-epoch ``*.pt``
  checkpoints, pixAcc / mIoU validation, and a step-granular resume bundle
  written on SIGTERM.
- ``MultiEvalModel`` / ``SegmentationTester``: multi-scale + flip
  sliding-window evaluation (gluoncv ``MultiEvalModel``), batched: the
  windows of B same-shape images at every scale, with their mirror images,
  go through the model in one call (up to ``max_windows``), and the label
  map is taken on the device.

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

The trainer and the tester run on ``args.device`` (``"cpu"`` only when the
caller asks for it), else on the CUDA card, and raise without one.
Checkpoints are the port's ``*.pt`` (a ``state_dict``), written to a
``.tmp`` file and moved into place; ``--weights`` also reads the JAX
package's msgpack ``*.params`` and reference mxnet DeepLabV3+ files.
Multi-process training (the JAX package's ``process_index`` /
``process_count``, SyncBatchNorm) is not ported: one process, one device.
"""

import logging
import math
import os
import signal
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import cuda_device
from ..data.segmentation import (IMAGENET_MEAN, IMAGENET_STD,
                                 imagenet_denormalize)
from ..metrics.seg_metrics import SegMetric, SegmentationMetric
from ..models.deeplab import HEAD_LR_MULT, head_param_groups
from ..ops.losses import seg_loss_with_aux
from ..ops.resize import bilinear_resize
from ..utils.viz import visualize_mask

log = logging.getLogger(__name__)

RESUME_BUNDLE = "resume_bundle.pt"


def _device_normalize(images):
    """ImageNet-normalise on the device when the feed is raw uint8 (a
    quarter of the f32 feed's bytes over the host link); a float feed is
    taken as already normalised."""
    if images.dtype == torch.uint8:
        mean = torch.from_numpy(IMAGENET_MEAN).to(images.device)
        std = torch.from_numpy(IMAGENET_STD).to(images.device)
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


def _device_of(args) -> torch.device:
    """``args.device`` when the caller named one, else the CUDA card."""
    device = getattr(args, "device", None)
    return torch.device(device) if device is not None else cuda_device()


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
               depth=None, criterion: Callable = seg_loss_with_aux):
    """One SGD step on ``(images, masks)``: NHWC uint8 (or normalised float)
    images and (N, H, W) integer masks with ignore label -1, on the model's
    device; ``depth`` an (N, H, W, 1) float plane for a 4-channel model.
    -> (loss, logits of the main head), both f32 and detached."""
    model.train()
    x = _device_normalize(images).to(dtype)
    kwargs = {} if depth is None else {"depth": depth}
    optimizer.zero_grad(set_to_none=True)
    outputs = [o.float() for o in model(x, generator=generator, **kwargs)]
    loss = criterion(outputs[0], outputs[1], masks,
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


def batch_iter(dataset, batch_size: int, shuffle: bool, seed: int = 0,
               drop_last: bool = True, prefetch: int = 2,
               decode_workers: int = 1, start_batch: int = 0):
    """Batches of ``dataset`` from a background prefetch thread (host-side
    decode overlaps device compute): ``(images, masks, extra)`` numpy
    stacks, ``extra`` the items' third elements (paths) or None.

    The order is ``np.random.RandomState(seed)``'s permutation when
    ``shuffle``.  Items whose first element is an (image, depth) tuple (the
    reference's with_depth batchify ``Tuple(Tuple(Stack(), Stack()),
    Stack())``, `lib/core/segmentation.py:32-35`) are stacked component-wise.
    ``decode_workers > 1`` decodes a batch's items in a thread pool (the
    reference DataLoader's ``num_workers``; cv2 and the native reader release
    the GIL), which interleaves a dataset's or augmentator's random draws
    nondeterministically: use 1 for bit-reproducible runs.  ``start_batch``
    skips the first N batches of the epoch's order without decoding them
    (mid-epoch resume).  A decode error in the worker reaches the consumer;
    the worker stops when the consumer stops early.
    """
    import queue
    import threading

    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    steps = n // batch_size if drop_last else math.ceil(n / batch_size)

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def stack_first(items):
        if isinstance(items[0][0], tuple):
            k = len(items[0][0])
            return tuple(np.stack([it[0][j] for it in items])
                         for j in range(k))
        return np.stack([it[0] for it in items])

    pool = None
    if decode_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=decode_workers,
                                  thread_name_prefix="decode")

    def fetch(sel):
        if pool is not None:
            return list(pool.map(dataset.__getitem__, [int(i) for i in sel]))
        return [dataset[int(i)] for i in sel]

    def worker():
        try:
            for s in range(start_batch, steps):
                sel = order[s * batch_size:(s + 1) * batch_size]
                items = fetch(sel)
                imgs = stack_first(items)
                masks = np.stack([it[1] for it in items])
                extra = [it[2] for it in items] if len(items[0]) > 2 else None
                while not stop.is_set():
                    try:
                        q.put((imgs, masks, extra), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            sentinel = None
        except BaseException as exc:  # handed to the consumer, which raises
            sentinel = exc            # it (a dead worker must not hang get())
        while not stop.is_set():
            try:
                q.put(sentinel, timeout=0.2)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=worker, name="batch_iter", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        if pool is not None:
            pool.shutdown(wait=False)


class SegmentationTrainer:
    """`lib/core/segmentation.py:26-183` on one device.

    ``args``: ``batch_size``, ``test_batch_size``, ``checkpoints_path``,
    and optionally ``device`` (else the CUDA card), ``dtype``, ``workers``
    (decode threads), ``seed`` (the dropout generator's), ``logs_path``
    (TensorBoard), ``backbone_weights`` (a gluoncv backbone file) and
    ``weights`` (a checkpoint, see ``load_checkpoint``).  The model moves
    to the device; ``optimizer_params``: ``baselr``, ``nepochs``, ``wd``,
    ``momentum``.
    """

    def __init__(self, args, model, model_cfg, trainset, valset,
                 optimizer_params: dict, with_depth: bool = False,
                 image_dump_interval: int = 200,
                 criterion: Callable = seg_loss_with_aux):
        self.args = args
        self.device = _device_of(args)
        self.model = model.to(self.device)
        self.model_cfg = model_cfg
        self.trainset = trainset
        self.valset = valset
        self.criterion = criterion
        self.image_dump_interval = image_dump_interval
        self.aux_weight = model_cfg.get("aux_weight", 0.5)
        self.with_depth = with_depth
        # mixed precision (`lib/core/segmentation.py:50,64-65`): f32 master
        # parameters and statistics, activations in the compute dtype
        self.compute_dtype = _resolve_dtype(getattr(args, "dtype", "float32"))
        if self.compute_dtype != torch.float32:
            log.info("compute dtype: %s (f32 master params + BN stats)",
                     self.compute_dtype)
        # the reference's --workers DataLoader knob (`cmd_args.py:14-16`):
        # 0/1 = decode in the prefetch thread
        self._decode_workers = max(1, getattr(args, "workers", 1) or 1)
        self.batch_size = args.batch_size
        self.iters_per_epoch = len(trainset) // self.batch_size
        self.total_iters = self.iters_per_epoch * optimizer_params["nepochs"]
        self.base_lr = optimizer_params["baselr"]

        if getattr(args, "backbone_weights", None):
            # ImageNet-pretrained gluoncv resnet50_v1s (the reference's
            # pretrained_base=True, `deeplabv3plus.py:92`)
            from ..core.backbone_convert import load_backbone_state_dict
            self.model.backbone.load_state_dict(load_backbone_state_dict(
                args.backbone_weights, layers=self.model.backbone.layers))
            log.info("loaded pretrained backbone from %s",
                     args.backbone_weights)
        if getattr(args, "weights", None):
            if not os.path.isfile(args.weights):
                raise RuntimeError(
                    f"=> no checkpoint found at '{args.weights}'")
            load_checkpoint(args.weights, self.model)
            log.info("resumed weights from %s", args.weights)

        self.optimizer, self.scheduler = make_optimizer(
            self.model, self.base_lr, self.total_iters,
            optimizer_params.get("wd", 0.0),
            optimizer_params.get("momentum", 0.9))
        self.generator = torch.Generator(device=self.device).manual_seed(
            getattr(args, "seed", 0))
        self.metric = SegmentationMetric(trainset.num_class)
        self.sw = None
        self._sw_made = False
        # preemption: SIGTERM sets the flag, training() saves a resume
        # bundle at the next step boundary and stops
        self._stop_requested = False
        self.preempted = False

    # ----------------------------------------------------------------- feeds
    @staticmethod
    def _feed(arr: np.ndarray, num_class: int) -> np.ndarray:
        """Host dtype of a feed: uint8 images and int8 masks (labels in
        [-1, num_class)) cross the host link, 4-5x fewer bytes than f32 and
        int32; the images are normalised on the device."""
        if arr.dtype == np.uint8:
            return arr
        if arr.dtype in (np.int32, np.int64) and num_class < 127:
            return arr.astype(np.int8)
        return arr.astype(np.float32) if arr.dtype.kind == "f" else arr

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _inputs(self, imgs):
        """Host images, or (image, depth) pairs -> (images, depth or None)
        on the device."""
        depth = None
        if self.with_depth:
            imgs, depth = imgs
            depth = self._upload(depth.astype(np.float32))
        return self._upload(self._feed(imgs, 256)), depth

    def current_lr(self, step: int) -> float:
        return poly_schedule(self.base_lr, self.total_iters)(step)

    # -------------------------------------------------------------- training
    def training(self, epoch: int, log_interval: int = 25,
                 start_iter: int = 0) -> float:
        """One epoch from batch ``start_iter``; -> the mean batch loss."""
        if not self._sw_made:  # once: None (one warning) without the package
            self.sw = _make_summary_writer(self.args)
            self._sw_made = True
        self.metric.reset()
        tic = time.time()

        # no per-step sync: each step's loss stays on the device, and the
        # pending ones are pulled in one transfer per log interval (TB
        # scalars written afterwards with their own global step), so the
        # epoch loss is the exact mean of the batch losses
        # (`lib/core/segmentation.py:116-117,139-141`)
        pending = []
        train_loss = 0.0
        n_pulled = 0
        last_step = -1

        def drain(upto_global_step):
            nonlocal train_loss, n_pulled
            if not pending:
                return
            vals = torch.stack(pending).cpu().numpy()
            pending.clear()
            for k, v in enumerate(vals):
                step = upto_global_step - (len(vals) - 1 - k)
                train_loss += float(v)
                n_pulled += 1
                if self.sw is not None:
                    self.sw.add_scalars(
                        "Loss/ce", {"batch": float(v),
                                    "epoch_avg": train_loss / n_pulled}, step)
                    self.sw.add_scalar("learning_rate",
                                       self.current_lr(step), step)

        nc = self.trainset.num_class
        for off, (imgs, masks, _) in enumerate(batch_iter(
                self.trainset, self.batch_size, shuffle=True, seed=epoch,
                decode_workers=self._decode_workers,
                start_batch=start_iter)):
            i = start_iter + off
            if self._stop_requested:
                # batch i has NOT run: the bundle points the resumed run at it
                drain(last_step)
                self.save_resume_bundle(epoch, i)
                self.save_checkpoint()
                self.preempted = True
                log.info("preempted at epoch %d iter %d: resume bundle "
                         "saved, stopping", epoch, i)
                return train_loss / max(1, n_pulled)
            global_step = self.iters_per_epoch * epoch + i
            last_step = global_step
            images, depth = self._inputs(imgs)
            labels = self._upload(self._feed(masks, nc))
            loss, pred = train_step(
                self.model, self.optimizer, self.scheduler, images, labels,
                self.generator, aux_weight=self.aux_weight,
                dtype=self.compute_dtype, depth=depth,
                criterion=self.criterion)
            pending.append(loss)

            if (self.sw is not None and self.image_dump_interval > 0
                    and global_step % self.image_dump_interval == 0):
                self._dump_images(imgs, masks, pred[:1].cpu().numpy(),
                                  global_step)
            if i % log_interval == log_interval - 1 or i == 0:
                drain(global_step)
                log.info("Epoch %d iter %d/%d training loss %.3f", epoch, i,
                         self.iters_per_epoch, train_loss / max(1, n_pulled))
        drain(last_step)
        log.info("Epoch %d done in %.1fs, training loss %.3f", epoch,
                 time.time() - tic, train_loss / max(1, n_pulled))
        self.save_checkpoint()
        return train_loss / max(1, n_pulled)

    def _dump_images(self, imgs, masks, pred, global_step):
        if self.with_depth:
            imgs = imgs[0]
        if imgs.dtype == np.uint8:
            image = imgs[0]
        else:
            image = imagenet_denormalize(imgs[0]).astype(np.uint8)
        offset, ncls = self.trainset.pred_offset, self.trainset.num_class + 1
        gt = visualize_mask(masks[0].astype(np.int32) + offset, ncls)
        pm = visualize_mask(np.argmax(pred[0], axis=-1).astype(np.int32)
                            + offset, ncls)
        panel = np.hstack([image, gt, pm]).transpose(2, 0, 1)
        self.sw.add_image("Images/input_image", panel, global_step)

    # ------------------------------------------------------------ validation
    def validation(self, epoch: int) -> dict:
        """pixAcc / mIoU over the whole val set, ``test_batch_size`` at a
        time; the argmax is taken on the device."""
        self.metric.reset()
        for imgs, masks, _ in batch_iter(
                self.valset, max(1, self.args.test_batch_size),
                shuffle=False, drop_last=False,
                decode_workers=self._decode_workers):
            images, depth = self._inputs(imgs)
            logits = eval_step(self.model, images, dtype=self.compute_dtype,
                               depth=depth)
            self.metric.update([masks], [logits.argmax(-1).cpu()])
        names, values = self.metric.get()
        result = ", ".join(f"{n}: {v:4f}" for n, v in zip(names, values))
        log.info("Epoch %d validation %s", epoch, result)
        if self.sw is not None:
            for n, v in zip(names, values):
                self.sw.add_scalars(f"Metrics/{n}", {"val": v}, epoch)
        return dict(zip(names, values))

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, epoch: Optional[int] = None):
        path = Path(self.args.checkpoints_path)
        path.mkdir(parents=True, exist_ok=True)
        name = ("last_checkpoint.pt" if epoch is None
                else f"{epoch:03d}_checkpoint.pt")
        save_checkpoint_file(str(path / name), self.model.state_dict())
        log.info("saved checkpoint %s", name)

    # ----------------------------------------------- preemption / resume
    # A signal requests a stop; training() persists a step-granular resume
    # bundle (model, optimizer and scheduler state, the dropout generator,
    # the position) at the next step boundary, and try_resume() continues
    # from it: the epoch order is a function of the epoch seed, so the
    # resumed run skips to its batch without decoding the ones before.  The
    # continuation is bit-identical on a deterministic device when the
    # datasets draw nothing (``train_epoch_len = -1``, no random
    # augmentation) and ``decode_workers`` is 1: the dataset's
    # ``random.Random`` and an augmentator's ``RandomState`` are not in the
    # bundle, as in the JAX package.

    def install_preemption_handler(self, signals=(signal.SIGTERM,)):
        """Make each of ``signals`` request a stop; -> the handlers they
        replaced, by signal."""
        def _handler(signum, frame):
            self._stop_requested = True
            log.info("received signal %d: will checkpoint and stop at the "
                     "next step boundary", signum)
        return {s: signal.signal(s, _handler) for s in signals}

    def _resume_bundle_path(self) -> Path:
        return Path(self.args.checkpoints_path) / RESUME_BUNDLE

    def save_resume_bundle(self, epoch: int, next_iter: int):
        """Persist the whole training state and the position to resume
        from, atomically."""
        path = self._resume_bundle_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"model": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict(),
                   "scheduler": self.scheduler.state_dict(),
                   "generator": self.generator.get_state(),
                   "epoch": epoch, "next_iter": next_iter}
        tmp = path.with_name(path.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a torn write must not poison the resume
        log.info("saved resume bundle: %s (epoch %d, iter %d)", path, epoch,
                 next_iter)

    def try_resume(self) -> Optional[Tuple[int, int]]:
        """Restore the resume bundle of the checkpoint dir, if there is one.
        -> ``(epoch, next_iter)`` for ``training(epoch,
        start_iter=next_iter)``, or None."""
        path = self._resume_bundle_path()
        if not path.is_file():
            return None
        d = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.scheduler.load_state_dict(d["scheduler"])
        self.generator.set_state(d["generator"])
        epoch, next_iter = int(d["epoch"]), int(d["next_iter"])
        log.info("resumed from bundle %s: epoch %d iter %d (step %d)", path,
                 epoch, next_iter, self.scheduler.last_epoch)
        return epoch, next_iter

    def clear_resume_bundle(self):
        """Drop the bundle once an epoch completed after it (a later run in
        the same dir must start fresh, not 'resume' into the past)."""
        path = self._resume_bundle_path()
        if path.is_file():
            path.unlink()


def save_checkpoint_file(path: str, state_dict) -> None:
    """``state_dict`` (on the host) -> ``path``, through a ``.tmp`` file: a
    crash mid-write never tears the checkpoint a resume loads next."""
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model) -> None:
    """Load a DeepLab checkpoint into ``model`` (strictly): the port's
    ``*.pt``, the JAX package's msgpack ``*.params``, or a reference mxnet
    DeepLabV3+ file (converted on load).  Any other file raises
    ``ValueError``, an mxnet file that is not a DeepLabV3+ checkpoint too."""
    if str(path).endswith(".pt"):
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        from ..core.deeplab_convert import load_deeplab_state_dict
        layers = getattr(getattr(model, "backbone", None), "layers",
                         (3, 4, 6, 3))
        state = load_deeplab_state_dict(path, layers=layers,
                                        aux=getattr(model, "aux", True))
    model.load_state_dict(state)


def _make_summary_writer(args):
    logs_path = getattr(args, "logs_path", None)
    if logs_path is None:
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        log.warning("tensorboardX unavailable; skipping TB logging")
        return None
    return SummaryWriter(logdir=str(logs_path), flush_secs=5)


# ===========================================================================
# Multi-scale + flip evaluation (gluoncv MultiEvalModel equivalent)
# ===========================================================================

def _pad_fill(c: int, pad_values=None) -> np.ndarray:
    """Per-channel pad value: gluoncv's ``-mean/std`` (black before
    normalisation) unless ``pad_values`` is given; channels beyond it (a
    depth plane) pad with 0."""
    if pad_values is None:
        pad_values = -IMAGENET_MEAN / IMAGENET_STD
    fill = np.zeros((c,), np.float32)
    pv = np.asarray(pad_values, np.float32)
    fill[:len(pv)] = pv[:c]
    return fill


class MultiEvalModel:
    """Multi-scale + flip sliding-window inference
    (`lib/core/segmentation.py:207-208`, gluoncv segbase), batched.

    For each scale: resize so the long side is ``ceil(base_size*scale)``;
    if it fits in ``crop_size``, pad to the crop (one window), else slide
    ``crop_size`` windows at a 2/3 stride and average the overlaps; with
    ``flip`` each window's scores are ``0.5 * (f(x) + unflip(f(flip(x))))``,
    with ``prob_avg`` taken after a softmax; scores are summed over scales
    at the image's size.  Every window is crop x crop, so the windows of all
    images and scales and their mirror images go through the model together,
    ``max_windows`` at a time (a bound on the activations' memory: 32
    windows of 480² hold a few GB in resnet50's eval forward); ``calls``
    counts the model calls.
    """

    max_windows = 32

    def __init__(self, model, nclass: int, base_size: int = 520,
                 crop_size: int = 480, flip: bool = True,
                 scales: Sequence[float] = (1.0,), prob_avg: bool = False,
                 pad_values=None, dtype: torch.dtype = torch.float32):
        self.model = model.eval()
        self.nclass = nclass
        self.base_size = base_size
        self.crop_size = crop_size
        self.flip = flip
        self.scales = tuple(scales)
        self.prob_avg = prob_avg
        self.pad_values = pad_values
        self.dtype = dtype
        self.calls = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _window_positions(self, ph: int, pw: int):
        crop = self.crop_size
        stride = int(math.ceil(crop * 2.0 / 3.0))
        h_grids = int(math.ceil(1.0 * (ph - crop) / stride)) + 1
        w_grids = int(math.ceil(1.0 * (pw - crop) / stride)) + 1
        return [(min(ig * stride, ph - crop), min(jg * stride, pw - crop))
                for ig in range(h_grids) for jg in range(w_grids)]

    def _scaled_size(self, h: int, w: int, scale: float):
        long_size = int(math.ceil(self.base_size * scale))
        if h > w:
            return long_size, int(1.0 * w * long_size / (1.0 * h)), long_size
        return int(1.0 * h * long_size / (1.0 * w)), long_size, long_size

    def _forward(self, windows):
        """(G, crop, crop, c) -> flip-averaged (G, crop, crop, nclass)."""
        g = windows.shape[0]
        if self.flip:
            windows = torch.cat([windows, windows.flip(2)])
        self.model.eval()
        outs = []
        for chunk in windows.split(self.max_windows):
            outs.append(self.model(chunk.to(self.dtype))[0].float())
            self.calls += 1
        out = torch.cat(outs)
        if self.prob_avg:
            out = torch.softmax(out, dim=-1)
        if self.flip:
            out = 0.5 * (out[:g] + out[g:].flip(2))
        return out

    @torch.no_grad()
    def device_scores_batch(self, images) -> torch.Tensor:
        """B same-shape (H, W, C) normalised images (numpy or tensors) ->
        (B, H, W, nclass) f32 scores on the model's device."""
        x = torch.stack([torch.as_tensor(im, dtype=torch.float32,
                                         device=self.device)
                         for im in images])
        b, h, w, c = x.shape
        crop = self.crop_size
        fill = torch.from_numpy(_pad_fill(c, self.pad_values)).to(x.device)
        plans, windows = [], []
        for scale in self.scales:
            height, width, long_size = self._scaled_size(h, w, scale)
            cur = bilinear_resize(x, height, width)
            ph, pw = max(height, crop), max(width, crop)
            # the pad takes gluoncv's fill: pad the residual with 0, add back
            pad = F.pad(cur - fill, (0, 0, 0, pw - width, 0, ph - height)
                        ) + fill
            pos = ([(0, 0)] if long_size <= crop
                   else self._window_positions(ph, pw))
            windows += [pad[:, y0:y0 + crop, x0:x0 + crop] for y0, x0 in pos]
            plans.append((height, width, ph, pw, pos))
        outs = self._forward(torch.cat(windows))
        scores = x.new_zeros((b, h, w, self.nclass))
        k = 0
        for height, width, ph, pw, pos in plans:
            out = x.new_zeros((b, ph, pw, self.nclass))
            cnt = x.new_zeros((1, ph, pw, 1))
            for y0, x0 in pos:
                out[:, y0:y0 + crop, x0:x0 + crop] += outs[k * b:(k + 1) * b]
                cnt[:, y0:y0 + crop, x0:x0 + crop] += 1.0
                k += 1
            out = (out / cnt)[:, :height, :width]
            scores += bilinear_resize(out, h, w)
        return scores

    def device_scores(self, image) -> torch.Tensor:
        """One image's (H, W, nclass) scores on the device."""
        return self.device_scores_batch([image])[0]

    def __call__(self, image) -> np.ndarray:
        """(H, W, C) normalised image -> summed scores (H, W, nclass)."""
        return self.device_scores(image).cpu().numpy()

    def parallel_forward(self, images):
        """Scores of each image; runs of same-shape images share calls."""
        out, run = [], []
        for im in list(images) + [None]:
            if run and (im is None or np.shape(im) != np.shape(run[0])):
                out += list(self.device_scores_batch(run).cpu().numpy())
                run = []
            if im is not None:
                run.append(im)
        return out


def _pad_image(img: np.ndarray, crop_size: int,
               pad_values: Optional[np.ndarray] = None) -> np.ndarray:
    """Bottom/right-pad a normalized image to ``crop_size``.

    gluoncv's ``segbase._pad_image`` fills each channel with ``-mean/std`` —
    i.e. the padding equals BLACK before normalization, not the ImageNet-mean
    pixel that zero-padding a normalized image would produce. Channels beyond
    the pad_values table (e.g. a with_depth plane) pad with 0.
    """
    h, w, c = img.shape
    ph, pw = max(0, crop_size - h), max(0, crop_size - w)
    if ph == 0 and pw == 0:
        return img
    fill = _pad_fill(c, pad_values)
    out = np.broadcast_to(fill, (h + ph, w + pw, c)).copy()
    out[:h, :w] = img
    return out


def label_map(scores: torch.Tensor, threshold: Optional[float],
              nclass: int) -> torch.Tensor:
    """``metrics._pred_label`` on ``softmax(scores)``, on the scores'
    device: P(class 1) > threshold in binary mode, else the argmax; uint8."""
    probs = torch.softmax(scores, dim=-1)
    if threshold is not None and nclass <= 2:
        return (probs[..., 1] > threshold).to(torch.uint8)
    return probs.argmax(-1).to(torch.uint8)


def _to_host(t: torch.Tensor):
    """Start copying ``t`` to the host; -> (host tensor, event or None).
    On the card the copy goes to pinned memory behind an event, so the
    host can enqueue the next batch before it waits for this one."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class SegmentationTester:
    """`lib/core/segmentation.py:186-253`."""

    def __init__(self, model, args, num_classes: int, use_flip: bool,
                 scales: Sequence[float], skip_bg: bool = True,
                 use_prob_avg: bool = False, class_names=None,
                 threshold: float = 0.5, base_size: int = 512,
                 crop_size: int = 480):
        self.args = args
        # the reference casts the model to args.dtype at tester init too
        # (`lib/core/segmentation.py:199-200`)
        cdt = _resolve_dtype(getattr(args, "dtype", "float32"))
        if class_names is None:
            class_names = [f"cls-{i}" for i in range(num_classes)]
        self.metric_orig = SegmentationMetric(num_classes, skip_bg=skip_bg,
                                              threshold=threshold)
        self.metric = SegMetric(num_classes, class_names=class_names,
                                skip_bg=skip_bg, threshold=threshold,
                                compute_dice=True)
        model = model.to(_device_of(args))
        load_checkpoint(args.weights, model)
        log.info("Loaded model weights from file: %s", args.weights)
        self.evaluator = MultiEvalModel(model, num_classes,
                                        base_size=base_size,
                                        crop_size=crop_size, flip=use_flip,
                                        scales=scales, prob_avg=use_prob_avg,
                                        dtype=cdt)
        self.bucket_calls = []  # model calls per batch of the last test()

    def test(self, testset, batch_size: Optional[int] = None) -> dict:
        """Multi-scale evaluation of the whole set
        (`lib/core/segmentation.py:207-253`).

        Images are bucketed by shape into batches of up to ``batch_size``
        (default: ``args.test_batch_size``) and scored by
        ``MultiEvalModel.device_scores_batch``; a ragged bucket is padded
        with repeats of its last image (one batch shape per image shape)
        and the padding's labels are dropped.  Only uint8 label maps reach
        the host, and batch i's copy overlaps batch i+1's enqueue.
        """
        self.metric.reset()
        self.metric_orig.reset()
        self.bucket_calls = []
        threshold, nclass = self.metric.threshold, self.metric.num_classes
        bs = batch_size or max(
            1, int(getattr(self.args, "test_batch_size", 1) or 1))

        def drain(pending):
            masks, (labs, event) = pending
            if event is not None:
                event.synchronize()
            for m, p in zip(masks, labs.numpy().astype(np.int64)):
                # the metrics take (N, H, W) integer label maps as they are
                self.metric.update([m[None]], [p[None]])
                self.metric_orig.update([m[None]], [p[None]])

        pending = None
        imgs, masks = [], []

        def flush():
            nonlocal pending, imgs, masks
            if not imgs:
                return
            n_valid = len(imgs)
            batch = imgs + [imgs[-1]] * (bs - n_valid)
            calls = self.evaluator.calls
            scores = self.evaluator.device_scores_batch(batch)
            self.bucket_calls.append(self.evaluator.calls - calls)
            labs = _to_host(label_map(scores, threshold, nclass)[:n_valid])
            if pending is not None:
                drain(pending)
            pending = (masks, labs)
            imgs, masks = [], []

        for i in range(len(testset)):
            item = testset[i]
            img = np.asarray(item[0], np.float32)
            if imgs and (img.shape != imgs[0].shape or len(imgs) == bs):
                flush()
            imgs.append(img)
            masks.append(item[1])
        flush()
        if pending is not None:
            drain(pending)
        log.info("----- new metric ------")
        for n, v in zip(*self.metric.get()):
            log.info("%s: %.5f%%", n, 100 * v)
        log.info("----- original metric ------")
        names, values = self.metric_orig.get()
        for n, v in zip(names, values):
            log.info("%s: %.5f%%", n, 100 * v)
        return dict(zip(names, values))

    def vizualizate(self, testset, output_path, suffix="", save_gt=True):
        import shutil

        import cv2
        output_path = Path(output_path)
        for i in range(len(testset)):
            img, gt_mask, im_path = testset[i]
            scores = self.evaluator(np.asarray(img, np.float32))
            predict = np.argmax(scores, axis=-1) + testset.pred_offset
            pm = visualize_mask(predict.astype(np.int32),
                                testset.num_class + 1)
            im_path = Path(im_path)
            dst_parent = output_path / im_path.parent.stem
            dst_parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(str(im_path),
                        str(dst_parent / (im_path.stem + "_image.jpg")))
            if save_gt:
                gtv = visualize_mask(
                    (np.asarray(gt_mask) + testset.pred_offset).astype(
                        np.int32), testset.num_class + 1)
                cv2.imwrite(str(dst_parent / (im_path.stem + "_image_gt.jpg")),
                            gtv)
            cv2.imwrite(str(dst_parent /
                            (im_path.stem + f"_image_predicted{suffix}.jpg")),
                        pm)

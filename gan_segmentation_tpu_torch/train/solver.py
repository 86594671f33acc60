"""SegSolver — the decoder's training, evaluation, prediction and checkpoints
on one device (PyTorch counterpart of ``gan_segmentation_tpu/train/
solver.py``).

``fit``: Adam 1e-4 (or SGD with momentum; ``wd`` is added to the gradient
as decayed weights), the ``None`` / ``steps`` / ``cos`` learning-rate
schedules with optax's values, 24 epochs at batch 1 by default, the
ignore-weighted softmax CE, epoch order ``RandomState(seed + epoch)``,
speedometer lines every ``train_display_iters`` steps, per-epoch accuracy
and loss logs, and a checkpoint at the end.  The decoder trains through the
CUDA kernels (``models/decoder.py`` train mode).  When the annotated
collection fits ``device_cache_gb`` it is uploaded to the card once and
each step selects its batch there; otherwise each step uploads its batch.

``SolverConfig.scan_epochs`` (the JAX package's whole epoch as one
program): with the collection resident on a card, a train step is one
CUDA graph (``core/graphs.py``), captured after ``GRAPH_WARMUP_STEPS``
eager steps of epoch 1 (counted in ``history``) and replayed for every
later step.  Its optimizer reads the rate from a device tensor (Adam
``capturable=True``, which keeps its step count and bias corrections on
the card; SGD ``fused``).  Before each replay the host fills that rate,
copies the step's batch indices on the card and draws the dropout bits
into the graph's static inputs (the eager path's bits,
``Decoder.draw_dropout``); the graph gathers the batch, runs the forward,
backward and update, and writes (loss, accuracy).  The host does not wait
inside an epoch: one copy of the epoch's (loss, accuracy) series to the
host follows it, and the speedometer and epoch lines are written from that
series, as the JAX package writes them after its scanned epoch.  ``None``
(auto) takes this path when the collection is resident on a CUDA device;
``False``, an upload per step or a CPU device take the per-step path,
whose step enqueues its forward, backward and update and waits only for
the display lines and the epoch logs.  ``True`` on a CPU device raises.

Data-parallel (``group``: a ``torch.distributed`` process group, by default
the launcher's world of ``core/distributed.py``, None in one process): one
process per card, ``train_batch_size`` the GLOBAL batch, as the JAX
package's multi-host fit.  The per-step path loads each process's
contiguous slice of every global batch (P must divide the batch); the
resident collection slices its batch indices the same way, and where P
does not divide the batch (the reference's batch 1) every process runs the
whole batch, replicated.  Batch norm takes the global batch's statistics
(``Decoder(group=...)``), and the gradients are averaged over the
processes before the update, one collective per step, inside the captured
step too (NCCL).  The parameters start from the primary's, the logged loss
and accuracy are the global means, a device cache that fails anywhere is
given up everywhere, dropout draws differ per process (seeded from (seed,
rank)), and only the primary writes the checkpoint and the epoch lines.  Over gloo (two
processes sharing one card) the steps run eagerly.

The port's checkpoint is ``torch.save`` of the decoder's ``state_dict`` as
``checkpoints/*.pt``.  ``load`` takes its own ``*.pt`` first; otherwise the
first ``*.params`` / ``*.msgpack`` of the directory, as the JAX package's
``load`` picks it: an mxnet file of the reference (either naming scheme,
``core/decoder_convert.py``) or the JAX package's msgpack tree
(``core/checkpoint.py``), mapped onto the decoder by
``core/params_bridge.py`` and loaded strictly.
"""

import logging
import math
import os
import time
import warnings
from os import makedirs
from os.path import isdir, isfile, join
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import distributed as dist_
from ..core import dtypes
from ..core.checkpoint import load_checkpoint
from ..core.config import SolverConfig
from ..core.decoder_convert import load_decoder_state_dict
from ..core.graphs import GRAPH_WARMUP_STEPS, GraphedCall
from ..core.mx_params import is_mx_params_file
from ..core.params_bridge import decoder_state_dict
from ..data.collection import CollectionDataset
from ..metrics.seg_metrics import SegmentationMetric
from ..models.decoder import decoder_from_config
from ..ops.losses import weighted_softmax_ce
from ..utils.io import list_files_with_ext
from ..utils.profiling import span
from .generator import class_mask

log = logging.getLogger(__name__)


def _set_rate(optimizer, rate: float):
    """Every group's rate: into the device tensor of a graph's optimizer,
    else the number itself."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(rate)
        else:
            group["lr"] = rate


def _mask_weights(mask):
    """1.0 where annotated, 0.0 where ignore."""
    return (mask > -1).float()


class SegSolver:
    def __init__(self, max_res_log2: int, path_to_data: str,
                 checkpoints_dir: str, keep_weights: bool = True,
                 cfg: Optional[SolverConfig] = None,
                 seed: Optional[int] = None,
                 device: Optional[torch.device] = None, group=None):
        self.path_to_data = path_to_data
        # the processes of a data-parallel fit (None: this one alone)
        self.group = dist_.group() if group is None else group
        self.checkpoints_dir = checkpoints_dir
        self.keep_weights = keep_weights
        self.cfg = cfg or SolverConfig(max_res_log2=max_res_log2)
        self.seed = self.cfg.seed if seed is None else seed
        self.device = device if device is not None else dtypes.cuda_device()
        compute_dtype = dtypes.default_policy(self.cfg.dtype).compute_dtype
        self.model = decoder_from_config(self.cfg, compute_dtype)
        self.model.to(self.device).eval()
        # counts the changes of the weights (reinit, load, every epoch of
        # fit): FusedPipeline keys its folded kernels on it
        self.weights_version = 0
        self.reinit()
        self.print_params(self.model, "decoder")
        self.params_file = None
        self.history: List[List[float]] = []  # per-step losses of each epoch
        self.is_trained = self.load()

    def reinit(self):
        """The seeded init: Xavier(in, 2.34) kernels, zero biases, BN 1/0."""
        self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
        self.weights_version += 1

    @staticmethod
    def print_params(model: torch.nn.Module, title: str):
        """Parameter table like `seg_solver.py:60-81`."""
        log.info("%-48s%-12s%-24s%-10s", title, "params", "weight shape",
                 "dtype")
        total = 0
        for name, p in model.named_parameters():
            total += p.numel()
            log.info("%-48s%-12d%-24s%-10s", name, p.numel(),
                     str(tuple(p.shape)), str(p.dtype))
        log.info("%-48s%-12d", "total", total)

    # ------------------------------------------------------------------ data
    def init_data(self):
        ds = CollectionDataset(self.path_to_data, self.cfg, max_samples=None,
                               load_to_memory=False)
        if len(ds) <= 0:
            raise ValueError("number of training samples should be > 0")
        # hold the collection in host memory when it fits cache_max_size
        # (GB): re-reading the pickles every epoch costs more than a step
        try:
            sample = ds.load_sample(ds._feat_names[0])
            sample_bytes = (sum(f.nbytes for f in sample[2])
                            + sample[1].nbytes)
            if sample_bytes * len(ds) <= self.cfg.cache_max_size * 1024 ** 3:
                ds = CollectionDataset(self.path_to_data, self.cfg,
                                       max_samples=None, load_to_memory=True)
        except (OSError, MemoryError) as exc:  # a sample that cannot be
            # read, or no room on the host: each step then reads its samples
            log.warning("host cache disabled (%s)", exc)
        iters_per_epoch = len(ds) // self.cfg.train_batch_size
        log.info("total train samples: %d, batch size: %d, epoch size: %d",
                 len(ds), self.cfg.train_batch_size, iters_per_epoch)
        return ds, iters_per_epoch

    # ----------------------------------------------------------------- train
    def _make_lr(self, iters_per_epoch: int) -> Callable[[int], float]:
        """step -> learning rate, the values of the JAX package's optax
        schedules: None (constant), 'steps' (x factor_d from each
        ``epochs_steps`` boundary on), 'cos' (linear warm-up over one epoch
        from base/10, then cosine to base/1000)."""
        cfg = self.cfg
        if cfg.scheduler is None:
            return lambda step: cfg.base_lr
        if cfg.scheduler == "steps":
            bounds = sorted({int(s * iters_per_epoch): cfg.factor_d
                             for s in getattr(cfg, "epochs_steps", [])}
                            .items())

            def steps_lr(step):
                lr = cfg.base_lr
                for boundary, factor in bounds:
                    if step >= boundary:
                        lr *= factor
                return lr
            return steps_lr
        if cfg.scheduler == "cos":
            warmup = iters_per_epoch
            decay = cfg.train_epochs * iters_per_epoch - warmup
            if decay <= 0:
                raise ValueError("the cos schedule needs more than one "
                                 "epoch of steps")
            init, peak = cfg.base_lr / 10, cfg.base_lr
            alpha = (cfg.base_lr / 1000) / peak

            def cos_lr(step):
                if step < warmup:
                    return init + (peak - init) * step / warmup
                t = min(step - warmup, decay)
                cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
                return peak * ((1 - alpha) * cosine + alpha)
            return cos_lr
        raise ValueError(cfg.scheduler)

    def _make_optimizer(self, iters_per_epoch: int = 1,
                        graphed: bool = False):
        """-> (optimizer, lr schedule).  The caller sets each step's rate
        (``_set_rate``).  ``wd`` is torch's ``weight_decay``: ``wd * param``
        added to the gradient before the update, as optax's
        ``add_decayed_weights``.  ``graphed`` on a card: the update of a
        step captured in a CUDA graph, whose rate is a device tensor that
        the host fills before each replay: Adam ``capturable=True``, SGD
        ``fused``."""
        cfg = self.cfg
        lr = self._make_lr(iters_per_epoch)
        params = list(self.model.parameters())
        on_card = graphed and self.device.type == "cuda"
        rate = (torch.tensor(lr(0), device=self.device) if on_card
                else lr(0))
        if cfg.optimizer == "adam":
            opt = torch.optim.Adam(params, lr=rate, betas=(0.9, 0.999),
                                   eps=1e-8, weight_decay=cfg.wd,
                                   capturable=on_card)
        elif cfg.optimizer == "sgd":
            opt = torch.optim.SGD(params, lr=rate,
                                  momentum=cfg.momentum or 0.0,
                                  weight_decay=cfg.wd,
                                  fused=True if on_card else None)
        else:
            raise ValueError(cfg.optimizer)
        return opt, lr

    def _scan_epochs(self, cached) -> bool:
        """Whether ``fit`` runs its steps as replays of a CUDA graph: the
        JAX package's ``scan_epochs`` rule (auto: the collection is
        resident and the device is a card; not over gloo, whose collectives
        wait on the host)."""
        flag = self.cfg.scan_epochs
        if flag and self.device.type != "cuda":
            raise ValueError(
                f"scan_epochs=True runs each epoch as replays of a CUDA graph "
                f"and needs a CUDA device, got {self.device}")
        gloo = (self.group is not None
                and torch.distributed.get_backend(self.group) == "gloo")
        if flag and gloo:
            raise ValueError("scan_epochs=True captures the gradient "
                             "all-reduce in a CUDA graph, which gloo cannot "
                             "join: use NCCL")
        if flag is None:
            flag = self.device.type == "cuda" and not gloo
        if flag and cached is None:
            log.info("scan_epochs: the collection is not resident on the "
                     "device; one eager dispatch per step")
        return bool(flag) and cached is not None

    def _try_device_cache(self, dataset):
        """The whole collection on the card, once: ``(feats_all,
        masks_all)`` with feats_all[i] (S, h_i, w_i, c_i) f32 and masks_all
        (S, H, W) int8 where the labels allow, or None when switched off,
        over the ``device_cache_gb`` budget, or when reading or uploading
        it fails (each step then uploads its batch).  ~20 samples of ~130
        MB f32 pyramids fit easily, and a step then moves nothing over the
        host link."""
        cfg = self.cfg
        if not cfg.device_cache or dataset._output_idx:
            return None
        try:
            items = [dataset.get_item(i) for i in range(len(dataset))]
            masks = np.stack([it[1] for it in items])
            if masks.min() >= -128 and masks.max() <= 127:
                masks = masks.astype(np.int8)
            total = (sum(f.nbytes for f in items[0][2]) * len(items)
                     + masks.nbytes)
            budget = cfg.device_cache_gb * 1024 ** 3
            if total > budget:
                log.info("device cache skipped: %.2f GB > %.2f GB budget",
                         total / 1024 ** 3, budget / 1024 ** 3)
                return None
            cached = self._upload_collection(items, masks)
        except (torch.cuda.OutOfMemoryError, OSError) as exc:
            # no room on the card, or a sample that cannot be read: fall
            # back to the per-step upload
            log.warning("device cache disabled (%s)", exc)
            return None
        log.info("device cache: %d samples, %.2f GB resident on %s",
                 len(items), total / 1024 ** 3, self.device)
        return cached

    def _upload_collection(self, items, masks):
        feats = []
        for k, f0 in enumerate(items[0][2]):
            dst = torch.empty((len(items), *f0.shape), dtype=torch.float32,
                              device=self.device)
            for s, it in enumerate(items):
                dst[s].copy_(torch.from_numpy(it[2][k]))
            feats.append(dst)
        return feats, torch.from_numpy(masks).to(self.device)

    def _agree_on_cache(self, cached):
        """Data-parallel: the resident collection only where every process
        built it (the processes must run one program)."""
        if self.group is None:
            return cached
        failed = int(dist_.allreduce_sum(np.int64(cached is None),
                                         self.group))
        if failed and cached is not None:
            log.warning("device cache disabled: %d process(es) could not "
                        "build it", failed)
            return None
        return cached

    def _split(self, cached):
        """-> (this process's share of each step's batch, the group of its
        batch norm): the contiguous slice and the group when P divides the
        global batch, else (a resident collection) the whole batch,
        replicated, with batch norm over it alone."""
        b, grp = self.cfg.train_batch_size, self.group
        p, r = dist_.size_of(grp), dist_.rank_of(grp)
        if grp is None or b % p == 0:
            return slice(r * (b // p), (r + 1) * (b // p)), grp
        if cached is None:
            raise ValueError(f"data-parallel training needs train_batch_size "
                             f"({b}) divisible by the process count ({p})")
        return slice(0, b), None

    def _epoch_orders(self, n: int, epoch: int):
        """The global index batches of ``epoch``: ``RandomState(seed +
        epoch)``'s permutation in full batches (``dataset.batches``'
        order)."""
        b = self.cfg.train_batch_size
        order = np.arange(n)
        np.random.RandomState(self.seed + epoch).shuffle(order)
        return [order[s:s + b] for s in range(0, len(order) - (b - 1), b)]

    def _epoch_batches(self, dataset, epoch: int, cached, part=slice(None)):
        """(features, int64 mask) of each step of ``epoch`` on the device,
        in the order of ``dataset.batches(shuffle=True, seed=seed+epoch)``;
        ``part``: this process's share of each batch (``_split``)."""
        b = self.cfg.train_batch_size
        if cached is None:
            for batch in dataset.batches(b, shuffle=True,
                                         seed=self.seed + epoch, part=part):
                yield ([torch.from_numpy(f).to(self.device)
                        for f in batch["features"]],
                       torch.from_numpy(batch["mask"]).to(self.device).long())
            return
        steps = [idx[part] for idx in self._epoch_orders(len(dataset),
                                                         epoch)]
        if not steps:
            return
        feats_all, masks_all = cached
        idx_all = torch.as_tensor(np.stack(steps), device=self.device)
        for idx in idx_all:
            yield ([f.index_select(0, idx) for f in feats_all],
                   masks_all.index_select(0, idx).long())

    def _train_step(self, optimizer, features, mask, generator,
                    dropout_u=None, bn_group=None):
        """One step; returns (loss, pixel accuracy over all pixels) as
        device scalars (no host sync).  Data-parallel: batch norm over
        ``bn_group``'s global batch, and the gradients averaged over
        ``self.group`` before the update."""
        logits = self.model(features, generator=generator,
                            dropout_u=dropout_u, group=bn_group)
        loss = weighted_softmax_ce(logits, mask, _mask_weights(mask)).mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dist_.allreduce_mean_([p.grad for p in self.model.parameters()],
                              self.group)
        optimizer.step()
        # train metric: plain pixel accuracy over ALL pixels, ignore
        # included, as the reference's mx.metric.Accuracy
        acc = (logits.detach().argmax(-1) == mask).float().mean()
        return loss.detach(), acc

    def _graphed_epochs(self, optimizer, lr, cached, dropout_gen,
                        part=slice(None), bn_group=None):
        """-> ``run(epoch, step) -> (n, 2)`` device tensor of per-step
        (loss, accuracy), returned once the epoch is enqueued: its steps as
        replays of the train step's graph (its first ``GRAPH_WARMUP_STEPS``
        calls run eagerly) in ``_epoch_batches``' order, each on ``part``
        of its batch.  It is overwritten by the next epoch.  Spans:
        ``gst.fit.epoch`` around ``run``, holding ``gst.fit.stage`` (the
        order and its indices to the card) and one ``gst.fit.step`` a step
        (rate, indices, dropout draws, the graph's call)."""
        cfg, dev = self.cfg, self.device
        n_max = len(cached[1]) // cfg.train_batch_size
        b = len(range(cfg.train_batch_size)[part])
        feats_all, masks_all = cached
        idx = torch.zeros((b,), dtype=torch.long, device=dev)
        idx_host = torch.empty((n_max, b), dtype=torch.long,
                               pin_memory=dev.type == "cuda")
        idx_all = torch.empty((n_max, b), dtype=torch.long, device=dev)
        series = torch.zeros((n_max, 2), dtype=torch.float32, device=dev)
        dropout_u = ([torch.empty(s, device=dev) for s in
                      self.model.dropout_shapes(
                          [(b, *f.shape[1:]) for f in feats_all])]
                     if self.model.use_dropout else None)

        def step():
            feats = [f.index_select(0, idx) for f in feats_all]
            mask = masks_all.index_select(0, idx).long()
            with warnings.catch_warnings():  # the warm-up steps' update
                warnings.filterwarnings("ignore", "This instance was "
                                        "constructed with capturable=True")
                loss, acc = self._train_step(optimizer, feats, mask, None,
                                             dropout_u, bn_group)
            return torch.stack([loss, acc])

        call = GraphedCall(step, dev, warmup=GRAPH_WARMUP_STEPS)

        def run(epoch, first_step):
            with span("gst.fit.epoch"):
                with span("gst.fit.stage"):
                    steps = [idx[part] for idx in self._epoch_orders(
                        len(masks_all), epoch)]
                    n = len(steps)
                    if n == 0:
                        return series[:0]
                    # the previous epoch's series was copied to the host,
                    # which waited for its steps: the pinned buffer is free
                    idx_host[:n].copy_(torch.from_numpy(np.stack(steps)))
                    idx_all[:n].copy_(idx_host[:n], non_blocking=True)
                for k in range(n):
                    with span("gst.fit.step"):
                        _set_rate(optimizer, lr(first_step + k))
                        idx.copy_(idx_all[k])
                        if dropout_u is not None:
                            self.model.draw_dropout(None, dropout_gen,
                                                    out=dropout_u)
                        series[k].copy_(call())
                return series[:n]

        run.call = call  # its graph and launch deltas
        return run

    def _global_mean(self, rows, bn_group):
        """(n, 2) device rows of (loss, accuracy) -> the global batch's, on
        the host: the processes' mean when each ran its own slice."""
        if bn_group is not None:
            rows = rows.clone()
            dist_.allreduce_mean_([rows], bn_group)
        return rows.cpu()

    def _info(self, *args):
        """An epoch log line, written by the primary process alone."""
        if dist_.rank_of(self.group) == 0:
            log.info(*args)

    def _log_speed(self, epoch: int, batch: int, speed: float, window):
        """The speedometer line of the display interval that ends at step
        ``batch`` of ``epoch``; ``window`` holds its (loss, accuracy)
        rows."""
        self._info("Epoch[%03d] Batch[%04d] Speed: %9.2f samples/sec "
                 "accuracy=%f total-loss=%f", epoch, batch, speed,
                 float(window[:, 1].contiguous().mean()),
                 float(window[:, 0].contiguous().mean()))

    def _log_epoch(self, epoch: int, series,
                   elapsed: Optional[float] = None):
        """After an epoch, from its (n, 2) host series of (loss, accuracy):
        its losses appended to ``history`` and its accuracy and loss lines.
        ``elapsed`` (the graphed path, whose host does not see the display
        intervals): the epoch's seconds, and the speedometer lines first,
        each with the epoch's mean speed; the per-step path wrote them as
        its steps ran."""
        display = self.cfg.train_display_iters
        n = len(series)
        if elapsed is not None and display:
            speed = n * self.cfg.train_batch_size / max(elapsed, 1e-9)
            for s in range(display, n + 1, display):
                self._log_speed(epoch, s, speed, series[s - display:s])
        if n:
            self.history.append(series[:, 0].tolist())
            self._info("Epoch[%d] Train-accuracy=%f", epoch + 1,
                       float(series[:, 1].contiguous().mean()))
            self._info("Epoch[%d] Train-total-loss=%f", epoch + 1,
                       float(np.mean(self.history[-1])))

    def fit(self, epoch_end_callback: Optional[Callable] = None):
        if not self.keep_weights:
            self.reinit()
        cfg = self.cfg
        dataset, iters_per_epoch = self.init_data()
        cached = self._agree_on_cache(self._try_device_cache(dataset))
        self.cache_active = cached is not None
        part, bn_group = self._split(cached)
        if self.group is not None:  # every replica starts from the primary's
            dist_.broadcast_tensors_(list(self.model.state_dict().values()),
                                     self.group)
            log.info("data-parallel fit over %d processes: %s",
                     dist_.size_of(self.group),
                     "each its slice of every batch" if bn_group is not None
                     else "every batch replicated")
        graphed = self._scan_epochs(cached)
        optimizer, lr = self._make_optimizer(iters_per_epoch, graphed)
        if graphed:
            log.info("scan_epochs: each step replays one CUDA graph, "
                     "captured after %d eager steps", GRAPH_WARMUP_STEPS)
        dropout_gen = torch.Generator(device=self.device)
        dropout_gen.manual_seed(dist_.rank_seed(
            self.seed, dist_.rank_of(bn_group)))
        display = cfg.train_display_iters
        self.history = []
        step = 0
        self.model.train()
        run_epoch = (self._graphed_epochs(optimizer, lr, cached, dropout_gen,
                                          part, bn_group)
                     if graphed else None)
        for epoch in range(cfg.train_epochs):
            tic = speed_tic = time.time()
            if graphed:  # the epoch's one wait
                series = self._global_mean(run_epoch(epoch, step), bn_group)
                step += len(series)
                self._log_epoch(epoch, series, time.time() - tic)
            rows = []
            for feats, mask in (() if graphed else self._epoch_batches(
                    dataset, epoch, cached, part)):
                _set_rate(optimizer, lr(step))
                loss, acc = self._train_step(optimizer, feats, mask,
                                             dropout_gen, bn_group=bn_group)
                step += 1
                rows.append(torch.stack([loss, acc]))
                if display and len(rows) % display == 0:
                    # waits for the interval's steps, then times them
                    window = self._global_mean(torch.stack(rows[-display:]),
                                               bn_group)
                    speed = display * cfg.train_batch_size / (
                        time.time() - speed_tic)
                    self._log_speed(epoch, len(rows), speed, window)
                    speed_tic = time.time()
            if not graphed:
                self._log_epoch(epoch, self._global_mean(
                    torch.stack(rows), bn_group) if rows
                    else torch.zeros((0, 2)))
            self._info("Epoch[%d] Time cost=%.3f", epoch + 1,
                       time.time() - tic)
            self.weights_version += 1
            if epoch_end_callback is not None:
                self.model.eval()
                epoch_end_callback()
                self.model.train()
        if graphed:  # the gradients live in the graph's memory pool
            optimizer.zero_grad(set_to_none=True)
        self.model.eval()
        self.is_trained = True
        if dist_.rank_of(self.group) == 0:  # the primary writes
            self.save()
        return []

    # --------------------------------------------------------------- predict
    def predict_logits(self, features: List) -> torch.Tensor:
        """Eval-mode logits (N, H, W, num_classes) f32 for a feature pyramid
        of (H, W, C) or (N, H, W, C) arrays or tensors."""
        feats = []
        for f in features:
            f = torch.as_tensor(np.asarray(f, np.float32) if not
                                isinstance(f, torch.Tensor) else f)
            feats.append((f[None] if f.dim() == 3 else f).to(
                self.device, torch.float32))
        with torch.inference_mode():
            return self.model(feats)

    def predict(self, features: List) -> np.ndarray:
        """-> (N, H, W, 1) int64 class masks (binary: strict compare)."""
        logits = self.predict_logits(features)
        return class_mask(logits).long()[..., None].cpu().numpy()

    # -------------------------------------------------------------- evaluate
    def evaluate(self, input_dir: str, output_dir: Optional[str] = None):
        ds = CollectionDataset(input_dir, self.cfg, load_to_memory=False,
                               output_idx=True)
        if len(ds) <= 0:
            raise ValueError("number of eval samples should be > 0")
        metric = SegmentationMetric(self.cfg.num_classes, skip_bg=True)
        return self.evaluate_for_data(ds, metric, output_dir=output_dir)

    def evaluate_for_data(self, dataset: CollectionDataset, metric,
                          output_dir: Optional[str] = None):
        total_loss, total_cnt = 0.0, 0
        for batch in dataset.batches(self.cfg.val_batch_size, shuffle=False,
                                     drop_last=False):
            logits = self.predict_logits(batch["features"])
            mask = torch.from_numpy(batch["mask"]).to(self.device)
            loss = weighted_softmax_ce(logits, mask, _mask_weights(mask))
            total_loss += float(loss.mean())
            total_cnt += 1
            logits_np = logits.cpu().numpy()
            metric.update([batch["mask"]], [logits_np])
            if output_dir is not None:
                self._dump_eval_images(dataset, batch, logits_np, output_dir)
        total_loss = total_loss / total_cnt if total_cnt else 0.0
        result = metric.get_name_value()
        result.append(("total-loss", total_loss))
        return result

    def _dump_eval_images(self, dataset, batch, logits, output_dir):
        """Per image: the image, the predicted and the annotated mask, and a
        line of metrics."""
        import cv2
        if not isdir(output_dir):
            makedirs(output_dir)
        pred = np.argmax(logits, axis=-1)
        for i in range(batch["image"].shape[0]):
            imname = dataset.get_imname(int(batch["idx"][i]))
            m = SegmentationMetric(self.cfg.num_classes, skip_bg=True)
            m.update([batch["mask"][i:i + 1]], [logits[i:i + 1]])
            metric_str = ", ".join(f"{n} {v:.3f}"
                                   for n, v in m.get_name_value())
            img = batch["image"][i].astype(np.uint8)
            pm = pred[i].astype(np.int32)
            gm = batch["mask"][i].astype(np.int32)
            pm_vis = np.where(pm == 1, 255, 128).astype(np.uint8)
            gm_vis = np.where(gm == 1, 255,
                              np.where(gm == 0, 128, 0)).astype(np.uint8)
            cv2.imwrite(join(output_dir, imname), img[:, :, ::-1])
            cv2.imwrite(join(output_dir, imname.replace("img", "mask")
                             .replace(".jpg", ".png")), pm_vis)
            cv2.imwrite(join(output_dir, imname.replace("img", "gt_mask")
                             .replace(".jpg", ".png")), gm_vis)
            with open(join(output_dir, imname.replace("img", "metrics")
                           .replace(".jpg", ".txt")), "w") as fp:
                fp.write(f"{imname}, {img.shape}, {pm.shape}, {gm.shape}, "
                         f"{metric_str}\n")

    # ------------------------------------------------------------ checkpoint
    def save(self, suffix: Optional[str] = None):
        if not isdir(self.checkpoints_dir):
            makedirs(self.checkpoints_dir)
        name = ("checkpoint_last.pt" if suffix is None
                else f"checkpoint_{suffix}.pt")
        dst = join(self.checkpoints_dir, name)
        # atomic: `load` must never see a torn checkpoint
        torch.save(self.model.state_dict(), dst + ".tmp")
        os.replace(dst + ".tmp", dst)
        self.params_file = name
        log.info("saved checkpoint: %s", name)

    def load(self) -> bool:
        if not isdir(self.checkpoints_dir):
            return False
        ours = sorted(f for f in os.listdir(self.checkpoints_dir)
                      if f.endswith(".pt")
                      and isfile(join(self.checkpoints_dir, f)))
        files = ours or list_files_with_ext(self.checkpoints_dir,
                                            [".params", ".msgpack"])
        if not files:
            return False
        path = join(self.checkpoints_dir, files[0])
        log.info("loading checkpoint: %s", files[0])
        if ours:
            state = torch.load(path, map_location="cpu", weights_only=True)
        else:
            tree = load_checkpoint(path)
            if is_mx_params_file(path):
                # a reference (mxnet) decoder checkpoint: convert on load
                state = load_decoder_state_dict(tree, self.cfg)
            elif isinstance(tree, dict) and "params" in tree:
                state = decoder_state_dict(tree["params"],
                                           tree.get("batch_stats", {}))
            else:
                raise ValueError(f"{path!r} holds no 'params' tree: not a "
                                 "decoder checkpoint of the JAX package")
        self.model.load_state_dict(state)
        self.weights_version += 1
        self.params_file = files[0]
        return True

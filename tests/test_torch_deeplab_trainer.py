"""The port's DeepLab trainer (gan_segmentation_tpu_torch/train/
deeplab_trainer.py: ``batch_iter``, ``SegmentationTrainer``, its
checkpoints and its preemption resume) against the JAX package's, on the
CPU in f32.

- ``batch_iter``: the same batches in the same order as the JAX function;
  ``start_batch``, the ragged tail, (image, depth) items, a worker's error
  reaching the consumer, the thread stopping when the consumer stops.
- ``SegmentationTrainer`` against the JAX ``SegmentationTrainer`` from the
  same initial weights (carried by ``core/params_bridge.py``), dropout off
  on both sides: 16 images at crop 32, batch 4, 2 epochs of the tiny
  (1, 1, 1, 1) backbone under the real heads.  Per-step losses within 1e-5
  relative on the first step and 1e-3 after; validation pixAcc / mIoU
  within 1e-2.  The rate is 2e-4 (head 2e-3), not the experiment's 0.005:
  the train-mode gradient of this model is ill-conditioned
  (tests/test_torch_deeplab.py), and at 0.005 the port's own losses move
  by up to 8e-3 within 8 steps when its initial weights are scaled by
  1 + 1e-7 (the JAX package's sit up to 7.8e-3 away); at 2e-4 the two
  packages agree to 7e-5.
- Preempted mid-epoch and resumed: bit-identical weights, statistics,
  momentum and generator to an uninterrupted run (dropout on, no random
  augmentation, ``train_epoch_len = -1``, one decode thread).
- ``--weights``: the port's ``*.pt`` and the JAX package's msgpack file
  give the JAX ``load_checkpoint``'s eval forward within ``_close``'s 2e-3
  of the largest logit; a reference mxnet DeepLabV3+ file loads the very
  tensors the JAX ``load_checkpoint`` converts.
"""

import copy
import os
import signal
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_deeplab import make_rgb_dataset
from test_deeplab_convert import synth_reference_deeplab
from test_mx_params import write_mx_file
from test_torch_deeplab import (_close, _no_dropout, jax_variables,
                                tiny_backbones)  # noqa: F401

from gan_segmentation_tpu.core.mesh import make_mesh
from gan_segmentation_tpu.data import augment as jaug
from gan_segmentation_tpu.data import segmentation as jseg
from gan_segmentation_tpu.models import deeplab as jdl
from gan_segmentation_tpu.train import deeplab_trainer as jtrainer

from gan_segmentation_tpu_torch.core.params_bridge import deeplab_state_dict
from gan_segmentation_tpu_torch.data import augment as taug
from gan_segmentation_tpu_torch.data import segmentation as tseg
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.ops import losses as tlosses
from gan_segmentation_tpu_torch.train import deeplab_trainer as ttrainer

torch.set_num_threads(2)  # the test workers share the host's cores

CROP = 32
OPT = {"mode": "poly", "baselr": 0.005, "nepochs": 2, "wd": 2e-4,
       "momentum": 0.9}
MODEL_CFG = {"num_classes": 2, "crop_size": CROP, "aux_weight": 0.5}


# ------------------------------------------------------------- batch_iter
class Items:
    """``n`` items (image, mask) or ((image, depth), mask[, path]) whose
    values name their index; ``fail_at`` raises on one index."""

    def __init__(self, n, depth=False, paths=False, fail_at=None, delay=0.0):
        self.n, self.depth, self.paths = n, depth, paths
        self.fail_at, self.delay = fail_at, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"cannot decode item {i}")
        time.sleep(self.delay)
        img = np.full((2, 3, 3), i, np.uint8)
        mask = np.full((2, 3), i % 3 - 1, np.int32)
        first = (img, np.full((2, 3, 1), i / 7, np.float32)) if self.depth \
            else img
        return (first, mask, f"p{i}") if self.paths else (first, mask)


def _batches(fn, ds, *args, **kw):
    return [b for b in fn(ds, *args, **kw)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gi, wi in zip(g, w):
            if isinstance(wi, tuple):
                assert all(np.array_equal(a, b) for a, b in zip(gi, wi))
            elif wi is None or isinstance(wi, list):
                assert gi == wi
            else:
                assert gi.dtype == wi.dtype and np.array_equal(gi, wi)


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=True, seed=4),
    dict(batch_size=3, shuffle=True, seed=4, drop_last=False),
    dict(batch_size=4, shuffle=False, drop_last=False, start_batch=1),
    dict(batch_size=2, shuffle=True, seed=1, start_batch=3,
         decode_workers=3)], ids=["drop_last", "ragged", "start", "pool"])
@pytest.mark.parametrize("items", ["plain", "depth_paths"])
def test_batch_iter_matches_jax(kw, items):
    ds = Items(10) if items == "plain" else Items(10, depth=True, paths=True)
    got = _batches(ttrainer.batch_iter, ds, **kw)
    want = _batches(jtrainer.batch_iter, ds, **kw)
    _same_batches(got, want)
    assert got, "no batch"
    if not kw.get("drop_last", True):
        assert len(got[-1][1]) == 10 % kw["batch_size"] or kw["batch_size"]


def test_batch_iter_worker_error_reaches_the_consumer():
    it = ttrainer.batch_iter(Items(8, fail_at=5), 2, shuffle=False)
    assert len(next(it)[0]) == 2
    with pytest.raises(ValueError, match="cannot decode item 5"):
        list(it)


def _batch_iter_threads():
    return [t for t in threading.enumerate()
            if t.name == "batch_iter" or t.name.startswith("decode")]


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_iter_thread_stops_when_the_consumer_stops(workers):
    before = set(_batch_iter_threads())
    it = ttrainer.batch_iter(Items(200, delay=0.002), 2, shuffle=True,
                             prefetch=1, decode_workers=workers)
    next(it)
    it.close()
    deadline = time.time() + 10
    while set(_batch_iter_threads()) - before and time.time() < deadline:
        time.sleep(0.02)
    assert not set(_batch_iter_threads()) - before, "worker thread left"


# ------------------------------------------------ trainer against the JAX one
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rgb")
    make_rgb_dataset(root, "train_generated", 16, size=40, seed=3)
    make_rgb_dataset(root, "val", 4, size=40, seed=4)
    return root


@pytest.fixture(scope="module")
def tiny_base():
    """One port DeepLabV3+ on the tiny backbone, dropout on; tests take
    copies (a build draws 15 M truncated normals)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
        return tdl.DeepLabV3Plus(2, "tiny", crop_size=CROP,
                                 generator=torch.Generator().manual_seed(7))


def _tiny(base, dropout=True):
    model = copy.deepcopy(base)
    model.aspp.use_dropout = model.auxlayer.use_dropout = dropout
    return model


def _sets(seg, aug, root, n=None):
    """Deterministic feeds: uint8 images, pad + center crop to 32; the
    first ``n`` training images by a seeded sample when ``n`` is given."""
    def augmentator():
        return aug.RGBSegmentationAug([aug.PadIfNeeded(CROP, CROP),
                                       aug.CenterCrop(CROP, CROP)],
                                      ignore_class=-1)
    kw = dict(transform=None)
    return (seg.FFHQHairSegmentation(str(root), split="train",
                                     subdir="train_generated", max_samples=n,
                                     rng_seed=0, augmentator=augmentator(),
                                     **kw),
            seg.FFHQHairSegmentation(str(root), split="val",
                                     augmentator=augmentator(), **kw))


def _args(path, **kw):
    return types.SimpleNamespace(**dict(
        dict(batch_size=4, test_batch_size=4, workers=1, weights=None,
             seed=0, logs_path=None, checkpoints_path=path), **kw))


class Recorder:
    """Wraps a step function and keeps its loss (output ``index``)."""

    def __init__(self, fn, index):
        self.fn, self.index, self.losses = fn, index, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.losses.append(float(out[self.index]))
        return out


@pytest.fixture(scope="module")
def two_trainers(data_root, tiny_base, tmp_path_factory):
    """Both trainers through 2 epochs from the same initial weights; ->
    (losses and metrics of each side, the port's trainer)."""
    opt = dict(OPT, baselr=2e-4)
    tmp = tmp_path_factory.mktemp("trainers")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
        jset, jval = _sets(jseg, jaug, data_root)
        jt = jtrainer.SegmentationTrainer(
            _args(tmp / "jax"), jdl.DeepLabV3Plus(2, "tiny", crop_size=CROP),
            MODEL_CFG, jset, jval, opt, image_dump_interval=0,
            mesh=make_mesh(jax.devices()[:1]))
        jrec = Recorder(jt._train_step, 1)
        jt._train_step = jrec
        model = _tiny(tiny_base, dropout=False)
        model.load_state_dict(deeplab_state_dict(
            jax.device_get(jt.state.params),
            jax.device_get(jt.state.batch_stats)))
        tset, tval = _sets(tseg, taug, data_root)
        tt = ttrainer.SegmentationTrainer(
            _args(tmp / "torch", device="cpu"), model, MODEL_CFG, tset,
            tval, opt, image_dump_interval=0)
        trec = Recorder(ttrainer.train_step, 0)
        mp.setattr(ttrainer, "train_step", trec)
        out = {"jax": {"val": []}, "torch": {"val": []}}
        for epoch in range(2):
            with nn.intercept_methods(_no_dropout):
                jt.training(epoch)
            out["jax"]["val"].append(jt.validation(epoch))
            tt.training(epoch)
            out["torch"]["val"].append(tt.validation(epoch))
        out["jax"]["losses"], out["torch"]["losses"] = jrec.losses, trec.losses
    return out, tt


def test_trainer_losses_match_jax(two_trainers):
    out, tt = two_trainers
    want, got = out["jax"]["losses"], out["torch"]["losses"]
    assert len(got) == len(want) == 8  # 4 steps an epoch, 2 epochs
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    assert tt.scheduler.last_epoch == 8 and tt.total_iters == 8
    assert tt.iters_per_epoch == 4


def test_trainer_validation_matches_jax(two_trainers):
    out, _ = two_trainers
    for got, want in zip(out["torch"]["val"], out["jax"]["val"]):
        assert got.keys() == want.keys() == {"accuracy", "mean-iou"}
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-2, (k, got[k], want[k])


def test_trainer_checkpoint_is_the_model(two_trainers):
    _, tt = two_trainers
    path = tt.args.checkpoints_path / "last_checkpoint.pt"
    state = torch.load(path, weights_only=True)
    assert not list(tt.args.checkpoints_path.glob("*.tmp"))
    assert state.keys() == tt.model.state_dict().keys()
    for k, v in tt.model.state_dict().items():
        assert torch.equal(state[k], v), k
    assert tt.current_lr(0) == pytest.approx(2e-4)
    assert tt.current_lr(8) == 0.0


# ------------------------------------------------------ preemption / resume
def _port_trainer(base, root, path, n=8):
    tset, tval = _sets(tseg, taug, root, n)
    return ttrainer.SegmentationTrainer(_args(path, device="cpu"),
                                        _tiny(base), MODEL_CFG, tset, tval,
                                        OPT, image_dump_interval=0)


def _state(trainer):
    opt = trainer.optimizer.state_dict()
    return (trainer.model.state_dict(),
            {k: s["momentum_buffer"] for k, s in opt["state"].items()},
            trainer.scheduler.state_dict(), trainer.generator.get_state())


def _assert_same_state(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert a[2] == b[2]
    assert torch.equal(a[3], b[3])


class StopAfter:
    """``train_step`` that asks ``trainer`` to stop after ``n`` steps."""

    def __init__(self, fn, n, trainer):
        self.fn, self.n, self.trainer = fn, n, trainer

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.n -= 1
        if self.n == 0:
            self.trainer._stop_requested = True
        return out


def test_preempt_then_resume_is_bit_identical(tiny_base, data_root, tmp_path,
                                              monkeypatch):
    """Dropout on (its generator is in the bundle), deterministic feed, 8
    images at batch 4: preempted after step 1 of epoch 0, resumed by a new
    trainer, the final state equals an uninterrupted run's bit for bit."""
    whole = _port_trainer(tiny_base, data_root, tmp_path / "whole")
    for epoch in range(2):
        whole.training(epoch)
        whole.validation(epoch)
    assert whole.scheduler.last_epoch == 4

    first = _port_trainer(tiny_base, data_root, tmp_path / "cut")
    with monkeypatch.context() as m:
        m.setattr(ttrainer, "train_step",
                  StopAfter(ttrainer.train_step, 1, first))
        first.training(0)
    assert first.preempted and first.scheduler.last_epoch == 1
    ck = tmp_path / "cut"
    assert (ck / ttrainer.RESUME_BUNDLE).is_file()
    assert (ck / "last_checkpoint.pt").is_file()
    assert not list(ck.glob("*.tmp"))

    second = _port_trainer(tiny_base, data_root, tmp_path / "cut")
    second.generator.manual_seed(99)
    assert second.try_resume() == (0, 1)
    _assert_same_state(_state(second), _state(first))
    second.training(0, start_iter=1)
    second.validation(0)
    second.clear_resume_bundle()
    assert not (ck / ttrainer.RESUME_BUNDLE).exists()
    second.training(1)
    second.validation(1)
    assert second.scheduler.last_epoch == 4
    _assert_same_state(_state(second), _state(whole))


def test_sigterm_sets_the_stop_flag():
    trainer = ttrainer.SegmentationTrainer.__new__(
        ttrainer.SegmentationTrainer)
    trainer._stop_requested = False
    old = trainer.install_preemption_handler()
    try:
        assert set(old) == {signal.SIGTERM}
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not trainer._stop_requested and time.time() < deadline:
            time.sleep(0.01)
        assert trainer._stop_requested
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_resume_bundle_roundtrips_the_training_state(tiny_base, data_root,
                                                     tmp_path):
    trainer = _port_trainer(tiny_base, data_root, tmp_path, n=4)
    assert trainer.try_resume() is None
    trainer.training(0)  # one step with dropout
    trainer.save_resume_bundle(1, 1)
    other = _port_trainer(tiny_base, data_root, tmp_path, n=4)
    other.generator.manual_seed(5)
    assert other.try_resume() == (1, 1)
    _assert_same_state(_state(other), _state(trainer))
    assert [g["lr"] for g in other.optimizer.param_groups] == \
        [g["lr"] for g in trainer.optimizer.param_groups]
    other.clear_resume_bundle()
    assert not (tmp_path / ttrainer.RESUME_BUNDLE).exists()
    assert other.try_resume() is None


# ----------------------------------------------------------------- weights
def _weights_trainer(model, path, tmp_path, data_root):
    tset, tval = _sets(tseg, taug, data_root, 4)
    return ttrainer.SegmentationTrainer(
        _args(tmp_path / "ck", device="cpu", weights=str(path)), model,
        MODEL_CFG, tset, tval, OPT)


def _check_forward(model, image, want):
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(image))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w, 2e-3)


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """JAX variables of the tiny model in a msgpack file written by the JAX
    package, and the JAX eval forward of what its ``load_checkpoint``
    reads back."""
    image = np.random.RandomState(12).randn(1, CROP, CROP, 3).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
        jm = jdl.DeepLabV3Plus(2, "tiny", crop_size=CROP)
        v = jax_variables(jm, jnp.asarray(image), False, seed=11)
        path = tmp_path_factory.mktemp("w") / "last_checkpoint.params"
        jtrainer.save_checkpoint_file(str(path), v["params"],
                                      v["batch_stats"])
        params, stats = jtrainer.load_checkpoint(str(path), v["params"],
                                                 v["batch_stats"])
        want = jax.jit(lambda v, x: jm.apply(v, x, False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(image))
    return path, image, want


@pytest.mark.parametrize("fmt", ["pt", "msgpack"])
def test_weights_from_port_and_jax_files(tiny_base, tiny_weights, data_root,
                                         tmp_path, fmt):
    msgpack, image, want = tiny_weights
    path = msgpack
    if fmt == "pt":  # the same weights through the port's own file
        src = _tiny(tiny_base)
        ttrainer.load_checkpoint(str(msgpack), src)
        path = tmp_path / "w.pt"
        ttrainer.save_checkpoint_file(str(path), src.state_dict())
    trainer = _weights_trainer(_tiny(tiny_base), path, tmp_path, data_root)
    _check_forward(trainer.model, image, want)


def test_weights_from_a_reference_mxnet_file(data_root, tmp_path):
    """A reference-named DeepLabV3+ file (resnet50): the port's trainer
    loads exactly the tensors the JAX ``load_checkpoint`` converts, so its
    forward is the JAX one's (tests/test_torch_deeplab_convert.py holds
    that forward on these weights within 2e-3)."""
    jm = jdl.DeepLabV3Plus(nclass=2, aux=True, crop_size=CROP)
    v = jax_variables(jm, jnp.zeros((1, CROP, CROP, 3)), False)
    named = synth_reference_deeplab(v["params"], v["batch_stats"])
    path = tmp_path / "last_checkpoint.params"
    write_mx_file(str(path), list(named.values()), list(named))
    trainer = _weights_trainer(tdl.DeepLabV3Plus(2, crop_size=CROP), path,
                               tmp_path, data_root)
    want = deeplab_state_dict(*jtrainer.load_checkpoint(
        str(path), v["params"], v["batch_stats"]))
    got = trainer.model.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k


def test_weights_refuses_other_files(tiny_base, data_root, tmp_path):
    model = _tiny(tiny_base)
    junk = tmp_path / "junk.params"
    junk.write_bytes(b"\x01not a checkpoint")
    with pytest.raises(ValueError):
        ttrainer.load_checkpoint(str(junk), model)
    mx = tmp_path / "other.params"
    write_mx_file(str(mx), [np.zeros(3, np.float32)], ["dense0_weight"])
    with pytest.raises(ValueError, match="not a reference DeepLabV3"):
        ttrainer.load_checkpoint(str(mx), model)
    with pytest.raises(RuntimeError, match="no checkpoint found"):
        _weights_trainer(model, tmp_path / "missing.pt", tmp_path, data_root)


# -------------------------------------------------------------- with depth
class DepthSet:
    """(image, depth) items from an RGB dataset, depth from the image."""

    def __init__(self, base):
        self.base = base
        self.num_class, self.pred_offset = base.num_class, base.pred_offset

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        img, mask = self.base[i]
        depth = (img[..., :1].astype(np.float32) - 127.5) / 64.0
        return (img, depth), mask


def test_trainer_feeds_the_depth_plane(tiny_backbones, data_root, tmp_path):
    """with_depth batches reach the model as its fourth input channel in
    training (the first step's loss is the model's on [image, depth]),
    validation and the image dump."""
    tset, tval = _sets(tseg, taug, data_root, 8)
    model = tdl.DeepLabV3Plus(2, "tiny", crop_size=CROP, in_channels=4,
                              use_dropout=False)
    before = copy.deepcopy(model).train()
    trainer = ttrainer.SegmentationTrainer(
        _args(tmp_path / "ck", device="cpu", logs_path=str(tmp_path / "tb")),
        model, MODEL_CFG, DepthSet(tset), DepthSet(tval), OPT,
        with_depth=True, image_dump_interval=1)
    rec = Recorder(ttrainer.train_step, 0)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ttrainer, "train_step", rec)
        trainer.training(0)
    metrics = trainer.validation(0)
    assert len(rec.losses) == 2 and np.isfinite(rec.losses).all()
    assert 0 <= metrics["accuracy"] <= 1
    assert list((tmp_path / "tb").rglob("events.out.tfevents.*"))

    (img, depth), mask, _ = next(ttrainer.batch_iter(DepthSet(tset), 4, True,
                                                     seed=0))
    x = ttrainer._device_normalize(torch.from_numpy(img))
    with torch.no_grad():
        out = before(x, depth=torch.from_numpy(depth))
    want = float(tlosses.seg_loss_with_aux(
        out[0], out[1], torch.from_numpy(mask), aux_weight=0.5).mean())
    np.testing.assert_allclose(rec.losses[0], want, rtol=1e-6)

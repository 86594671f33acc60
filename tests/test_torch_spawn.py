"""Processes of a data-parallel world on the CPU for the scale-out tests of
the port (``tests/test_torch_distributed.py``, ``tests/test_torch_scale_out
.py``): ``run_world`` spawns ``world`` processes, joins them in a gloo group
on a free port, runs one of the workers below in each and returns their
results by rank.  This module holds no test and imports neither jax nor the
JAX package, so a spawned process imports only torch, the port and this."""

import multiprocessing as mp
import os
import queue
import traceback
from pathlib import Path

import numpy as np

WORLD_TIMEOUT = 240  # seconds for one world to finish


def _entry(rank, world, port, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    import torch

    from gan_segmentation_tpu_torch.core import distributed as dist_
    from gan_segmentation_tpu_torch.core import dtypes
    torch.set_num_threads(1)
    # the entry points' card is this process's CPU (as the tests' override)
    dtypes.cuda_device = lambda: torch.device("cpu")
    try:
        assert dist_.initialize(cuda=False)
        results.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:  # the parent raises it
        results.put((rank, "error", traceback.format_exc()))
    finally:
        dist_.shutdown()


def run_world(fn, world: int = 2, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one gloo
    group; -> their picklable results, by rank.  A process that raises or
    does not finish within ``WORLD_TIMEOUT`` fails the caller."""
    from gan_segmentation_tpu_torch.core.distributed import free_port
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = str(free_port())  # not a fixed one: a killed run may hold it
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args,
                                              results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, kind, value = results.get(timeout=WORLD_TIMEOUT)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" did not finish") from None
            if kind == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


def draw(seed: int, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------- collectives
def collectives(rank, world):
    """any_flag, allreduce_sum, broadcast_str, global-batch BN (decoder
    and DeepLab forms, and over a world of one) and the global loss
    normalisers, each on this rank's half of one seeded global batch."""
    import torch
    import torch.distributed as dist
    from torch import nn

    from gan_segmentation_tpu_torch.core import distributed as dist_
    from gan_segmentation_tpu_torch.models.resnet import (BatchNorm,
                                                          set_process_group)
    from gan_segmentation_tpu_torch.ops import losses, norm

    grp = dist_.group()
    out = {"flags": [dist_.any_flag(rank == 1), dist_.any_flag(False)],
           "sums": dist_.allreduce_sum(
               (np.arange(3, dtype=np.int64) * (rank + 1), rank + 1,
                {"f": np.full(2, 0.5 * rank)})),
           "str": dist_.broadcast_str("run-%d" % rank if rank == 0 else None)}
    own = [dist.new_group([r]) for r in range(world)][rank]
    x = draw(0, 4, 5, 5, 6)
    dy = draw(1, 4, 5, 5, 6)
    half = slice(rank * 2, rank * 2 + 2)
    bns = {}
    for name in ("decoder", "deeplab", "own", "own_plain"):
        bn = (BatchNorm(6) if name == "deeplab" else
              nn.BatchNorm2d(6, eps=1e-5, momentum=0.1))
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(1 + 0.3 * draw(2, 6)))
            bn.bias.copy_(torch.from_numpy(0.2 * draw(3, 6)))
            bn.running_var.copy_(torch.from_numpy(1 + 0.1 * draw(4, 6) ** 2))
        xs = torch.from_numpy(x[half]).requires_grad_(True)
        if name == "decoder":
            y = norm.batch_norm_train(xs, bn, grp)
        elif name == "deeplab":
            set_process_group(bn, grp)
            y = bn.train()(xs)
        elif name == "own":
            y = norm.batch_norm_train(xs, bn, own)
        else:
            y = norm.batch_norm_train(xs, bn)
        (y * torch.from_numpy(dy[half])).sum().backward()
        bns[name] = {k: v.detach().numpy().copy() for k, v in dict(
            y=y, dx=xs.grad, dw=bn.weight.grad, db=bn.bias.grad,
            mean=bn.running_mean, var=bn.running_var).items()}
    out["bn"] = bns
    logits = torch.from_numpy(draw(5, 4, 6, 6, 3)[half])
    labels = torch.from_numpy(np.random.RandomState(6).randint(
        -1, 3, (4, 6, 6))[half])
    out["ce"] = float(losses.softmax_ce_valid_norm(logits, labels,
                                                   group=grp))
    out["mult"] = float(losses.normalized_focal_loss_softmax(
        logits, labels, group=grp)[1])
    return out


# ------------------------------------------------------------- decoder fit
NARROW_IN = [32, 32, 16, 8]       # a narrow res-32 pyramid
NARROW_FEATURES = [16, 16, 16, 8, 2]


def narrow_cfg(batch: int, **kw):
    from gan_segmentation_tpu_torch.core.config import SolverConfig
    cfg = SolverConfig(max_res_log2=5, features=list(NARROW_FEATURES),
                       in_channels=list(NARROW_IN), use_dropout=False,
                       optimizer="sgd", momentum=0.9, **kw)
    cfg.train_epochs, cfg.train_batch_size = 2, batch
    return cfg


def fit(rank, world, data_dir, init_path, out_dir):
    """The decoder fit from the weights of ``init_path``: global batch 4
    per step (each process its slice) from the collection on disk and from
    the resident one, and batch 1 resident (replicated); -> each one's
    weights, and which checkpoint dirs got a file."""
    import torch

    from gan_segmentation_tpu_torch.train.solver import SegSolver
    init = torch.load(init_path, weights_only=True)
    out = {}
    for name, batch, cache in (("steps", 4, False), ("cached", 4, True),
                               ("replicated", 1, True)):
        ckpt = Path(out_dir) / f"{name}_{rank}"
        s = SegSolver(5, str(data_dir), str(ckpt),
                      cfg=narrow_cfg(batch, device_cache=cache),
                      device=torch.device("cpu"))
        s.model.load_state_dict(init)
        s.fit()
        assert s.cache_active == cache
        out[name] = {k: v.numpy().copy() for k, v in
                     s.model.state_dict().items()}
        out[name + "_history"] = s.history
        out[name + "_wrote"] = sorted(p.name for p in ckpt.glob("*")) \
            if ckpt.is_dir() else []
    return out


# ---------------------------------------------------------------- DeepLab
CROP = 32


def tiny_deeplab(seed: int = 7):
    """DeepLabV3+ on the (1, 1, 1, 1) backbone, dropout off."""
    import torch

    from gan_segmentation_tpu_torch.models import deeplab as tdl
    tdl._BACKBONE_LAYERS["tiny"] = (1, 1, 1, 1)
    model = tdl.DeepLabV3Plus(2, "tiny", crop_size=CROP,
                              generator=torch.Generator().manual_seed(seed))
    model.aspp.use_dropout = model.auxlayer.use_dropout = False
    return model


def deeplab_sets(root):
    """Deterministic feeds of ``root``: pad + center crop to 32."""
    from gan_segmentation_tpu_torch.data import augment as aug
    from gan_segmentation_tpu_torch.data import segmentation as seg

    def augmentator():
        return aug.RGBSegmentationAug([aug.PadIfNeeded(CROP, CROP),
                                       aug.CenterCrop(CROP, CROP)],
                                      ignore_class=-1)
    return (seg.FFHQHairSegmentation(str(root), split="train",
                                     subdir="train_generated", rng_seed=0,
                                     augmentator=augmentator(),
                                     transform=None),
            seg.FFHQHairSegmentation(str(root), split="val",
                                     augmentator=augmentator(),
                                     transform=None))


def deeplab_trainer(root, ckpt, batch, test_batch, seed=0):
    import types

    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        SegmentationTrainer)
    trainset, valset = deeplab_sets(root)
    args = types.SimpleNamespace(
        batch_size=batch, test_batch_size=test_batch, workers=1,
        weights=None, seed=seed, logs_path=None, checkpoints_path=str(ckpt),
        device="cpu")
    opt = {"mode": "poly", "baselr": 2e-4, "nepochs": 2, "wd": 2e-4,
           "momentum": 0.9}
    return SegmentationTrainer(args, tiny_deeplab(), {
        "num_classes": 2, "crop_size": CROP, "aux_weight": 0.5}, trainset,
        valset, opt, image_dump_interval=0)


def counters(metric):
    return [np.asarray(metric.total_inter).copy(),
            np.asarray(metric.total_union).copy(),
            int(metric.total_correct), int(metric.total_label)]


def deeplab(rank, world, root, out_dir):
    """The trainer over ``world`` processes: validation before training
    (counters), one epoch (its loss and weights), then an epoch in which
    only the last rank asks to stop after its second step (the agreed stop,
    the bundle), and every rank resuming from the primary's bundle."""
    t = deeplab_trainer(root, Path(out_dir) / f"ckpt_{rank}", world, world)
    t.validation(0)
    out = {"val": counters(t.metric)}
    out["loss"] = t.training(0)
    out["weights"] = {k: v.numpy().copy()
                      for k, v in t.model.state_dict().items()}
    step, calls = t.step, []

    def step_then_stop(*a):
        calls.append(1)
        if rank == world - 1 and len(calls) == 2:
            t._stop_requested = True
        return step(*a)

    t.step = step_then_stop
    t.training(1, log_interval=2)
    out["preempted"], out["steps_run"] = t.preempted, len(calls)
    out["wrote"] = sorted(p.name for p in (Path(out_dir) / f"ckpt_{rank}")
                          .glob("*"))
    out["generator"] = t.generator.get_state().numpy().copy()
    resumed = deeplab_trainer(root, Path(out_dir) / "ckpt_0", world, world)
    out["resumed_at"] = resumed.try_resume()
    out["resumed_generator"] = resumed.generator.get_state().numpy().copy()
    return out


# ----------------------------------------------------------------- generate
def generate(rank, world, base, gan_dir):
    """``generate`` of 5 pairs over the processes, then again with
    ``--resume`` after this rank lost its slice's last pair; -> the files of
    each run."""
    from gan_segmentation_tpu_torch.apps import main as app
    from gan_segmentation_tpu_torch.core import config as tconfig
    from gan_segmentation_tpu_torch.core import distributed as dist_
    cfg = tconfig.AppConfig(BASE_DIR=str(base), GAN="bedrooms",
                            GAN_DIR=str(gan_dir), GAN_BATCH_SIZE_PER_GPU=2,
                            GENERATE_NUM=5, MAX_RES_LOG2=5)
    app.run_generate(cfg, writer="cv2")
    dist_.barrier()
    out = Path(base) / "dataset" / "train_generated"
    first = {p.name: p.read_bytes() for p in out.iterdir()}
    dist_.barrier()
    last = min(5, (rank + 1) * 3) - 1  # this rank's slice is 3 * rank..
    for name in (f"img_{last:06d}.jpg", f"mask_{last:06d}.png"):
        (out / name).unlink()
    dist_.barrier()
    app.run_generate(cfg, writer="cv2", resume=True)
    dist_.barrier()
    return {"first": first,
            "resumed": {p.name: p.read_bytes() for p in out.iterdir()}}


# ------------------------------------------------------------------ runner
def runner(rank, world, root, exp_path):
    """The experiment runner under the launcher's environment, on the CPU
    (``--no-cuda``: gloo): one short epoch at global batch 2 and its
    validation; -> the run dir this process used."""
    from gan_segmentation_tpu_torch.models import deeplab as tdl
    from gan_segmentation_tpu_torch.train import rgb_experiments as rx
    tdl._BACKBONE_LAYERS["resnet50"] = (1, 1, 1, 1)
    trainer = rx.run(rx.SPECS["01_hair_deeplabv3_ffhq_pretrain_gan"], [
        "train", "--input-path", str(root), "--no-cuda", "--crop-size",
        "32", "--base-size", "48", "--scale-factor", "1.0", "--epochs", "1",
        "--epoch-len", "4", "--batch-size", "2", "--test-batch-size", "2",
        "--workers", "1"], exp_path=exp_path)
    return {"run_path": str(trainer.args.run_path),
            "world": (trainer._pi, trainer._pc), "ngpus": trainer.args.ngpus}


# ------------------------------------------------------ global batch norm
SYNC_CROP = 32
SYNC_SEED = 11


def sync_ref():
    """The benchmark's plain reference of the DeepLab cell
    (``benchmark/configs/deeplab_sync_ref.py``: plain torch)."""
    import importlib.util

    path = (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
            / "deeplab_sync_ref.py")
    spec = importlib.util.spec_from_file_location("deeplab_sync_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync_inputs(batch: int, crop: int = SYNC_CROP):
    """Seeded uint8 crops, labels with an ignored band and the two dropout
    draws (NHWC at output stride 8) of a global batch.  Each crop is a
    4 x 4 grid of random colours, each colour a block, plus noise: crops
    that differ in their global content, as photographs do (over crops of
    noise alone the ASPP's pooled branch reads one value per channel, and
    its batch norm's variance is round-off)."""
    rng = np.random.RandomState(3)
    grid = (rng.uniform(0, 255, (batch, 4, 4, 3))
            * np.linspace(0.2, 1.0, batch)[:, None, None, None])
    blocks = grid.repeat(crop // 4, axis=1).repeat(crop // 4, axis=2)
    images = np.clip(blocks + rng.normal(0, 16, blocks.shape), 0,
                     255).astype(np.uint8)
    masks = rng.randint(0, 2, (batch, crop, crop)).astype(np.int8)
    masks[:, -3:] = -1
    s = crop // 8
    uniforms = [rng.uniform(size=(batch, s, s, 256)).astype(np.float32)
                for _ in range(2)]
    return images, masks, uniforms


def sync_model(crop: int = SYNC_CROP):
    """DeepLabV3+ over resnet50 at every published width, seeded."""
    import torch

    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
    return DeepLabV3Plus(2, "resnet50", aux=True, crop_size=crop,
                         generator=torch.Generator().manual_seed(SYNC_SEED))


def sync_gaps(ref, before, after, grads, losses, want, rows):
    """The program's step against the reference's (``train_step``'s
    result) on the whole batch: the loss of the samples ``rows`` (relative),
    and for the gradients, the update and the running statistics the
    worst leaf's norm of the difference over the larger of its and the
    median leaf's reference norm, and the whole model's."""
    per_sample, ref_grads, ref_after, _ = want
    model = {"layers": [3, 4, 6, 3], "stem_width": 64, "in_channels": 3,
             "atrous_rates": [12, 24, 36], "nclass": 2, "aux": True}
    names = ref.trainable(model)
    stats = [k for k in before if k.endswith(("running_mean",
                                              "running_var"))]

    def gaps(got, wanted, leaves):
        norms = {k: float(wanted[k].norm()) for k in leaves}
        med = float(np.median(list(norms.values())))
        worst = max(float((got[k] - wanted[k]).norm()) / max(norms[k], med)
                    for k in leaves)
        whole = (sum(float((got[k] - wanted[k]).square().sum())
                     for k in leaves)
                 / sum(float(wanted[k].square().sum()) for k in leaves))
        return worst, whole ** 0.5

    ref_loss = float(per_sample[rows].mean())
    return {"loss": abs(losses - ref_loss) / abs(ref_loss),
            "grad": gaps(grads, ref_grads, names),
            "update": gaps({k: after[k] - before[k] for k in names},
                           {k: ref_after[k] - before[k] for k in names},
                           names),
            "stats": gaps({k: after[k] - before[k] for k in stats},
                          {k: ref_after[k] - before[k] for k in stats},
                          stats)}


SYNC_HYPER = {"base_lr": 0.005, "power": 0.9, "wd": 2e-4, "momentum": 0.9,
              "head_lr_mult": 10.0, "aux_weight": 0.5, "total_steps": 25000}


def deeplab_sync(rank, world, images, masks, uniforms):
    """One eager ``train_step`` of the seeded resnet50 DeepLabV3+ on this
    rank's share of the global batch, batch norm over the world's gloo
    group, the gradients averaged; its gaps to the reference's step on the
    whole batch (every rank computes it), and the all-reduces it issued.
    Then one more step under a stand-in of a card's ``GraphedCall``
    (its capture runs the step, its replays run nothing, as a CUDA graph's
    replay runs no Python) and two replays: what the capture holds and
    what the replays moved."""
    import torch

    from gan_segmentation_tpu_torch.core import distributed as dist_
    from gan_segmentation_tpu_torch.core import graphs
    from gan_segmentation_tpu_torch.models.resnet import set_process_group
    from gan_segmentation_tpu_torch.train import deeplab_trainer as T

    grp = dist_.group()
    model = sync_model()
    set_process_group(model, grp)
    per = len(images) // world
    rows = slice(rank * per, (rank + 1) * per)
    mine = (torch.from_numpy(images[rows]), torch.from_numpy(masks[rows]))
    u = [torch.from_numpy(x[rows]) for x in uniforms]
    opt, sch = T.make_optimizer(model, SYNC_HYPER["base_lr"],
                                SYNC_HYPER["total_steps"], SYNC_HYPER["wd"],
                                SYNC_HYPER["momentum"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counted = dict(dist_.counters)
    loss, _ = T.train_step(model, opt, sch, *mine, dropout_u=u, group=grp)
    step_calls = {k: dist_.counters[k] - counted[k] for k in counted}
    after = model.state_dict()
    grads = {k: p.grad for k, p in model.named_parameters()}
    ref = sync_ref()
    want = ref.train_step(before, {
        "layers": [3, 4, 6, 3], "stem_width": 64, "in_channels": 3,
        "atrous_rates": [12, 24, 36], "nclass": 2, "aux": True},
        SYNC_HYPER, torch.from_numpy(images), torch.from_numpy(masks),
        [torch.from_numpy(x).permute(0, 3, 1, 2) for x in uniforms], 0)
    out = {"gaps": sync_gaps(ref, before, after, grads, float(loss), want,
                             rows),
           "step_calls": step_calls,
           "bn_channels": [m.num_features for m in model.modules()
                           if isinstance(m, torch.nn.BatchNorm2d)],
           "parameters": sum(p.numel() for p in model.parameters())}

    class StandIn(graphs.GraphedCall):
        def _capture(self):
            self.graph = "captured"
            return self.fn()

        def _replay(self):
            pass

    call = StandIn(lambda: T.train_step(model, opt, None, *mine,
                                        dropout_u=u, group=grp),
                   "cuda", warmup=0)
    counted = dict(dist_.counters)
    call()
    captured = {k: dist_.counters[k] - counted[k] for k in counted}
    counted = dict(dist_.counters)
    call()
    call()
    out.update(captured=captured, held=dict(call.collectives),
               replayed={k: dist_.counters[k] - counted[k] for k in counted})
    return out

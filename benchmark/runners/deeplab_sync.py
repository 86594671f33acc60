"""Traffic runner ``deeplab_sync``: DeepLabV3+ trained data-parallel over
the world's cards with global batch norm, the pipeline's step 5 at the
reference experiment's batch.

One process a card (``gsbench/world.py`` starts them); each joins the
world through the program's ``core/distributed.py::initialize`` and runs
the program as ``train/rgb_experiments.py`` builds it for its experiment:
``init_model`` (DeepLabV3+ over resnet50, aux head), the benchmark's
seeded weights loaded strictly, and ``SegmentationTrainer`` over the
world (batch norm over the global batch through ``set_process_group``,
``make_optimizer(graphed=True)``, ``GraphedTrainStep`` with the gradients'
all-reduce captured).  Each step is ``SegmentationTrainer.step`` on a host
batch: pinned staging and the graph's replay after two eager steps and
the capture.  The crops come from a resident host pool a rank
(``gsbench/deeplab.py::crop_pool``, from the seed and the rank), the
rank's share of the global batch a step, consecutive crops round the
pool; file decode and augmentation are bypassed.  Closed loop, steps back
to back; the window ends on the same step on every rank
(``world.agree`` every ``agree_every`` steps, behind the launch queue).

The global batch is the configuration's (the experiment's
``--batch-size``), split evenly over the ranks.  Traffic parameters
(``traffic/<name>.json``): ``pool``, ``ignore_band_max``,
``agree_every``, and ``trace_lead`` /
``trace_settle`` / ``trace_steps`` (with ``--trace 1``, rank 0: steps of
the window before the profiler starts, under it before the profiled
stretch, and in the stretch, which starts on an empty launch queue).

End-to-end: ``train_samples_per_s`` (steps x the global batch over rank
0's window, ended after the card's work).  Counters: ``samples_per_unit``
(this card's samples a step), ``collectives_per_step`` and
``collective_bytes_per_step`` (the all-reduces the captured step holds,
``GraphedCall.collectives``; absent where the program keeps no such
record).

Compared, on every rank, against the plain reference
(``configs/deeplab_sync_ref.py``) stepping the whole global batch on this
card: the ``start`` step, the set-up's first, from the seeded weights, and
the ``window`` step, one replay right after the window, from the state
read after the window's last step.  Both over the same crops, labels and
dropout draws of every rank, made again from the seed (each rank's
dropout stream as the program seeds it, the earlier steps' draws drawn
and dropped).  For each: ``loss_gap``, the relative gap of this rank's
loss (its samples' mean); ``momentum_gap``, SGD's buffer after the step,
the worst leaf's gap of norms over the larger of its and the median
leaf's reference norm; ``change_gap``, the weights' change over the step,
the whole model's norm of the difference over the reference's;
``bn_stat_gap``, the running means' and variances' change over the step
(which holds the global statistics), the worst leaf's norm of the
difference over the larger of its and the median leaf's reference norm.
At the seeded weights TF32's gradients lie as far from f32's as no
update at all (a deep random net's gradients amplify the convs' rounding
toward the stem), so the start step compares its forward's numbers
alone: ``loss_gap`` and ``bn_stat_gap``.  The world keeps each number's
worst rank.

Controls (``--control``), in the program's place, with a short window:
``bf16``, the program's bf16 activations (below the configured f32 with
TF32 convs); ``local-bn``, batch norm over each rank's own samples;
``no-allreduce``, each rank's gradients left unaveraged.
"""

import json
import sys
import tempfile
import time
import types

import numpy as np

from gsbench import deeplab, harness, program, world
from gsbench import trace as tracing
from gsbench.trace import STRETCH

CONTROLS = ("bf16", "local-bn", "no-allreduce")
NAMES = ("loss_gap", "momentum_gap", "change_gap", "bn_stat_gap")
# what each checked step compares (the module's docstring says why)
COMPARED = {"start": ("loss_gap", "bn_stat_gap"), "window": NAMES}
# seconds a rank waits for the others at an agreement: the first one
# follows every rank's set-up
AGREE_S = 600
# the set-up's steps: two eager, the capture with its first replay, a
# replay alone
SETUP_STEPS = 4
WEIGHT_STREAM = 5


class Crops:
    """What the trainer reads of a training set: its length (an epoch's
    draws, which sets the poly rate's steps) and its classes."""

    def __init__(self, length, num_class):
        self.length, self.num_class = length, num_class

    def __len__(self):
        return self.length


def rank_stream_seed(pseed, rank):
    """The seed of rank ``rank``'s dropout stream, as the trainer seeds it
    (``core/distributed.py::rank_seed`` of its ``seed``)."""
    return (pseed + (rank << 32)) % 2 ** 63


def read_state(trainer):
    """(parameters and buffers, SGD's momentum buffers) by name, copied to
    the host."""
    model, opt = trainer.model, trainer.optimizer
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    moms = {k: opt.state[p]["momentum_buffer"].detach().to("cpu", copy=True)
            for k, p in model.named_parameters()}
    return state, moms


def captured(trainer):
    """(calls, bytes) of the all-reduces the train step's graph holds, or
    None where the program keeps no such record."""
    fn = getattr(getattr(trainer, "_train_graph", None), "fn", None)
    held = [getattr(c, "collectives", None)
            for c in getattr(fn, "calls", {}).values()]
    held = [h for h in held if h]
    if not held:
        return None
    return (sum(h["distributed.allreduce.calls"] for h in held),
            sum(h["distributed.allreduce.bytes"] for h in held))


def collective_calls(distributed):
    """The all-reduces the program has issued, or None where it keeps no
    such counter."""
    counters = getattr(distributed, "counters", None)
    return None if counters is None else counters[
        "distributed.allreduce.calls"]


def make_trainer(cfg, pseed, device, weights, group, control):
    """The program's trainer as ``rgb_experiments.train`` makes it, holding
    the benchmark's weights, with a control applied."""
    import torch

    from gan_segmentation_tpu_torch.models.resnet import set_process_group
    from gan_segmentation_tpu_torch.train import rgb_experiments
    from gan_segmentation_tpu_torch.train.deeplab_trainer import \
        SegmentationTrainer

    sol, mcfg = cfg["solver"], cfg["model"]
    # the experiment's crop, through the program's own override (the CPU
    # tests' smaller crops)
    spec = rgb_experiments.apply_overrides(
        rgb_experiments.SPECS[sol["experiment"]],
        types.SimpleNamespace(crop_size=mcfg["crop_size"]))
    model, model_cfg = rgb_experiments.init_model(spec, pseed)
    pairs = {"crop_size": (model.crop_size, mcfg["crop_size"]),
             "nclass": (model.nclass, mcfg["nclass"]),
             "aux": (model.aux, mcfg["aux"]),
             "layers": (list(model.backbone.layers), mcfg["layers"]),
             "lr": (spec.lr, sol["base_lr"]),
             "wd": (spec.weight_decay, sol["wd"]),
             "epochs": (spec.num_epochs, sol["epochs"]),
             "epoch_len": (spec.train_epoch_len, sol["epoch_len"]),
             "aux_weight": (model_cfg["aux_weight"], sol["aux_weight"])}
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError(f"the program's experiment differs from the "
                           f"configuration: {bad}")
    with torch.no_grad():
        model.load_state_dict(weights)
    args = types.SimpleNamespace(
        batch_size=sol["global_batch"], test_batch_size=sol["global_batch"],
        checkpoints_path=tempfile.gettempdir(), device=str(device),
        dtype="bfloat16" if control == "bf16" else sol["dtype"],
        seed=pseed, workers=1)
    optimizer_params = {"mode": "poly", "baselr": spec.lr,
                        "nepochs": spec.num_epochs,
                        "wd": spec.weight_decay,
                        "momentum": sol["momentum"]}
    trainer = SegmentationTrainer(
        args, model, model_cfg, Crops(spec.train_epoch_len, mcfg["nclass"]),
        None, optimizer_params, graphed=True, group=group)
    if trainer.total_iters != sol["total_steps"]:
        raise RuntimeError(f"the program's poly rate spans "
                           f"{trainer.total_iters} steps")
    if control == "local-bn":
        set_process_group(trainer.model, None)
    elif control == "no-allreduce":
        trainer.group = None
        trainer._graphs()
    return trainer


def dropout_draws(torch, cfg, pseed, ranks, per_card, steps, device):
    """The dropout draws of step ``steps`` of every rank, as the program
    draws them (each rank's stream, the earlier steps' draws drawn and
    dropped), concatenated over the ranks and made NCHW."""
    mcfg = cfg["model"]
    shapes = deeplab.dropout_shapes(mcfg, mcfg["crop_size"], per_card)
    out = [[] for _ in shapes]
    scratch = [torch.empty(s, device=device) for s in shapes]
    for r in range(ranks):
        g = torch.Generator(device=device)
        g.manual_seed(rank_stream_seed(pseed, r))
        for _ in range(steps):
            for u in scratch:
                u.uniform_(0.0, 1.0, generator=g)
        for i, s in enumerate(shapes):
            out[i].append(torch.rand(s, generator=g, device=device))
    return [torch.cat(o).permute(0, 3, 1, 2) for o in out]


def global_batch(torch, pools, per_card, step, device):
    """Step ``step``'s crops and labels of every rank, concatenated."""
    parts = [deeplab.pool_batch(p, per_card, step) for p in pools]
    images = np.concatenate([a for a, _ in parts])
    masks = np.concatenate([m for _, m in parts])
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(masks).to(device))


def follow(torch, ref, cfg, pools, pseed, ranks, per_card, step, state,
           moms, device):
    """The reference's step ``step`` on the global batch from ``state``
    (parameters and buffers) and ``moms`` (None before the first step),
    in full f32."""
    sol = cfg["solver"]
    hyper = {"base_lr": sol["base_lr"], "power": sol["power"],
             "wd": sol["wd"], "momentum": sol["momentum"],
             "head_lr_mult": sol["head_lr_mult"],
             "aux_weight": sol["aux_weight"],
             "total_steps": sol["total_steps"]}
    images, labels = global_batch(torch, pools, per_card, step, device)
    u = dropout_draws(torch, cfg, pseed, ranks, per_card, step, device)
    p = {k: v.to(device) for k, v in state.items()}
    m = None if moms is None else {k: v.to(device) for k, v in moms.items()}
    with ref.full_precision():
        return ref.train_step(p, cfg["model"], hyper, images, labels, u,
                              step, m)


def readings(tag, ref, cfg, rank, per_card, want, before, loss, after, moms):
    """(loss_gap, momentum_gap, change_gap, bn_stat_gap) of one step
    against the reference's (``follow``'s result) from the state
    ``before``; the losses and the leaves that set the gaps go to standard
    error."""
    per_sample, _, ref_after, ref_moms = want
    ref_loss = float(per_sample[rank * per_card:(rank + 1) * per_card]
                     .mean())
    names = ref.trainable(cfg["model"])
    stats = [k for k in before if k.endswith(("running_mean",
                                              "running_var"))]
    change = {k: after[k] - before[k] for k in names + stats}
    wanted = {k: ref_after[k].cpu() - before[k] for k in names + stats}
    momentum_gap, m_at = deeplab.gap_of_norms(
        moms, {k: v.cpu() for k, v in ref_moms.items()}, names)
    bn_gap, b_at = deeplab.gap_of_differences(change, wanted, stats)
    print(f"gap leaves {tag} " + json.dumps({
        "rank": rank, "loss": loss, "ref_loss": ref_loss,
        "momentum": m_at, "change": deeplab.gap_of_differences(
            change, wanted, names)[1], "bn_stat": b_at}), file=sys.stderr)
    return (abs(loss - ref_loss) / abs(ref_loss), momentum_gap,
            deeplab.whole_gap(change, wanted, names), bn_gap)


def run(cell, seed, seconds, trace, device, t0, control=None):
    import torch

    from gan_segmentation_tpu_torch.core import distributed

    cfg, tr = cell.config, cell.traffic
    if control is not None and control not in CONTROLS:
        raise SystemExit(f"unknown control {control!r}: {CONTROLS}")
    # the configuration's precision: f32 with cuDNN's convs in TF32
    torch.backends.cudnn.allow_tf32 = cfg["tf32_convs"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32_matmul"]
    phases = harness.Phases(t0, device)
    ref = harness.load_reference(cfg)
    distributed.initialize(cuda=device.type == "cuda")
    grp = distributed.group()
    rank, ranks = distributed.process_index(), distributed.process_count()
    gb, mcfg = cfg["solver"]["global_batch"], cfg["model"]
    if gb % ranks:
        raise SystemExit(f"a global batch of {gb} over {ranks} ranks")
    per_card, crop = gb // ranks, mcfg["crop_size"]
    pseed = program.program_seed(seed)
    phases.mark("imports and world")
    pools = [deeplab.crop_pool(torch, seed, r, tr["pool"], crop,
                               tr["ignore_band_max"], mcfg["nclass"])
             for r in range(ranks)]
    stream = torch.Generator(device=device)
    stream.manual_seed((int(seed) * 8 + WEIGHT_STREAM) % 2 ** 63)
    seeded = deeplab.weights(torch, ref.spec(mcfg), device, stream)
    phases.mark("crops and weights")
    trainer = make_trainer(cfg, pseed, device, seeded, grp, control)
    if device.type == "cuda":  # the peak from here on is the program's
        torch.cuda.reset_peak_memory_stats(device)
    phases.mark("trainer")
    mine = pools[rank]
    record = harness.Record(cell, counters={"samples_per_unit": per_card})

    def step_at(k):
        return trainer.step(*deeplab.pool_batch(mine, per_card, k))

    # set-up: the start step (compared), an eager step, the capture with
    # its first replay, a replay alone
    start_before = {k: v.detach().cpu() for k, v in seeded.items()}
    counted = [collective_calls(distributed)]
    loss, _ = step_at(0)
    start_loss = float(loss)
    start_after, start_moms = read_state(trainer)
    counted.append(collective_calls(distributed))
    for k in range(1, SETUP_STEPS):
        step_at(k)
        counted.append(collective_calls(distributed))
    held = captured(trainer)
    if held is not None:
        record.counters["collectives_per_step"] = held[0]
        record.counters["collective_bytes_per_step"] = held[1]
    if counted[0] is not None:
        print("allreduces_by_setup_step " + json.dumps(
            [b - a for a, b in zip(counted, counted[1:])]), file=sys.stderr)
    step = SETUP_STEPS
    setup_s = time.perf_counter() - t0
    phases.mark("set-up steps")
    # the window starts together on every rank
    world.agree(False, AGREE_S)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    p_at = m_at = m_end = -1
    if trace:
        p_at = tr["trace_lead"]
        m_at = p_at + tr["trace_settle"]
        m_end = m_at + tr["trace_steps"]
    series = torch.zeros((1 << 17,), device=device)
    prof = mark = None
    k = traced = 0
    start = time.perf_counter()
    while True:
        if k == p_at:
            prof = tracing.profiler(torch, device)
            prof.__enter__()
        if k == m_at:
            if device.type == "cuda":  # the stretch starts on an empty queue
                torch.cuda.synchronize(device)
            mark = torch.profiler.record_function(STRETCH)
            mark.__enter__()
        loss, _ = step_at(step)
        series[k % len(series)].copy_(loss)
        step += 1
        k += 1
        if mark is not None:
            traced += 1
            if k == m_end:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                mark.__exit__(None, None, None)
                mark = None
                prof.__exit__(None, None, None)
                record.stretch = tracing.Stretch(
                    tracing.from_profiler(prof), traced)
                print("nccl_kernels_per_step " + json.dumps(
                    deeplab.nccl_launches_per_unit(record.stretch)),
                    file=sys.stderr)
        if k % tr["agree_every"] == 0:
            done = (time.perf_counter() - start >= seconds
                    and (not trace or k >= m_end))
            if world.agree(done, AGREE_S):
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window = time.perf_counter() - start
    losses = series[:min(k, len(series))].cpu()
    failed = int((~torch.isfinite(losses)).sum())
    # the window's check: one replay from the state after its last step
    window_before, window_moms = read_state(trainer)
    loss, _ = step_at(step)
    window_loss = float(loss)
    window_after, window_after_moms = read_state(trainer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del trainer, loss
    distributed.shutdown()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phases.mark("window")
    checks = []
    for tag, at, before, moms, loss_v, after, after_moms in (
            ("start", 0, start_before, None, start_loss, start_after,
             start_moms),
            ("window", step, window_before, window_moms, window_loss,
             window_after, window_after_moms)):
        want = follow(torch, ref, cfg, pools, pseed, ranks, per_card, at,
                      before, moms, device)
        gaps = dict(zip(NAMES, readings(tag, ref, cfg, rank, per_card, want,
                                        before, loss_v, after, after_moms)))
        checks += [(f"{tag}_{n}", gaps[n]) for n in COMPARED[tag]]
        del want
    phases.mark("check")
    phases.report()
    # every rank hands over its outcome only once rank 0 has its own: the
    # world's watchdog takes a rank that has ended before then, whose exit
    # code it may read before the process is reaped, for a failed one
    world.agree(False, AGREE_S)
    return harness.Outcome(
        {"train_samples_per_s": k * gb / window}, attempted=k,
        failed=failed, compared=checks, memory_peak_bytes=peak,
        record=record, setup_s=setup_s)

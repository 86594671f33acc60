"""Traffic runner ``fit_epochs``: the decoder's training, the wait of every
Retrain and of ``main.py train``.

The program under test is ``SegSolver``'s graphed epochs
(``_graphed_epochs``: each step one replay of the train step's CUDA graph,
the collection resident on the card, the host waiting once an epoch for
its (loss, accuracy) series), handed the collection as ``chip_smoke.py::
graph_fit_runner`` hands it, with the benchmark's own collection in place
of the pickles on disk.  The collection is made at set-up from the seed by
the benchmark's plain generator (the reference, f32) on the card, in one
call: each sample its full feature pyramid, its mask the sign of the last
level's channel 0 (``tests/util_fixtures.py::mask_rule``) with its first
``ignore_rows`` rows ignored (-1), as the fixture's annotation border.
Set-up runs the first epoch (the eager steps, the capture, the first
replays) and epochs until one has run on replays alone; the window runs
epochs back to back until its seconds have passed.

Traffic parameters (``traffic/<name>.json``): ``collection`` (samples),
``ignore_rows``, and ``trace_lead`` / ``trace_settle`` / ``trace_epochs``
(with ``--trace 1``: epochs of the window before the profiler starts,
under it before the profiled stretch, and in the stretch).

End-to-end: ``train_samples_per_s`` (steps x batch completed in the
window over its seconds).  Counter: ``samples_per_unit`` (the batch).

Compared, with the program's state read only between two epochs (once
an epoch's series is on the host): the ``start`` epoch, the set-up's
first, which the reference follows from the seeded weights; and the
``window`` epoch, one of the window's drawn from the seed after the
profiled stretch, which the reference follows from the program's
parameters and Adam moments before it (the step count is the
benchmark's).  Both over the same samples, labels, dropout draws and
rate.  For each: ``loss_gap``, the largest relative gap of a step's loss
(of the start epoch, its first step's: from Adam's first updates on,
sound runs and the TF32 control drift apart alike);
``moment_gap``, Adam's first moment after the epoch (the gradients as
Adam got them), the largest over leaves of the gap between the norms of
the program's and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf; ``change_gap``, the same for
each leaf's change over the epoch, leaving out the leaves whose
reference gradient at the epoch's first step is under a thousandth of
the median leaf's (they move by round-off alone under Adam).

Controls and faults (``--control``), put in the program's place, no
window, the f32 reference's state after the first epoch standing in for
the program's before the second: ``tf32``, the reference in TF32 (the
precision below the configuration's f32 with TF32 off); ``half``, the
reference whose loss takes the mean over the top half of each image's
rows only.
"""

import json
import random
import sys
import tempfile
import time

import numpy as np

from gsbench import harness, program, weights
from gsbench import trace as tracing
from gsbench.trace import STRETCH

CONTROLS = ("tf32", "half")
# the window's checked epoch: drawn from the seed among this many epochs
# after the profiled stretch (a 40 s window holds about 90)
CHECK_SPAN = 16
NAMES = ("loss_gap", "moment_gap", "change_gap")
START_LOSS_STEPS = 1


def make_collection(torch, ref, cfg, tr, seed, device):
    """(feature pyramids: per level (S, h, w, c) f32 NHWC, masks (S, H, W)
    int8) on ``device``, from the seed, by the plain generator."""
    gan = cfg["pyramid"]["gan"]
    gw = weights.generator_weights(gan, seed, device)
    g = weights.generator(seed, "inputs", device)
    n, top = tr["collection"], gan["max_res_log2"]
    z = torch.empty((n, gan["latent_size"]), device=device)
    z.normal_(generator=g)
    noise = {}
    for r in range(2, top + 1):
        s = gan["base"] * 2 ** r // 4
        for j in (1, 2):
            t = torch.empty((n, s, s, 1), device=device)
            noise[f"block_{r}.noise_{j}"] = t.normal_(generator=g)
    with torch.no_grad(), ref.full_precision():
        _, fs = ref.generator_forward(gw, gan, z, noise)
    masks = (fs[-1][:, 0] > 0).to(torch.int8)
    masks[:, :tr["ignore_rows"]] = -1
    feats = [f.permute(0, 2, 3, 1).contiguous() for f in fs]
    return feats, masks


def epoch_order(pseed, n, epoch):
    """The samples of ``epoch``'s steps at batch 1, as the program orders
    them: ``RandomState(seed + epoch)``'s shuffle of 0..n-1."""
    order = np.arange(n)
    np.random.RandomState(pseed + epoch).shuffle(order)
    return order


def epoch_batches(torch, cfg, seed, pseed, feats, masks, epoch, first,
                  device):
    """The steps of ``epoch`` as (NCHW features, labels, dropout draws),
    the epoch's first step being step ``first`` of the run: the dropout
    draws made from the seed's dropout stream in the program's order and
    shapes, the ``first`` steps' draws before them drawn and dropped."""
    dec = cfg["decoder"]
    g = weights.generator(seed, "dropout", device)
    shapes = [(1, *feats[lvl].shape[1:3], dec["features"][lvl])
              for lvl in range(dec.get("start_res", 0), len(feats))]
    scratch = [torch.empty(s, device=device) for s in shapes]
    for _ in range(first):
        for u in scratch:
            u.uniform_(0.0, 1.0, generator=g)
    del scratch
    out = []
    for i in epoch_order(pseed, len(masks), epoch):
        i = int(i)
        u = [torch.empty(s, device=device).uniform_(0.0, 1.0, generator=g)
             for s in shapes]
        out.append(([f[i:i + 1].permute(0, 3, 1, 2) for f in feats],
                    masks[i:i + 1].long(), u))
    return out


def gap_of_norms(got, want, leaves):
    """(the largest over ``leaves`` of |‖got‖ - ‖want‖| over the larger of
    ‖want‖ of the leaf and of the median leaf, that leaf)."""
    norms = {k: float(want[k].norm()) for k in want}
    med = float(np.median(list(norms.values())))
    worst, at = 0.0, None
    for k in leaves:
        g = float(got[k].norm())
        gap = abs(g - norms[k]) / max(norms[k], med, 1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def readings(tag, ref_run, before, losses, moment, after, loss_steps=None):
    """(loss_gap, moment_gap, change_gap) of an epoch against the
    reference's run over it (``train_steps``' result) from the parameters
    ``before``: the epoch's losses (the first ``loss_steps`` compared, all
    by default), Adam's first moment and the parameters after it, by leaf.
    Each step's loss gap, the leaves that set the last two, and how many
    were left out of the change, go to standard error."""
    ref_losses, ref_grad, ref_after, (ref_moment, _) = ref_run
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    loss_gap = (max(gaps[:loss_steps]) if len(losses) == len(ref_losses)
                else float("inf"))
    moment_gap, m_at = gap_of_norms(moment, ref_moment, list(ref_moment))
    gnorm = {k: float(v.norm()) for k, v in ref_grad.items()}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k in ref_grad if gnorm[k] >= 1e-3 * med]
    want = {k: ref_after[k] - before[k] for k in moving}
    got = {k: after[k] - before[k] for k in moving}
    change, c_at = gap_of_norms(got, want, moving)
    print(f"gap leaves {tag} " + json.dumps({
        "moment": m_at, "change": c_at,
        "left_out_of_change": len(ref_grad) - len(moving),
        "loss_gaps": ["%.3g" % g for g in gaps]}), file=sys.stderr)
    return loss_gap, moment_gap, change


def named_checks(start, window):
    return ([(f"start_{n}", v) for n, v in zip(NAMES, start)]
            + [(f"window_{n}", v) for n, v in zip(NAMES, window)])


def read_state(named, opt):
    """(parameters, (Adam's first moment, second moment)) by leaf, copied:
    read between two epochs, once the first's series is on the host."""
    return ({k: p.detach().clone() for k, p in named},
            ({k: opt.state[p]["exp_avg"].detach().clone() for k, p in named},
             {k: opt.state[p]["exp_avg_sq"].detach().clone()
              for k, p in named}))


def follow(ref, cfg, batches, params, moments, done, control=None):
    """``train_steps`` of the reference over ``batches`` from ``params``
    and ``moments`` after ``done`` steps, in f32 with TF32 off, or as the
    control ``control``."""
    dec, lr = cfg["decoder"], cfg["solver"]["base_lr"]

    def half_loss(logits, labels):
        h = labels.shape[1] // 2
        return ref.loss(logits[:, :, :h], labels[:, :h])

    with ref.precision(control == "tf32"):
        return ref.train_steps(
            params, dec, batches, lr, moments=moments, done=done,
            loss_fn=half_loss if control == "half" else ref.loss)


def control_run(torch, ref, cfg, seed, feats, masks, dw, device, control):
    """The readings of a control or fault put in the program's place, over
    the first epoch from the seeded weights and over the second from the
    f32 reference's state after the first."""
    pseed = program.program_seed(seed)
    n = len(masks)
    out, params, moments = [], dw, None
    for epoch in (0, 1):
        batches = epoch_batches(torch, cfg, seed, pseed, feats, masks, epoch,
                                epoch * n, device)
        want = follow(ref, cfg, batches, params, moments, epoch * n)
        got = follow(ref, cfg, batches, params, moments, epoch * n, control)
        out.append(readings(("start", "window")[epoch], want, params, got[0],
                            got[3][0], got[2],
                            (START_LOSS_STEPS, None)[epoch]))
        params, moments = dict(dw, **want[2]), want[3]
    return named_checks(*out)


def replayed(run_epoch, device):
    """Whether the train step's graph has replayed (always, off a card,
    where nothing is captured)."""
    return device.type != "cuda" or run_epoch.call.replays > 0


def run(cell, seed, seconds, trace, device, t0, control=None):
    import torch

    cfg, tr = cell.config, cell.traffic
    if control is not None and control not in CONTROLS:
        raise SystemExit(f"unknown control {control!r}: {CONTROLS}")
    # the configuration's precision: f32 with TF32 off (cuDNN's wgrad too)
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    phases = harness.Phases(t0, device)
    ref = harness.load_reference(cfg)
    program.build_kernels(device)
    phases.mark("imports and kernel library")
    feats, masks = make_collection(torch, ref, cfg, tr, seed, device)
    if device.type == "cuda":  # the peak from here on is the program's
        torch.cuda.reset_peak_memory_stats(device)
    phases.mark("collection")
    dec = cfg["decoder"]
    dw = weights.decoder_weights(dec, seed, device)
    pseed = program.program_seed(seed)
    record = harness.Record(cell, counters={
        "samples_per_unit": cfg["solver"]["train_batch_size"]})
    names = ref.trainable(dw)
    if control is not None:
        checks = control_run(torch, ref, cfg, seed, feats, masks, dw, device,
                             control)
        return harness.Outcome({}, 0, 0, checks, 0, record,
                               setup_s=time.perf_counter() - t0)
    solver = program.solver(torch, cfg["pyramid"]["gan"]["max_res_log2"],
                            dec, cfg["solver"], pseed, device,
                            tempfile.gettempdir(), dw)
    n = len(masks)
    opt, lr = solver._make_optimizer(n // solver.cfg.train_batch_size,
                                     graphed=True)
    solver.model.train()
    run_epoch = solver._graphed_epochs(
        opt, lr, (feats, masks), weights.generator(seed, "dropout", device))
    named = [(k, p) for k, p in solver.model.named_parameters()]
    if sorted(k for k, _ in named) != sorted(names):
        raise RuntimeError("the program's trainable leaves differ from the "
                           "benchmark's")
    phases.mark("weights and solver")
    first = run_epoch(0, 0).cpu()
    start_losses = first[:, 0].tolist()
    start_after, (start_moment, _) = read_state(named, opt)
    step, epoch = len(first), 1
    # epochs until one has run on replays alone
    while True:
        ready = replayed(run_epoch, device)
        step += len(run_epoch(epoch, step).cpu())
        epoch += 1
        if ready:
            break
    steps, failed, k, traced = 0, 0, 0, 0
    prof = mark = None
    # with --trace 1: the profiler starts, the stretch starts once an epoch
    # has run under it, and both stop after the stretch (epoch counts)
    lead_end = tr["trace_lead"] + tr["trace_settle"] + tr["trace_epochs"]
    p_at = m_at = m_end = -1
    if trace:
        p_at = tr["trace_lead"]
        m_at = p_at + tr["trace_settle"]
        m_end = lead_end
    # the checked epoch lies after the stretch, also without --trace
    check_at = lead_end + random.Random(seed).randrange(CHECK_SPAN)
    checked = None
    setup_s = time.perf_counter() - t0
    phases.mark("first epochs")
    start = last = time.perf_counter()
    epoch_s = []
    while True:
        if k == p_at:
            prof = tracing.profiler(torch, device)
            prof.__enter__()
        if k == m_at:
            mark = torch.profiler.record_function(STRETCH)
            mark.__enter__()
        if k == check_at:
            before = read_state(named, opt)
        with torch.profiler.record_function("gsbench.epoch"):
            rows = run_epoch(epoch, step).cpu()
        now = time.perf_counter()
        epoch_s.append(now - last)
        last = now
        if k == check_at:
            after, (moment, _) = read_state(named, opt)
            checked = (epoch, step, before, rows[:, 0].tolist(), moment,
                       after)
        steps += len(rows)
        failed += int((~torch.isfinite(rows[:, 0])).sum())
        step += len(rows)
        epoch += 1
        k += 1
        if mark is not None:
            traced += len(rows)
        if k == m_end:
            mark.__exit__(None, None, None)
            mark = None
            prof.__exit__(None, None, None)
            record.stretch = tracing.Stretch(tracing.from_profiler(prof),
                                             traced)
        if now - start >= seconds and k > check_at and (not trace
                                                        or k >= m_end):
            break
    window = now - start
    q = np.quantile(epoch_s, [0.0, 0.05, 0.5, 0.95, 1.0])
    print("epoch_s min p5 median p95 max " + json.dumps(
        [round(float(x), 5) for x in q]), file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del solver, run_epoch, opt, named
    # the reference: the start epoch from the seed, the checked epoch from
    # the program's state before it
    batches = epoch_batches(torch, cfg, seed, pseed, feats, masks, 0, 0,
                            device)
    start_gaps = readings("start", follow(ref, cfg, batches, dw, None, 0),
                          dw, start_losses, start_moment, start_after,
                          START_LOSS_STEPS)
    c_epoch, c_step, (c_params, c_moments), c_losses, c_moment, c_after = \
        checked
    batches = epoch_batches(torch, cfg, seed, pseed, feats, masks, c_epoch,
                            c_step, device)
    window_gaps = readings(
        "window", follow(ref, cfg, batches, dict(dw, **c_params),
                         c_moments, c_step),
        c_params, c_losses, c_moment, c_after)
    phases.mark("window and check")
    phases.report()
    batch = cfg["solver"]["train_batch_size"]
    return harness.Outcome(
        {"train_samples_per_s": steps * batch / window}, attempted=steps,
        failed=failed, compared=named_checks(start_gaps, window_gaps),
        memory_peak_bytes=peak, record=record, setup_s=setup_s)

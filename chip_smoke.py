#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``gan_segmentation_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device  — requires CUDA; prints torch, the capability, the card's name and
   power limit (nvidia-smi).
2. build   — compiles the CUDA kernels of ``gan_segmentation_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints ptxas's registers and
   spills; every tensor-core kernel (``conv3x3_tc.cuh``, bf16 and s8;
   ``conv3x3_tf32.cuh``, 3xTF32; ``conv3x3_sm90.cuh``, bf16, s8 and f32 as
   3xTF32) must spill 0 bytes, every s8 Hopper-body tile ``tc_plan.plan_s8``
   and every tf32 one ``tc_plan.plan_tf32`` and ``plan_tf32_in_stats``
   (kernel 1, entry 9) can return must be built, and the wide Hopper tiles
   must launch with 168 registers.
3. kernels — each kernel against its plain PyTorch version, with the error
   and the tolerance, and per call its device time by CUDA-graph replay
   beside the plain version's, ``F.conv2d`` alone (the library call) and
   the floor (bytes once over HBM or operations over the type's peak; f32
   as 3xTF32): kernel 1 at every shape the ffhq 1024^2 generator gives it
   at batch 8, in f32 (TF32 off on the plain side; on the rule's body, the
   tf32 Hopper body's entry 9 wherever ``tc_plan.plan_tf32_in_stats`` takes
   the call, and on the mma.sync 3xTF32 body, both held to plain and
   timed, the rule's repeats and graph replays bit-identical) and bf16,
   both timed;
   kernel 2 at every decoder conv at batch 8 in f32 and bf16 (bf16 timed)
   and at batch 1 in f32 (evaluate, timed on both f32 bodies: the rule's,
   the tf32 Hopper body wherever ``tc_plan.plan_tf32`` takes the call, and
   the mma.sync 3xTF32 body, ``mma_sync_tf32_body``); kernel 3 (bil_conv)
   in f32 at every call of a train step at batch 1 (forward and input
   gradient) on both f32 bodies, timed beside ``F.conv2d`` with TF32 on
   too, and at its edge cases, with bit-identical repeats; how wgmma
   rounds the f32 accumulator at the longest chain and at a split kernel-1
   call (``tf32_rounding``: against truncating and round-to-nearest
   emulations); kernel 3's bf16
   body at generate's 16 -> 16
   convs at batch 8; Conv3x3's output, dX, dW and db against
   torch.autograd at every train shape.  Kernels 1 and 2 run the bf16
   tensor-core kernel in bf16 and the 3xTF32 ones in f32; both are also
   checked at their edge cases (4^2 tiles spanning images with Cin 512 and
   split-K, ragged tiles, Cout = 2, Cin = 3, batch 1; kernel 2 with its
   three epilogues, kernel 1 with its statistics; bf16 and f32 on both
   bodies) and for bit-identical repeats; every f32 path shape that splits
   K is timed beside one split.
4. generate — ``run_generate`` at ffhq 1024^2, batch 8, 24 pairs, with a
   seeded random generator and a seeded decoder checkpoint; a device trace
   must show that it went through kernels 1 and 2; a repeated
   batch must be bit-identical; a small slice on the card must agree with
   the same slice on the CPU (plain versions); samples/s beside the
   generator's and the decoder's stage times per batch (CUDA events).
4b. int8  — int8 generation (``generate --quant``) at ffhq 1024^2, batch 8,
   bf16, after the generate-as-graphs checks: each s8 entry of kernels 1
   and 2 at every s8 3x3 shape of an int8-full batch (split-K ones among
   them), on the Hopper body the rule picks and on the mma.sync s8 body
   (``mma_sync_s8_body``) on the same inputs, equals the exact integer
   product bit for bit (deq 1, f32 out), and with real scales, bias, noise
   and activation gives y bit-equal between the bodies and to its plain
   twin (kernel 1's statistics within ``STAT_TOL``), repeats and graph
   replays bit-identical; the s8 edge cases on both bodies (phase 3); the
   quantize pass equals its twin (ties at .5, saturation); device times of
   both bodies beside the bf16 Hopper body on the same shapes and the
   bound at 1,979 int8 TOPS; ``FusedPipeline(quant="int8" |
   "int8-full")`` with seeded random weights as CUDA graphs equal to the
   eager path bit for bit, a replay repeated equal to itself, the s8
   kernels' launches traced, every one on the Hopper body, batches against
   the same z and noise with the s8 calls on the mma.sync body (int8 bit
   for bit, int8-full's logits within bf16's own distance from f32), masks
   and image against the bf16 pipeline on the same z and noise (each mode
   held just under its repeatable reading, ``INT8_MIN_AGREEMENT``),
   samples/s of the three in turns; ``run_generate(quant="int8")`` and
   ``--resume`` byte-identical, ``quant="int8-full"`` alone and with
   ``dp=2`` (two replicas on the one card).  Prints a ``{"int8": ...}``
   line before the kernels'.
4c. spatial — ``generate --spatial`` (``phase_spatial``, after 4b): the
   row-band forms of kernels 1 and 2 against their plain twins at every
   band shape of the grids below, bf16 and f32, repeats bit-identical, and
   each band call's device time beside F.conv2d on the same band and its
   bound; ``FusedPipeline(mesh=grid)`` at ffhq 1024^2, batch 8, bf16, on
   grids that repeat the one card (N = 2 and 4, and 2 x 2), eager, its
   launches traced, held to the one-device pipeline as ``check_bf16_slice``
   holds a bf16 slice, with samples/s and batch-1 latency beside the
   one-device eager and graph paths; a grid bundle served from a fresh
   interpreter equal to the live grid pipeline, and a ``--platforms
   cpu,cuda`` artifact exported on the CPU served on the card equal to one
   exported there (ffhq cut to 64^2).  Prints a ``{"spatial": ...}`` line.
5. train   — three fit steps at res 32 on the card agree with the CPU; then
   ``main train`` and ``main evaluate`` at ffhq 1024^2 with the defaults
   (24 epochs, batch 1, Adam 1e-4, dropout on) on 20 + 4 samples of the
   seeded f32 generator (kernel 1 in f32, 9 launches per batch of 8,
   counted by body in its device trace):
   ``main train`` runs each step as a replay of a CUDA graph, once timed
   and once traced for its launch counts per step; falling loss,
   checkpoint, metrics above the untrained decoder's; the fit loop's rate,
   the step time by CUDA events, host vs device time, and the device time
   by kernel family, eager and as replays, the replays also with the f32
   calls on the mma.sync 3xTF32 body; a 2-epoch graphed fit equal to
   the per-step fit bit for bit in cuDNN's deterministic mode.
5b. export — the serving export (``core/export.py``) of the decoder that
   phase 5 trained, with the seeded ffhq generator, bf16, batch 8: the
   artifact and the bundle (export seconds, file sizes); the bundle served
   in a fresh interpreter that imports only ``core.export``, batches 0-3
   from a seed bit-identical to ``FusedPipeline.sample_batch`` from that
   seed; both forms served here as CUDA-graph replays under a device
   trace (9 + 26 launches of kernels 1 and 2 a replay); served samples/s
   beside the live pipeline's in turns; the DeepLab evaluator (DeepLabV3+
   resnet50, crop 480, base 512, flip) exported at 1x512x512x3 and served
   here: equal to the live ``device_scores_batch`` in cuDNN's
   deterministic mode, ms per image beside it (TF32 convs).
6. foreign weights — a seeded ffhq generator written as a synthetic
   mxnet-format ``stylegan-ffhq.params`` (the reference's names and
   layouts) and loaded by ``ImageGenerator``: a batch of 8 bit-identical
   to the source generator's; a decoder written as a dotted-name mxnet
   ``checkpoint_last.params`` and loaded by ``SegSolver.load``: logits
   equal to the source decoder's; file sizes and load times.
7. annotation — ``SegmentationAnnotator`` at ffhq 1024^2 driven through
   its own handlers under a stub ``tkinter`` / ``PIL.ImageTk`` (the card's
   machine has no display): Generate disabled at first, 6 annotations
   saved by the handlers (trimap from the sample's own features), Retrain
   (2 epochs: previews, falling loss, last preview = predict, buttons),
   Generate of 16 pairs whose masks equal a fresh pipeline's on the saved
   checkpoint, a pipeline built before Retrain refolded, launch counts by
   stage (kernel 1 in the sampler, kernel 2 in predict, kernels 2 and 3
   in Retrain), wall time of Retrain and of Generate.
8. deeplab — the DeepLab stack (``models/{resnet,resnext,deeplab}.py``,
   ``ops/{resize,losses,norm}.py``, ``train/deeplab_trainer.py``), which
   launches no hand-written kernel (the JAX package computes it outside any
   Pallas kernel; its convs are ``F.conv2d``).  Small, card against CPU in
   f32: DeepLabV3+ on resnet50 at 2x96x96 with seeded weights and
   randomised running statistics (eval outputs, one ``train_step`` without
   dropout: loss, named gradients, running statistics), DeepLabV3 and
   SE-ResNeXt-50 eval forwards, the seven losses.  Full width, the
   experiment's configuration (DeepLabV3+ on dilated resnet50_v1s, 2
   classes, aux weight 0.5, crop 480, batch 8, SGD 0.9, poly rate from
   0.005, weight decay 2e-4, head rate x10), f32 with cuDNN's TF32 convs
   as PyTorch's default has them: eval forward in f32 and bf16 (ms per
   batch, bf16 logits against f32 logits; exact f32 timed once beside
   them), 12 ``train_step``s on
   one seeded batch in f32 and in bf16 with dropout (falling loss, finite
   gradients, the two rates on the poly curve, ms per step, peak memory,
   a repeated run's losses), the step's host and device time by kernel
   family, a step with the batch norm written out beside the fused one;
   the step as a CUDA graph (``GraphedTrainStep``): 6 graphed steps (2
   eager warm-ups, the capture, 3 replays) equal to 6 eager steps with the
   same optimizer bit for bit in cuDNN's deterministic mode, f32 (TF32
   convs) and bf16, then graph beside eager per step (ms
   by CUDA events, host enqueue, busy share, launches in the device trace,
   the memory the graph keeps).  Loaded weights: a dotted-name DeepLabV3+
   file and a
   legacy-name gluoncv backbone file, fabricated in mxnet's format from a
   seeded model, load bit-identically and give the source's eval forward.
9. step 5 — the experiment ``01_hair_deeplabv3_ffhq_pretrain_gan`` through
   the port's runner (``train/rgb_experiments.py::run``), which launches
   no hand-written kernel of its own: ``run_generate`` writes 32 pairs at
   ffhq 1024^2 (phase 4's seeded generator and decoder, cv2 writer) and
   generator seed 1 writes 8 more as the val split (synthetic: the
   repository holds no real annotated data); ``train`` at the spec's crop
   480, base 512, scale factor 0.5, rotate 15, DeepLabV3+ on resnet50, f32
   with cuDNN's TF32 convs, batch 8, 2 epochs of 128 draws, each step a
   replay of the trainer's CUDA graph, 4 decode processes: a validation
   line (validation as graph replays) and a checkpoint per epoch, finite
   losses, the rates on the poly curve; the trainer's loop ms per step
   with its 4 decode processes and with one decode thread (two epochs
   each, alternated) beside the feed alone (``batch_iter``, no model, one
   thread, 4 and 7 processes, two rounds) and the bare step on a resident
   batch (graph and eager); a
   second run stopped by SIGTERM after step 3 (bundle,
   no ``.tmp``, ``try_resume`` restoring weights, momentum, scheduler and
   dropout generator bit-equal) and continued with ``--resume`` to the
   uninterrupted run's step and epoch; ``test`` with flip at test batch 2
   on the sliding-window path (one model call per bucket of 16 windows,
   each bucket a replay of its graph), images/s and both metrics;
   ``MultiEvalModel`` on the card against the CPU (tiny backbone, crop 32,
   base 48, scales 0.75 and 1.0, TF32 off).
10. demo — ``gan_segmentation_tpu_torch/examples/full_pipeline_demo.py``
   at bedrooms 256^2 (all 8 levels; 12 fixture annotations, decoder fit of
   10 epochs and evaluation, 96 + 12 generated pairs, DeepLabV3+ resnet50
   at crop 256 for 2 epochs of 64 draws through its graphed step, and
   validation) under a device trace: kernels 1, 2 and 3 all run, and the
   trace's counts equal the wrappers' counts plus the replays.
11. scale-out — (a) this process alone in an NCCL group, passed
   explicitly: the DeepLab step of phase 8 (f32, TF32 convs) with batch
   norm over the group and the gradient all-reduce captured in its CUDA
   graph, 6 graphed steps equal to 6 eager ones bit for bit in cuDNN's
   deterministic mode, ms per step as replays with and without the
   group, NCCL's kernels per step, the fused global batch norm against
   the written-out one; the decoder fit at ffhq 1024^2 (4 samples, 2
   epochs, graphed) with the group under a device trace (kernels 2 and 3)
   against the fit without it; ``generate --dp 2``'s machinery on the one
   card (two replicas, batch 8 = 4 + 4): against one device its
   differences recorded, against the one-device program on each half of
   the same inputs bit for bit.  (b) Two processes on the one card: first
   whether NCCL refuses two ranks on one device; then over gloo, eager,
   through the runner's spawn entry: the decoder fit at global batch
   2 = 1 + 1 against one process at batch 2, the experiment runner's
   DeepLab training (global batch 8 = 4 + 4, one epoch of 2 steps) with
   one run dir and the primary's checkpoint, its validation over a ragged
   set of 5 against that checkpoint validated in one process (equal
   confusion counters), and ``generate`` of 16 ffhq 1024^2 pairs per
   process, each process's files byte-equal to one process with its seed.
   Prints a ``{"scale_out": ...}`` line before the kernels' line.

Not in the default run (it needs one card): ``phase_multi_card`` on a
machine with several cards — ``generate --dp N`` over them against the
one-device program on each part, with four cards or more ``generate
--spatial 4`` and ``--spatial 2 --dp 2`` on the first four (held to one
device as in phase 4c) and the 2 x 2 grid's bundle served from a fresh
process on them, then one process per card over NCCL (the
decoder fit, the DeepLab step as replays beside one card's, the runner's
graphed training and ragged validation, ``generate``'s slices), each
against one process:
``python3 -c "import chip_smoke as c, torch; from
gan_segmentation_tpu_torch.kernels import _build; _build.build_library();
torch.backends.cudnn.allow_tf32 = False; c.phase_multi_card(torch,
c.smi_line()); assert not c.FAILED"``.

Launch counts: every run of a main path that the script counts runs
under ``LaunchTrace``, which sets the wrappers' counters to 0, traces the
device and counts each kernel's runs by name (the card's count, replays of
CUDA graphs included), and holds that count to the wrappers' own counts
(eager launches and the launches a capture records) plus the replays.

The last lines are the kernels' JSON record (per kernel, the s8 bodies and
the quantize pass included: launches on the main path, max error, device
ms of the kernel, its plain version and the library call, and its bound),
the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from os.path import join

BATCH = 8
GENERATE_NUM = 24
REPS = 10
TRAIN_BATCH = 1          # SolverConfig.train_batch_size
TRAIN_SAMPLES = 20       # the reference protocol's ~20 annotations
EVAL_SAMPLES = 4
# kernel launches of one train step at ffhq width, batch 1 (counted from
# models/decoder.py and kernels/conv3x3_grad.py): kernel 3 runs the 21
# forward convs inside its contract (cvt_5..8, main_0..7 conv_0 / conv_1,
# main_8_conv) and the input gradients of the 17 convs after the cvt_i;
# kernel 2 runs the 5 forward convs with Cin 512 / 256 (cvt_0..4)
BIL_PER_STEP = 21 + 17
SMALL_PER_STEP = 5
SMALL_PER_EVAL_SAMPLE = 26  # eval mode: every 3x3 conv, BN folded


def log(*args):
    print(*args, flush=True)


# failed checks that let the script run on to its end first (so that one
# run reads every phase); main raises on any of them before its last lines
FAILED = []


def check_later(ok, message):
    if not ok:
        log(f"FAILED (raised at the end): {message}")
        FAILED.append(message)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(path, registers=None):
    """ptxas -v's report: registers per kernel (printed, and into the dict
    ``registers`` where given) and {mangled kernel name: (spill store
    bytes, spill load bytes)}."""
    spills, name = {}, None
    with open(path) as fh:
        for line in fh:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name is not None:
                spills[name] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name is not None and registers is not None:
                registers[name] = int(m.group(1))
            if "registers" in line:
                log(f"  ptxas: {name}: {line.strip()}")
    return spills


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def captured(fn, reps: int = 1):
    """-> (a CUDA graph of ``reps`` calls of ``fn``, the last call's
    outputs), after a warm-up call on a side stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            outs = fn()
    return graph, outs


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, after a warm-up call
    outside the graph.  The host's time per call (the wrappers' ctypes and
    checks, 30-180 us) is not in it."""
    import torch
    graph, _ = captured(fn, reps)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


# ------------------------------------------------------ counting launches
# A wrapper call launches one device kernel of its own (and with split-K a
# finish kernel, not counted here).  The tensor-core kernels carry the
# number of the entry point that launches them as their last template
# argument (4 and 5: kernels 1 and 2's s8 bodies, 6 and 7 their row-band
# forms, 8 and 9 kernels 2 and 1's f32 forms of the Hopper body); kernel
# 3's bf16 body and the quantize pass are kernels of their own (and so is
# entry 9's K-major tap layout, tf32_taps_kernel, not counted either).
KERNEL_NUMBERS = {"1": "conv_in_stats", "2": "small_conv", "3": "bil_conv",
                  "4": "conv_in_stats_s8", "5": "small_conv_s8",
                  "6": "conv_in_stats_rows", "7": "small_conv_rows",
                  "8": "small_conv", "9": "conv_in_stats"}
S8_KERNELS = ("conv_in_stats_s8", "small_conv_s8", "quantize_s8")


def kernel_of(name):
    """The hand-written kernel (1-3, by name; the s8 bodies and the quantize
    pass of int8 generation; the row-band forms of generate --spatial) a
    device kernel is, or None."""
    m = re.search(r"conv3x3_(?:tc|tf32|sm90)_kernel<[^>]*,\s*(\d)>", name)
    if m:
        return KERNEL_NUMBERS[m.group(1)]
    if "quantize_s8_kernel<" in name:
        return "quantize_s8"
    return "bil_conv" if "conv3x3_bil_kernel<" in name else None


def body_of(name):
    """The body a tensor-core kernel of kernels 1-3 runs: "sm90" (the bf16
    or s8 Hopper body, conv3x3_sm90.cuh), "sm90_tf32" (its f32 form, entries
    3, 8 and 9), "mma_sync" (conv3x3_tc.cuh: bf16 or s8), "3xtf32"
    (conv3x3_tf32.cuh), else None."""
    if re.search(r"conv3x3_sm90_kernel<[^>]*,\s*[389]>", name):
        return "sm90_tf32"
    for key, body in (("conv3x3_sm90_kernel<", "sm90"),
                      ("conv3x3_tc_kernel<", "mma_sync"),
                      ("conv3x3_tf32_kernel<", "3xtf32")):
        if key in name:
            return body
    return None


# {(kernel, body): launches} over every counted trace of the run
# (LaunchTrace): which body each main path's launches of kernels 1 and 2
# went through
BODY_LAUNCHES = {}


@contextlib.contextmanager
def mma_sync_body():
    """bf16 and s8 kernels 1 and 2 on the mma.sync bodies (conv3x3_tc.cuh)
    inside: the rule's Hopper plan (tc_plan.plan_sm90) swapped out, as
    phase_split_sweep swaps the f32 plan, so that one timing can set the
    two bodies side by side on the same inputs."""
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan
    _build._tc_plan_c.cache_clear()
    try:
        with mock.patch.object(tc_plan, "plan_sm90",
                               lambda *args, **kw: None):
            yield
    finally:
        _build._tc_plan_c.cache_clear()


@contextlib.contextmanager
def mma_sync_tf32_body():
    """The f32 calls of kernels 3, 2 and 1 on the mma.sync 3xTF32 body
    (conv3x3_tf32.cuh) inside: the f32 rules' Hopper plans
    (tc_plan.plan_tf32, and kernel 1's tc_plan.plan_tf32_in_stats) swapped
    out, so that one timing can set the two f32 bodies side by side on the
    same inputs."""
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan

    def clear():
        _build._tc_plan_c.cache_clear()
        _build._bil_plan_c.cache_clear()
    clear()
    try:
        with mock.patch.object(tc_plan, "plan_tf32",
                               lambda *args, **kw: None), \
                mock.patch.object(tc_plan, "plan_tf32_in_stats",
                                  lambda *args, **kw: None):
            yield
    finally:
        clear()


@contextlib.contextmanager
def mma_sync_s8_body():
    """The s8 calls of kernels 1 and 2 alone on the mma.sync s8 body
    inside (tc_plan.plan_s8 swapped for tc_plan.plan(s8=True)); the bf16
    calls keep their body, so that an int8 pipeline's float path (its
    generator under int8, its calibration) runs as outside."""
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan

    def plan_s8(n, h, w, cin, cout, noise=False, aligned=True):
        return tc_plan.plan(n, h, w, cin, cout, noise, s8=True)
    _build._tc_plan_c.cache_clear()
    try:
        with mock.patch.object(tc_plan, "plan_s8", plan_s8):
            yield
    finally:
        _build._tc_plan_c.cache_clear()


def kernel_wrappers(s8=False, rows=False):
    """{kernel: its wrapper}, whose ``launches`` counts its launches; with
    ``s8`` the int8 kernels too, with ``rows`` the row-band forms."""
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import quantize as kqm
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    out = {"conv_in_stats": k1m.conv3x3_noise_bias_lrelu_instats,
           "small_conv": k2m.conv3x3_small, "bil_conv": k3m.conv3x3_bil}
    if s8:
        out.update(conv_in_stats_s8=k1m.conv3x3_noise_bias_lrelu_instats_s8,
                   small_conv_s8=k2m.conv3x3_small_s8,
                   quantize_s8=kqm.quantize_s8)
    if rows:
        out.update(
            conv_in_stats_rows=k1m.conv3x3_noise_bias_lrelu_instats_rows,
            small_conv_rows=k2m.conv3x3_small_rows)
    return out


class ReplayTally:
    """While open, the launches of every ``GraphedCall`` capture and
    replay, by wrapper: a capture records ``deltas`` into its graph (the
    wrappers count them, the card does not run them), a replay runs them.
    ``ran(counts)``: what the card ran, from the wrappers' counts over the
    same span, i.e. their eager launches plus the replays' launches."""

    def __enter__(self):
        from collections import Counter
        from unittest import mock

        from gan_segmentation_tpu_torch.core.graphs import GraphedCall

        self.recorded, self.replayed = Counter(), Counter()
        real = GraphedCall.__call__

        def spy(call):
            fresh, replays = call.graph is None, call.replays
            out = real(call)
            runs = call.replays - replays
            for fn, d in (call.deltas.items() if runs else ()):
                self.replayed[fn] += d * runs
                if fresh:  # this call captured
                    self.recorded[fn] += d
            return out

        self._patch = mock.patch.object(GraphedCall, "__call__", spy)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        return False

    def ran(self, counts):
        return {fn: n - self.recorded[fn] + self.replayed[fn]
                for fn, n in counts.items()}


# kineto keeps a device activity only if it falls inside the profiler's
# window on the host's clock; the card's timestamps, converted to that
# clock, drift from it over a long run, so a kernel that ran right after
# the start or right before the stop can land outside and drop out of the
# trace.  An idle margin on both sides of a counted span keeps its kernels
# well inside.
TRACE_MARGIN_S = 0.1


def trace_margin(torch):
    """Let the card go idle, then wait ``TRACE_MARGIN_S``."""
    torch.cuda.synchronize()
    time.sleep(TRACE_MARGIN_S)


def device_kernel_names(prof):
    """The name of every device kernel run in a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class LaunchTrace:
    """The launches of kernels 1-3 in a span of a main path, as the card
    ran them.  On entry every wrapper's counter is set to 0 and a device
    trace starts (``torch.profiler``, kernels only: CUPTI records each
    kernel node of a replayed CUDA graph).  On exit ``device`` = {kernel:
    its runs in the trace} (by body too, into ``BODY_LAUNCHES``) and
    ``wrapper`` = {kernel: its wrapper's count,
    i.e. eager launches plus the launches each capture recorded}; the exit
    fails unless ``device`` equals what ``ReplayTally`` derives from
    ``wrapper`` and the replays.  ``so_far()`` is that derived count at
    any point inside the span.  Without a card (the tests' CPU rehearsals
    of a phase) nothing is traced and ``device`` is that derived count.
    ``s8``: the int8 kernels are counted too (int8 generation's spans);
    ``rows``: the row-band forms (generate --spatial's spans)."""

    def __init__(self, torch, s8=False, rows=False):
        self.torch = torch
        self.fns = kernel_wrappers(s8, rows)
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        for fn in self.fns.values():
            fn.launches = 0
        self.tally = ReplayTally().__enter__()
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            trace_margin(self.torch)
        return self

    def so_far(self):
        ran = self.tally.ran({fn: fn.launches for fn in self.fns.values()})
        return {k: ran[fn] for k, fn in self.fns.items()}

    def __exit__(self, *exc):
        if self.prof is not None:
            trace_margin(self.torch)
            self.prof.__exit__(*exc)
        self.tally.__exit__(*exc)
        if exc[0] is not None:
            return False
        self.wrapper = {k: fn.launches for k, fn in self.fns.items()}
        expected = self.so_far()
        if self.prof is None:
            self.device = expected
            return False
        self.device = dict.fromkeys(self.fns, 0)
        self.by_body = {}
        for name in device_kernel_names(self.prof):
            k = kernel_of(name)
            if k is not None:
                self.device[k] = self.device.get(k, 0) + 1
                key = (k, body_of(name))
                self.by_body[key] = self.by_body.get(key, 0) + 1
                BODY_LAUNCHES[key] = BODY_LAUNCHES.get(key, 0) + 1
        assert self.device == expected, (
            f"the trace ran {self.device}, the wrappers' counts "
            f"{self.wrapper} with the replays give {expected}")
        return False


# The card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s
# and operations/s by type.  3xTF32 does three TF32 MMAs per f32 product.
HBM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}


def conv_floors(n, h, w, cin, cout, elem, extra_bytes=0):
    """(bytes, FLOP) of one 3x3 conv: x, w and y each moved once (``elem``
    bytes an element) plus ``extra_bytes`` (bias, noise, statistics)."""
    nbytes = elem * (n * h * w * (cin + cout) + 9 * cin * cout) + extra_bytes
    return nbytes, 18 * n * h * w * cin * cout


def bound(nbytes, ops, rate):
    """(least ms, what bounds it) for ``nbytes`` over HBM and ``ops`` at
    ``rate`` operations/s."""
    tb, to = nbytes / HBM_RATE * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def summed_bound(parts):
    """Sum of per-call bounds, and what bounds the larger share of it."""
    total = sum(t for t, _ in parts)
    by_bytes = sum(t for t, by in parts if by == "bytes")
    return total, ("bytes" if by_bytes >= total - by_bytes else "operations")


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def check_close(name, got, want, atol, rtol, extra=0.0):
    """|got - want| <= atol + rtol*|want| + extra, elementwise."""
    import torch
    got, want = got.detach(), want.detach()
    bad = ((got.float() - want.float()).abs()
           > atol + rtol * want.float().abs() + extra)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values outside "
                             f"atol={atol} rtol={rtol} "
                             f"(max abs err {max_err(got, want):.3g})")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")


# Tolerances, kernel vs plain on identical inputs.  f32: both sides sum up to
# 9*512 products in f32 in different orders.  bf16: the kernel rounds its f32
# result to bf16 once; the plain side (cuDNN in bf16) rounds the conv result
# and then the epilogue result, so the two may sit up to ~2 bf16 ulps apart
# (2^-7 relative each).
TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=1.6e-2)}
STAT_TOL = {"f32": dict(atol=1e-4, rtol=1e-3), "bf16": dict(atol=1e-2, rtol=1e-2)}


def kernel1_shapes(gcfg, batch=BATCH):
    """(n, h, w, cin, cout) of conv_2 in every synthesis block."""
    out = []
    for res in range(2, gcfg.max_res_log2 + 1):
        c = gcfg.num_features(res)
        out.append((batch, 2 ** res, 2 ** res, c, c))
    return out


def kernel2_shapes(scfg, batch=BATCH):
    """(name, n, h, w, cin, cout, leaky) of every decoder 3x3 conv."""
    f, cin = scfg.features, scfg.in_channels
    last = len(cin) - 1
    out = []
    for i in range(last + 1):
        r = 2 ** (i + 2)
        out.append((f"cvt_{i}", batch, r, r, cin[i], f[i], True))
        c_in = f[i] * (2 if i > 0 else 1)
        if i < last:
            out.append((f"main_{i}.conv_0", batch, 2 * r, 2 * r, c_in,
                        f[i + 1], True))
            out.append((f"main_{i}.conv_1", batch, 2 * r, 2 * r, f[i + 1],
                        f[i + 1], True))
        else:
            out.append((f"main_{i}_conv", batch, r, r, c_in, f[i + 1], False))
    return out


def train_conv_shapes(scfg):
    """The train path's 3x3 convs at batch 1: (name, n, h, w, cin, cout,
    leaky, needs_dx).  Every conv after the cvt_i needs an input gradient
    (the cvt_i read the feature pyramid)."""
    return [(*shape, not shape[0].startswith("cvt_"))
            for shape in kernel2_shapes(scfg, batch=TRAIN_BATCH)]


def bil_shapes(scfg):
    """(label, n, h, w, cin, cout, bias) of every kernel-3 call of a train
    step, as the step makes it: the forward convs inside its contract (bias,
    no epilogue: BN and leaky follow) and the input gradients (Cin and Cout
    swapped, no bias)."""
    from gan_segmentation_tpu_torch.kernels.bil_conv import fits
    out = []
    for (name, n, h, w, cin, cout, _, dx) in train_conv_shapes(scfg):
        if fits(n, cin, cout):
            out.append((f"{name} fwd", n, h, w, cin, cout, True))
        if dx:
            out.append((f"{name} dX", n, h, w, cout, cin, False))
    return out


def library_ms(torch, x, wt, b=None, padding=1, **timing):
    """Device ms (graph replay) of F.conv2d alone on the same NHWC inputs
    (cuDNN, channels-last): the library call beside a conv kernel; a row
    band's takes ``padding=(0, 1)``."""
    xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    bc = None if b is None else b.to(x.dtype)
    return graph_ms(lambda: torch.nn.functional.conv2d(xc, wc, bc,
                                                       padding=padding),
                    **timing)


def device_times(torch, kernel, plain, x, wt, b=None):
    """Device ms (graph replay) of the kernel, its plain version and the
    library call on the same inputs."""
    return dict(kernel=graph_ms(kernel), plain=graph_ms(plain),
                library=library_ms(torch, x, wt, b))


def add_times(acc, times, floor):
    for k, v in times.items():
        acc[k] = acc.get(k, 0.0) + v
    acc.setdefault("bounds", []).append(floor)


def times_line(times, floor):
    old = (f", mma.sync body {times['mma_sync']:.4f}" if "mma_sync" in times
           else "")
    return (f"  device: kernel {times['kernel']:.4f} ms{old}, plain "
            f"{times['plain']:.4f}, F.conv2d {times['library']:.4f}; floor "
            f"{floor[0]:.4f} ({floor[1]}), share "
            f"{floor[0] / times['kernel']:.3f}")


def bf16_plan(n, h, w, cin, cout, noise):
    """The bf16 plan the rule gives (tc_plan.plan_bf16), as a log field."""
    from gan_segmentation_tpu_torch.kernels.tc_plan import plan_bf16
    p = plan_bf16(n, h, w, cin, cout, noise)
    return f"{'sm90' if p.sm90 else 'mma.sync'} plan {p.args()}"


def f32_plan(n, h, w, cin, cout, kernel3=False, noise=False):
    """The f32 plan the rule gives (tc_plan.plan_f32_body; ``noise``:
    kernel 1's), as a log field."""
    from gan_segmentation_tpu_torch.kernels.tc_plan import plan_f32_body
    p = plan_f32_body(n, h, w, cin, cout, kernel3=kernel3, noise=noise)
    return (f"{'sm90 tf32' if p.sm90 else 'mma.sync 3xTF32'} plan "
            f"{p.args()}")


def conv_inputs(torch, g):
    """inputs(n, h, w, cin, cout) -> x ~ N(0, 1) NHWC and w ~ N(0, 1) /
    sqrt(9 Cin) HWIO on the card, from the seeded generator g."""
    def inputs(n, h, w, cin, cout):
        x = torch.randn((n, h, w, cin), generator=g, device="cuda")
        wt = torch.randn((3, 3, cin, cout), generator=g, device="cuda")
        return x, wt / (9 * cin) ** 0.5
    return inputs


def phase_kernels(torch, gcfg, scfg):
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    inputs = conv_inputs(torch, g)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rec = {}

    # kernel 1
    errs = {"f32": 0.0, "bf16": 0.0}
    f32_err = {"rule": 0.0, "mma_sync": 0.0}  # y, f32, by body
    dev_t = {"f32": {}, "bf16": {}}
    for (n, h, w, cin, cout) in kernel1_shapes(gcfg):
        x32, w32 = inputs(n, h, w, cin, cout)
        noise = torch.randn((n, h, w), generator=g, device=dev)
        nscale = 0.1 * torch.randn((cout,), generator=g, device=dev)
        bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
        for tag, dt in dtypes.items():
            x, wt = x32.to(dt), w32.to(dt)
            args = (x, wt, noise, nscale, bias)
            y, mean, var = k1m.conv3x3_noise_bias_lrelu_instats(*args)
            yp, meanp, varp = k1m.conv3x3_noise_bias_lrelu_instats_plain(*args)
            torch.cuda.synchronize()
            name = f"conv_in_stats {tag} {(n, h, w, cin, cout)}"
            check_close(name + " y", y, yp, **TOL[tag])
            check_close(name + " mean", mean, meanp, **STAT_TOL[tag])
            check_close(name + " var", var, varp, **STAT_TOL[tag])
            errs[tag] = max(errs[tag], max_err(y, yp))
            line = (f"  {name}: max|y err| {max_err(y, yp):.3g} (tol "
                    f"{TOL[tag]}, stats {STAT_TOL[tag]})")
            times = device_times(
                torch,
                lambda: k1m.conv3x3_noise_bias_lrelu_instats(*args),
                lambda: k1m.conv3x3_noise_bias_lrelu_instats_plain(*args),
                x, wt)
            # noise, nscale, bias in; mean, var out (f32); the f32 floor is
            # 3xTF32, the card's fastest f32-exact rate
            nbytes, flop = conv_floors(
                n, h, w, cin, cout, x.element_size(),
                4 * (n * h * w + 2 * cout + 2 * n * cout))
            floor = (bound(nbytes, flop, PEAK["bf16"]) if tag == "bf16"
                     else bound(nbytes, 3 * flop, PEAK["tf32"]))
            if tag == "bf16":
                with mma_sync_body():
                    times["mma_sync"] = graph_ms(
                        lambda: k1m.conv3x3_noise_bias_lrelu_instats(*args))
                line += "; " + bf16_plan(n, h, w, cin, cout, True)
            else:
                # the rule's f32 body (entry 9 of the Hopper body wherever
                # plan_tf32_in_stats takes the call) beside the mma.sync
                # 3xTF32 body on the same inputs, both held to plain; the
                # rule's repeats and graph replays bit-identical
                again = k1m.conv3x3_noise_bias_lrelu_instats(*args)
                same = all(torch.equal(a, b) for a, b in
                           zip((y, mean, var), again))
                same &= graph_replays_equal(
                    torch, lambda: k1m.conv3x3_noise_bias_lrelu_instats(*args),
                    (y, mean, var))
                with mma_sync_tf32_body():
                    old = k1m.conv3x3_noise_bias_lrelu_instats(*args)
                    times["mma_sync"] = graph_ms(
                        lambda: k1m.conv3x3_noise_bias_lrelu_instats(*args))
                for what, a, r, tol in zip(
                        ("y", "mean", "var"), old, (yp, meanp, varp),
                        (TOL[tag], STAT_TOL[tag], STAT_TOL[tag])):
                    check_close(f"{name} {what} (mma.sync 3xTF32 body)", a, r,
                                **tol)
                check_later(same, f"{name}: a repeat or a graph replay "
                                  f"differs")
                f32_err["rule"] = max(f32_err["rule"], max_err(y, yp))
                f32_err["mma_sync"] = max(f32_err["mma_sync"],
                                          max_err(old[0], yp))
                errs[tag] = max(errs[tag], f32_err["mma_sync"])
                line += (f", mma.sync body {max_err(old[0], yp):.3g}; repeats "
                         f"and replays bit-identical {same}; "
                         + f32_plan(n, h, w, cin, cout, noise=True))
                del again, old
            add_times(dev_t[tag], times, floor)
            log(line + ";" + times_line(times, floor))
        del x32, w32, x, wt, y, yp
    rec["conv_in_stats"] = dict(errs=errs, f32_err=f32_err, dev=dev_t["bf16"],
                                f32_dev=dev_t["f32"])

    # kernel 2
    errs = {"f32": 0.0, "bf16": 0.0}
    dev_t = {}
    for (cname, n, h, w, cin, cout, leaky) in kernel2_shapes(scfg):
        x32, w32 = inputs(n, h, w, cin, cout)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        kw = dict(leaky=0.2) if leaky else {}
        for tag, dt in dtypes.items():
            x, wt = x32.to(dt), w32.to(dt)
            y = k2m.conv3x3_small(x, wt, b, **kw)
            yp = k2m.conv3x3_small_plain(x, wt, b, **kw)
            torch.cuda.synchronize()
            name = f"small_conv {tag} {cname} {(n, h, w, cin, cout)}"
            check_close(name, y, yp, **TOL[tag])
            errs[tag] = max(errs[tag], max_err(y, yp))
            line = f"  {name}: max|err| {max_err(y, yp):.3g} (tol {TOL[tag]})"
            if tag == "bf16":
                times = device_times(
                    torch, lambda: k2m.conv3x3_small(x, wt, b, **kw),
                    lambda: k2m.conv3x3_small_plain(x, wt, b, **kw), x, wt, b)
                with mma_sync_body():
                    times["mma_sync"] = graph_ms(
                        lambda: k2m.conv3x3_small(x, wt, b, **kw))
                floor = bound(*conv_floors(n, h, w, cin, cout, 2, 4 * cout),
                              PEAK["bf16"])
                add_times(dev_t, times, floor)
                line += ("; " + bf16_plan(n, h, w, cin, cout, False) + ";"
                         + times_line(times, floor))
            log(line)
        del x32, w32, x, wt, y, yp
    # evaluate runs every decoder conv through kernel 2 at batch 1 in f32
    # (BN folded, leaky), on the 3xTF32 body; train runs cvt_0..4 so (bias
    # only, checked in phase_conv_grads through Conv3x3).  Its floor is
    # kernel 3's for the same work: 3xTF32 on the tensor cores, the
    # card's fastest f32-exact rate.
    b1_err = 0.0
    b1_dev = {}
    for (cname, n, h, w, cin, cout, leaky) in kernel2_shapes(
            scfg, batch=TRAIN_BATCH):
        x, wt = inputs(n, h, w, cin, cout)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        kw = dict(leaky=0.2) if leaky else {}
        y = k2m.conv3x3_small(x, wt, b, **kw)
        yp = k2m.conv3x3_small_plain(x, wt, b, **kw)
        again = k2m.conv3x3_small(x, wt, b, **kw)
        with mma_sync_tf32_body():
            yo = k2m.conv3x3_small(x, wt, b, **kw)
            oagain = k2m.conv3x3_small(x, wt, b, **kw)
        torch.cuda.synchronize()
        name = f"small_conv f32 {cname} {(n, h, w, cin, cout)}"
        check_close(name, y, yp, **TOL["f32"])
        check_close(name + " (mma.sync body)", yo, yp, **TOL["f32"])
        assert torch.equal(y, again) and torch.equal(yo, oagain), (
            name + ": a repeat differs")
        b1_err = max(b1_err, max_err(y, yp), max_err(yo, yp))
        times = device_times(
            torch, lambda: k2m.conv3x3_small(x, wt, b, **kw),
            lambda: k2m.conv3x3_small_plain(x, wt, b, **kw), x, wt, b)
        with mma_sync_tf32_body():
            times["mma_sync"] = graph_ms(
                lambda: k2m.conv3x3_small(x, wt, b, **kw))
        nbytes, flop = conv_floors(n, h, w, cin, cout, 4, 4 * cout)
        floor = bound(nbytes, 3 * flop, PEAK["tf32"])
        add_times(b1_dev, times, floor)
        log(f"  {name}: max|err| {max_err(y, yp):.3g}, mma.sync body "
            f"{max_err(yo, yp):.3g} (tol {TOL['f32']}), repeats "
            f"bit-identical;" + times_line(times, floor)
            + f"; {f32_plan(n, h, w, cin, cout)}")
        del x, wt, y, yp, yo
    errs["f32"] = max(errs["f32"], b1_err)
    # the relu epilogue is not on the path; check it once
    x, wt = inputs(2, 16, 16, 16, 16)
    check_close("small_conv relu", k2m.conv3x3_small(x, wt, relu=True),
                k2m.conv3x3_small_plain(x, wt, relu=True), **TOL["f32"])
    rec["small_conv"] = dict(errs=errs, dev=dev_t, b1_dev=b1_dev)
    for k, r in rec.items():
        fl = summed_bound(r["dev"]["bounds"])
        log(f"{k}: max abs err f32 {r['errs']['f32']:.3g}, bf16 "
            f"{r['errs']['bf16']:.3g}; bf16 per batch of 8 over the path's "
            f"shapes, device time (graph replay): kernel "
            f"{r['dev']['kernel']:.3f} ms (the mma.sync body on the same "
            f"inputs {r['dev']['mma_sync']:.3f}), plain "
            f"{r['dev']['plain']:.3f}, F.conv2d {r['dev']['library']:.3f}, "
            f"floor {fl[0]:.3f} ({fl[1]}), share "
            f"{fl[0] / r['dev']['kernel']:.3f}")
    k1_f32 = rec["conv_in_stats"]["f32_dev"]
    fl = summed_bound(k1_f32["bounds"])
    log(f"conv_in_stats: f32 per batch of 8 over the path's 9 shapes, device "
        f"time (graph replay): kernel {k1_f32['kernel']:.3f} ms on the "
        f"rule's body (the mma.sync 3xTF32 body on the same inputs "
        f"{k1_f32['mma_sync']:.3f}), plain {k1_f32['plain']:.3f}, F.conv2d "
        f"{k1_f32['library']:.3f}, floor {fl[0]:.3f} ({fl[1]}, 3xTF32), "
        f"share {fl[0] / k1_f32['kernel']:.3f} (mma.sync body "
        f"{fl[0] / k1_f32['mma_sync']:.3f})")
    fl = summed_bound(b1_dev["bounds"])
    log(f"small_conv: f32 per evaluate sample (batch 1, its 26 convs), "
        f"device time (graph replay): kernel {b1_dev['kernel']:.3f} ms (the "
        f"mma.sync 3xTF32 body on the same inputs {b1_dev['mma_sync']:.3f}), "
        f"plain {b1_dev['plain']:.3f}, F.conv2d {b1_dev['library']:.3f}, "
        f"floor {fl[0]:.3f} ({fl[1]}, 3xTF32), share "
        f"{fl[0] / b1_dev['kernel']:.3f}; max abs err {b1_err:.3g}")
    phase_split_sweep(torch, gcfg, scfg, g, inputs)
    phase_tc_edges(torch, g, inputs)
    phase_annotation_shapes(torch, gcfg, scfg, g, inputs)
    rec["bil_conv"] = phase_bil(torch, scfg, g, inputs)
    phase_conv_grads(torch, scfg, g)
    return rec


def phase_split_sweep(torch, gcfg, scfg, g, inputs):
    """Every f32 path shape of kernels 1 and 2 whose mma.sync 3xTF32 plan
    splits K: device time (graph replay) on that body with the plan's split
    beside one split (the plan function swapped for that launch only), so
    that the record shows where the split wins and what the chain cap
    costs.  Kernel 1's calls run inside ``mma_sync_tf32_body`` (its rule
    takes them to the Hopper body; ``tf32_k1_sweep`` times its splits
    there)."""
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    cases = [("conv_in_stats", s) for s in kernel1_shapes(gcfg)]
    cases += [("small_conv", tuple(s[1:6]))
              for s in kernel2_shapes(scfg, batch=TRAIN_BATCH)]
    for kernel, (n, h, w, cin, cout) in cases:
        stats = kernel == "conv_in_stats"
        p = tc_plan.plan_f32(n, h, w, cin, cout, stats=stats)
        if p.splits == 1:
            continue
        x, wt = inputs(n, h, w, cin, cout)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        noise = torch.randn((n, h, w), generator=g, device=dev)
        if stats:
            def call():
                return k1m.conv3x3_noise_bias_lrelu_instats(x, wt, noise, b,
                                                            b)
        else:
            def call():
                return k2m.conv3x3_small(x, wt, b, leaky=0.2)
        body = mma_sync_tf32_body if stats else contextlib.nullcontext
        with body():
            planned = graph_ms(call)
            one = functools.partial(tc_plan.plan_f32, splits=1)
            _build._tc_plan_c.cache_clear()
            try:
                with mock.patch.object(tc_plan, "plan_f32", one):
                    unsplit = graph_ms(call)
            finally:
                _build._tc_plan_c.cache_clear()
        log(f"  split-K {kernel} f32 {(n, h, w, cin, cout)}"
            f"{' (mma.sync 3xTF32 body)' if stats else ''}: {p.splits} "
            f"splits of {p.cps} chunks, {p.blocks} blocks: {planned:.4f} ms; "
            f"one split, {p.blocks // p.splits} blocks: {unsplit:.4f} ms")
        del x, wt


# The Hopper body's plan sweeps (phase_sm90_sweep, not in the default run):
# the narrow layers' ring (Cin per stage, stages) and the wide split
# layers' splits, ffhq shapes at batch 8
SM90_RING_SWEEP = [("conv_in_stats", (8, 1024, 1024, 16, 16)),
                   ("small_conv", (8, 1024, 1024, 16, 16)),
                   ("small_conv", (8, 1024, 1024, 64, 16)),
                   ("conv_in_stats", (8, 512, 512, 32, 32)),
                   ("small_conv", (8, 512, 512, 32, 32))]
SM90_SPLIT_SWEEP = [(8, 4, 4, 512, 512), (8, 8, 8, 512, 512),
                    (8, 16, 16, 512, 512)]


def phase_sm90_sweep(torch):
    """Device time (graph replay) of bf16 kernels 1 and 2 on the Hopper body
    with its plan varied, the rule's first: at SM90_RING_SWEEP every Cin
    per stage (16, 32) and stage count that fits, at SM90_SPLIT_SWEEP the
    wide tiles' split at 16-channel chunks (32, 16 and 8 splits) beside the
    rule's.  The evidence behind tc_plan.plan_sm90's choices; not in the
    default run (~1 min after the build): python3 -c "import chip_smoke as
    c, torch; c.phase_sm90_sweep(torch)"."""
    import dataclasses
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    inputs = conv_inputs(torch, g)

    def call(kernel, shape):
        n, h, w, cin, cout = shape
        x, wt = (t.to(torch.bfloat16) for t in inputs(*shape))
        noise = torch.randn((n, h, w), generator=g, device=dev)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        if kernel == "conv_in_stats":
            return lambda: k1m.conv3x3_noise_bias_lrelu_instats(
                x, wt, noise, b, b)
        return lambda: k2m.conv3x3_small(x, wt, b, leaky=0.2)

    def timed(fn, p):
        _build._tc_plan_c.cache_clear()
        try:
            with mock.patch.object(tc_plan, "plan_sm90",
                                   lambda *args, **kw: p):
                return graph_ms(fn)
        finally:
            _build._tc_plan_c.cache_clear()

    for kernel, shape in SM90_RING_SWEEP:
        fn = call(kernel, shape)
        rule = tc_plan.plan_sm90(*shape, noise=kernel == "conv_in_stats")
        cells = [f"rule (ck {rule.ck}, {rule.stages} stages) "
                 f"{timed(fn, rule):.4f}"]
        for ck in (16, 32):
            chunks = -(-shape[3] // ck)
            for stages in range(2, 8):
                p = dataclasses.replace(rule, ck=ck, chunks=chunks,
                                        cps=chunks, stages=stages)
                if p.smem_bytes <= tc_plan.MAX_SMEM and p != rule:
                    cells.append(f"ck {ck} x {stages} ({p.smem_bytes} B) "
                                 f"{timed(fn, p):.4f}")
        log(f"  sm90 ring {kernel} {shape}: " + "; ".join(cells) + " ms")
    for shape in SM90_SPLIT_SWEEP:
        fn = call("conv_in_stats", shape)
        rule = tc_plan.plan_sm90(*shape, noise=True)
        cells = [f"rule ({rule.splits} splits of {rule.cps} x ck "
                 f"{rule.ck}) {timed(fn, rule):.4f}"]
        chunks = -(-shape[3] // 16)
        for splits in (32, 16, 8):
            cps = -(-chunks // splits)
            p = dataclasses.replace(rule, ck=16, chunks=chunks, cps=cps,
                                    splits=-(-chunks // cps))
            if p.smem_bytes <= tc_plan.MAX_SMEM:
                cells.append(f"{p.splits} splits of {cps} x ck 16 "
                             f"{timed(fn, p):.4f}")
        log(f"  sm90 split conv_in_stats {shape}: " + "; ".join(cells)
            + " ms")


# The s8 calls whose tile the s8 rule sets apart from bf16's (tc_plan.
# plan_sm90(s8=True)): 32-channel tiles at Cin <= 64, kernel 1's BN 32 in
# 128-pixel blocks, Cin 16 in tap pairs
S8_SWEEP = [("small_conv_s8", (8, 512, 512, 64, 64)),
            ("small_conv_s8", (8, 512, 512, 32, 64)),
            ("small_conv_s8", (8, 256, 256, 64, 128)),
            ("small_conv_s8", (8, 1024, 1024, 16, 16)),
            ("conv_in_stats_s8", (8, 1024, 1024, 16, 16)),
            ("conv_in_stats_s8", (8, 512, 512, 32, 32)),
            ("conv_in_stats_s8", (8, 256, 256, 64, 64))]


def s8_tile_plan(shape, noise, bn, mi, ck, stages):
    """The s8 Hopper plan of ``shape`` with its tile set by hand: (bn, mi,
    ck, stages), the geometry, blocks and resident taps as the rule derives
    them, no split."""
    from gan_segmentation_tpu_torch.kernels import tc_plan
    n, h, w, cin, cout = shape
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    th, g, tiles_x, tiles_y, groups = tc_plan._geometry(n, h, w, 128 * mi,
                                                        tw, 16 // tw)
    cout_blocks, chunks = -(-cout // bn), -(-cin // ck)
    return tc_plan.PlanSM90(
        bn=bn, mi=mi, ck=ck, tw=tw, th=th, g=g, splits=1, cps=chunks,
        stages=stages, resident=(cout_blocks == 1 and chunks * 9 * ck * bn
                                 <= tc_plan.SM90_RESIDENT_MAX),
        tma_y=cout % 8 == 0, noise=noise, chunks=chunks, tiles_x=tiles_x,
        tiles_y=tiles_y, groups=groups, cout_blocks=cout_blocks, s8=True)


def phase_s8_sweep(torch):
    """Device time (graph replay) of the s8 calls of ``S8_SWEEP`` on the
    Hopper body with the tile varied, the rule's first: every built tile
    (``tc_plan.S8_SM90_TILES``) of BN up to the bf16 rule's (Cin 16 also
    in 32-byte stages, half of each empty) and 2-4 stages that fit beside
    the blocks an SM the tile asks for.  The
    evidence behind plan_sm90's s8 rules; not in the default run (~1 min
    after the build): python3 -c "import chip_smoke as c, torch;
    c.phase_s8_sweep(torch)"."""
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def timed(fn, p):
        _build._tc_plan_c.cache_clear()
        try:
            with mock.patch.object(tc_plan, "plan_s8",
                                   lambda *args, **kw: p):
                return graph_ms(fn)
        finally:
            _build._tc_plan_c.cache_clear()

    for kernel, shape in S8_SWEEP:
        n, h, w, cin, cout = shape
        k1 = kernel == "conv_in_stats_s8"
        x = torch.randint(-127, 128, (n, h, w, cin), dtype=torch.int8,
                          device=dev, generator=g)
        wq = torch.randint(-127, 128, (3, 3, cout, cin), dtype=torch.int8,
                           device=dev, generator=g)
        deq = torch.rand(cout, device=dev, generator=g) * 1e-4
        b = torch.randn(cout, device=dev, generator=g)
        noise = torch.randn((n, h, w), device=dev, generator=g)
        if k1:
            def fn():
                return k1m.conv3x3_noise_bias_lrelu_instats_s8(
                    x, wq, deq, noise, b, b)
        else:
            def fn():
                return k2m.conv3x3_small_s8(x, wq, deq, b, leaky=0.2)
        rule = tc_plan.plan_s8(*shape, noise=k1)
        cells = [f"rule {rule.bn}/{rule.mi}/{rule.ck}/{rule.stages} "
                 f"{timed(fn, rule):.4f}"]
        top = 128 if cout > 64 else max(16, 1 << (cout - 1).bit_length())
        for bn, mi, ck in sorted(tc_plan.S8_SM90_TILES[k1]):
            if bn > top or (ck == 16 and cin != 16) or ck > 2 * cin:
                continue
            for stages in (2, 3, 4):
                p = s8_tile_plan(shape, k1, bn, mi, ck, stages)
                if (p.pairs and not p.resident or p.smem_bytes > min(
                        tc_plan.MAX_SMEM,
                        tc_plan.SM_SMEM // p.min_blocks - 1024)
                        or p == rule):
                    continue
                cells.append(f"{bn}/{mi}/{ck}/{stages} {timed(fn, p):.4f}")
        log(f"  s8 tiles {kernel} {shape} (bn/mi/ck/stages ms): "
            + "; ".join(cells))


# The tf32 Hopper body's sweep (phase_tf32_sweep, not in the default run):
# kernel 3's entry built from patched copies of csrc (what each part of the
# body costs), and the rule's plan beside the variants it turned down, at
# train-step shapes (batch 1)
TF32_ABLATIONS = {
    # the MMAs left out: the loads, A's split and the epilogue alone
    "no_mma": [("        wgmma_tf32<2 * BN>(acc[i], ah[b], d);\n", ""),
               ("        wgmma_tf32<BN>(reinterpret_cast<float(&)[BN / 2]>"
                "(acc[i][0]), al[b],\n                       d);\n", "")],
    # A_lo B_hi left out: what its narrow wgmma costs
    "no_lo_hi": [("        wgmma_tf32<BN>(reinterpret_cast<float(&)[BN / 2]>"
                  "(acc[i][0]), al[b],\n                       d);\n", "")],
    # A split as the mma.sync body splits it, both parts masked (3 ops a
    # value instead of 2; the same operands as the MMA reads them)
    "mask_both": [("          al[b][e] = __float_as_uint(__uint_as_float("
                   "ah[b][e]) -\n                                     "
                   "__uint_as_float(ah[b][e] & 0xFFFFE000u));",
                   "          tf32_split(ah[b][e], ah[b][e], al[b][e]);")],
    # y's stores left out
    "no_store": [("          } else if (ok[i][hf]) {",
                  "          } else if (ok[i][hf] && a.n < 0) {")],
}
TF32_SWEEP = [(1, 1024, 1024, 16, 16), (1, 1024, 1024, 64, 16),
              (1, 1024, 1024, 16, 64), (1, 1024, 1024, 32, 2),
              (1, 512, 512, 32, 32), (1, 512, 512, 64, 32),
              (1, 512, 512, 32, 64), (1, 256, 256, 64, 32),
              (1, 256, 256, 32, 64), (1, 128, 128, 64, 32),
              (1, 128, 128, 128, 32), (1, 128, 128, 32, 32),
              (1, 128, 128, 32, 64), (1, 64, 64, 64, 32),
              (1, 64, 64, 32, 64), (1, 64, 64, 32, 32),
              (1, 32, 32, 64, 32), (1, 16, 16, 64, 32),
              (1, 16, 16, 32, 64), (1, 16, 16, 32, 32),
              (1, 8, 8, 32, 32)]


def tf32_plan_variants(p, shape):
    """What plan_tf32 turned down at ``shape``: other BN (taps resident,
    one block an SM where two do not fit), the other MI, each also in two
    Cin splits where Cin has 4 chunks or more, other stages."""
    import dataclasses

    from gan_segmentation_tpu_torch.kernels import tc_plan
    n, h, w, cin, cout = shape
    out = []
    for bn in (8, 16, 32, 64):
        for mi in (1, 2):
            if (bn, mi, 16) not in tc_plan.TF32_SM90_TILES or bn > max(
                    8, 1 << (cout - 1).bit_length()):
                continue
            th, g, tx, ty, gr = tc_plan._geometry(n, h, w, 128 * mi, p.tw,
                                                  16 // p.tw)
            q = dataclasses.replace(
                p, bn=bn, mi=mi, th=th, g=g, tiles_x=tx, tiles_y=ty,
                groups=gr, cout_blocks=-(-cout // bn), splits=1,
                cps=p.chunks, stages=3)
            if q.smem_bytes <= tc_plan.MAX_SMEM and (bn, mi) != (p.bn, p.mi):
                out.append(q)
            if q.chunks >= 4 and q.smem_bytes <= tc_plan.MAX_SMEM:
                # the same in two Cin splits (the finish kernel adds them)
                out.append(dataclasses.replace(
                    q, splits=2, cps=-(-q.chunks // 2)))
    for stages in (2, 3, 4):
        q = dataclasses.replace(p, stages=stages)
        if stages != p.stages and q.smem_bytes <= tc_plan.MAX_SMEM:
            out.append(q)
    return out


def tf32_k1_variants(p, shape):
    """What plan_tf32_in_stats turned down at ``shape`` (kernel 1's rule,
    plan ``p``): every built tile (``tc_plan.TF32_K1_SM90_TILES``) of BN up
    to Cout's, each with the rule's splits for it, half and twice as many
    within the chain cap, its taps resident (where they fit) and streamed;
    each with the deepest ring that fits."""
    from gan_segmentation_tpu_torch.kernels import tc_plan
    cout = shape[4]
    top = max(16, 1 << (cout - 1).bit_length())
    out = []
    for bn, mi, _ in sorted(tc_plan.TF32_K1_SM90_TILES):
        base = tc_plan.tf32_in_stats_plan(*shape, bn, mi)
        if bn > top or base is None:
            continue
        for splits in sorted({base.splits, max(1, base.splits // 2),
                              min(base.chunks, 2 * base.splits)}):
            for resident in (False, True):
                q = tc_plan.tf32_in_stats_plan(*shape, bn, mi, splits=splits,
                                               resident=resident)
                if q is not None and q != p and q not in out:
                    out.append(q)
    return out


# Kernel 1's entry 9 (phase_tf32_sweep's kernel-1 part) built from patched
# copies of csrc: what each part of the call costs at the path's shapes
TF32_K1_ABLATIONS = {
    "no_mma": TF32_ABLATIONS["no_mma"],
    "no_lo_hi": TF32_ABLATIONS["no_lo_hi"],
    # the streamed taps' TMA box left out (the MMAs read a stale stage)
    "no_tap_box": [("              tma_load_4d(st + L.tap_off, &a.tm_w, "
                    "full + s, 0, it.co0, 0,\n                          (c0 "
                    "+ c) * 9);", "              {}"),
                   ("      const uint32_t tx = L.halo + (a.resident ? 0 : "
                    "L.taps);", "      const uint32_t tx = L.halo + "
                    "(a.resident || TF32 ? 0 : L.taps);")],
    # the statistics' slots and partials left out
    "no_stats": [("      if (STATS) {  // slots of the sums",
                  "      if (STATS && a.n < 0) {  // slots of the sums"),
                 ("    if (STATS) {  // per (image, channel)",
                  "    if (STATS && a.n < 0) {  // per (image, channel)")],
    # the split-K finish kernel not launched
    "no_finish": [("  if (rc || a.splits == 1) return rc;\n  // split-K: "
                   "conv3x3_tc.cuh's finish kernel",
                   "  if (rc || a.splits >= 1) return rc;\n  // split-K: "
                   "conv3x3_tc.cuh's finish kernel")],
    # the K-major layout not made (the taps stream from stale memory)
    "no_layout": [("    gst::tf32_taps_kernel<<<grid, gst::TAPS_THREADS, 0, "
                   "st>>>(\n        static_cast<const float*>(w), ws, cin, "
                   "cout);", "    (void)grid;")],
}


def patched_libs(torch, ablations, source):
    """{name: ctypes library} of ``source`` (a csrc/*.cu) built alone from
    copies of csrc patched as ``ablations`` says (each (old, new) replaced
    in the one csrc file that holds ``old``), all nvcc runs at once; and
    the directory to remove."""
    import ctypes

    from gan_segmentation_tpu_torch.kernels import _build
    root = tempfile.mkdtemp()
    libs, jobs = {}, []
    for name, patches in ablations.items():
        d = join(root, name)
        shutil.copytree(_build.CSRC, d)
        for old, new in patches:
            hits = [f for f in os.listdir(d)
                    if old in open(join(d, f)).read()]
            assert len(hits) == 1, (name, old, hits)
            path = join(d, hits[0])
            with open(path) as fh:
                text = fh.read()
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-shared",
               join(d, source), "-o", join(d, "lib.so")]
        jobs.append((name, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, d, proc in jobs:
        _, err = proc.communicate()
        assert proc.returncode == 0, f"{name}: nvcc failed\n{err[-2000:]}"
        libs[name] = ctypes.CDLL(join(d, "lib.so"))
    return libs, root


def phase_tf32_sweep(torch, kernel3=True, kernel1=True):
    """Device time (graph replay) of the tf32 Hopper entries: kernel 3's
    (entry 3) at ``TF32_SWEEP``, the rule's plan beside
    ``tf32_plan_variants``, then the entry built from copies of csrc patched
    as ``TF32_ABLATIONS`` says (each variant's y against the body's: the
    split variant must be bit-equal); kernel 1's (entry 9,
    ``tf32_k1_sweep``) at the f32 generator's 9 shapes.  The evidence
    behind plan_tf32's and plan_tf32_in_stats's choices and the body's
    split; not in the default run (~4 min after the build): python3 -c
    "import chip_smoke as c, torch; c.phase_tf32_sweep(torch)"."""
    import ctypes

    from gan_segmentation_tpu_torch.kernels import _build, tc_plan

    if kernel1:
        tf32_k1_sweep(torch)
    if not kernel3:
        return
    libs, root = patched_libs(torch, TF32_ABLATIONS, "bil_conv_sm90.cu")
    libs["body"] = ctypes.CDLL(_build.build_library())
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.gst_conv3x3_bil_sm90.restype = i
        lib.gst_conv3x3_bil_sm90.argtypes = [vp, vp, vp, vp, vp, i, i, i, i,
                                             i, i, i, f, vp, vp]
    g = torch.Generator(device="cuda").manual_seed(1234)
    for shape in TF32_SWEEP:
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), device="cuda", generator=g)
        wt = torch.randn((3, 3, cin, cout), device="cuda", generator=g) / (
            9 * cin) ** 0.5
        y = torch.empty((n, h, w, cout), device="cuda")
        rule = tc_plan.plan_tf32(*shape)
        runs = [("rule", libs["body"], rule)]
        runs += [("", libs["body"], q) for q in tf32_plan_variants(rule,
                                                                   shape)]
        runs += [(name, libs[name], rule) for name in TF32_ABLATIONS]
        cells, ref = [], None
        for name, lib, p in runs:
            ws = (torch.empty(p.ws_elems(n, h, w, cout), device="cuda")
                  if p.splits > 1 else None)
            plan = (ctypes.c_int * 11)(*p.args())

            def call(lib=lib, plan=plan, ws=ws):
                rc = lib.gst_conv3x3_bil_sm90(
                    x.data_ptr(), wt.data_ptr(), None, y.data_ptr(),
                    None if ws is None else ws.data_ptr(), n, h, w, cin,
                    cout, 0, 0, 0.0, plan,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, (name, p, rc)
            call()
            torch.cuda.synchronize()
            tag = name or (f"bn {p.bn} mi {p.mi} x {p.stages}"
                           + (f" / {p.splits}" if p.splits > 1 else ""))
            same = ""
            if ref is None:
                ref = y.clone()
            elif name not in ("no_mma", "no_lo_hi", "no_store"):
                same = " =" if torch.equal(y, ref) else " !="
            cells.append(f"{tag}{same} {graph_ms(call):.4f}")
        log(f"  tf32 sweep {shape} (rule bn {rule.bn} mi {rule.mi} x "
            f"{rule.stages}, {rule.splits} splits; '=' y bit-equal to the "
            f"rule's): " + "; ".join(cells) + " ms")
    shutil.rmtree(root, ignore_errors=True)


def k1_f32_parts(torch, fn):
    """Device ms of one call of ``fn`` by part, from a profiler trace of
    five eager calls: the body (conv3x3_*_kernel), the K-major layout
    (tf32_taps_kernel), the split-K finish, the rest (the wrapper's second
    pass over the tile axis)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    parts = {"body": 0.0, "layout": 0.0, "finish": 0.0, "rest": 0.0}
    for name, ms in kernel_times(prof).items():
        key = ("finish" if "finish_kernel" in name else
               "layout" if "tf32_taps_kernel" in name else
               "body" if kernel_of(name) == "conv_in_stats" else "rest")
        parts[key] += ms / 5
    return parts


def tf32_k1_sweep(torch):
    """Kernel 1's f32 entry (entry 9) at the f32 generator's 9 ffhq shapes
    (batch 8), device time by graph replay of the C entry alone: the rule's
    plan beside ``tf32_k1_variants`` (its taps streamed against resident,
    its splits, BN, MI; each variant's y against the rule's: "=" bit-equal,
    else its largest difference), the entry built from copies of csrc
    patched as ``TF32_K1_ABLATIONS`` says; then the wrapper's call on the
    rule's body and on the mma.sync 3xTF32 body, and its device time by
    part (``k1_f32_parts``)."""
    import ctypes

    from gan_segmentation_tpu_torch.core.config import gan_config
    from gan_segmentation_tpu_torch.kernels import _build, tc_plan
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m

    libs, root = patched_libs(torch, TF32_K1_ABLATIONS,
                              "conv_in_stats_f32.cu")
    libs["body"] = ctypes.CDLL(_build.build_library())
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.gst_conv3x3_in_stats_f32_sm90.restype = i
        lib.gst_conv3x3_in_stats_f32_sm90.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, f, vp, vp]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    for shape in kernel1_shapes(gan_config("ffhq")):
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), device=dev, generator=g)
        wt = torch.randn((3, 3, cin, cout), device=dev, generator=g) / (
            9 * cin) ** 0.5
        noise = torch.randn((n, h, w), device=dev, generator=g)
        b = 0.1 * torch.randn((cout,), device=dev, generator=g)
        y = torch.empty((n, h, w, cout), device=dev)
        rule = tc_plan.plan_tf32_in_stats(*shape)
        runs = [("rule", libs["body"], rule)]
        runs += [("", libs["body"], q) for q in tf32_k1_variants(rule,
                                                                 shape)]
        runs += [(name, libs[name], rule) for name in TF32_K1_ABLATIONS]
        cells, ref = [], None
        for name, lib, p in runs:
            nws = p.ws_elems(n, h, w, cout)
            ws = torch.empty(nws, device=dev) if nws else None
            partial = torch.empty((n, p.tiles, 2, cout), device=dev)
            plan = (ctypes.c_int * 11)(*p.args())

            def call(lib=lib, plan=plan, ws=ws, partial=partial, p=p):
                rc = lib.gst_conv3x3_in_stats_f32_sm90(
                    x.data_ptr(), wt.data_ptr(), noise.data_ptr(),
                    b.data_ptr(), b.data_ptr(), y.data_ptr(),
                    partial.data_ptr(), None if ws is None else ws.data_ptr(),
                    n, h, w, cin, cout, 0, 0.2, plan,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, (name, p, rc)
            call()
            torch.cuda.synchronize()
            tag = name or (f"bn {p.bn} mi {p.mi} / {p.splits} "
                           f"{'res' if p.resident else 'str'} x {p.stages}")
            same = ""
            if ref is None:
                ref = y.clone()
            elif not name:
                same = (" =" if torch.equal(y, ref) else
                        f" ({float((y - ref).abs().max()):.2g})")
            cells.append(f"{tag}{same} {graph_ms(call):.4f}")
        args = (x, wt, noise, b, b)

        def wrapped():
            return k1m.conv3x3_noise_bias_lrelu_instats(*args)
        op, parts = graph_ms(wrapped), k1_f32_parts(torch, wrapped)
        with mma_sync_tf32_body():
            old, old_parts = graph_ms(wrapped), k1_f32_parts(torch, wrapped)
        log(f"  tf32 k1 sweep {shape} (rule bn {rule.bn} mi {rule.mi} / "
            f"{rule.splits} {'res' if rule.resident else 'str'} x "
            f"{rule.stages}; the op {op:.4f} ms, parts "
            f"{ {k: round(v, 4) for k, v in parts.items()} }; mma.sync "
            f"3xTF32 body {old:.4f}, parts "
            f"{ {k: round(v, 4) for k, v in old_parts.items()} }): "
            + "; ".join(cells) + " ms")
        del x, wt, y, ref
    shutil.rmtree(root, ignore_errors=True)


# Edge cases of the tensor-core kernels (n, h, w, cin, cout), run in bf16
# (on both bodies) and f32: 4^2 tiles spanning images with Cin 512
# (split-K), ragged 12 x 20
# tiles, Cout = 2, Cin = 3 (scalar staging), batch 1, 256-pixel blocks of 64
# channels with a ragged W; then the f32 split's own: a ragged 13 x 21 with
# Cin 512, three 4^2 images in a tile of eight, Cin 40 -> Cout 24 (masked
# channels), Cin 500 (a short last split); in f32 also 2^2 and 1^2 images
# (the statistics keep 16 tile pixels per image)
TC_EDGES = [(8, 4, 4, 512, 512), (8, 4, 4, 512, 32), (3, 12, 20, 32, 16),
            (2, 12, 20, 64, 64), (4, 64, 64, 32, 2), (2, 9, 7, 3, 16),
            (1, 64, 64, 64, 16), (1, 16, 16, 512, 512), (1, 4, 4, 512, 32),
            (8, 64, 72, 64, 64), (1, 13, 21, 512, 32), (3, 4, 4, 64, 64),
            (2, 5, 6, 40, 24), (1, 32, 32, 500, 32)]
F32_EDGES = [(2, 2, 2, 8, 8), (1, 1, 1, 4, 4)]
# The s8 bodies' edge cases (tests/test_torch_sm90_s8.py plans them):
# tiles spanning images, split-K, ragged tiles, Cout 2 and 24 (masked
# channels, stores from registers), Cin 48 (a short chunk), 496 (a short
# last split), Cin 3, 40 and 8 (refused: rows not a multiple of 16 bytes),
# W 6 and 7 (kernel 1 refused: the noise's rows), Cout 200 (two
# 128-channel blocks, the second ragged)
S8_EDGES = [(8, 4, 4, 512, 512), (3, 12, 20, 32, 16), (2, 12, 20, 64, 64),
            (4, 64, 64, 32, 2), (2, 9, 7, 3, 16), (1, 64, 64, 64, 16),
            (1, 16, 16, 512, 512), (8, 64, 72, 64, 64), (1, 13, 21, 512, 32),
            (3, 4, 4, 64, 64), (2, 5, 6, 48, 24), (1, 32, 32, 496, 32),
            (2, 33, 40, 32, 2), (2, 8, 8, 16, 200), (2, 5, 6, 40, 24),
            (1, 8, 8, 8, 8)]


def phase_tc_edges(torch, g, inputs):
    """Kernels 1 and 2 at the tensor-core kernels' edge cases, against the
    plain versions: kernel 1's y and statistics, kernel 2 with its three
    epilogues, and a repeat of each call bit-identical; bf16 and f32 on
    both bodies (the rule's, Hopper where its rules take the shape, then
    the mma.sync body everywhere); then the s8 entries on both bodies, y
    bit-equal to the plain epilogue."""
    runs = (("bf16", torch.bfloat16, contextlib.nullcontext),
            ("bf16 mma.sync body", torch.bfloat16, mma_sync_body),
            ("f32", torch.float32, contextlib.nullcontext),
            ("f32 mma.sync body", torch.float32, mma_sync_tf32_body))
    for tag, dt, body in runs:
        with body():
            edge_cases(torch, g, inputs, tag, dt)
    for tag, body in (("s8", contextlib.nullcontext),
                      ("s8 mma.sync body", mma_sync_s8_body)):
        with body():
            s8_edge_cases(torch, g, tag)


def s8_edge_cases(torch, g, tag):
    """The s8 entries at ``S8_EDGES`` on the body the plan picks: the s32
    sums exact (deq 1, f32 out), kernel 1's y bit-equal to its plain twin
    and its statistics within ``STAT_TOL``, kernel 2 with its three
    epilogues bit-equal, each call's repeat bit-identical."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.kernels import tc_plan

    dev = torch.device("cuda")
    bodies = {}
    for (n, h, w, cin, cout) in S8_EDGES:
        xq = torch.randint(-127, 128, (n, h, w, cin), dtype=torch.int8,
                           device=dev, generator=g)
        wq = torch.randint(-127, 128, (3, 3, cout, cin), dtype=torch.int8,
                           device=dev, generator=g)
        deq = (torch.rand(cout, device=dev, generator=g) + 0.5) / (
            127.0 * (9 * cin) ** 0.5)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        noise = torch.randn((n, h, w), generator=g, device=dev)
        ones = torch.ones(cout, device=dev)
        zeros = torch.zeros(cout, device=dev)
        acc = k2m.conv3x3_s8_acc(xq, wq)
        name = f"s8 edge {tag} {(n, h, w, cin, cout)}"
        ex = (k2m.conv3x3_small_s8(xq, wq, ones, out_dtype=torch.float32),
              k1m.conv3x3_noise_bias_lrelu_instats_s8(
                  xq, wq, ones, torch.zeros_like(noise), zeros, zeros,
                  leaky=1.0, out_dtype=torch.float32)[0])
        check_later(all(torch.equal(e, acc) for e in ex),
                    f"{name}: the s32 sums differ from the exact product")
        args = (xq, wq, deq, noise, b, b)
        got = k1m.conv3x3_noise_bias_lrelu_instats_s8(*args)
        want = k1m.conv3x3_noise_bias_lrelu_instats_s8_plain(*args)
        again = k1m.conv3x3_noise_bias_lrelu_instats_s8(*args)
        torch.cuda.synchronize()
        check_later(torch.equal(got[0], want[0]),
                    f"{name} conv_in_stats_s8: y differs from plain, max "
                    f"{max_err(got[0], want[0]):.3g}")
        for what, a, r in zip(("mean", "var"), got[1:], want[1:]):
            check_close(f"{name} conv_in_stats_s8 {what}", a, r,
                        **STAT_TOL["bf16"])
        check_later(all(torch.equal(a, r) for a, r in zip(got, again)),
                    f"{name}: conv_in_stats_s8 repeat differs")
        for kw in (dict(leaky=0.2), dict(relu=True), {}):
            ys = k2m.conv3x3_small_s8(xq, wq, deq, b, **kw)
            ysp = k2m.conv3x3_small_s8_plain(xq, wq, deq, b, **kw)
            check_later(torch.equal(ys, ysp) and torch.equal(
                ys, k2m.conv3x3_small_s8(xq, wq, deq, b, **kw)),
                f"{name} small_conv_s8 {kw}: y differs from plain or a "
                f"repeat differs")
        for k1 in (True, False):
            body = "sm90" if tc_plan.plan_s8(n, h, w, cin, cout,
                                             k1).sm90 else "mma_sync"
            bodies[body] = bodies.get(body, 0) + 1
    log(f"tensor-core edge cases {tag}: {len(S8_EDGES)} shapes, kernel 1 "
        f"with statistics and kernel 2 x 3 epilogues, y bit-equal to the "
        f"plain epilogue; calls by body {bodies}")


def edge_cases(torch, g, inputs, tag, dt):
    """phase_tc_edges' checks in one dtype, on the body the plan picks."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    f32 = dt == torch.float32
    tol, stat_tol = TOL["f32" if f32 else "bf16"], STAT_TOL[
        "f32" if f32 else "bf16"]
    worst = 0.0
    shapes = TC_EDGES + (F32_EDGES if f32 else [])
    for (n, h, w, cin, cout) in shapes:
        x, wt = (t.to(dt) for t in inputs(n, h, w, cin, cout))
        noise = torch.randn((n, h, w), generator=g, device=dev)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        args = (x, wt, noise, b, b)
        got = k1m.conv3x3_noise_bias_lrelu_instats(*args)
        want = k1m.conv3x3_noise_bias_lrelu_instats_plain(*args)
        again = k1m.conv3x3_noise_bias_lrelu_instats(*args)
        torch.cuda.synchronize()
        name = f"tensor-core edge {tag} {(n, h, w, cin, cout)}"
        check_close(name + " conv_in_stats y", got[0], want[0], **tol)
        for what, a, r in zip(("mean", "var"), got[1:], want[1:]):
            check_close(f"{name} conv_in_stats {what}", a, r, **stat_tol)
        assert all(torch.equal(a, r) for a, r in zip(got, again)), \
            name + ": conv_in_stats repeat differs"
        err = max_err(got[0], want[0])
        for kw in (dict(leaky=0.2), dict(relu=True), {}):
            ys = k2m.conv3x3_small(x, wt, b, **kw)
            ysp = k2m.conv3x3_small_plain(x, wt, b, **kw)
            torch.cuda.synchronize()
            check_close(f"{name} small_conv {kw}", ys, ysp, **tol)
            assert torch.equal(ys, k2m.conv3x3_small(x, wt, b, **kw)), \
                name + ": small_conv repeat differs"
            err = max(err, max_err(ys, ysp))
        worst = max(worst, err)
        body = (f"kernel 1 {f32_plan(n, h, w, cin, cout, noise=True)}, "
                f"kernel 2 {f32_plan(n, h, w, cin, cout)}" if f32 else (
                    f"kernel 1 {bf16_plan(n, h, w, cin, cout, True)}, "
                    f"kernel 2 {bf16_plan(n, h, w, cin, cout, False)}"))
        log(f"  {name}: max|y err| {err:.3g} (tol {tol}, stats "
            f"{stat_tol}), repeats bit-identical; {body}")
    log(f"tensor-core edge cases {tag}: {len(shapes)} shapes, kernel 1 "
        f"with statistics and kernel 2 x 3 epilogues, max |err| "
        f"{worst:.3g}")


def phase_annotation_shapes(torch, gcfg, scfg, g, inputs):
    """Kernels 1 and 2 in bf16 at every ffhq path shape at the annotation
    run's batch (its sampler and Generate run ANN_BATCH images at a time, and
    the launch plan depends on the batch), against the plain versions."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.kernels.tc_plan import plan_bf16

    dev, dt = torch.device("cuda"), torch.bfloat16
    worst = {"conv_in_stats": 0.0, "small_conv": 0.0}
    split = []
    for (n, h, w, cin, cout) in kernel1_shapes(gcfg, batch=ANN_BATCH):
        x, wt = (t.to(dt) for t in inputs(n, h, w, cin, cout))
        noise = torch.randn((n, h, w), generator=g, device=dev)
        nscale = 0.1 * torch.randn((cout,), generator=g, device=dev)
        bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
        args = (x, wt, noise, nscale, bias)
        got = k1m.conv3x3_noise_bias_lrelu_instats(*args)
        want = k1m.conv3x3_noise_bias_lrelu_instats_plain(*args)
        torch.cuda.synchronize()
        name = f"conv_in_stats bf16 {(n, h, w, cin, cout)}"
        check_close(name + " y", got[0], want[0], **TOL["bf16"])
        for what, a, r in zip(("mean", "var"), got[1:], want[1:]):
            check_close(f"{name} {what}", a, r, **STAT_TOL["bf16"])
        worst["conv_in_stats"] = max(worst["conv_in_stats"],
                                     max_err(got[0], want[0]))
        if plan_bf16(n, h, w, cin, cout, True).splits > 1:
            split.append((n, h, w, cin, cout))
        del x, wt, got, want
    for (cname, n, h, w, cin, cout, leaky) in kernel2_shapes(
            scfg, batch=ANN_BATCH):
        x, wt = (t.to(dt) for t in inputs(n, h, w, cin, cout))
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        kw = dict(leaky=0.2) if leaky else {}
        y = k2m.conv3x3_small(x, wt, b, **kw)
        yp = k2m.conv3x3_small_plain(x, wt, b, **kw)
        torch.cuda.synchronize()
        check_close(f"small_conv bf16 {cname} {(n, h, w, cin, cout)}", y, yp,
                    **TOL["bf16"])
        worst["small_conv"] = max(worst["small_conv"], max_err(y, yp))
        if plan_bf16(n, h, w, cin, cout, False).splits > 1:
            split.append((n, h, w, cin, cout))
        del x, wt, y, yp
    log(f"annotation run's shapes (bf16, batch {ANN_BATCH}): kernel 1 at "
        f"{len(kernel1_shapes(gcfg))} and kernel 2 at "
        f"{len(kernel2_shapes(scfg))} ffhq shapes against the plain "
        f"versions, max|y err| {worst} (tol {TOL['bf16']}, stats "
        f"{STAT_TOL['bf16']}); split-K at {split}")


def phase_bil(torch, scfg, g, inputs):
    """Kernel 3 in f32 at every call of a train step (batch 1, forward and
    input gradient) on both f32 bodies, the rule's (the Hopper body's
    3xTF32 form wherever tc_plan.plan_tf32 takes the call) and the
    mma.sync 3xTF32 body (``mma_sync_tf32_body``) on the same inputs:
    against its plain version, repeats bit-identical, and device time by
    graph replay of both beside F.conv2d with TF32 off (the library call)
    and on, and plain, with the call's floors; the accumulator's rounding
    at the longest chain (``tf32_rounding``); then the edge cases on both
    bodies, and the bf16 body (FFMA, on no path) at generate's design
    case."""
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    err = 0.0
    tot = {}
    floors = {"hbm": 0.0, "tf32x3": 0.0, "ffma": 0.0}
    bounds, losses, refused, same = [], [], [], 0
    for (label, n, h, w, cin, cout, bias) in bil_shapes(scfg):
        x, wt = inputs(n, h, w, cin, cout)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        args = (x, wt, b) if bias else (x, wt)
        y = k3m.conv3x3_bil(*args)
        yp = k3m.conv3x3_bil_plain(*args)
        ys = k2m.conv3x3_small(*args)
        again = k3m.conv3x3_bil(*args)
        with mma_sync_tf32_body():
            yo = k3m.conv3x3_bil(*args)
            oagain = k3m.conv3x3_bil(*args)
        torch.cuda.synchronize()
        name = f"bil_conv f32 {label} {(n, h, w, cin, cout)}"
        check_close(name, y, yp, **TOL["f32"])
        check_close(name + " (mma.sync body)", yo, yp, **TOL["f32"])
        check_close(f"small_conv f32 {label}", ys, yp, **TOL["f32"])
        assert torch.equal(y, again), name + ": repeat differs"
        assert torch.equal(yo, oagain), name + ": mma.sync repeat differs"
        err = max(err, max_err(y, yp), max_err(yo, yp))
        same += bool(torch.equal(y, yo))
        times = device_times(torch, lambda: k3m.conv3x3_bil(*args),
                             lambda: k3m.conv3x3_bil_plain(*args), *args)
        with mma_sync_tf32_body():
            times["mma_sync"] = graph_ms(lambda: k3m.conv3x3_bil(*args))
        torch.backends.cudnn.allow_tf32 = True
        try:
            times["library_tf32"] = library_ms(torch, *args)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        nbytes, flop = conv_floors(n, h, w, cin, cout, 4,
                                   4 * cout if bias else 0)
        floor = bound(nbytes, 3 * flop, PEAK["tf32"])
        bounds.append(floor)
        floors["hbm"] += nbytes / HBM_RATE * 1e3
        floors["tf32x3"] += floor[0]
        floors["ffma"] += bound(nbytes, flop, PEAK["f32"])[0]
        for k, v in times.items():
            tot[k] = tot.get(k, 0.0) + v
        if times["kernel"] > times["library"]:
            losses.append(label)
        plan = f32_plan(n, h, w, cin, cout, kernel3=True)
        if not plan.startswith("sm90"):
            refused.append(label)
        log(f"  {name}: max|err| {max_err(y, yp):.3g}, mma.sync body "
            f"{max_err(yo, yp):.3g} (tol {TOL['f32']}), repeats "
            f"bit-identical; device ms: kernel {times['kernel']:.4f}, "
            f"mma.sync body {times['mma_sync']:.4f}, F.conv2d "
            f"{times['library']:.4f} (TF32 on {times['library_tf32']:.4f}), "
            f"plain {times['plain']:.4f}; floor {floor[0]:.4f} ({floor[1]}, "
            f"3xTF32), share {floor[0] / times['kernel']:.3f}; {plan}")
        del x, wt, y, yp, ys, again, yo, oagain
    n_calls = len(bil_shapes(scfg))
    log(f"bil_conv: f32 per train step over its {n_calls} calls, device "
        f"time (graph replay): kernel {tot['kernel']:.3f} ms (the mma.sync "
        f"3xTF32 body on the same inputs {tot['mma_sync']:.3f}), F.conv2d "
        f"TF32 off "
        f"{tot['library']:.3f}, TF32 on {tot['library_tf32']:.3f}, plain "
        f"{tot['plain']:.3f}; floors: HBM {floors['hbm']:.3f}, 3xTF32 "
        f"{floors['tf32x3']:.3f} (share "
        f"{floors['tf32x3'] / tot['kernel']:.3f}, mma.sync body "
        f"{floors['tf32x3'] / tot['mma_sync']:.3f}), "
        f"FFMA {floors['ffma']:.3f}; max abs err {err:.3g}; y bit-equal "
        f"between the bodies at {same} of {n_calls} calls; on the "
        f"mma.sync body by the rule: {', '.join(refused) or 'none'}; "
        f"slower than F.conv2d TF32 off at: {', '.join(losses) or 'none'}")
    rounding = tf32_rounding(torch, g, inputs)

    edge_err = 0.0
    for tag, body in (("", contextlib.nullcontext),
                      (" (mma.sync body)", mma_sync_tf32_body)):
        with body():
            for (n, h, w, cin, cout) in k3m.EDGE_SHAPES:
                x, wt = inputs(n, h, w, cin, cout)
                b = 0.1 * torch.randn((cout,), generator=g, device=dev)
                for kw in ({}, dict(leaky=0.2), dict(relu=True)):
                    got = k3m.conv3x3_bil(x, wt, b, **kw)
                    again = k3m.conv3x3_bil(x, wt, b, **kw)
                    want = k3m.conv3x3_bil_plain(x, wt, b, **kw)
                    torch.cuda.synchronize()
                    name = (f"bil_conv f32 edge {(n, h, w, cin, cout)} "
                            f"{kw}{tag}")
                    check_close(name, got, want, **TOL["f32"])
                    assert torch.equal(got, again), name + ": repeat differs"
                    edge_err = max(edge_err, max_err(got, want))
                del x, wt, got, again, want
    bodies = [f32_plan(*s, kernel3=True).split(" plan")[0]
              for s in k3m.EDGE_SHAPES]
    log(f"bil_conv f32 edge cases: {len(k3m.EDGE_SHAPES)} shapes x 3 "
        f"epilogues on both bodies (the rule's: "
        f"{ {b: bodies.count(b) for b in sorted(set(bodies))} }), "
        f"max |err| {edge_err:.3g} (tol {TOL['f32']}), repeats "
        f"bit-identical")

    # bf16 stays on the FFMA core (on no path): generate's design case
    x, wt = (t.to(torch.bfloat16) for t in inputs(BATCH, 1024, 1024, 16, 16))
    b = 0.1 * torch.randn((16,), generator=g, device=dev)
    y = k3m.conv3x3_bil(x, wt, b, leaky=0.2)
    yp = k3m.conv3x3_bil_plain(x, wt, b, leaky=0.2)
    torch.cuda.synchronize()
    check_close("bil_conv bf16 (FFMA) main_7.conv_1 / cvt_8 at batch 8", y,
                yp, **TOL["bf16"])
    bf16_err = max_err(y, yp)
    log(f"bil_conv bf16 (FFMA body) {(BATCH, 1024, 1024, 16, 16)}: max|err| "
        f"{bf16_err:.3g} (tol {TOL['bf16']})")
    del x, wt, y, yp
    total, by = summed_bound(bounds)
    return dict(errs={"f32": max(err, edge_err), "bf16": bf16_err},
                ms=tot["kernel"], mma_sync_ms=tot["mma_sync"],
                plain_ms=tot["plain"], library_ms=tot["library"],
                library_tf32_ms=tot["library_tf32"], bound_ms=total,
                bound_by=by, rounding=rounding,
                on_mma_sync_body=refused, bit_equal_bodies=same)


def tf32_chain(torch, x, w, cps, trunc):
    """The 3xTF32 sum of a 3x3 conv as the Hopper body orders it (chunks of
    16 Cin, then taps, then 8 channels a k8 step: A_hi B_hi and A_hi B_lo
    into two f32 accumulators, then A_lo B_hi into the first, each added
    with one rounding of the accumulator, toward zero (``trunc``) or to
    nearest, of products of truncated tf32 operands; the two accumulators
    added to nearest at the end of a chain of ``cps`` chunks, the chains in
    order); x NHWC, w HWIO on the card, -> (pixels, Cout) f32.
    tests/test_torch_sm90_tf32.py emulates the same on the CPU."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + h, kx:kx + wd]
                        for ky in range(3) for kx in range(3)], 3)
    cols = cols.reshape(-1, 9, cin)

    def split(v):
        hi = (v.view(torch.int32) & -8192).view(torch.float32)
        return hi, ((v - hi).view(torch.int32) & -8192).view(torch.float32)

    def mma(acc, a, b):
        s = acc.double() + a.double() @ b.double()
        r = s.float()
        if trunc:
            over = r.double().abs() > s.abs()
            r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
        return r

    wk = w.reshape(9, cin, cout)
    chunks = -(-cin // 16)
    total = torch.zeros((cols.shape[0], cout), device=x.device)
    for c0 in range(0, chunks, cps):
        hh, hl = torch.zeros_like(total), torch.zeros_like(total)
        for c in range(c0, min(chunks, c0 + cps)):
            for t in range(9):
                for kk in (0, 8):
                    ch = slice(c * 16 + kk, min(cin, c * 16 + kk + 8))
                    (ah, al), (bh, bl) = split(cols[:, t, ch]), split(wk[t, ch])
                    hh, hl = mma(hh, ah, bh), mma(hl, ah, bl)
                    hh = mma(hh, al, bh)
        total = total + (hh + hl)
    return total


def tf32_rounding(torch, g, inputs):
    """How the Hopper body's wgmma rounds its f32 accumulator: kernel 3 at
    the longest chain a train step makes (cvt_5, 128^2, Cin 128 -> 32: one
    chain of 8 chunks, 72 k8 steps), and kernel 1 at a split path shape
    (8^2 512 -> 512 at batch 8: 4 chains of 8 chunks added by the finish
    kernel; noise, nscale and bias 0, leaky slope 1, so y is the sum),
    against the f64 sum, and against the 3xTF32 chain emulated with each
    step's sum truncated (as mma.sync does, tests/test_torch_f32_tc.py) and
    rounded to nearest (``tf32_chain``; the chains added in order, to
    nearest, in both): the share of outputs each emulation gives bit for
    bit, and the signed mean error relative to the f64 sum (truncation
    biases it toward zero)."""
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels.tc_plan import (plan_tf32,
                                                            plan_tf32_in_stats)

    def measure(shape, y, p):
        x, wt = shape_inputs[shape]
        y = y.reshape(-1, shape[4])
        ref = torch.nn.functional.conv2d(
            x.double().permute(0, 3, 1, 2), wt.double().permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1).reshape(-1, shape[4])
        out = {"shape": shape, "plan": p.args(),
               "max_abs_err": float((y.double() - ref).abs().max()),
               "bias": float(((y.double() - ref) * ref.sign()).mean())}
        for tag, trunc in (("truncating", True), ("nearest", False)):
            e = tf32_chain(torch, x, wt, p.cps, trunc)
            out[tag] = dict(
                bit_equal=float((e == y).double().mean()),
                max_abs_err=float((e.double() - ref).abs().max()),
                bias=float(((e.double() - ref) * ref.sign()).mean()))
        out["matches"] = max(("truncating", "nearest"),
                             key=lambda k: out[k]["bit_equal"])
        log(f"tf32 accumulator rounding at {shape} (plan {p.args()}: "
            f"{p.splits} chain(s) of {p.cps} chunks): kernel max |err| "
            f"{out['max_abs_err']:.3g}, signed mean error toward |y| "
            f"{out['bias']:.3g}; emulated truncating: bit-equal share "
            f"{out['truncating']['bit_equal']:.4f}, max |err| "
            f"{out['truncating']['max_abs_err']:.3g}, bias "
            f"{out['truncating']['bias']:.3g}; to nearest: bit-equal share "
            f"{out['nearest']['bit_equal']:.4f}, max |err| "
            f"{out['nearest']['max_abs_err']:.3g}, bias "
            f"{out['nearest']['bias']:.3g}; wgmma matches the "
            f"{out['matches']} emulation")
        return out

    k3, k1 = (1, 128, 128, 128, 32), (BATCH, 8, 8, 512, 512)
    shape_inputs = {s: inputs(*s) for s in (k3, k1)}
    out = measure(k3, k3m.conv3x3_bil(*shape_inputs[k3]), plan_tf32(*k3))
    n, h, w, _, cout = k1
    zn, zc = (torch.zeros((n, h, w), device="cuda"),
              torch.zeros((cout,), device="cuda"))
    y1 = k1m.conv3x3_noise_bias_lrelu_instats(*shape_inputs[k1], zn, zc, zc,
                                              leaky=1.0)[0]
    out["kernel1"] = measure(k1, y1, plan_tf32_in_stats(*k1))
    return out


# Conv3x3's output and gradients against torch.autograd through the plain
# conv, f32 with TF32 off.  y and dX: the kernels sum 9*Cin (9*Cout)
# products per value in another order than cuDNN (values ~1).  dW and db
# are cuDNN / torch reductions on both sides over up to 1024^2 pixels, in
# orders that differ and do not repeat (cuDNN's wgrad adds the pixel splits
# with atomics).  Their rounding follows the partial sums (~1e3), not the
# value: an element near 0 is off by ~2e-3.  So each element of dW and db
# may also differ by SUM_ROUNDING (one unit of f32 roundoff per side) times
# its sum of |terms|, sum|x*dy| or sum|dy| over the pixels.
GRAD_TOL = {"y": TOL["f32"], "dX": TOL["f32"],
            "dW": dict(atol=1e-3, rtol=1e-4),
            "db": dict(atol=1e-3, rtol=1e-4)}
SUM_ROUNDING = 2 * 2.0 ** -24


def phase_conv_grads(torch, scfg, g):
    from gan_segmentation_tpu_torch.kernels.conv3x3_grad import Conv3x3
    from gan_segmentation_tpu_torch.kernels.small_conv import \
        conv3x3_small_plain

    dev = torch.device("cuda")
    worst = {"y": 0.0, "dX": 0.0, "dW": 0.0, "db": 0.0}
    for (name, n, h, w, cin, cout, _, dx) in train_conv_shapes(scfg):
        x = torch.randn((n, h, w, cin), generator=g, device=dev)
        wt = torch.randn((3, 3, cin, cout), generator=g, device=dev) / (
            9 * cin) ** 0.5
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        dy = torch.randn((n, h, w, cout), generator=g, device=dev)
        got = [x.clone().requires_grad_(dx), wt.clone().requires_grad_(),
               b.clone().requires_grad_()]
        y = Conv3x3.apply(*got)
        y.backward(dy)
        want = [x.clone().requires_grad_(dx), wt.clone().requires_grad_(),
                b.clone().requires_grad_()]
        yp = conv3x3_small_plain(*want)
        yp.backward(dy)
        torch.cuda.synchronize()
        check_close(f"Conv3x3 y {name}", y, yp, **GRAD_TOL["y"])
        worst["y"] = max(worst["y"], max_err(y, yp))
        abs_sum = {"dX": 0.0,
                   "dW": torch.nn.grad.conv2d_weight(
                       x.abs().permute(0, 3, 1, 2), (cout, cin, 3, 3),
                       dy.abs().permute(0, 3, 1, 2), padding=1
                   ).permute(2, 3, 1, 0),
                   "db": dy.abs().sum(dim=(0, 1, 2))}
        for tag, a, r in zip(("dX", "dW", "db"), got, want):
            if tag == "dX" and not dx:
                assert a.grad is None, f"{name}: dX computed for a cvt conv"
                continue
            check_close(f"Conv3x3 {tag} {name}", a.grad, r.grad,
                        extra=SUM_ROUNDING * abs_sum[tag], **GRAD_TOL[tag])
            worst[tag] = max(worst[tag], max_err(a.grad, r.grad))
        del x, wt, dy, got, want, y, yp, abs_sum
    log(f"Conv3x3 output and gradients at the {len(train_conv_shapes(scfg))} "
        f"train shapes vs torch.autograd through the plain conv: max |err| "
        f"y {worst['y']:.3g}, dX {worst['dX']:.3g}, dW {worst['dW']:.3g}, "
        f"db {worst['db']:.3g} (tol {GRAD_TOL}; dW and db also "
        f"{SUM_ROUNDING:.3g} * their sum of |terms|)")


def phase_small_reference(torch):
    """A narrow slice (res 32) on the card, f32, through the kernels, against
    the same slice on the CPU through the plain versions."""
    import numpy as np

    from gan_segmentation_tpu_torch.core.config import SolverConfig
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    outs, logits = {}, {}
    cfg = SolverConfig(max_res_log2=5)
    with tempfile.TemporaryDirectory() as empty:  # no weights, no checkpoint
        for dev in (torch.device("cpu"), torch.device("cuda")):
            gen = ImageGenerator(gan="bedrooms", batch_size=4, dtype="fp32",
                                 max_res_log2=5, gan_dir=empty, seed=7,
                                 device=dev)
            solver = SegSolver(5, "", empty, cfg=cfg, device=dev)
            pipe = FusedPipeline(gen, solver, inference_dtype=torch.float32)
            z = torch.randn((4, gen.cfg.latent_size),
                            generator=torch.Generator().manual_seed(3)).to(dev)
            # noise scales are zero at random init: the noise draw cannot
            # differ
            outs[dev.type] = [t.cpu() for t in pipe._fused(
                z, torch.Generator(device=dev).manual_seed(5))]
            with torch.inference_mode():
                _, feats = gen.model(z, generator=torch.Generator(
                    device=dev).manual_seed(5))
                logits[dev.type] = solver.model(feats).cpu()
    (ic, mc), (ig, mg) = outs["cpu"], outs["cuda"]
    lsb = int((ic.int() - ig.int()).abs().max())
    assert lsb <= 1, f"small slice: images differ by {lsb} LSB"
    lc = logits["cpu"]
    confident = (lc[..., 1] - lc[..., 0]).abs() > 1e-3
    unpacked = [torch.from_numpy(np.unpackbits(m.numpy(), axis=-1))
                for m in (mc, mg)]
    diff = (unpacked[0] != unpacked[1]) & confident
    assert not bool(diff.any()), "small slice: masks differ"
    log(f"small slice (res 32, f32) card vs CPU: images within {lsb} LSB, "
        f"masks equal on {int(confident.sum())} confident pixels")


def phase_slice(torch):
    import numpy as np

    from gan_segmentation_tpu_torch.apps.main import run_generate
    from gan_segmentation_tpu_torch.core.config import AppConfig
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    try:
        import cv2
    except ImportError:
        cv2 = None
    with tempfile.TemporaryDirectory() as base:
        cfg = AppConfig(BASE_DIR=base, GAN="ffhq",
                        GAN_DIR=os.path.join(base, "no-models"),
                        GAN_BATCH_SIZE_PER_GPU=BATCH,
                        GENERATE_NUM=GENERATE_NUM)
        SegSolver(cfg.max_res_log2, "", os.path.join(base, "checkpoints"),
                  cfg=cfg.solver_config()).save()
        n_batches = -(-GENERATE_NUM // BATCH)

        with LaunchTrace(torch) as trace:
            t0 = time.perf_counter()
            if cv2 is not None:
                run_generate(cfg, writer="cv2")
            else:
                log("no host encoder on this machine (cv2 missing, the "
                    "native writer is not used here): checking "
                    "generate_batches instead")
                solver = SegSolver(cfg.max_res_log2, "",
                                   os.path.join(base, "checkpoints"),
                                   cfg=cfg.solver_config())
                pipe = FusedPipeline(ImageGenerator(
                    gan="ffhq", gan_dir=cfg.GAN_DIR, batch_size=BATCH),
                    solver)
                batches = list(pipe.generate_batches(GENERATE_NUM))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n1, n2 = trace.device["conv_in_stats"], trace.device["small_conv"]
        log(f"slice launches (device trace): conv_in_stats {n1}, small_conv "
            f"{n2} ({n_batches} batches; the wrappers counted {trace.wrapper}"
            f", eager and recorded at the capture)")
        assert n1 == 9 * n_batches, "conv_in_stats must run 9x per batch"
        assert n2 > 0, "small_conv was not launched"

        if cv2 is not None:
            out = os.path.join(base, "dataset", "train_generated")
            imgs = sorted(f for f in os.listdir(out) if f.startswith("img_"))
            masks = sorted(f for f in os.listdir(out)
                           if f.startswith("mask_"))
            assert len(imgs) == len(masks) == GENERATE_NUM, (len(imgs),
                                                            len(masks))
            values = set()
            for name in imgs:
                im = cv2.imread(os.path.join(out, name))
                assert im is not None and im.shape == (1024, 1024, 3), name
            for name in masks:
                m = cv2.imread(os.path.join(out, name), cv2.IMREAD_GRAYSCALE)
                assert m is not None and m.shape == (1024, 1024), name
                values |= set(np.unique(m).tolist())
        else:
            assert sum(b[0].shape[0] for b in batches) == GENERATE_NUM
            values = set()
            for imgs, masks, packed in batches:
                assert imgs.shape[1:] == (1024, 1024, 3)
                m = np.unpackbits(masks, axis=-1) if packed else masks
                values |= set(np.unique(m).tolist())
        assert values <= {0, 1}, values
        log(f"slice: {GENERATE_NUM} pairs at 1024^2 written, mask values "
            f"{sorted(values)}, {GENERATE_NUM / wall:.3f} samples/s end to "
            f"end including the cv2 writer, traced ({wall:.2f} s)")

        # determinism, finiteness, and the device pipeline's own rate
        solver = SegSolver(cfg.max_res_log2, "",
                           os.path.join(base, "checkpoints"),
                           cfg=cfg.solver_config())

        def fresh():
            return FusedPipeline(ImageGenerator(
                gan="ffhq", gan_dir=cfg.GAN_DIR, batch_size=BATCH), solver)

        a = [t.cpu().numpy() for t in fresh().sample_batch()]
        b = [t.cpu().numpy() for t in fresh().sample_batch()]
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b)), \
            "sample_batch(0) differs between two fresh pipelines"
        log("repeat: two fresh sample_batch(0) calls are bit-identical")

        pipe = fresh()
        z, gen = pipe.gen.next_inputs(BATCH)
        with torch.inference_mode():
            rgb, feats = pipe.gen.model(z, generator=gen)
            logits = solver.model(feats, pipe._prepared(), pipe.dec_dtype)
        assert rgb.shape == (BATCH, 1024, 1024, 3)
        assert logits.shape == (BATCH, 1024, 1024, 2)
        assert bool(torch.isfinite(rgb.float()).all()), "rgb not finite"
        assert bool(torch.isfinite(logits).all()), "logits not finite"
        with torch.inference_mode():
            gen_ms = cuda_ms(lambda: pipe.gen.model(z, generator=gen), 5)
            dec_ms = cuda_ms(lambda: solver.model(
                feats, pipe._prepared(), pipe.dec_dtype), 5)

        rate = pipeline_rate(torch, pipe, GENERATE_NUM)
        log(f"device pipeline (generate_batches, no writer): {rate:.3f} "
            f"samples/s at 1024^2, batch {BATCH}; stages per batch (CUDA "
            f"events, 5 batches): generator {gen_ms:.3f} ms, decoder "
            f"{dec_ms:.3f} ms")
    return dict(launches=trace.device, wrapper=trace.wrapper,
                end_to_end_sps=GENERATE_NUM / wall, pipeline_sps=rate,
                gen_ms=gen_ms, dec_ms=dec_ms)


def make_collection(gen, dst, n):
    """Write the next ``n`` samples of ``gen`` (the port's seeded random
    generator) with ``save_annotation_sample``: the mask is the sign of
    channel 0 of the last-scale feature, top two rows ignored
    (tests/util_fixtures.py::mask_rule and make_annotation_dir)."""
    import numpy as np

    from gan_segmentation_tpu_torch.data.collection import \
        save_annotation_sample

    os.makedirs(dst, exist_ok=True)
    done = 0
    while done < n:
        imgs, feats, _ = gen.sample_batch()
        imgs = imgs.cpu().numpy()
        for i in range(min(imgs.shape[0], n - done)):
            fs = [f[i].float().cpu().numpy() for f in feats]
            trimap = (fs[-1][..., 0] > 0).astype(np.int32)
            trimap[:2] = -1
            save_annotation_sample(dst, done, imgs[i], trimap, fs)
            done += 1


class LogLines(logging.Handler):
    """Collects the messages of one logger (the solver's epoch lines)."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger(name)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)

    def floats(self, key):
        pat = re.compile(re.escape(key) + r"=([-+0-9.eE]+|nan|inf)")
        return [float(m.group(1)) for line in self.lines
                if (m := pat.search(line))]


def phase_small_train_reference(torch):
    """Three fit steps at res 32, f32, dropout off: on the card through the
    kernels and on the CPU through the plain versions, from the same seeded
    init in the same batch order.  Per-step losses agree within rtol 1e-4:
    both sides sum in f32 in different orders, and Adam's first updates
    (about lr * sign(g)) flip only where |g| is at rounding level, the
    pre-BN conv biases, which the batch norm cancels."""
    from gan_segmentation_tpu_torch.core.config import SolverConfig
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.train.generator import ImageGenerator
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    losses = {}
    with tempfile.TemporaryDirectory() as base:
        gen = ImageGenerator(gan="bedrooms", batch_size=3, dtype="fp32",
                             max_res_log2=5, gan_dir=join(base, "none"),
                             seed=7, device=torch.device("cpu"))
        make_collection(gen, join(base, "data"), 3)
        for dev in (torch.device("cpu"), torch.device("cuda")):
            cfg = SolverConfig(max_res_log2=5, use_dropout=False)
            cfg.train_epochs = 1
            solver = SegSolver(5, join(base, "data"),
                               join(base, f"ckpt-{dev.type}"), cfg=cfg,
                               device=dev)
            before = k3m.conv3x3_bil.launches
            solver.fit()
            launched = k3m.conv3x3_bil.launches - before
            assert (launched > 0) == (dev.type == "cuda"), launched
            losses[dev.type] = solver.history[0]
    cpu, card = losses["cpu"], losses["cuda"]
    assert len(cpu) == len(card) == 3, (cpu, card)
    for a, b in zip(card, cpu):
        assert abs(a - b) <= 1e-4 * abs(b), (card, cpu)
    log(f"small train reference (res 32, f32, 3 steps) card vs CPU losses: "
        f"{[f'{v:.6f}' for v in card]} vs {[f'{v:.6f}' for v in cpu]} "
        f"(rtol 1e-4)")
    small_graphed_fit_is_the_per_step_fit(torch)


@contextlib.contextmanager
def graph_optimizer_per_step():
    """The per-step path with the graph path's optimizer (Adam
    ``capturable``, SGD ``fused``, the rate a device tensor): the eager
    twin of a graphed fit, step for step the same arithmetic."""
    import warnings
    from unittest import mock

    from gan_segmentation_tpu_torch.train.solver import SegSolver

    real = SegSolver._make_optimizer

    def make(self, iters_per_epoch=1, graphed=False):
        return real(self, iters_per_epoch, True)

    with mock.patch.object(SegSolver, "_make_optimizer", make), \
            warnings.catch_warnings():
        warnings.filterwarnings("ignore", "This instance was constructed "
                                "with capturable=True")
        yield


def small_graphed_fit_is_the_per_step_fit(torch):
    """At res 32 on the card in cuDNN's deterministic mode, dropout on, with
    Adam and with SGD (momentum 0.9, weight decay): a fit of 4 epochs x 3
    steps as replays of its graph (2 eager steps, the capture, 9 replays)
    equals its eager twin (the per-step path with the graph's optimizer)
    bit for bit, every step's loss and the final weights; its distance from
    the per-step path's own optimizer is read."""
    import dataclasses

    import numpy as np

    from gan_segmentation_tpu_torch.core.config import SolverConfig
    from gan_segmentation_tpu_torch.train.generator import ImageGenerator
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    seen = {}
    with tempfile.TemporaryDirectory() as base, cudnn_deterministic(torch):
        gen = ImageGenerator(gan="bedrooms", batch_size=3, dtype="fp32",
                             max_res_log2=5, gan_dir=join(base, "none"),
                             seed=7, device=torch.device("cpu"))
        make_collection(gen, join(base, "data"), 3)
        for opt in ("adam", "sgd"):
            cfg = SolverConfig(max_res_log2=5, optimizer=opt,
                               scheduler="cos",
                               wd=1e-4 if opt == "sgd" else 0.0,
                               momentum=0.9 if opt == "sgd" else None)
            cfg.train_epochs = 4
            runs = {}
            for tag, scan in (("plain", False), ("twin", False),
                              ("graph", None)):
                solver = SegSolver(
                    5, join(base, "data"), join(base, f"c-{opt}-{tag}"),
                    cfg=dataclasses.replace(cfg, scan_epochs=scan))
                with LogLines("gan_segmentation_tpu_torch.train.solver"
                              ) as lines, (graph_optimizer_per_step()
                                           if tag == "twin"
                                           else contextlib.nullcontext()):
                    solver.fit()
                graphed = any(m.startswith("scan_epochs: each")
                              for m in lines.lines)
                assert graphed == (scan is None), (opt, scan)
                runs[tag] = (np.array(solver.history), {
                    k: v.clone() for k, v in
                    solver.model.state_dict().items()})
            (h_twin, w_twin), (h_graph, w_graph) = runs["twin"], runs["graph"]
            assert (h_graph == h_twin).all(), (opt, h_graph, h_twin)
            assert all(torch.equal(w_graph[k], w_twin[k])
                       for k in w_twin), f"{opt}: weights differ"
            h_plain = runs["plain"][0]
            seen[opt] = (h_graph[-1][-1], float(np.max(
                np.abs(h_graph - h_plain) / np.abs(h_plain))))
    log(f"small graphed fit (res 32, 4 epochs x 3 steps, dropout on, cuDNN "
        f"deterministic): every loss and the final weights bit-identical to "
        f"its eager twin, Adam and SGD (last losses, and the max relative "
        f"loss distance from the per-step optimizer: "
        f"{', '.join(f'{k} {v:.7f} {d:.3g}' for k, (v, d) in seen.items())})")


def kernel_times(prof):
    """ms per device kernel name in a ``torch.profiler`` trace: kernels
    only (user ranges such as "Optimizer.step#Adam.step" also sit on the
    device timeline and overlap the kernels they enclose)."""
    from torch.autograd import DeviceType

    by_name = {}
    for evt in prof.events():
        annotation = (getattr(evt, "is_user_annotation", False)
                      or evt.name.startswith("Optimizer."))
        if evt.device_type == DeviceType.CUDA and not annotation:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    return by_name


def decoder_family(name):
    """The kernel family of a decoder train step's device kernel."""
    low = name.lower()
    # the 3xTF32 kernels carry their kernel's number as the last template
    # argument; only kernels 1 and 2 split K (finish kernel)
    tf32 = re.search(r"conv3x3_(?:tf32|sm90)_kernel<[^>]*,\s*(\d)>", name)
    if tf32:
        return {"1": "conv_in_stats", "2": "small_conv", "3": "bil_conv",
                "8": "small_conv"}[tf32.group(1)]
    if "conv3x3_tf32_finish" in low:
        return "small_conv"
    # a train step's Hopper-body split-K finish: kernel 3's (its kernel-2
    # calls, Cin 512 / 256, stay on the mma.sync body)
    if "conv3x3_tc_finish" in low:
        return "bil_conv"
    if "conv3x3_bil" in low:
        return "bil_conv"
    if "wgrad" in low:
        return "cuDNN wgrad"
    if any(k in low for k in ("conv", "gemm", "xmma", "cudnn", "cutlass")):
        return "cuDNN other"
    return "elementwise + reductions (BN, leaky, dropout, loss, Adam)"


def families(by_name, steps, family=decoder_family):
    fam = {}
    for name, t in by_name.items():
        fam[family(name)] = fam.get(family(name), 0.0) + t / steps
    return fam


def graph_fit_runner(torch, base, scfg):
    """A fresh solver on the collection of ``base`` with its graphed epoch
    loop ready (``SegSolver._graphed_epochs``, the collection resident):
    -> (solver, run)."""
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    solver = SegSolver(scfg.max_res_log2, join(base, "data"),
                       join(base, "no-checkpoints"), cfg=scfg)
    dataset, iters = solver.init_data()
    cached = solver._try_device_cache(dataset)
    assert cached is not None, "the collection is not resident"
    opt, lr = solver._make_optimizer(iters, graphed=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    solver.model.train()
    return solver, solver._graphed_epochs(opt, lr, cached, gen)


def profile_train_step(torch, base, scfg, steps=5):
    """A train step at ffhq 1024^2, batch 1: its time (CUDA events over 10
    steps), whether the host or the device bounds it (three windows of 10
    steps: wall time, the time the host took to enqueue them, and the
    process's CPU time), and its device time by kernel family
    (torch.profiler); then the same for the step as replays of its CUDA
    graph (``SegSolver._graphed_epochs``), windows of one epoch each."""
    from torch.profiler import ProfilerActivity, profile

    from gan_segmentation_tpu_torch.data.collection import CollectionDataset
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    solver = SegSolver(scfg.max_res_log2, join(base, "data"),
                       join(base, "checkpoints"), cfg=scfg)
    _, mask, feats = CollectionDataset(join(base, "data"), scfg,
                                       load_to_memory=False).get_item(0)
    dev = torch.device("cuda")
    feats = [torch.from_numpy(f[None]).to(dev) for f in feats]
    mask = torch.from_numpy(mask[None]).to(dev).long()
    opt, _ = solver._make_optimizer(TRAIN_SAMPLES)
    gen = torch.Generator(device=dev).manual_seed(0)
    solver.model.train()

    def step():
        solver._train_step(opt, feats, mask, gen)

    for _ in range(3):
        step()
    step_ms = cuda_ms(step)
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(10):
            step()
        enqueued = time.perf_counter()
        torch.cuda.synchronize()
        t1, c1 = time.perf_counter(), time.process_time()
        windows.append(((t1 - t0) * 100, (enqueued - t0) * 100,
                        (c1 - c0) * 100))  # ms per step
    log("train step windows of 10 steps (ms per step: wall / host enqueue "
        "/ process CPU): " + "; ".join(
            f"{w:.3f} / {e:.3f} / {c:.3f}" for w, e, c in windows))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    by_name = kernel_times(prof)
    fam = families(by_name, steps)
    busy = sum(fam.values())
    log(f"train step (ffhq 1024^2, batch 1, f32): {step_ms:.3f} ms "
        f"(CUDA events, 10 steps); kernel time {busy:.3f} ms per step "
        f"(profiler), i.e. a device busy share of {busy / step_ms:.3f} of "
        f"the unprofiled step (a profiled step took "
        f"{window_ms / steps:.3f} ms); peak memory {peak_gb:.2f} GiB")
    for name, t in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {t:.3f} ms/step ({t / busy:.3f} of device time)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"    {t / steps:8.3f} ms/step  {name[:110]}")
    del solver, opt, feats, mask
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, windows=windows, families=fam, busy_ms=busy,
                **profile_graphed_step(torch, base, scfg))


def profile_graphed_step(torch, base, scfg, tag=""):
    """The train step as replays of its CUDA graph: three epochs of 20
    steps (wall, host enqueue and process CPU per step), then a profiled
    epoch: its device time by kernel family, its launches per replay
    against the trace's."""
    from torch.profiler import ProfilerActivity, profile

    gsolver, run = graph_fit_runner(torch, base, scfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    run(0, 0).cpu()  # the eager warm-up steps, the capture, the replays
    torch.cuda.empty_cache()
    # what the first epoch keeps reserved: the graph's pool and the
    # optimizer's state
    pool_gb = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    gwindows, done = [], TRAIN_SAMPLES
    for epoch in range(1, 4):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        series = run(epoch, done)
        enqueued = time.perf_counter()
        torch.cuda.synchronize()
        t1, c1 = time.perf_counter(), time.process_time()
        n = len(series)
        done += n
        gwindows.append(((t1 - t0) * 1e3 / n, (enqueued - t0) * 1e3 / n,
                         (c1 - c0) * 1e3 / n))
        assert bool(torch.isfinite(series.cpu()).all())
    gpeak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_margin(torch)
        t0 = time.perf_counter()
        n = len(run(4, done))
        torch.cuda.synchronize()
        gwindow_ms = (time.perf_counter() - t0) * 1e3
        trace_margin(torch)
    fns = kernel_wrappers()
    ran = dict.fromkeys(fns, 0)
    for name in device_kernel_names(prof):
        k = kernel_of(name)
        if k is not None:
            ran[k] = ran.get(k, 0) + 1
    per_replay = {k: run.call.deltas[fn] for k, fn in fns.items()}
    assert ran == {k: d * n for k, d in per_replay.items()}, (ran, per_replay)
    gby_name = kernel_times(prof)
    gfam = families(gby_name, n)
    gbusy = sum(gfam.values())
    graph_ms = min(w for w, _, _ in gwindows)
    log(f"train step as CUDA-graph replays{tag}, windows of one epoch of "
        f"{TRAIN_SAMPLES} steps (ms per step: wall / host enqueue / "
        "process CPU): " + "; ".join(
            f"{w:.3f} / {e:.3f} / {c:.3f}" for w, e, c in gwindows)
        + f"; kernel time {gbusy:.3f} ms per step (profiler), a busy "
        f"share of {gbusy / graph_ms:.3f} of the fastest window (a "
        f"profiled epoch took {gwindow_ms / n:.3f} ms a step); the first "
        f"epoch keeps {pool_gb:.3f} GiB reserved (the graph's pool, Adam's "
        f"state), peak memory {gpeak_gb:.2f} GiB; launches per replay "
        f"{per_replay}, and the profiled epoch's trace ran {ran} in {n} "
        f"replays")
    for name, t in sorted(gfam.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {t:.3f} ms/step ({t / max(gbusy, 1e-9):.3f} of "
            f"device time)")
    del gsolver, run
    torch.cuda.empty_cache()
    return dict(graph_windows=gwindows, graph_ms=graph_ms,
                graph_busy_ms=gbusy, graph_families=gfam, pool_gib=pool_gb)


GRAPH_FIT_EPOCHS = 2     # the graph-vs-eager fits
BITS_STEPS = 3           # steps whose dropout bits are compared


@contextlib.contextmanager
def cudnn_deterministic(torch, on=True):
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def fit_series(torch, base, scfg, tag, scan, twin=False):
    """A ``GRAPH_FIT_EPOCHS``-epoch fit from the seeded init on the
    collection of ``base``: the per-step path (``scan`` False; ``twin``:
    with the graph's optimizer) or the graphed one (None, the auto rule on
    the card).  -> ((steps, 2) numpy (loss, accuracy) per step, the dropout
    keep masks of its first ``BITS_STEPS`` steps, the final weights, the
    fit's wall seconds)."""
    import dataclasses
    from unittest import mock

    from gan_segmentation_tpu_torch.models import decoder as dec
    from gan_segmentation_tpu_torch.ops.dropout import DROPOUT_RATE
    from gan_segmentation_tpu_torch.train import solver as solver_mod

    cfg = dataclasses.replace(scfg, train_epochs=GRAPH_FIT_EPOCHS,
                              scan_epochs=scan)
    solver = solver_mod.SegSolver(cfg.max_res_log2, join(base, "data"),
                                  join(base, f"ckpt-{tag}"), cfg=cfg)
    per_step = len(cfg.in_channels) - cfg.start_res
    bits, rows = [], []
    keep = 1.0 - DROPOUT_RATE

    def record(draws):
        for u in draws:
            if len(bits) < BITS_STEPS * per_step:
                bits.append(u < keep)

    real_dropout, real_draw = dec.dropout, dec.Decoder.draw_dropout
    real_log = solver._log_epoch

    def spy_dropout(x, generator=None, rate=DROPOUT_RATE, uniform=None):
        if uniform is None:  # the per-step path draws here
            uniform = torch.rand(x.shape, generator=generator,
                                 device=x.device)
            record([uniform])
        return real_dropout(x, rate=rate, uniform=uniform)

    def spy_draw(self, shapes, generator, out=None):
        out = real_draw(self, shapes, generator, out=out)
        record(out)  # the graphed path draws here, before each call
        return out

    def log_epoch(epoch, series, *a):
        rows.append(series.clone())
        return real_log(epoch, series, *a)

    solver._log_epoch = log_epoch
    with mock.patch.object(dec, "dropout", spy_dropout), \
            mock.patch.object(dec.Decoder, "draw_dropout", spy_draw), \
            (graph_optimizer_per_step() if twin
             else contextlib.nullcontext()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    series = torch.cat(rows).numpy()
    assert len(series) == GRAPH_FIT_EPOCHS * TRAIN_SAMPLES, len(series)
    assert len(bits) == BITS_STEPS * per_step, len(bits)
    weights = {k: v.clone() for k, v in solver.model.state_dict().items()}
    del solver
    torch.cuda.empty_cache()
    return series, bits, weights, wall


def fit_dist(x, y):
    """(max relative loss difference, max accuracy difference) of two
    fits' (steps, 2) series."""
    import numpy as np
    return (float(np.max(np.abs(x[:, 0] - y[:, 0]) / np.abs(y[:, 0]))),
            float(np.max(np.abs(x[:, 1] - y[:, 1]))))


SPREAD_FITS = 4          # per-step fits whose 6 pairs give the spread


def train_graph_vs_eager(torch, base, scfg):
    """Graphed fits against per-step fits, 2 epochs each from the same init
    on the same collection.  In cuDNN's deterministic mode (held): the
    graphed fit equals its eager twin (the per-step path with the graph's
    optimizer, Adam ``capturable``) bit for bit, every step's (loss,
    accuracy) and the final weights, and the dropout bits of its first
    steps equal the per-step path's; its distance from the per-step
    path's own optimizer is read.  In its default mode, where cuDNN's wgrad
    adds with atomics (held): step 1's loss within 1e-6 relative of the
    per-step fit's, and the graphed fit, taken as one more member of the
    per-step fits' ensemble, as far from them as they are from each other
    within twice: the median of its distances from ``SPREAD_FITS``
    per-step fits against the largest distance between two of them."""
    with cudnn_deterministic(torch):
        p, bits_p, _, wall_dp = fit_series(torch, base, scfg, "det-plain",
                                           False)
        t, _, w_t, wall_dt = fit_series(torch, base, scfg, "det-twin",
                                        False, twin=True)
        g, bits_g, w_g, wall_dg = fit_series(torch, base, scfg, "det-graph",
                                             None)
    same_series = bool((t == g).all())
    same_weights = all(torch.equal(w_t[k], w_g[k]) for k in w_t)
    same_bits = all(torch.equal(x, y) for x, y in zip(bits_g, bits_p))
    optimizer_dist = fit_dist(g, p)
    eager, walls = [], []
    for i in range(SPREAD_FITS):
        e, _, _, wall = fit_series(torch, base, scfg, f"eager-{i}", False)
        eager.append(e)
        walls.append(wall)
    g2, _, _, wall_g = fit_series(torch, base, scfg, "graph", None)
    pairs = [fit_dist(eager[j], eager[i]) for i in range(SPREAD_FITS)
             for j in range(i + 1, SPREAD_FITS)]
    spread = (max(d[0] for d in pairs), max(d[1] for d in pairs))
    dists = [fit_dist(g2, e) for e in eager]
    # the upper median of the graph's distances, per component
    apart = tuple(sorted(d[c] for d in dists)[SPREAD_FITS // 2]
                  for c in range(2))
    first = float(abs(g2[0, 0] - eager[0][0, 0]) / abs(eager[0][0, 0]))
    log(f"train graph vs eager ({GRAPH_FIT_EPOCHS} epochs x "
        f"{TRAIN_SAMPLES} steps each, ffhq 1024^2): cuDNN deterministic: "
        f"graph vs its eager twin: every step's loss and accuracy "
        f"{'bit-identical' if same_series else 'DIFFER'} (max "
        f"{fit_dist(g, t)}), final weights "
        f"{'bit-identical' if same_weights else 'DIFFER'}; dropout bits of "
        f"the first {BITS_STEPS} steps {'equal' if same_bits else 'DIFFER'} "
        f"({len(bits_g)} draws); graph vs the per-step optimizer max "
        f"relative loss difference {optimizer_dist[0]:.3g}, accuracy "
        f"{optimizer_dist[1]:.3g}; fit wall s per-step {wall_dp:.2f}, twin "
        f"{wall_dt:.2f}, graph {wall_dg:.2f}. Default mode: step 1 loss "
        f"{g2[0, 0]:.7f} vs {eager[0][0, 0]:.7f} (relative {first:.3g}, "
        f"limit 1e-6); graph vs each eager fit (max relative loss "
        f"difference, max accuracy difference) "
        f"{[tuple(float(f'{v:.3g}') for v in d) for d in dists]}, median "
        f"{apart[0]:.3g} / {apart[1]:.3g}; {len(pairs)} eager pairs "
        f"{[tuple(float(f'{v:.3g}') for v in d) for d in pairs]}, spread "
        f"{spread[0]:.3g} / {spread[1]:.3g} (limit twice that); fit wall s "
        f"(collection load included): eager "
        f"{', '.join(f'{w:.2f}' for w in walls)}, graph {wall_g:.2f}; final "
        f"loss eager {eager[0][-1, 0]:.6f}, graph {g2[-1, 0]:.6f}")
    assert same_bits, "dropout bits differ between the graphed and eager fits"
    check_later(same_series and same_weights, "train: the graphed fit is not "
                "its eager twin bit for bit in cuDNN's deterministic mode")
    check_later(first <= 1e-6, f"train: step 1 loss {g2[0]} vs {eager[0][0]}")
    check_later(apart[0] <= 2 * spread[0] and apart[1] <= 2 * spread[1],
                f"train: graph vs eager {apart} beyond twice the eager "
                f"spread {spread}")
    return dict(twin_equal=same_series and same_weights,
                optimizer_dist=optimizer_dist, first_rel=first, apart=apart,
                dists=dists, spread=spread, pairs=pairs,
                wall_s={"eager": walls, "graph": wall_g,
                        "deterministic": [wall_dp, wall_dt, wall_dg]})


def write_train_collection(torch, base):
    """``TRAIN_SAMPLES`` + ``EVAL_SAMPLES`` ffhq 1024^2 samples of the
    port's seeded f32 generator in ``base``/data and ``base``/eval, and
    ``base``/config.yml with the defaults.  -> (config path, its solver
    config)."""
    from gan_segmentation_tpu_torch.core.config import load_config_file
    from gan_segmentation_tpu_torch.train.generator import ImageGenerator

    gen = ImageGenerator(gan="ffhq", batch_size=BATCH, dtype="fp32",
                         gan_dir=join(base, "no-models"), seed=0)
    make_collection(gen, join(base, "data"), TRAIN_SAMPLES)
    # eval: the same generator, the next z of its stream
    make_collection(gen, join(base, "eval"), EVAL_SAMPLES)
    del gen
    torch.cuda.empty_cache()
    config = join(base, "config.yml")
    with open(config, "w") as fh:
        fh.write(f"BASE_DIR: {base}\nGAN: ffhq\n"
                 f"GAN_DIR: {join(base, 'no-models')}\n")
    return config, load_config_file(config).solver_config()


def phase_train(torch, keep_dir):
    """``main train`` then ``main evaluate`` at ffhq 1024^2 with the
    defaults (24 epochs, batch 1, Adam 1e-4, dropout on) on a collection
    of the port's seeded generator; falling loss, checkpoint, metrics, and
    mean-iou above the untrained decoder's.  ``main train`` runs twice:
    timed, then under a device trace for its launch counts (the trace
    slows the replays).  The trained checkpoint is copied into
    ``keep_dir`` (the export phase serves that decoder)."""
    import contextlib
    import io
    import math

    from gan_segmentation_tpu_torch.apps.main import main as cli
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    with tempfile.TemporaryDirectory() as base:
        free = shutil.disk_usage(base).free / 2 ** 30
        with LaunchTrace(torch) as ctrace:
            t0 = time.perf_counter()
            config, scfg = write_train_collection(torch, base)
        n_k1 = ctrace.device["conv_in_stats"]
        batches = -(-TRAIN_SAMPLES // BATCH) + -(-EVAL_SAMPLES // BATCH)
        log(f"train collection: {TRAIN_SAMPLES} + {EVAL_SAMPLES} ffhq 1024^2 "
            f"samples (f32 pyramids) written in "
            f"{time.perf_counter() - t0:.1f} s, traced ({free:.1f} GiB free "
            f"before); conv_in_stats (f32) launches {n_k1} over {batches} "
            f"batches of {BATCH} (device trace; the wrapper counted "
            f"{ctrace.wrapper['conv_in_stats']})")
        assert n_k1 == 9 * batches, "conv_in_stats must run 9x per batch"
        # by body: kernel 1's f32 calls on the Hopper body's tf32 form
        # (entry 9) wherever plan_tf32_in_stats takes the shape
        coll_by_body = {f"{k} {b}": v for (k, b), v in sorted(
            getattr(ctrace, "by_body", {}).items()) if k == "conv_in_stats"}
        log(f"collection launches by body (device trace): {coll_by_body}")
        if torch.cuda.is_available():
            from gan_segmentation_tpu_torch.core.config import gan_config
            from gan_segmentation_tpu_torch.kernels.tc_plan import \
                plan_f32_body
            on = sum(plan_f32_body(*s, noise=True).sm90
                     for s in kernel1_shapes(gan_config("ffhq")))
            want = {"conv_in_stats sm90_tf32": on * batches,
                    "conv_in_stats 3xtf32": (9 - on) * batches}
            assert coll_by_body == {k: v for k, v in want.items() if v}, (
                coll_by_body)
        steps = scfg.train_epochs * (TRAIN_SAMPLES // scfg.train_batch_size)

        def main_train():
            """-> (the solver's log lines, wall s, fit loop s after the
            first epoch); the fit replayed its graph."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with LogLines("gan_segmentation_tpu_torch.train.solver") as lines:
                cli(["train", "--config", config])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert any(line.startswith("scan_epochs: each step replays")
                       for line in lines.lines), "main train ran no graph"
            # each epoch's log line follows a sync
            return lines, wall, sum(lines.floats("Time cost")[1:])

        lines, wall, fit_s = main_train()
        with LaunchTrace(torch) as trace:
            _, traced_wall, traced_fit_s = main_train()
        n_bil, n_small = trace.device["bil_conv"], trace.device["small_conv"]
        log(f"train launches (device trace of the second run): bil_conv "
            f"{n_bil}, small_conv {n_small}, conv_in_stats "
            f"{trace.device['conv_in_stats']} over {steps} steps (expected "
            f"{BIL_PER_STEP} and {SMALL_PER_STEP} per step); the wrappers "
            f"counted {trace.wrapper} (the eager steps and the capture's "
            f"recording); traced run {traced_wall:.1f} s, its fit loop "
            f"{traced_fit_s:.3f} s against {fit_s:.3f} s untraced")
        assert n_bil == BIL_PER_STEP * steps, n_bil
        assert n_small == SMALL_PER_STEP * steps, n_small
        assert trace.device["conv_in_stats"] == 0, trace.device
        # by body: all of a step's kernel-3 calls on the tf32 Hopper body
        # but main_8_conv's input gradient (Cin 2); kernel 2's five (Cin
        # 512 / 256) on the mma.sync 3xTF32 body
        by_body = {f"{k} {b}": v for (k, b), v in sorted(
            getattr(trace, "by_body", {}).items())}
        log(f"train launches by body (device trace): {by_body}")
        if torch.cuda.is_available():
            assert by_body == {
                "bil_conv 3xtf32": steps,
                "bil_conv sm90_tf32": (BIL_PER_STEP - 1) * steps,
                "small_conv 3xtf32": SMALL_PER_STEP * steps}, by_body
        epoch_loss = lines.floats("Train-total-loss")
        epoch_acc = lines.floats("Train-accuracy")
        cost = lines.floats("Time cost")
        assert len(epoch_loss) == scfg.train_epochs, epoch_loss
        assert all(math.isfinite(v) for v in epoch_loss), epoch_loss
        assert epoch_loss[-1] < epoch_loss[0], epoch_loss
        ckpt = join(base, "checkpoints", "checkpoint_last.pt")
        assert os.path.isfile(ckpt), "no checkpoint written"
        shutil.copy(ckpt, keep_dir)
        # the fit loop's rate: every step after the first epoch over the
        # wall time of those epochs
        later = sorted(cost[1:])
        fit_steps = len(later) * TRAIN_SAMPLES
        log(f"train: epoch loss {epoch_loss[0]:.4f} -> {epoch_loss[-1]:.4f}, "
            f"accuracy {epoch_acc[0]:.4f} -> {epoch_acc[-1]:.4f}; "
            f"{fit_steps / fit_s:.3f} train samples/s, "
            f"{fit_s / fit_steps * 1e3:.3f} ms per step ({fit_steps} steps "
            f"of epochs 2-{len(cost)} in {fit_s:.3f} s; epoch times min "
            f"{later[0]:.3f} median {later[len(later) // 2]:.3f} max "
            f"{later[-1]:.3f} s), first epoch {cost[0]:.2f} s, "
            f"whole run {wall:.1f} s including the collection's load; "
            f"checkpoint {os.path.basename(ckpt)}")

        out = io.StringIO()
        with LaunchTrace(torch) as etrace, contextlib.redirect_stdout(out):
            cli(["evaluate", "--config", config])
        n_eval = etrace.device["small_conv"]
        line = out.getvalue().strip().splitlines()[-1]
        log(f"evaluate prints: {line}")
        metrics = dict(kv.split(": ") for kv in line.split(", "))
        assert list(metrics) == ["accuracy", "mean-iou", "total-loss"], line
        metrics = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in metrics.values()), metrics
        assert n_eval == SMALL_PER_EVAL_SAMPLE * EVAL_SAMPLES, n_eval
        assert etrace.device["bil_conv"] == 0, etrace.device
        # by body: an evaluate sample's kernel-2 calls on the tf32 Hopper
        # body but cvt_0..4 (Cin 512 / 256)
        eval_by_body = {f"{k} {b}": v for (k, b), v in sorted(
            getattr(etrace, "by_body", {}).items())}
        log(f"evaluate launches by body (device trace): {eval_by_body}")
        if torch.cuda.is_available():
            assert eval_by_body == {
                "small_conv 3xtf32": 5 * EVAL_SAMPLES,
                "small_conv sm90_tf32": (SMALL_PER_EVAL_SAMPLE - 5)
                * EVAL_SAMPLES}, eval_by_body

        untrained = SegSolver(scfg.max_res_log2, "",
                              join(base, "no-checkpoints"), cfg=scfg)
        assert not untrained.is_trained
        before = dict(untrained.evaluate(join(base, "eval")))
        log(f"untrained decoder on the same eval set: mean-iou "
            f"{before['mean-iou']:.4f}, accuracy {before['accuracy']:.4f}")
        assert metrics["mean-iou"] > before["mean-iou"], (metrics, before)
        prof = profile_train_step(torch, base, scfg)
        # the same graphed step with kernel 3's (and kernel 2's) f32 calls
        # on the mma.sync 3xTF32 body, in the same run
        with mma_sync_tf32_body():
            old = profile_graphed_step(torch, base, scfg,
                                       " (f32 on the mma.sync 3xTF32 body)")
        log(f"train step as graph replays, fastest window: "
            f"{prof['graph_ms']:.3f} ms on the rule's f32 bodies against "
            f"{old['graph_ms']:.3f} on the mma.sync 3xTF32 body; kernel 3 "
            f"{prof['graph_families'].get('bil_conv', 0.0):.3f} against "
            f"{old['graph_families'].get('bil_conv', 0.0):.3f} ms a step "
            f"(profiler)")
        versus = train_graph_vs_eager(torch, base, scfg)
    return dict(launches={"bil_conv": n_bil, "small_conv": n_small},
                launches_by_body=by_body, eval_launches_by_body=eval_by_body,
                collection_launches_by_body=coll_by_body,
                eval_launches=n_eval, versus=versus,
                wrapper=dict(collection=ctrace.wrapper, train=trace.wrapper,
                             evaluate=etrace.wrapper),
                collection_launches=n_k1, steps=steps,
                step_ms=fit_s / fit_steps * 1e3, sps=fit_steps / fit_s,
                traced_fit_s=traced_fit_s, fit_s=fit_s, metrics=metrics,
                prof=prof, prof_mma_sync=old)


# ------------------------------------------------- serving export (phase 5b)
# The generate program at ffhq 1024^2, batch 8, bf16, exported as an
# artifact and a bundle, and the bundle served from a fresh process; the
# DeepLab evaluator exported at the experiment's crop.  A served batch
# replays one CUDA graph of 9 kernel-1 and 26 kernel-2 launches.
EXPORT_SEED = 9
EXPORT_BATCHES = 4        # the eager first batch, the capture's, 2 replays
EXPORT_RATE_BATCHES = 6   # batches per timed run, served or live
EXPORT_DL_SHAPE = (1, 512, 512, 3)  # crop 480, base 512, flip: 8 windows

SERVE_WORKER = r"""
import json, sys, time
import torch
t0 = time.perf_counter()
from gan_segmentation_tpu_torch.core.export import draw_inputs, load_bundle
bundle, out, seed, n, det = sys.argv[1:]
torch.backends.cudnn.deterministic = det == "1"
torch.backends.cudnn.allow_tf32 = False
serve = load_bundle(bundle)
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
gen = torch.Generator(device=serve.device)
outs = []
for i in range(int(n)):
    gen.manual_seed(int(seed) * 2 ** 32 + i)
    outs.append([t.cpu() for t in serve(*draw_inputs(serve.meta, gen))])
torch.save(outs, out)
models = [m for m in sys.modules
          if m.startswith("gan_segmentation_tpu_torch.models")
          or m.split(".")[0] in ("jax", "gan_segmentation_tpu")]
print(json.dumps({"load_s": load_s, "replays": serve.call.replays,
                  "model_modules": models}))
"""


def start_fresh_serving(bundle, base, deterministic):
    """Start serving batches 0..EXPORT_BATCHES-1 from ``EXPORT_SEED`` with
    the bundle in a fresh interpreter that imports only ``core.export``;
    ``finish_fresh_serving`` collects them."""
    out = join(base, f"served_{int(deterministic)}.pt")
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_WORKER, bundle, out, str(EXPORT_SEED),
         str(EXPORT_BATCHES), "1" if deterministic else "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, out, time.perf_counter()


def finish_fresh_serving(torch, started):
    """-> (the fresh process's batches on the host, its record)."""
    proc, out, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, (stdout + stderr)[-4000:]
    rec = json.loads(stdout.strip().splitlines()[-1])
    rec["wall_s"] = time.perf_counter() - t0
    assert rec["replays"] == EXPORT_BATCHES - 1, rec
    assert not rec["model_modules"], rec
    return torch.load(out, weights_only=True), rec


def export_pipeline(torch, solver, gan_dir):
    """The phase's FusedPipeline: the seeded ffhq generator (bf16) with its
    noise scales moved off zero, so the served noise inputs show."""
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    gen = ImageGenerator(gan="ffhq", gan_dir=gan_dir, batch_size=BATCH,
                         seed=EXPORT_SEED)
    perturb(torch, gen.model, 34)
    return FusedPipeline(gen, solver)


def same_batches(torch, a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


def seconds_per_call(torch, step, n=EXPORT_RATE_BATCHES):
    """Wall seconds per call of ``step`` over ``n`` calls after one warm
    call, ending in a sync."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def phase_export_deeplab(torch, base):
    """The DeepLab evaluator (DeepLabV3+ resnet50, seeded, crop 480, base
    512, flip) exported at ``EXPORT_DL_SHAPE`` and served in this process
    (eager, capture, replay) against the live ``device_scores_batch`` of
    the same image, equal in cuDNN's deterministic mode (f32, TF32 off);
    ms per image of both with cuDNN's TF32 convs, in turns."""
    from gan_segmentation_tpu_torch.core import export as tex
    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
    from gan_segmentation_tpu_torch.train.deeplab_trainer import \
        MultiEvalModel

    model = DeepLabV3Plus(DL_CLASSES, "resnet50", aux=True,
                          crop_size=DL_CROP,
                          generator=torch.Generator().manual_seed(43))
    perturb(torch, model, 44)
    ev = MultiEvalModel(model.cuda(), DL_CLASSES, base_size=512,
                        crop_size=DL_CROP, flip=True)
    path = join(base, "deeplab_eval.pt2")
    b, h, w, c = EXPORT_DL_SHAPE
    image = torch.randn((h, w, c), generator=torch.Generator(
        device="cuda").manual_seed(45), device="cuda")
    t0 = time.perf_counter()
    tex.export_eval_model(ev, b, h, w, c, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = tex.load_artifact(path)
    load_s = time.perf_counter() - t0
    with cudnn_deterministic(torch):  # cuDNN's default f32 algorithms
        live = ev.device_scores_batch([image])  # differ run to run
        served = [serve(image[None]) for _ in range(3)]
    assert serve.call.replays == 2
    errs = [float((s - live).abs().max()) for s in served]
    # timed as step 5's evaluator runs: cuDNN's default mode with its TF32
    # convs (PyTorch's default), a fresh load captured so; in turns
    serve = tex.load_artifact(path)
    times = {"served": [], "live": []}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for tag in ("served", "live", "live", "served"):
            times[tag].append(1e3 * seconds_per_call(
                torch, (lambda: serve(image[None])) if tag == "served" else
                (lambda: ev.device_scores_batch([image])), n=3))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    rec = dict(export_s=export_s, load_s=load_s,
               size_bytes=os.path.getsize(path), max_abs_err=errs,
               ms=times, shape=list(EXPORT_DL_SHAPE))
    check_later(all(e == 0.0 for e in errs), "deeplab eval artifact: served "
                f"scores differ from the live evaluator's ({errs})")
    del serve, ev, model
    torch.cuda.empty_cache()
    return rec


def phase_export(torch, ckpt_dir, smi):
    """The serving export at ffhq 1024^2, batch 8, bf16, on the decoder in
    ``ckpt_dir`` (phase 5's, or a seeded random one when None): the
    artifact and the bundle exported (seconds, sizes); the bundle served
    in a fresh process, batches 0-3 from a seed equal to
    ``FusedPipeline.sample_batch`` from that seed bit for bit (in cuDNN's
    deterministic mode on both sides if they differ in its default mode);
    the bundle and the artifact served in this process under a device
    trace (9 + 26 launches per replay); served samples/s beside the live
    pipeline's in turns; then the DeepLab evaluator
    (``phase_export_deeplab``)."""
    from gan_segmentation_tpu_torch.core import export as tex
    from gan_segmentation_tpu_torch.core.config import SolverConfig
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    k1, k2 = k1m.conv3x3_noise_bias_lrelu_instats, k2m.conv3x3_small
    scfg = SolverConfig(max_res_log2=10)
    n_convs = len(kernel2_shapes(scfg))
    rec = {}
    with tempfile.TemporaryDirectory() as base:
        none = join(base, "none")
        if ckpt_dir is None:
            solver = SegSolver(10, "", none, cfg=scfg)
            perturb(torch, solver.model, 35)
            solver.weights_version += 1
        else:
            solver = SegSolver(10, "", ckpt_dir, cfg=scfg)
            assert solver.is_trained, f"no decoder checkpoint in {ckpt_dir}"
        rec["decoder"] = "phase 5's" if ckpt_dir else "seeded random"
        pipe = export_pipeline(torch, solver, none)
        art, bdir = join(base, "generate.pt2"), join(base, "generate.bundle")
        t0 = time.perf_counter()
        tex.export_fused_pipeline(pipe, BATCH, art)
        t1 = time.perf_counter()
        tex.export_fused_pipeline_bundle(pipe, BATCH, bdir)
        t2 = time.perf_counter()
        rec["export_s"] = {"artifact": t1 - t0, "bundle": t2 - t1}
        rec["sizes"] = {"artifact": os.path.getsize(art), **{
            f: os.path.getsize(join(bdir, f))
            for f in ("program.pt2", "weights.pt", "meta.json")}}
        rec["meta"] = tex.load_bundle_meta(bdir)
        assert rec["meta"]["decoder_dtype"] == "bfloat16"

        # the fresh process serves while this one runs the live batches
        # and serves the two forms itself (no timing until it is done)
        fresh = start_fresh_serving(bdir, base, False)
        live = [[t.cpu() for t in pipe.sample_batch()]
                for _ in range(EXPORT_BATCHES)]
        assert not torch.equal(live[0][0], live[1][0])

        # in this process, under a device trace: 9 + 26 launches a replay
        t0 = time.perf_counter()
        served = tex.load_bundle(bdir)
        torch.cuda.synchronize()
        rec["load_s"] = {"bundle_here": time.perf_counter() - t0}
        t0 = time.perf_counter()
        hermetic = tex.load_artifact(art)
        torch.cuda.synchronize()
        rec["load_s"]["artifact_here"] = time.perf_counter() - t0
        gen = torch.Generator(device="cuda")

        def serve_batch(fn, i):
            gen.manual_seed(EXPORT_SEED * 2 ** 32 + i)
            return fn(*tex.draw_inputs(fn.meta, gen))

        with LaunchTrace(torch) as trace:
            here = [[t.cpu() for t in serve_batch(served, i)]
                    for i in range(EXPORT_BATCHES)]
        counted = (trace.device["conv_in_stats"], trace.device["small_conv"])
        deltas = (served.call.deltas[k1], served.call.deltas[k2])
        assert deltas == (9, n_convs), deltas
        assert counted == (EXPORT_BATCHES * 9, EXPORT_BATCHES * n_convs), \
            counted
        assert served.call.replays == EXPORT_BATCHES - 1
        hermetic_batches = [[t.cpu() for t in serve_batch(hermetic, i)]
                            for i in range(EXPORT_BATCHES)]
        rec["here_equal"] = same_batches(torch, here, live)
        rec["hermetic_equal_bundle"] = same_batches(torch, hermetic_batches,
                                                   here)
        check_later(rec["here_equal"] and rec["hermetic_equal_bundle"],
                    "export: the bundle or the artifact served in this "
                    "process differs from FusedPipeline")
        rec["launches"] = dict(zip(("conv_in_stats", "small_conv"), counted))
        rec["per_replay"] = {"conv_in_stats": deltas[0],
                             "small_conv": deltas[1]}

        fresh, rec["worker"] = finish_fresh_serving(torch, fresh)
        rec["load_s"]["bundle_fresh_process"] = rec["worker"]["load_s"]
        rec["fresh_default_equal"] = same_batches(torch, fresh, live)
        if not rec["fresh_default_equal"]:
            with cudnn_deterministic(torch):
                twin = export_pipeline(torch, solver, none)
                live_det = [[t.cpu() for t in twin.sample_batch()]
                            for _ in range(EXPORT_BATCHES)]
                del twin
            fresh_det, rec["worker_det"] = finish_fresh_serving(
                torch, start_fresh_serving(bdir, base, True))
            rec["fresh_deterministic_equal"] = same_batches(
                torch, fresh_det, live_det)
            check_later(rec["fresh_deterministic_equal"], "export: the "
                        "bundle served in a fresh process differs from "
                        "FusedPipeline also in cuDNN's deterministic mode")

        # samples/s in turns: served, live, live, served (device-resident
        # outputs, inputs drawn on the card, as sample_batch does)
        n = [EXPORT_BATCHES]

        def served_step():
            serve_batch(served, n[0])
            n[0] += 1

        rates = {"served": [], "live": []}
        for tag in ("served", "live", "live", "served"):
            rates[tag].append(BATCH / seconds_per_call(
                torch, served_step if tag == "served" else pipe.sample_batch))
        rates["live_pipeline"] = pipeline_rate(torch, pipe, 48)
        rec["rates"] = rates
        del served, hermetic, pipe
        torch.cuda.empty_cache()
        rec["deeplab"] = phase_export_deeplab(torch, base)
    log(f"export (ffhq 1024^2, batch {BATCH}, bf16, {rec['decoder']} "
        f"decoder): artifact {rec['export_s']['artifact']:.2f} s, bundle "
        f"{rec['export_s']['bundle']:.2f} s to export; sizes {rec['sizes']} "
        f"bytes; load {rec['load_s']}; fresh process served batches "
        f"0-{EXPORT_BATCHES - 1} equal to FusedPipeline.sample_batch: "
        f"{rec['fresh_default_equal']} (cuDNN default mode)"
        + (f", deterministic mode {rec['fresh_deterministic_equal']}"
           if "fresh_deterministic_equal" in rec else "")
        + f"; in this process bundle {rec['here_equal']}, artifact = bundle "
        f"{rec['hermetic_equal_bundle']}; launches (device trace) "
        f"{rec['launches']} over {EXPORT_BATCHES} batches, per replay "
        f"{rec['per_replay']}; samples/s served "
        f"{', '.join(f'{v:.3f}' for v in rates['served'])} vs live "
        f"sample_batch {', '.join(f'{v:.3f}' for v in rates['live'])}, live "
        f"generate_batches {rates['live_pipeline']:.3f}; deeplab eval "
        f"{rec['deeplab']} on {smi}")
    return rec


# ------------------------------------------------ cars 512^2, bedrooms 256^2
# The whole f32 slice on the card, kernels against plain versions: the
# image after 17 (15) generator convs and the logits after 26 (23) decoder
# convs, each kernel call within TOL["f32"] of its plain version.  Masks
# must agree wherever the plain logits' margin exceeds MASK_MARGIN.
SLICE_TOL = dict(atol=1e-3, rtol=1e-3)
MASK_MARGIN = 4e-3  # a mask can flip only under twice the logits' error
OTHER_GANS = {"cars": 512, "bedrooms": 256}
OTHER_NUM = 16
OTHER_RATE_NUM = 320  # the device pipeline's rate: 40 batches of 8


def plain_path():
    """Context: the generator and the decoder call the kernels' plain
    PyTorch versions (what the wrappers do for a CPU tensor), on the card."""
    from unittest import mock

    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.models import decoder, stylegan

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        stylegan, "conv3x3_noise_bias_lrelu_instats",
        k1m.conv3x3_noise_bias_lrelu_instats_plain))
    stack.enter_context(mock.patch.object(decoder, "conv3x3_small",
                                          k2m.conv3x3_small_plain))
    return stack


# The bf16 slice, kernels against plain versions.  Each of its ~40 layers
# rounds to bf16 on both sides (TOL["bf16"] apart per layer) and a random
# generator amplifies that, so the two bf16 slices cannot agree to 1 LSB.
# The scale they may differ by is measured in the same run: the distance of
# the plain bf16 slice from the plain f32 slice, which is bf16's own rounding
# through the stack.  A kernel that computes something else lands whole
# logits away (their spread is ~1).  Masks may flip only under BF16_MARGIN.
BF16_MARGIN = 0.5
BF16_SHARE = 1.25  # kernels' distance from f32 over the plain bf16 slice's


def check_bf16_slice(gan, kern, plain, ref):
    """(image, logits, mask) of the bf16 slice through the kernels, through
    the plain versions, and of the plain f32 slice on the same z and noise.
    Fails unless the kernels lie as near to f32 as the plain bf16 slice does
    (mean |logit error| within BF16_SHARE of its), nearer to the plain bf16
    slice than that slice lies to f32 (mean and max |logit error|, share of
    image bytes beyond 1 LSB, share of mask pixels), and no mask pixel whose
    plain bf16 margin exceeds BF16_MARGIN differs.  Returns the readings."""
    def dist(a, b):
        (ia, la, ma), (ib, lb, mb) = a, b
        e = (la.float() - lb.float()).abs()
        lsb = (ia.int() - ib.int()).abs()
        return dict(mean=float(e.mean()), max=float(e.max()),
                    img=float((lsb > 1).float().mean()),
                    mask=float((ma != mb).float().mean()))
    kp, pr, kr = dist(kern, plain), dist(plain, ref), dist(kern, ref)
    margin = (plain[1][..., 1] - plain[1][..., 0]).abs()
    confident = margin > BF16_MARGIN
    flipped = int(((kern[2] != plain[2]) & confident).sum())
    assert kr["mean"] <= BF16_SHARE * pr["mean"], (gan, kr, pr)
    for key in ("mean", "max", "img", "mask"):
        assert kp[key] <= pr[key], (gan, key, kp, pr)
    assert flipped == 0, f"{gan}: {flipped} confident bf16 mask pixels differ"
    return (f"bf16 slice kernels vs plain versions: logits mean|err| "
            f"{kp['mean']:.4g}, max {kp['max']:.4g}, image bytes beyond 1 "
            f"LSB {kp['img']:.4f}, mask pixels differing {kp['mask']:.5f}, "
            f"0 of the {float(confident.float().mean()):.4f} with margin > "
            f"{BF16_MARGIN}; the plain bf16 slice from the plain f32 slice: "
            f"{pr['mean']:.4g}, {pr['max']:.4g}, {pr['img']:.4f}, "
            f"{pr['mask']:.5f}; the kernels' bf16 slice from the plain f32 "
            f"slice: mean {kr['mean']:.4g} (limit {BF16_SHARE} x "
            f"{pr['mean']:.4g}), max {kr['max']:.4g}")


def phase_other_gans(torch):
    """``run_generate`` at cars 512^2 and bedrooms 256^2, bf16, batch 8, 16
    pairs, with a fresh seeded decoder: launch counts, files, samples/s.
    Their decoders end in a 64 -> 2 conv at 512^2 / 256^2, a shape the ffhq
    path never launches: kernel 2 is held to its plain version there in
    bf16 and f32, and the whole f32 slice (kernels) to the whole f32 slice
    through the plain versions on the same z and noise: images within 1
    LSB, logits within SLICE_TOL, masks equal off near-ties.  The whole
    bf16 slice, the one ``run_generate`` runs, is held to its plain versions
    by ``check_bf16_slice``, at the scale of bf16's own rounding."""
    import numpy as np

    from gan_segmentation_tpu_torch.apps.main import run_generate
    from gan_segmentation_tpu_torch.core.config import AppConfig
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.train.generator import (
        FusedPipeline, ImageGenerator, _to_uint8, class_mask)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    import cv2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    inputs = conv_inputs(torch, g)
    out = {}
    for gan, res in OTHER_GANS.items():
        with tempfile.TemporaryDirectory() as base:
            cfg = AppConfig(BASE_DIR=base, GAN=gan,
                            GAN_DIR=join(base, "no-models"),
                            GAN_BATCH_SIZE_PER_GPU=BATCH,
                            GENERATE_NUM=OTHER_NUM)
            scfg = cfg.solver_config()
            assert scfg.max_res_log2 == res.bit_length() - 1
            ckpt = join(base, "checkpoints")
            SegSolver(scfg.max_res_log2, "", ckpt, cfg=scfg).save()
            n_batches = -(-OTHER_NUM // BATCH)
            n_convs = len(kernel2_shapes(scfg))

            with LaunchTrace(torch) as trace:
                t0 = time.perf_counter()
                run_generate(cfg, writer="cv2")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n1, n2 = trace.device["conv_in_stats"], trace.device["small_conv"]
            assert n1 == (scfg.max_res_log2 - 1) * n_batches, n1
            assert n2 == n_convs * n_batches, (n2, n_convs)
            dst = join(base, "dataset", "train_generated")
            values = set()
            for i in range(OTHER_NUM):
                im = cv2.imread(join(dst, f"img_{i:06d}.jpg"))
                m = cv2.imread(join(dst, f"mask_{i:06d}.png"),
                               cv2.IMREAD_GRAYSCALE)
                assert im is not None and im.shape == (res, res, 3), i
                assert m is not None and m.shape == (res, res), i
                values |= set(np.unique(m).tolist())
            assert values <= {0, 1}, values

            solver = SegSolver(scfg.max_res_log2, "", ckpt, cfg=scfg)
            assert solver.is_trained
            pipe = FusedPipeline(ImageGenerator(
                gan=gan, gan_dir=cfg.GAN_DIR, batch_size=BATCH), solver)
            rate = pipeline_rate(torch, pipe, OTHER_RATE_NUM)

            # the tail conv, kernel 2 against plain in both dtypes
            (cname, n, h, w, cin, cout, _) = kernel2_shapes(scfg)[-1]
            assert (h, cin, cout) == (res, 64, 2), (cname, h, cin, cout)
            x32, w32 = inputs(n, h, w, cin, cout)
            b = 0.1 * torch.randn((cout,), generator=g, device=dev)
            tail_err = {}
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                y = k2m.conv3x3_small(x32.to(dt), w32.to(dt), b)
                yp = k2m.conv3x3_small_plain(x32.to(dt), w32.to(dt), b)
                torch.cuda.synchronize()
                check_close(f"small_conv {tag} {gan} {cname}", y, yp,
                            **TOL[tag])
                tail_err[tag] = max_err(y, yp)
            del x32, w32, y, yp

            # the whole f32 slice: kernels against plain versions
            gen32 = ImageGenerator(gan=gan, gan_dir=cfg.GAN_DIR,
                                   batch_size=BATCH, dtype="fp32", seed=3)
            z, _ = gen32.next_inputs(BATCH)

            def slice_f32():
                noise = torch.Generator(device=dev).manual_seed(9)
                with torch.inference_mode():
                    rgb, feats = gen32.model(z, generator=noise)
                    logits = solver.model(feats, None, torch.float32)
                    return (_to_uint8(rgb, gen32.cfg.imrange), logits,
                            class_mask(logits))

            # the same weights, z and noise in bf16, as run_generate runs them
            gen16 = ImageGenerator(gan=gan, gan_dir=cfg.GAN_DIR,
                                   batch_size=BATCH, seed=3)
            folded16 = solver.model.fold_bn(torch.bfloat16)

            def slice_bf16():
                noise = torch.Generator(device=dev).manual_seed(9)
                with torch.inference_mode():
                    rgb, feats = gen16.model(z, generator=noise)
                    logits = solver.model(feats, folded16, torch.bfloat16)
                    return (_to_uint8(rgb, gen16.cfg.imrange),
                            logits.float(), class_mask(logits))

            k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
            img_k, logit_k, mask_k = slice_f32()
            assert k1m.conv3x3_noise_bias_lrelu_instats.launches > 0
            with plain_path():
                k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
                img_p, logit_p, mask_p = slice_f32()
                assert k1m.conv3x3_noise_bias_lrelu_instats.launches == 0
            torch.cuda.synchronize()
            lsb = int((img_k.int() - img_p.int()).abs().max())
            assert lsb <= 1, f"{gan}: images differ by {lsb} LSB"
            check_close(f"{gan} f32 slice logits", logit_k, logit_p,
                        **SLICE_TOL)
            confident = (logit_p[..., 1] - logit_p[..., 0]).abs() > MASK_MARGIN
            assert not bool(((mask_k != mask_p) & confident).any()), \
                f"{gan}: masks differ off near-ties"
            k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
            bf_k = slice_bf16()
            assert k1m.conv3x3_noise_bias_lrelu_instats.launches > 0
            with plain_path():
                k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
                bf_p = slice_bf16()
                assert k1m.conv3x3_noise_bias_lrelu_instats.launches == 0
            torch.cuda.synchronize()
            bf16_line = check_bf16_slice(gan, bf_k, bf_p,
                                        (img_p, logit_p, mask_p))
            del gen16, folded16, bf_k, bf_p
            smi = smi_line()
            log(f"{gan} {res}^2 generate: {OTHER_NUM} pairs, bf16, batch "
                f"{BATCH}: launches (device trace) conv_in_stats {n1}, "
                f"small_conv {n2} ({n_convs} convs x {n_batches} batches; "
                f"the wrappers counted {trace.wrapper}); "
                f"{rate:.3f} samples/s (device pipeline, "
                f"{OTHER_RATE_NUM} samples), "
                f"{OTHER_NUM / wall:.3f} samples/s end to end with the cv2 "
                f"writer and the first launches, traced ({wall:.2f} s) on "
                f"{smi}; "
                f"tail conv {cname} {(n, h, w, cin, cout)} kernel vs plain "
                f"max|err| f32 {tail_err['f32']:.3g} (tol {TOL['f32']}), "
                f"bf16 {tail_err['bf16']:.3g} (tol {TOL['bf16']}); f32 "
                f"slice kernels vs plain versions: images within {lsb} LSB, "
                f"logits max|err| {max_err(logit_k, logit_p):.3g} (tol "
                f"{SLICE_TOL}), masks equal on "
                f"{float(confident.float().mean()):.4f} of the pixels "
                f"(margin > {MASK_MARGIN}), "
                f"{int((mask_k != mask_p).sum())} near-tie pixels differ; "
                + bf16_line)
            assert trace.device["bil_conv"] == 0, trace.device
            out[gan] = dict(launches={"conv_in_stats": n1, "small_conv": n2},
                            wrapper=trace.wrapper, pipeline_sps=rate)
            del gen32, pipe, solver, img_k, img_p, logit_k, logit_p
            torch.cuda.empty_cache()
    return out


# ------------------------------------------ generate as CUDA-graph replays
GRAPH_GANS = ("ffhq", "cars", "bedrooms")
GRAPH_BATCHES = 4   # the eager first batch, the capture's, two more replays
GRAPH_RATE_NUM = {"ffhq": 48, "cars": 96, "bedrooms": 160}
GRAPH_PROFILE_BATCHES = 3


def pipeline_rate(torch, pipe, n):
    """Samples/s of ``pipe.generate_batches(n)`` (device pipeline, no
    writer) after two warm-up batches (on a card the eager first batch and
    the graph's capture); its last batch waits for the card."""
    for _ in pipe.generate_batches(2 * BATCH):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in pipe.generate_batches(n):
        pass
    return n / (time.perf_counter() - t0)


def pipeline_busy(torch, pipe):
    """(kernel ms per batch, wall ms per batch, busy share) of a profiled
    window of ``GRAPH_PROFILE_BATCHES`` batches of ``generate_batches``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in pipe.generate_batches(GRAPH_PROFILE_BATCHES * BATCH):
            pass
        wall = (time.perf_counter() - t0) * 1e3 / GRAPH_PROFILE_BATCHES
    kern = sum(kernel_times(prof).values()) / GRAPH_PROFILE_BATCHES
    return kern, wall, kern / wall


def sampler_f32_vs_eager(torch, state, gan_dir):
    """``ImageGenerator.sample_batch`` in f32 at ffhq 1024^2, batch 8 (the
    collection's sampler) as graph replays against the eager forward of the
    same draws, and that against a second eager forward: in cuDNN's
    deterministic mode all bit-identical (images and the 9 features); in
    its default mode, where two eager forwards differ, the graph within
    twice the eager path's own repeat spread.
    -> readings and a line."""
    from gan_segmentation_tpu_torch.train.generator import (ImageGenerator,
                                                            _to_uint8)

    def eager(g):
        z, noise = g.next_inputs(BATCH)
        with torch.inference_mode():
            rgb, feats = g.model(z, generator=noise)
            return _to_uint8(rgb, g.cfg.imrange), feats, z

    def dist(a, b):  # max |difference| of the images, of the features
        return (int((a[0].int() - b[0].int()).abs().max()),
                max(float((x - y).abs().max()) for x, y in zip(a[1], b[1])))

    def levels(a, b):
        return [f"{float((x - y).abs().max()):.3g}" for x, y in zip(a[1], b[1])]

    out = {}
    for mode in ("deterministic", "default"):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = mode == "deterministic"
        try:
            g32, r1, r2, r3 = (ImageGenerator(
                gan="ffhq", gan_dir=gan_dir, batch_size=BATCH, dtype="fp32",
                seed=5, params=state) for _ in range(4))
            graph_eager, eager_eager, side_eager, by_level = [], [], [], []
            side = torch.cuda.Stream()
            for i in range(3):
                if i == 1:  # the capture
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    reserved = torch.cuda.memory_reserved()
                got, want, again = g32.sample_batch(), eager(r1), eager(r2)
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    aside = eager(r3)
                torch.cuda.current_stream().wait_stream(side)
                assert torch.equal(got[2], want[2]), f"f32 z of batch {i}"
                graph_eager.append(dist(got, want))
                eager_eager.append(dist(again, want))
                side_eager.append(dist(aside, want))
                by_level.append(levels(got, want))
                del got, want, again, aside
                if i == 1:  # what the capture keeps reserved
                    torch.cuda.empty_cache()
                    pool = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
        finally:
            torch.backends.cudnn.deterministic = prev
        out[mode] = dict(graph_vs_eager=graph_eager,
                         eager_vs_eager=eager_eager,
                         side_stream_vs_eager=side_eager,
                         levels=by_level, pool_gib=pool)
        del g32, r1, r2, r3
        torch.cuda.empty_cache()
    det, dft = out["deterministic"], out["default"]
    line = (f"ImageGenerator.sample_batch f32, batches 0-2 (max |image "
            f"diff|, max |feature diff| per batch): cuDNN deterministic "
            f"graph vs eager {det['graph_vs_eager']}, eager vs eager "
            f"{det['eager_vs_eager']}, eager on a side stream vs eager "
            f"{det['side_stream_vs_eager']}; default mode graph vs eager "
            f"{dft['graph_vs_eager']} (by feature {dft['levels']}), eager "
            f"vs eager {dft['eager_vs_eager']}, side stream "
            f"{dft['side_stream_vs_eager']}; the capture kept "
            f"{dft['pool_gib']:.3f} GiB reserved")
    log(line)
    exact = [(0, 0.0)] * 3
    check_later(det["graph_vs_eager"] == exact and det["eager_vs_eager"]
                == exact, "f32 sampler: not bit-identical in cuDNN's "
                "deterministic mode")
    spread = tuple(max(v) for v in zip(*dft["eager_vs_eager"]))
    check_later(all(g <= 2 * e for d in dft["graph_vs_eager"]
                    for g, e in zip(d, spread)),
                "f32 sampler: the graph lies beyond twice the eager repeat "
                "spread")
    out["line"] = line
    return out


def phase_graph_generate(torch):
    """Generate as replays of CUDA graphs against the eager path, bf16,
    batch 8, at ffhq 1024^2, cars 512^2 and bedrooms 256^2, with seeded
    random weights whose noise scales and batch-norm statistics are moved
    off their init (so the noise draws and the fold show): the graph's
    batches 0-3 (the eager first batch, the capture, two replays) equal
    the eager ``_fused`` of the same draws in every byte of the images and
    masks; a replay runs on the card (device trace) what an eager batch
    launches; device-pipeline samples/s graph vs eager in turns (graph,
    eager, eager, graph); kernel time and busy share under the profiler;
    the graph's pool.  At ffhq also ``ImageGenerator.sample_batch`` in f32
    (the collection's sampler, ``sampler_f32_vs_eager``)."""
    from gan_segmentation_tpu_torch.core.config import MAX_RES_LOG2, \
        SolverConfig
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    k1, k2 = k1m.conv3x3_noise_bias_lrelu_instats, k2m.conv3x3_small
    out, launched = {}, {"conv_in_stats": 0, "small_conv": 0}
    smi = smi_line()
    for gan in GRAPH_GANS:
        r = MAX_RES_LOG2[gan]
        with tempfile.TemporaryDirectory() as base:
            none = join(base, "none")
            scfg = SolverConfig(max_res_log2=r)
            solver = SegSolver(r, "", none, cfg=scfg)
            perturb(torch, solver.model, 31)
            solver.weights_version += 1
            gen = ImageGenerator(gan=gan, gan_dir=none, batch_size=BATCH,
                                 seed=5)
            perturb(torch, gen.model, 32)
            ref = ImageGenerator(gan=gan, gan_dir=none, batch_size=BATCH,
                                 seed=5, params=gen.model.state_dict())
            pipe, eager = FusedPipeline(gen, solver), FusedPipeline(ref,
                                                                    solver)
            # the eager path: every batch through _fused, as before graphs
            eager._batch = lambda b, p=eager: [p._fused(
                *p.gen.next_inputs(b))]
            n_blocks, n_convs = r - 1, len(kernel2_shapes(scfg))

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            with LaunchTrace(torch) as gtrace:
                got = [[t.cpu() for t in pipe.sample_batch()]
                       for _ in range(GRAPH_BATCHES)]
            torch.cuda.empty_cache()
            # what the graph keeps reserved, its static inputs and outputs
            # included (the capture emptied the cache before it)
            pool_gib = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
            with LaunchTrace(torch) as etrace:
                want = [[t.cpu() for t in eager._batch(BATCH)[0]]
                        for _ in range(GRAPH_BATCHES)]
            n_graph = (gtrace.device["conv_in_stats"],
                       gtrace.device["small_conv"])
            n_eager = (etrace.device["conv_in_stats"],
                       etrace.device["small_conv"])
            call = pipe._graphs[BATCH]
            assert n_eager == (GRAPH_BATCHES * n_blocks,
                               GRAPH_BATCHES * n_convs), n_eager
            assert n_graph == n_eager, (n_graph, n_eager)
            assert call.replays == GRAPH_BATCHES - 1, call.replays
            assert (call.deltas[k1], call.deltas[k2]) == (n_blocks, n_convs)
            # the eager first batch and the capture's recording
            assert (gtrace.wrapper["conv_in_stats"],
                    gtrace.wrapper["small_conv"]) == (2 * n_blocks,
                                                      2 * n_convs), gtrace
            for i, (x, y) in enumerate(zip(got, want)):
                assert all(a.dtype == torch.uint8 for a in x)
                assert all(torch.equal(a, b) for a, b in zip(x, y)), \
                    f"{gan}: graph batch {i} differs from the eager batch"
            assert not torch.equal(got[0][0], got[1][0])
            for k, n in zip(launched, n_graph):
                launched[k] += n

            rates = {"graph": [], "eager": []}
            for tag, p in (("graph", pipe), ("eager", eager),
                           ("eager", eager), ("graph", pipe)):
                rates[tag].append(pipeline_rate(torch, p,
                                                GRAPH_RATE_NUM[gan]))
            busy = {tag: pipeline_busy(torch, p)
                    for tag, p in (("graph", pipe), ("eager", eager))}
            rec = dict(rates=rates, busy=busy, pool_gib=pool_gib,
                       launches_per_replay={"conv_in_stats": n_blocks,
                                            "small_conv": n_convs})
            line = (f"{gan} {2 ** r}^2 generate as graph replays (bf16, "
                    f"batch {BATCH}): batches 0-{GRAPH_BATCHES - 1} "
                    f"bit-identical to the eager path (images and masks), "
                    f"launches (device traces) {n_graph} = eager {n_eager}, "
                    f"the wrappers counted {gtrace.wrapper} (the eager first "
                    f"batch and the capture's recording), per replay "
                    f"conv_in_stats {n_blocks}, small_conv {n_convs}; device "
                    f"pipeline samples/s graph "
                    f"{', '.join(f'{v:.3f}' for v in rates['graph'])} vs "
                    f"eager {', '.join(f'{v:.3f}' for v in rates['eager'])}"
                    f"; profiled (kernel ms / wall ms per batch, busy): "
                    + "; ".join(f"{t} {k:.3f} / {w:.3f}, {b:.3f}"
                                for t, (k, w, b) in busy.items())
                    + f"; the graph keeps {rec['pool_gib']:.3f} GiB "
                    f"reserved")
            if gan == "ffhq":  # the collection's sampler, f32
                del eager, ref
                rec["f32"] = sampler_f32_vs_eager(torch, gen.model.state_dict(),
                                                  none)
                line += "; " + rec["f32"].pop("line")
            log(line + f" on {smi}")
            out[gan] = rec
            del pipe, gen, solver
            torch.cuda.empty_cache()
    return dict(gans=out, launches=launched)


# ------------------------------------------------------- int8 generation
INT8_BATCHES = 4     # the eager first batch, the capture's, two replays
INT8_RATE_NUM = 48   # samples per timed device-pipeline run
INT8_GENERATE = 16   # pairs of run_generate --quant int8 (two batches)
INT8_SEED = 13
# int8 against bf16 on the phase's random weights: the share of mask
# pixels each mode keeps and the int8-full image's PSNR, each limit just
# under its reading, which repeats from run to run (the weights are seeded:
# 0.967 and 0.921 of the pixels, 20.1 dB; PERF.md)
INT8_MIN_AGREEMENT = {"int8": 0.96, "int8-full": 0.91}
INT8_MIN_PSNR = 19.5


def s8_bytes_ops(n, h, w, cin, cout, kernel1):
    """(bytes, int8 operations) of one s8 3x3 call: x and w once in s8, y
    once in bf16, deq and bias (kernel 1: the noise scale, the noise and
    the statistics too) once in f32."""
    nbytes = n * h * w * cin + 9 * cin * cout + 2 * n * h * w * cout
    nbytes += 4 * 2 * cout
    if kernel1:
        nbytes += 4 * cout + 4 * n * h * w + 4 * 2 * n * cout
    return nbytes, 18 * n * h * w * cin * cout


def quantize_calls(torch, pipe):
    """(shape, dtype) of every quantize_s8 call of one eager batch of
    ``pipe`` (an int8 pipeline), in order."""
    from gan_segmentation_tpu_torch.ops import quant as q8
    seen, real = [], q8.quantize_act

    def spy(x, inv):
        seen.append((tuple(x.shape), x.dtype))
        return real(x, inv)

    q8.quantize_act = spy
    try:
        pipe._fused(*pipe.gen.next_inputs(BATCH))
    finally:
        q8.quantize_act = real
    return seen


def graph_replays_equal(torch, fn, want, replays=2):
    """``fn`` captured in a CUDA graph and replayed ``replays`` times:
    whether every replay's outputs (a tuple of tensors) equal ``want`` bit
    for bit."""
    graph, outs = captured(fn)
    same = True
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        same &= all(torch.equal(a, b) for a, b in zip(outs, want))
    del graph, outs
    return same


def phase_s8_kernels(torch, gcfg, scfg, pipe):
    """(i) and (ii) of the int8 phase, and the device times: each s8 entry
    at every s8 3x3 shape of an int8-full batch at ffhq 1024^2, batch 8
    (the split-K shapes among them), on the body the rule picks
    (``tc_plan.plan_s8``: the Hopper body at every one of them) and on the
    mma.sync s8 body (``mma_sync_s8_body``), on the same inputs: the s32
    sums exact on both, y bit-equal between them and to the plain
    epilogue, kernel 1's statistics within ``STAT_TOL``, repeats and graph
    replays bit-identical; device times of both beside the bf16 Hopper
    body on the same shapes and the bound; then the quantize pass at every
    input an int8-full batch quantizes (``pipe``'s calls)."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import quantize as kqm
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.kernels import tc_plan
    from gan_segmentation_tpu_torch.ops import quant as q8

    g = torch.Generator("cuda").manual_seed(INT8_SEED)
    dev = torch.device("cuda")
    # quantize: ties at .5 (half to even), saturation, both dtypes, the
    # vector path and the scalar one (an odd length)
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5,
                         -127.5, 300.0, -300.0, 0.49999997, 3.0, -4.0, 7.5,
                         8.5] * 8, device=dev)
    one = torch.ones(1, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for t in (ties.to(dt), ties.to(dt)[1:].contiguous()):
            check_later(torch.equal(kqm.quantize_s8(t, one),
                                    kqm.quantize_s8_plain(t, one)),
                        f"quantize_s8 {dt}: ties or saturation differ")
    out = {k: dict(ms=0.0, mma_sync_ms=0.0, plain_ms=0.0, bf16_ms=0.0,
                   bounds=[], shapes=0, sm90_shapes=0, exact=True,
                   equal=True, repeats=True, err=0.0, per_shape=[])
           for k in ("conv_in_stats_s8", "small_conv_s8")}
    shapes = q8.conv3x3_s8_shapes(gcfg, scfg, BATCH)
    stat_err = 0.0
    for key, kernel1 in (("conv_in_stats_s8", True), ("small_conv_s8", False)):
        r = out[key]
        for n, h, w, cin, cout in shapes[key]:
            x = torch.randn((n, h, w, cin), device=dev, generator=g)
            xb = x.bfloat16()
            inv = (127.0 / xb.float().abs().amax()).reshape(1)
            xq = kqm.quantize_s8(xb, inv)
            wq = torch.randint(-127, 128, (3, 3, cout, cin),
                               dtype=torch.int8, device=dev, generator=g)
            acc = k2m.conv3x3_s8_acc(xq, wq)
            ones = torch.ones(cout, device=dev)
            zeros = torch.zeros(cout, device=dev)
            deq = (torch.rand(cout, device=dev, generator=g) + 0.5) / (
                127.0 * (9 * cin) ** 0.5)
            bias = 0.1 * torch.randn(cout, device=dev, generator=g)
            noise = torch.randn((n, h, w), device=dev, generator=g)
            ns = 0.1 * torch.randn(cout, device=dev, generator=g)
            wb = (torch.randn((3, 3, cin, cout), device=dev, generator=g)
                  / (9 * cin) ** 0.5).bfloat16()
            if kernel1:
                def exact():  # deq = 1, no bias, no activation, f32 out
                    return k1m.conv3x3_noise_bias_lrelu_instats_s8(
                        xq, wq, ones, torch.zeros_like(noise), zeros, zeros,
                        leaky=1.0, out_dtype=torch.float32)[0]

                def run():
                    return k1m.conv3x3_noise_bias_lrelu_instats_s8(
                        xq, wq, deq, noise, ns, bias)

                def plain():
                    return k1m.conv3x3_noise_bias_lrelu_instats_s8_plain(
                        xq, wq, deq, noise, ns, bias)

                def bf16_body():
                    return k1m.conv3x3_noise_bias_lrelu_instats(
                        xb, wb, noise, ns, bias)
                want, pm, pv = k1m.s8_in_stats_epilogue_plain(
                    acc, deq, noise, ns, bias)
            else:
                def exact():
                    return k2m.conv3x3_small_s8(xq, wq, ones,
                                                out_dtype=torch.float32)

                def run():
                    return (k2m.conv3x3_small_s8(xq, wq, deq, bias,
                                                 leaky=0.2),)

                def plain():
                    return k2m.conv3x3_small_s8_plain(xq, wq, deq, bias,
                                                      leaky=0.2)

                def bf16_body():
                    return k2m.conv3x3_small(xb, wb, bias, leaky=0.2)
                want = k2m.s8_epilogue_plain(acc, deq, bias, leaky=0.2)
            tag = f"{key} {n}x{h}x{w}x{cin}->{cout}"
            plan = tc_plan.plan_s8(n, h, w, cin, cout, kernel1)
            check_later(plan.sm90, f"{tag}: the rule keeps the s8 call off "
                                   f"the Hopper body")
            got, again = run(), run()
            exact_h = torch.equal(exact(), acc)
            replays = graph_replays_equal(torch, run, got)
            with mma_sync_s8_body():
                ref = run()
                exact_m = torch.equal(exact(), acc)
                mma_ms = graph_ms(run)
            torch.cuda.synchronize()
            equal = (torch.equal(got[0], ref[0])
                     and torch.equal(got[0], want))
            repeats = all(torch.equal(a, b) for a, b in zip(got, again)) \
                and replays
            check_later(exact_h and exact_m, f"{tag}: the s32 sums differ "
                        f"from the exact integer product (Hopper body "
                        f"{exact_h}, mma.sync body {exact_m})")
            check_later(equal, f"{tag}: y differs between the bodies or "
                               f"from the plain epilogue, max "
                               f"{max_err(got[0], want):.3g}")
            check_later(repeats, f"{tag}: a repeat or a graph replay "
                                 f"differs")
            if kernel1:
                for what, a, b in (("mean", got[1], pm), ("var", got[2], pv),
                                   ("mean (mma.sync)", ref[1], pm),
                                   ("var (mma.sync)", ref[2], pv)):
                    check_close(f"{tag} {what}", a, b, **STAT_TOL["bf16"])
                    stat_err = max(stat_err, max_err(a, b))
            ms = graph_ms(run)
            plain_ms = graph_ms(plain, reps=1, replays=2)
            bf16_ms = graph_ms(bf16_body)
            b = bound(*s8_bytes_ops(n, h, w, cin, cout, kernel1),
                      PEAK["int8"])
            r["exact"] &= exact_h and exact_m
            r["equal"] &= equal
            r["repeats"] &= repeats
            r["err"] = max(r["err"], max_err(got[0], want))
            r["ms"] += ms
            r["mma_sync_ms"] += mma_ms
            r["plain_ms"] += plain_ms
            r["bf16_ms"] += bf16_ms
            r["bounds"].append(b)
            r["shapes"] += 1
            r["sm90_shapes"] += int(plan.sm90)
            r["per_shape"].append(dict(
                shape=[n, h, w, cin, cout], ms=ms, mma_sync_ms=mma_ms,
                bf16_ms=bf16_ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], plan=list(plan.args())))
            if plan.splits > 1:
                r["split"] = r.get("split", 0) + 1
            log(f"  {tag}: Hopper body {ms:.4f} ms, mma.sync s8 body "
                f"{mma_ms:.4f}, bf16 Hopper body {bf16_ms:.4f}, plain "
                f"{plain_ms:.3f}, bound {b[0]:.4f} ({b[1]}); exact "
                f"{exact_h and exact_m}, y bit-equal {equal}, repeats and "
                f"replays {repeats}; plan {plan.args()}")
            del x, xb, xq, wq, wb, acc, got, again, ref, want
        r["bound_ms"], r["bound_by"] = summed_bound(r.pop("bounds"))
        log(f"{key} at the {r['shapes']} s8 shapes of an int8-full ffhq "
            f"1024^2 batch of {BATCH} ({r.get('split', 0)} split-K, "
            f"{r['sm90_shapes']} on the Hopper body): exact s32 sums on "
            f"both bodies {r['exact']}; y bit-equal between the bodies and "
            f"to the plain epilogue {r['equal']}; repeats and graph replays "
            f"bit-identical {r['repeats']}; device ms per batch "
            f"{r['ms']:.4f} (mma.sync s8 body {r['mma_sync_ms']:.4f}, bf16 "
            f"Hopper body on the same shapes {r['bf16_ms']:.4f}, plain "
            f"{r['plain_ms']:.3f}), bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    out["conv_in_stats_s8"]["stat_err"] = stat_err
    # the quantize pass at every input an int8-full batch quantizes
    q = dict(ms=0.0, plain_ms=0.0, bounds=[], calls=0, exact=True)
    for shape, dt in quantize_calls(torch, pipe):
        x = torch.randn(shape, device=dev, generator=g).to(dt)
        inv = (127.0 / x.float().abs().amax()).reshape(1)
        got, want = kqm.quantize_s8(x, inv), kqm.quantize_s8_plain(x, inv)
        exact = torch.equal(got, want)
        check_later(exact, f"quantize_s8 {shape} {dt} differs from plain")
        q["exact"] &= exact
        q["err"] = max(q.get("err", 0.0), max_err(got, want))
        q["ms"] += graph_ms(lambda: kqm.quantize_s8(x, inv))
        q["plain_ms"] += graph_ms(lambda: kqm.quantize_s8_plain(x, inv))
        numel = x.numel()
        q["bounds"].append(bound((x.element_size() + 1) * numel, numel,
                                 PEAK["f32"]))
        q["calls"] += 1
    q["bound_ms"], q["bound_by"] = summed_bound(q.pop("bounds"))
    out["quantize_s8"] = q
    log(f"quantize_s8 at the {q['calls']} inputs of an int8-full batch: "
        f"equal to plain {q['exact']} (ties and saturation included); "
        f"device ms per batch {q['ms']:.4f} (plain {q['plain_ms']:.4f}), "
        f"bound {q['bound_ms']:.4f} ({q['bound_by']})")
    return out


# bf16's own mean |logit error| from f32 through the ffhq 1024^2 stack, as
# check_bf16_slice reads it in phase_spatial (0.04749 in the card runs of
# the Hopper body's bf16 form): the scale below which two int8-full runs
# that differ only in their statistics' summation order must stay
BF16_FROM_F32_LOGITS = 0.047


def int8_logits(torch, program, z, noise):
    """The f32 logits of an int8 ``FusedProgram`` on z and the noise: its
    forward up to the class mask."""
    with torch.inference_mode():
        _, feats = program.model(z, noise=noise, quant=program.gen_quant)
        return program.decoder.forward_int8(feats, program.dec_quant,
                                            program.dtype).float()


def masks_of(batch):
    """A batch's masks as (N, H, W) {0, 1}, unpacked where bit-packed."""
    import numpy as np
    m = batch[1].numpy()
    return np.unpackbits(m, axis=-1) if m.shape[-1] * 8 == batch[0].shape[2] \
        else m


def phase_int8(torch, smi):
    """Int8 generation at ffhq 1024^2, batch 8, bf16 (``generate --quant``).
    (i)-(ii) the s8 bodies and the quantize pass against their plain
    versions (``phase_s8_kernels``); (iii) ``FusedPipeline(quant="int8")``
    and ``"int8-full"`` with seeded random weights as CUDA graphs: batches
    0-3 equal the eager path's bit for bit, a replay repeated equals
    itself, the s8 kernels' launches in device traces, every one of them
    on the Hopper body, batches 0-3 against the same z and noise with the
    s8 calls on the mma.sync s8 body (int8 bit for bit; int8-full, whose
    statistics differ by summation order: logits distance and masks), the
    masks against the bf16 pipeline's on the same z and noise, the
    int8-full image's PSNR, samples/s of the three in turns; (iv)
    ``run_generate(quant="int8")`` writes pairs and ``--resume`` rewrites
    a lost tail byte for byte."""
    import numpy as np

    from gan_segmentation_tpu_torch.apps.main import run_generate
    from gan_segmentation_tpu_torch.core.config import (AppConfig,
                                                        SolverConfig,
                                                        gan_config)
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator,
                                                            _infer)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    t0 = time.perf_counter()
    gcfg, scfg = gan_config("ffhq"), SolverConfig(max_res_log2=10)
    launched = {k: {} for k in S8_KERNELS}
    traced_before = dict(BODY_LAUNCHES)
    with tempfile.TemporaryDirectory() as base:
        none = join(base, "none")
        solver = SegSolver(10, "", none, cfg=scfg)
        perturb(torch, solver.model, 41)
        solver.weights_version += 1
        src = ImageGenerator(gan="ffhq", gan_dir=none, batch_size=BATCH,
                             seed=7)
        perturb(torch, src.model, 42)
        state = src.model.state_dict()
        del src

        def fresh():
            return ImageGenerator(gan="ffhq", gan_dir=none, batch_size=BATCH,
                                  seed=7, params=state)

        pipes = {q: FusedPipeline(fresh(), solver, quant=q)
                 for q in (None, "int8", "int8-full")}
        kern = phase_s8_kernels(torch, gcfg, scfg, pipes["int8-full"])
        t_kernels = time.perf_counter() - t0
        runs, per_batch = {}, {}
        for q in ("int8", "int8-full"):
            pipe = pipes[q]
            pipe.gen.skip_batches(-pipe.gen._batch_index)  # batch 0 again
            eager = FusedPipeline(fresh(), solver, quant=q)
            eager._batch = lambda b, p=eager: [p._fused(
                *p.gen.next_inputs(b))]
            pipe.program(), eager.program()  # quantized before the traces
            with LaunchTrace(torch, s8=True) as gtrace:
                got = [[t.cpu() for t in pipe.sample_batch()]
                       for _ in range(INT8_BATCHES)]
            with LaunchTrace(torch, s8=True) as etrace:
                want = [[t.cpu() for t in eager._batch(BATCH)[0]]
                        for _ in range(INT8_BATCHES)]
            del eager
            call = pipe._graphs[BATCH]
            assert call.replays == INT8_BATCHES - 1, call.replays
            assert gtrace.device == etrace.device, (gtrace.device,
                                                    etrace.device)
            same = all(torch.equal(a, b) for x, y in zip(got, want)
                       for a, b in zip(x, y))
            check_later(same, f"{q}: graph batches differ from the eager "
                              f"path's")
            first = [t.clone() for t in call()]
            again = call()
            check_later(all(torch.equal(a, b) for a, b in zip(first, again)),
                        f"{q}: a replay repeated differs from itself")
            per_batch[q] = {k: n // INT8_BATCHES
                            for k, n in etrace.device.items() if n}
            for k in S8_KERNELS:
                if gtrace.device[k]:
                    launched[k][f"{q} graph vs eager"] = (gtrace.device[k]
                                                          + etrace.device[k])
            runs[q] = got
        ref = pipes[None]
        ref.gen.skip_batches(-ref.gen._batch_index)
        runs["bf16"] = [[t.cpu() for t in ref.sample_batch()]
                        for _ in range(INT8_BATCHES)]
        quality = {}
        for q in ("int8", "int8-full"):
            agree = float(np.mean([(masks_of(a) == masks_of(b)).mean()
                                   for a, b in zip(runs[q], runs["bf16"])]))
            mse = float(np.mean([((a[0].double() - b[0].double()) ** 2
                                  ).mean().item()
                                 for a, b in zip(runs[q], runs["bf16"])]))
            psnr = None if mse == 0 else float(10 * np.log10(255 ** 2 / mse))
            quality[q] = dict(mask_agreement=agree, image_psnr_db=psnr,
                              images_equal=mse == 0)
            check_later(agree >= INT8_MIN_AGREEMENT[q],
                        f"{q}: masks agree with bf16 on {agree:.4f} of the "
                        f"pixels (< {INT8_MIN_AGREEMENT[q]})")
        check_later(quality["int8-full"]["image_psnr_db"] is not None
                    and quality["int8-full"]["image_psnr_db"]
                    >= INT8_MIN_PSNR, f"int8-full: image PSNR "
                    f"{quality['int8-full']['image_psnr_db']} dB (< "
                    f"{INT8_MIN_PSNR})")
        check_later(quality["int8"]["images_equal"],
                    "int8: the images differ from bf16's (the generator is "
                    "float under int8)")
        # the s8 Hopper body against the mma.sync s8 body on the path: a
        # twin of the eager pipeline above (its draws, its calibration)
        # with its s8 calls forced onto the mma.sync body, its float calls
        # as before; logits of both programs on one more batch's inputs
        bodies = {}
        for q in ("int8", "int8-full"):
            with mma_sync_s8_body():
                alt = FusedPipeline(fresh(), solver, quant=q)
                alt._batch = lambda b, p=alt: [p._fused(
                    *p.gen.next_inputs(b))]
                alt.program()
                got = [[t.cpu() for t in alt._batch(BATCH)[0]]
                       for _ in range(INT8_BATCHES)]
                z, nz = alt.gen.draw_inputs(BATCH)
                lm = int8_logits(torch, alt.program(), z, nz)
            lh = int8_logits(torch, pipes[q].program(), z, nz)
            d = (lh - lm).abs()
            bodies[q] = dict(
                batches_equal=all(torch.equal(a, b) for x, y in zip(
                    runs[q], got) for a, b in zip(x, y)),
                mask_agreement=float(np.mean([
                    (masks_of(a) == masks_of(b)).mean()
                    for a, b in zip(runs[q], got)])),
                logits_mean=float(d.mean()), logits_max=float(d.max()))
            del alt, got, z, nz, lh, lm, d
        check_later(bodies["int8"]["batches_equal"],
                    f"int8: batches on the Hopper s8 body differ from the "
                    f"mma.sync s8 body's {bodies['int8']}")
        check_later(bodies["int8-full"]["logits_mean"]
                    < BF16_FROM_F32_LOGITS,
                    f"int8-full: logits on the two s8 bodies "
                    f"{bodies['int8-full']}, not within bf16's own "
                    f"{BF16_FROM_F32_LOGITS} from f32")
        rates = {k: [] for k in ("bf16", "int8", "int8-full")}
        for tag in ("bf16", "int8", "int8-full", "int8-full", "int8",
                    "bf16"):
            rates[tag].append(pipeline_rate(
                torch, pipes[None if tag == "bf16" else tag], INT8_RATE_NUM))
        # --dp's machinery on the one card: two replicas of the int8-full
        # program, half the batch each, each part bit-equal to the
        # one-device program on that half (the replicas serve its state)
        one = pipes["int8-full"].program()
        dp = FusedPipeline(fresh(), solver, mesh=["cuda:0", "cuda:0"],
                           quant="int8-full")
        with LaunchTrace(torch, s8=True) as dtrace:
            parts = [[t.cpu() for t in dp.sample_batch()] for _ in range(2)]
        draw, dp_equal = fresh(), True
        for got in parts:
            z, noise = draw.draw_inputs(BATCH)
            halves = [_infer(one, z[h].clone(), noise={
                k: v[h].clone() for k, v in noise.items()})
                for h in (slice(0, BATCH // 2), slice(BATCH // 2, None))]
            dp_equal &= all(torch.equal(g, torch.cat(
                [p[i] for p in halves]).cpu()) for i, g in enumerate(got))
        check_later(dp_equal, "int8-full over two replicas differs from the "
                              "one-device program on each half")
        for k in S8_KERNELS:
            launched[k]["int8-full --dp 2 parts"] = dtrace.device[k]
        del pipes, runs, dp, draw, one
        torch.cuda.empty_cache()

        # (iv) the entry point, and --resume
        try:
            import cv2  # noqa: F401
            writer = "cv2"
        except ImportError:
            writer = None
        resume = None
        if writer is not None:
            cfg = AppConfig(BASE_DIR=base, GAN="ffhq", GAN_DIR=none,
                            GAN_BATCH_SIZE_PER_GPU=BATCH,
                            GENERATE_NUM=INT8_GENERATE)
            solver.checkpoints_dir = join(base, "checkpoints")
            solver.save()  # the decoder run_generate loads
            out = join(base, "dataset", "train_generated")
            with LaunchTrace(torch, s8=True) as trace:
                run_generate(cfg, writer=writer, quant="int8")
            for k in S8_KERNELS:
                if trace.device[k]:
                    launched[k]["run_generate int8"] = trace.device[k]
            ref_bytes = {f: open(join(out, f), "rb").read()
                         for f in os.listdir(out)}
            assert len(ref_bytes) == 2 * INT8_GENERATE, sorted(ref_bytes)
            lost = [f"{k}_{i:06d}.{e}" for i in range(BATCH + 2,
                                                       INT8_GENERATE)
                    for k, e in (("img", "jpg"), ("mask", "png"))]
            for f in lost:
                os.remove(join(out, f))
            run_generate(cfg, writer=writer, quant="int8", resume=True)
            resume = all(open(join(out, f), "rb").read() == b
                         for f, b in ref_bytes.items()) and sorted(
                os.listdir(out)) == sorted(ref_bytes)
            check_later(resume, "run_generate --quant int8 --resume: the "
                                "rewritten tail differs")
            shutil.rmtree(out)
            cfg.GENERATE_NUM = BATCH
            with LaunchTrace(torch, s8=True) as trace:
                run_generate(cfg, writer=writer, quant="int8-full")
            for k in S8_KERNELS:
                launched[k]["run_generate int8-full"] = trace.device[k]
            assert len(os.listdir(out)) == 2 * BATCH, os.listdir(out)
            # --quant int8-full --dp 2 through the entry point, its two
            # replicas on the one card (generate_devices over [card, card])
            shutil.rmtree(out)
            import gan_segmentation_tpu_torch.apps.main as app
            real = app.generate_devices
            app.generate_devices = functools.partial(
                real, devices=[torch.device("cuda", 0)] * 2)
            try:
                with LaunchTrace(torch, s8=True) as trace:
                    run_generate(cfg, writer=writer, quant="int8-full", dp=2)
            finally:
                app.generate_devices = real
            for k in S8_KERNELS:
                launched[k]["run_generate int8-full --dp 2"] = \
                    trace.device[k]
                check_later(trace.device[k] > 0, f"run_generate --quant "
                            f"int8-full --dp 2 launched no {k}")
            check_later(len(os.listdir(out)) == 2 * BATCH,
                        f"run_generate --quant int8-full --dp 2 wrote "
                        f"{sorted(os.listdir(out))}")
        else:
            log("int8: no cv2 on this machine, run_generate not driven")
    for k in S8_KERNELS:
        check_later(sum(launched[k].values()) > 0,
                    f"int8: {k} was not launched on the main path")
    # every traced s8 launch of the phase's main paths ran the Hopper body
    by_body = {k: {body: n - traced_before.get((kk, body), 0)
                   for (kk, body), n in sorted(BODY_LAUNCHES.items())
                   if kk == k and n > traced_before.get((kk, body), 0)}
               for k in ("conv_in_stats_s8", "small_conv_s8")}
    for k, by in by_body.items():
        check_later(set(by) == {"sm90"},
                    f"int8: {k}'s traced launches by body {by}, not all on "
                    f"the Hopper body")
    seconds = time.perf_counter() - t0
    log(f"int8 generation at ffhq 1024^2, batch {BATCH} (bf16 compute): "
        f"graphs equal eager (batches 0-{INT8_BATCHES - 1}); launches per "
        f"batch {per_batch}; against bf16 on the same z and noise "
        f"{quality}; device pipeline samples/s "
        + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)}"
                    for k, vs in rates.items())
        + f"; traced s8 launches by body {by_body}; against the mma.sync "
        f"s8 body on the same z and noise {bodies}"
        + f"; --dp 2 parts = the one-device int8-full program on each "
        f"half {dp_equal}; run_generate --quant int8: {INT8_GENERATE} "
        f"pairs, --resume byte-identical {resume}, --quant int8-full "
        f"{BATCH} pairs, with --dp 2 {BATCH} pairs; phase {seconds:.1f} s (kernel checks "
        f"{t_kernels:.1f} s) on {smi}")
    return dict(kernels=kern, launches=launched, per_batch=per_batch,
                quality=quality, rates=rates, resume=resume,
                dp_parts_equal=dp_equal, traced_launches_by_body=by_body,
                s8_bodies=bodies, seconds=seconds)


# --------------------------------------------------- foreign checkpoints
def write_mx_file(path, named):
    """Write ``{name: float32 array}`` in mxnet's NDArray-list format (V2
    arrays, int64 dims, cpu(0) context), the layout
    ``core/mx_params.py``'s docstring gives."""
    import struct

    import numpy as np

    with open(path, "wb") as fp:
        fp.write(struct.pack("<QQQ", 0x112, 0, len(named)))
        for arr in named.values():
            arr = np.ascontiguousarray(arr, np.float32)
            fp.write(struct.pack("<IiI", 0xF993FAC9, 0, arr.ndim))
            fp.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            fp.write(struct.pack("<iii", 1, 0, 0))  # cpu(0), float32
            fp.write(arr.tobytes())
        fp.write(struct.pack("<Q", len(named)))
        for name in named:
            raw = name.encode()
            fp.write(struct.pack("<Q", len(raw)) + raw)


def generator_mx_arrays(state, gcfg):
    """A generator ``state_dict`` of the port -> the reference's mxnet
    names and layouts (the inverse of ``core/mx_params.py::
    convert_stylegan_params`` followed by ``core/params_bridge.py``): convs
    OIHW and dense (out, in) as the port keeps them, the transposed conv
    (I, O, kh, kw), the constant NCHW, noise scales and biases (1, C, 1, 1)."""
    t = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    mx = {"constant_tensor": t["constant_tensor"].transpose(0, 3, 1, 2),
          "latent_avg": t["latent_avg"],
          "truncation_psi": t["truncation_psi"]}
    for i in range(8):
        mx[f"mp_dense_{i}_weight"] = t[f"mapping.dense_{i}.weight"]
        mx[f"mp_dense_{i}_bias"] = t[f"mapping.dense_{i}.bias"]
    for res in range(2, gcfg.max_res_log2 + 1):
        s, blk = 2 ** res, f"block_{res}"
        if res >= 3:
            up = "deconv_1" if res >= 7 else "conv_1"
            mx[f"{s}_{up}_weight"] = t[f"{blk}.{up}.weight"]
        mx[f"{s}_conv_2_weight"] = t[f"{blk}.conv_2.weight"]
        for j in (1, 2):
            mx[f"{s}_noise_{j}_scale_factors"] = t[
                f"{blk}.noise_{j}.scale_factors"].reshape(1, -1, 1, 1)
            mx[f"{s}_bias_{j}_bias"] = t[f"{blk}.bias_{j}.bias"].reshape(
                1, -1, 1, 1)
            mx[f"{s}_adain_{j}_dense_affine_weight"] = t[
                f"{blk}.adain_{j}.affine.weight"]
            mx[f"{s}_adain_{j}_dense_affine_bias"] = t[
                f"{blk}.adain_{j}.affine.bias"]
    top = gcfg.max_res_log2
    mx[f"{2 ** top}_conv_to_rgb_weight"] = t[f"to_rgb_{top}.weight"]
    mx[f"{2 ** top}_conv_to_rgb_bias"] = t[f"to_rgb_{top}.bias"]
    # entries a real file also holds and a loader must ignore
    mx["16_conv_2_std"] = t["latent_avg"][:1]
    return mx


_BN_NAMES = {"weight": "gamma", "bias": "beta",
             "running_mean": "running_mean", "running_var": "running_var"}


def decoder_mx_arrays(state, scfg):
    """A decoder ``state_dict`` of the port -> the attribute-path names of
    the reference's ``save_parameters`` (``core/decoder_convert.py``'s
    dotted scheme, batch norm on)."""
    t = {k: v.detach().float().cpu().numpy() for k, v in state.items()
         if not k.endswith("num_batches_tracked")}
    mx = {}

    def conv(src, dst):
        mx[f"{dst}.weight"] = t.pop(f"{src}.weight")
        mx[f"{dst}.bias"] = t.pop(f"{src}.bias")

    def bn(src, dst):
        for ours, theirs in _BN_NAMES.items():
            mx[f"{dst}.{theirs}"] = t.pop(f"{src}.{ours}")

    n = len(scfg.in_channels)
    for i in range(scfg.start_res, n):
        conv(f"cvt_{i}_conv", f"cvt_block_{i}.0")
        bn(f"cvt_{i}_bn", f"cvt_block_{i}.1")
    for i in range(scfg.start_res, n - 1):
        base = f"main_block_{i}.1"
        conv(f"main_{i}.conv_0", f"{base}.base_layers.0")
        bn(f"main_{i}.bn_0", f"{base}.base_layers.1")
        conv(f"main_{i}.conv_1", f"{base}.base_layers.3")
        bn(f"main_{i}.bn_1", f"{base}.base_layers.4")
        if f"main_{i}.shortcut.weight" in t:
            conv(f"main_{i}.shortcut", f"{base}.shortcut.0")
    conv(f"main_{n - 1}_conv", f"main_block_{n - 1}.0")
    assert not t, sorted(t)
    return mx


def perturb(torch, module, seed):
    """Move every parameter and statistic that a seeded init leaves at 0 or
    1 (noise scales, biases, latent_avg, psi, batch-norm scale, shift and
    running statistics) to seeded random values, so that a layout or name
    mistake in any of them changes the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked" or t.dim() != 1:
                continue
            r = torch.randn(t.shape, generator=g)
            if leaf in ("running_var", "truncation_psi") or (
                    leaf == "weight" and "bn" in name):
                t.copy_((0.75 + 0.25 * torch.tanh(r)).to(t.device))
            else:
                t.copy_((0.1 * r).to(t.device))


def phase_foreign_weights(torch, gcfg, scfg):
    """A seeded ffhq generator written as a synthetic mxnet
    ``stylegan-ffhq.params`` and loaded by ``ImageGenerator``: one batch of
    8 bit-identical to the source generator's.  A decoder written as a
    dotted-name mxnet ``checkpoint_last.params`` and loaded by
    ``SegSolver.load``: logits equal to the source decoder's."""
    from gan_segmentation_tpu_torch.models.stylegan import init_generator
    from gan_segmentation_tpu_torch.train.generator import ImageGenerator
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    with tempfile.TemporaryDirectory() as base:
        gan_dir, ckpt = join(base, "stylegan-models"), join(base,
                                                            "checkpoints")
        os.makedirs(gan_dir)
        os.makedirs(ckpt)
        src = init_generator(gcfg, seed=11)
        perturb(torch, src, 12)
        state = src.state_dict()
        path = join(gan_dir, "stylegan-ffhq.params")
        write_mx_file(path, generator_mx_arrays(state, gcfg))
        t0 = time.perf_counter()
        loaded = ImageGenerator(gan="ffhq", gan_dir=gan_dir, batch_size=BATCH)
        torch.cuda.synchronize()
        gen_load_s = time.perf_counter() - t0
        want = ImageGenerator(gan="ffhq", gan_dir=join(base, "none"),
                              batch_size=BATCH, params=state)
        got_state = loaded.model.state_dict()
        assert got_state.keys() == state.keys()
        for k, v in state.items():
            assert torch.equal(got_state[k].cpu(), v), k
        with LaunchTrace(torch) as trace1:
            img_a, feats_a, z_a = loaded.sample_batch()
            img_b, feats_b, z_b = want.sample_batch()
        n1 = trace1.device["conv_in_stats"]
        assert n1 == 2 * (gcfg.max_res_log2 - 1), n1
        assert torch.equal(z_a, z_b)
        assert img_a.shape == (BATCH, 1024, 1024, 3)
        assert torch.equal(img_a, img_b), "loaded generator's images differ"
        assert all(torch.equal(a, b) for a, b in zip(feats_a, feats_b)), \
            "loaded generator's features differ"
        assert float(img_a.float().std()) > 1.0, "constant image"
        log(f"foreign weights: {os.path.basename(path)} "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB (mxnet format, "
            f"{len(state)} tensors) loaded by ImageGenerator in "
            f"{gen_load_s:.2f} s (model build and upload included); a batch "
            f"of {BATCH} at 1024^2 (bf16, conv_in_stats launched {n1} times "
            f"over both generators) is bit-identical to the source "
            f"generator's")

        source = SegSolver(scfg.max_res_log2, "", join(base, "none"),
                           cfg=scfg)
        perturb(torch, source.model, 13)
        dec_path = join(ckpt, "checkpoint_last.params")
        write_mx_file(dec_path, decoder_mx_arrays(source.model.state_dict(),
                                                  scfg))
        t0 = time.perf_counter()
        solver = SegSolver(scfg.max_res_log2, "", ckpt, cfg=scfg)
        dec_load_s = time.perf_counter() - t0
        assert solver.is_trained
        assert solver.params_file == "checkpoint_last.params"
        feats = [f[:1].float() for f in feats_b]
        with LaunchTrace(torch) as trace2:
            got, ref = (solver.predict_logits(feats),
                        source.predict_logits(feats))
        n2 = trace2.device["small_conv"]
        assert n2 == 2 * SMALL_PER_EVAL_SAMPLE, n2
        assert got.shape == (1, 1024, 1024, 2)
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, ref), "loaded decoder's logits differ"
        fresh = SegSolver(scfg.max_res_log2, "", join(base, "none"), cfg=scfg)
        assert not torch.equal(fresh.predict_logits(feats), ref)
        log(f"foreign weights: {os.path.basename(dec_path)} "
            f"{os.path.getsize(dec_path) / 2 ** 10:.1f} KiB (mxnet format, "
            f"dotted names) loaded by SegSolver.load in {dec_load_s:.2f} s; "
            f"logits on one 1024^2 pyramid (f32, small_conv launched {n2} "
            f"times) equal the source decoder's")
    return dict(launches={"conv_in_stats": n1, "small_conv": n2},
                gen_load_s=gen_load_s, dec_load_s=dec_load_s)


# ------------------------------------------------------------ annotation
class FakeEvent:
    def __init__(self, x=0, y=0, num=0, keycode=0):
        self.x, self.y, self.num, self.keycode = x, y, num, keycode


class FakeWidget:
    """What the annotator asks of a tk widget, recorded."""

    def __init__(self, *args, **kw):
        self.kw = dict(kw)
        self.bindings = {}

    def pack(self, **kw):
        return None

    def bind(self, event, handler):
        self.bindings[event] = handler

    def config(self, **kw):
        self.kw.update(kw)

    def title(self, text):
        self.kw["title"] = text


class FakeButton(FakeWidget):
    @property
    def state(self):
        return self.kw.get("state", "normal")

    def invoke(self):
        assert self.state != "disabled", f"{self.kw.get('text')} is disabled"
        return self.kw["command"]()


class FakeCanvas(FakeWidget):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.alive, self.calls = set(), []

    def _create(self, kind, *args, **kw):
        cid = len(self.calls) + 1
        self.alive.add(cid)
        self.calls.append((kind, cid, args, kw))
        return cid

    def create_line(self, *a, **kw):
        return self._create("line", *a, **kw)

    def create_oval(self, *a, **kw):
        return self._create("oval", *a, **kw)

    def create_image(self, *a, **kw):
        return self._create("image", *a, **kw)

    def delete(self, cid):
        self.alive.discard(cid)

    def update(self):
        return None

    def images(self):
        return sum(c[0] == "image" for c in self.calls)


class FakePhotoImage:
    def __init__(self, image=None):
        self._size = image.size  # a PIL Image

    def width(self):
        return self._size[0]

    def height(self):
        return self._size[1]


@contextlib.contextmanager
def stub_tk():
    """Context: ``tkinter`` and ``PIL.ImageTk`` replaced by the recording
    stubs above (a headless machine has neither a display nor, often,
    tkinter itself); PIL proper stays the real one.  Only these two entries
    of ``sys.modules`` are set and put back: what is first imported inside
    the context stays imported."""
    import types

    import PIL

    tk = types.ModuleType("tkinter")
    tk.Frame, tk.Tk, tk.Button, tk.Canvas = (FakeWidget, FakeWidget,
                                             FakeButton, FakeCanvas)
    tk.BOTTOM, tk.BOTH, tk.RIGHT, tk.NW = "bottom", "both", "right", "nw"
    imagetk = types.ModuleType("PIL.ImageTk")
    imagetk.PhotoImage = FakePhotoImage
    stubs = {"tkinter": tk, "PIL.ImageTk": imagetk}
    saved = {name: sys.modules.get(name) for name in stubs}
    saved_attr = PIL.__dict__.get("ImageTk")
    sys.modules.update(stubs)
    PIL.ImageTk = imagetk
    try:
        yield tk
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
        if saved_attr is None:
            del PIL.ImageTk
        else:
            PIL.ImageTk = saved_attr


def drag(a, points):
    """A left-button drag over ``points`` through the annotator's mouse
    handlers."""
    a.on_mouse_down(FakeEvent(*points[0]))
    for xy in points[1:]:
        a.on_mouse_move(FakeEvent(*xy))
    a.on_mouse_up(FakeEvent(*points[-1]))


def drive_annotator(root_dir, gan, gan_dir, batch, n_images, n_generate,
                    epochs=2, max_res_log2=None, counts=None,
                    retrain_again=False):
    """A whole annotation run through ``SegmentationAnnotator``'s own
    handlers under the tk stub: ``n_images`` annotations (a drag sets
    ``has_changes``; the trimap the handlers save is the sign of channel 0
    of the sample's last feature, top two rows ignored, in place of the
    rasterized strokes, so that the decoder can learn it), the last one
    saved by Retrain itself, Retrain of ``epochs`` epochs with its preview,
    a pipeline whose graph was captured before Retrain serving the new
    decoder after it, one more image (now with a predicted mask), Generate
    of ``n_generate`` pairs; with ``retrain_again`` a second Retrain (warm)
    and a third on the per-step path (``scan_epochs=False``), timed.
    Asserts what the run must show and returns what it saw; ``counts()`` is
    read after each stage into ``marks``."""
    import random
    import types
    from unittest import mock

    import cv2
    import numpy as np
    import torch

    from gan_segmentation_tpu_torch.apps import annotator as ann
    from gan_segmentation_tpu_torch.core.config import SolverConfig
    from gan_segmentation_tpu_torch.data.collection import (
        CollectionDataset, gray_from_trimap)
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.utils.viz import get_draw_mask

    real_solver = ann.SegSolver

    def short_solver(res_log2, data, ckpt, **kw):
        cfg = SolverConfig(max_res_log2=res_log2)
        cfg.train_epochs = epochs
        return real_solver(res_log2, data, ckpt, cfg=cfg, **kw)

    marks = {}

    def mark(stage):
        if counts is not None:
            marks[stage] = counts()

    def annotate(a):
        """Draw, and make the handlers' save write the learnable trimap."""
        trimap = (a.features[-1][..., 0] > 0).astype(np.int32)
        trimap[:2] = -1
        gray = gray_from_trimap(trimap)
        drag(a, [(4, 4), (10, 10), (16, 16)])
        assert a.strokes.has_changes and len(a.strokes.history) == 3
        a.strokes.rasterize = lambda w, h: gray
        return a.image_id

    random.seed(0)
    no_sleep = types.SimpleNamespace(sleep=lambda seconds: None)
    with stub_tk(), mock.patch.object(ann, "SegSolver", short_solver), \
            mock.patch.object(ann, "time", no_sleep):
        a = ann.SegmentationAnnotator(
            FakeWidget(), root_dir, gan_dir=gan_dir, gan=gan,
            n_generate=n_generate, gan_batch_size=batch,
            max_res_log2=max_res_log2)
        res = 2 ** a.netG.cfg.max_res_log2
        assert a.generate_btn.state == "disabled"
        assert not a.solver.is_trained and a.can.images() == 1
        assert a.img_orig.shape == (res, res, 3)
        assert a.img_orig.dtype == np.uint8
        assert all(f.dtype == np.float32 for f in a.features)
        mark("constructed")

        data = join(root_dir, "data")
        ids = []
        for _ in range(n_images - 1):
            ids.append(annotate(a))
            a.ok_btn.invoke()
            assert a.image_id != ids[-1] and not a.strokes.has_changes
        ids.append(annotate(a))  # Retrain saves this one
        mark("annotated")

        # a pipeline built, and its graph captured, before Retrain must
        # serve the new weights after it
        reused_gen = ImageGenerator(gan=gan, gan_dir=gan_dir,
                                    batch_size=batch,
                                    max_res_log2=max_res_log2,
                                    device=a.solver.device)
        reused = FusedPipeline(reused_gen, a.solver)
        for _ in range(2):  # the eager first batch, then the capture
            reused.sample_batch()
        mark("reused")
        before = {k: (w.clone(), b.clone())
                  for k, (w, b) in reused._prepared().items()}
        shown = []
        real_set_img = a.set_img
        a.set_img = lambda img: (shown.append(np.array(img)),
                                 real_set_img(img))[1]
        redraws = a.can.images()
        t0 = time.perf_counter()
        a.retrain_btn.invoke()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        retrain_s = time.perf_counter() - t0
        a.set_img = real_set_img
        mark("retrained")
        for i in ids:
            for name in (f"mask_{i:06d}.png", f"img_{i:06d}.jpg",
                         f"vis_img_{i:06d}.jpg", f"feat_{i:06d}.pickle"):
                assert os.path.isfile(join(data, name)), name
        ds = CollectionDataset(data, a.solver.cfg, load_to_memory=False)
        assert len(ds) == n_images
        _, mask, feats = ds.get_item(0)
        assert set(np.unique(mask)) == {-1, 0, 1} and mask.shape == (res, res)
        assert [f.shape[-1] for f in feats] == list(a.solver.cfg.in_channels)
        assert a.solver.is_trained
        assert a.can.images() >= redraws + epochs
        history = a.solver.history
        assert len(history) == epochs and all(
            len(h) == n_images for h in history)
        first, last = float(np.mean(history[0])), float(np.mean(history[-1]))
        assert np.isfinite(first) and last < first, history
        for b in (a.ok_btn, a.skip_btn, a.retrain_btn, a.generate_btn):
            assert b.state == "normal"
        # the preview after the last epoch is predict after fit returned
        pred = a.solver.predict(a.features)[0].astype(np.uint8)
        assert np.array_equal(shown[-1], get_draw_mask(
            a.img_orig, pred[:, :, 0], alpha=0.5))
        after = reused._prepared()
        fresh_fold = a.solver.model.fold_bn(reused.dec_dtype)
        assert all(torch.equal(after[k][0], fresh_fold[k][0])
                   and torch.equal(after[k][1], fresh_fold[k][1])
                   for k in fresh_fold)
        assert any(not torch.equal(after[k][0], before[k][0])
                   for k in fresh_fold), "Retrain left the weights as is"
        got = reused.sample_batch()  # a replay of the graph from before
        fresh_gen = ImageGenerator(gan=gan, gan_dir=gan_dir,
                                   batch_size=batch,
                                   max_res_log2=max_res_log2,
                                   device=a.solver.device)
        fresh_gen.skip_batches(reused_gen._batch_index - 1)
        want = FusedPipeline(fresh_gen, a.solver).sample_batch()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), \
            "a graph captured before Retrain served the old decoder"
        del reused_gen, fresh_gen, got, want
        mark("stale_checked")

        a.skip_btn.invoke()  # the next image comes with a predicted mask
        assert not np.array_equal(a.vis_img, a.img_orig)
        mark("predicted")

        consumed = a.netG._batch_index
        t0 = time.perf_counter()
        a.generate_btn.invoke()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        mark("generated")
        # the weights Generate used, for the check below (the Retrains
        # after it train on)
        shutil.copytree(join(root_dir, "checkpoints"),
                        join(root_dir, "checkpoints_at_generate"))
        for b in (a.ok_btn, a.skip_btn, a.retrain_btn, a.generate_btn):
            assert b.state == "normal"
        retrain = {}
        if retrain_again:  # warm, then the per-step path, same collection
            for tag, scan in (("warm", None), ("eager", False)):
                a.solver.cfg.scan_epochs = scan
                t0 = time.perf_counter()
                a.retrain_btn.invoke()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                retrain[tag] = time.perf_counter() - t0
            a.solver.cfg.scan_epochs = None
        device = a.solver.device
        del a, reused

    # Generate's masks are those of a fresh pipeline on the checkpoint
    # saved before Generate, at the same place of the same seeded stream
    dst = join(root_dir, "dataset", "train_generated")
    gen = ImageGenerator(gan=gan, gan_dir=gan_dir, batch_size=batch,
                         max_res_log2=max_res_log2, device=device)
    gen.skip_batches(consumed)
    solver = short_solver(gen.cfg.max_res_log2, data,
                          join(root_dir, "checkpoints_at_generate"),
                          device=device)
    assert solver.is_trained and solver.params_file == "checkpoint_last.pt"
    ones = 0
    pairs = FusedPipeline(gen, solver).generate_pairs(n_generate)
    for i, (img, mask) in enumerate(pairs):
        got = cv2.imread(join(dst, f"mask_{i:06d}.png"), cv2.IMREAD_GRAYSCALE)
        assert got is not None and np.array_equal(got, mask), i
        jpg = cv2.imread(join(dst, f"img_{i:06d}.jpg"))
        assert jpg is not None and jpg.shape == img.shape, i
        ones += int(mask.sum())
    assert len(os.listdir(dst)) == 2 * n_generate
    return dict(ids=ids, history=history, marks=marks, retrain_s=retrain_s,
                retrain_again_s=retrain, generate_s=generate_s, res=res,
                mask_share=ones / (n_generate * res * res))


ANN_BATCH = 2        # gan_batch_size of the run
ANN_IMAGES = 6
ANN_EPOCHS = 2
ANN_GENERATE = 16


def phase_annotation(torch):
    """The annotation run at ffhq 1024^2 on the card (see
    ``drive_annotator``), with the kernels' launch counts per stage."""
    with tempfile.TemporaryDirectory() as base, LogLines(
            "gan_segmentation_tpu_torch.train.solver") as lines, \
            LaunchTrace(torch) as trace:
        seen = drive_annotator(
            base, "ffhq", join(base, "no-models"), ANN_BATCH, ANN_IMAGES,
            ANN_GENERATE, epochs=ANN_EPOCHS, counts=trace.so_far,
            retrain_again=True)
    epoch_s = lines.floats("Time cost")
    assert len(epoch_s) == 3 * ANN_EPOCHS, epoch_s  # 3 Retrains
    graphed = [m for m in lines.lines if m.startswith("scan_epochs: each")]
    assert len(graphed) == 2, graphed  # the first two Retrains, not eager
    # the device trace's count; the stages' counts below are the wrappers'
    # eager launches plus their graphs' replays, whose sum the trace equals
    total = trace.device
    m = seen["marks"]
    steps = ANN_EPOCHS * ANN_IMAGES
    # the sampler: one batch of ANN_BATCH per two images shown, kernel 1
    # nine times a batch; no decoder before Retrain
    assert m["constructed"] == {"conv_in_stats": 9, "small_conv": 0,
                                "bil_conv": 0}, m
    assert m["annotated"]["conv_in_stats"] == 9 * -(-ANN_IMAGES // 2), m
    assert m["annotated"]["small_conv"] == m["annotated"]["bil_conv"] == 0, m
    # two batches of the pipeline built before Retrain
    assert (m["reused"]["conv_in_stats"] - m["annotated"]["conv_in_stats"]
            == 2 * 9), m
    assert m["reused"]["small_conv"] == 2 * SMALL_PER_EVAL_SAMPLE, m
    # Retrain: kernels 3 and 2 in every step (eager steps and replays),
    # kernel 2 in each epoch's preview
    assert m["retrained"]["bil_conv"] == BIL_PER_STEP * steps, m
    assert (m["retrained"]["small_conv"] - m["reused"]["small_conv"]
            == SMALL_PER_STEP * steps + SMALL_PER_EVAL_SAMPLE * ANN_EPOCHS), m
    assert m["retrained"]["conv_in_stats"] == m["reused"]["conv_in_stats"]
    # the check's predict, a replay of the old graph, a fresh batch
    assert (m["stale_checked"]["small_conv"] - m["retrained"]["small_conv"]
            == 3 * SMALL_PER_EVAL_SAMPLE), m
    assert (m["stale_checked"]["conv_in_stats"]
            - m["retrained"]["conv_in_stats"] == 2 * 9), m
    # predict for the next image
    assert (m["predicted"]["small_conv"] - m["stale_checked"]["small_conv"]
            == SMALL_PER_EVAL_SAMPLE), m
    # Generate: kernels 1 and 2 per batch
    batches = -(-ANN_GENERATE // ANN_BATCH)
    assert (m["generated"]["conv_in_stats"] - m["predicted"]["conv_in_stats"]
            == 9 * batches), m
    assert (m["generated"]["small_conv"] - m["predicted"]["small_conv"]
            == SMALL_PER_EVAL_SAMPLE * batches), m
    assert m["generated"]["bil_conv"] == m["retrained"]["bil_conv"]
    hist = seen["history"]
    smi = smi_line()
    log(f"annotation run (ffhq 1024^2, gan_batch_size {ANN_BATCH}): "
        f"{ANN_IMAGES} annotations saved by the handlers and read back; "
        f"Retrain ({ANN_EPOCHS} epochs x {ANN_IMAGES} steps, previews "
        f"included) {seen['retrain_s']:.2f} s, of which the epochs' steps "
        f"took {' + '.join(f'{t:.3f}' for t in epoch_s[:ANN_EPOCHS])} s and "
        f"the rest is "
        f"the last annotation's save, the collection's load and upload, "
        f"the previews and the checkpoint; epoch loss "
        f"{sum(hist[0]) / len(hist[0]):.4f} -> "
        f"{sum(hist[-1]) / len(hist[-1]):.4f}, last preview = predict; "
        f"again: warm {seen['retrain_again_s']['warm']:.2f} s, on the "
        f"per-step path {seen['retrain_again_s']['eager']:.2f} s (epochs "
        f"{' + '.join(f'{t:.3f}' for t in epoch_s[2 * ANN_EPOCHS:])} s); "
        f"a graph captured before Retrain serves the new decoder; "
        f"Generate {ANN_GENERATE} pairs {seen['generate_s']:.2f} s "
        f"({ANN_GENERATE / seen['generate_s']:.3f} samples/s with the cv2 "
        f"writer), masks equal a fresh pipeline's on the saved checkpoint "
        f"(class 1 on {seen['mask_share']:.4f} of the pixels), the pipeline "
        f"built before Retrain refolded; launches by stage {m}, in all "
        f"{total} (device trace; the run was traced) on {smi}")
    return dict(launches=total, retrain_s=seen["retrain_s"],
                retrain_warm_s=seen["retrain_again_s"]["warm"],
                retrain_eager_s=seen["retrain_again_s"]["eager"],
                generate_s=seen["generate_s"])

# ----------------------------------------------------------------- deeplab
DL_BATCH, DL_CROP, DL_CLASSES = 8, 480, 2
DL_STEPS, DL_WARMUP = 12, 2
# the experiment's schedule: 20 epochs of 10000 samples at batch 8
DL_LR, DL_WD, DL_MOMENTUM, DL_TOTAL_ITERS = 0.005, 2e-4, 0.9, 25000
DL_AUX_WEIGHT = 0.5
DL_GRADS = ("backbone.stem_conv0", "backbone.layer4_block2.conv2",
            "aspp.b3_conv", "head_sep1.pointwise", "auxlayer.conv1")
# card vs CPU in f32 (TF32 off): both sum thousands of products in another
# order through 57 convs.  A gradient is held by its relative L2 error: 1e-2
# with batch norm in eval mode (measured 5e-7 to 1.6e-3).  In train mode the
# gradient of this random, 57-batch-norm-deep model is ill-conditioned: the
# CPU against itself with its input scaled by 1 + 1e-7 moves it by 0.02-0.05
# (0.00003 at auxlayer.conv1, next to the loss; the phase measures and logs
# it), while the loss moves by 1e-6; the card against the CPU measured
# 0.027-0.034.  A wrong layout or formula moves a gradient by its own size.
DL_EVAL_TOL = dict(atol=1e-3, rtol=1e-3)
DL_LOSS_RTOL = 1e-4
DL_GRAD_L2 = 1e-2
DL_TRAIN_GRAD_L2 = 0.2
DL_STAT_TOL = dict(atol=1e-4, rtol=1e-4)
# full width, bf16 logits against f32 logits on the same weights: a bound
# on the mean |difference|, six times the first run's reading (0.00033 at a
# mean |logit| of 0.0535, random init, NVIDIA H100 80GB HBM3)
DL_BF16_MEAN = 0.002


def _deeplab_ref_name(path):
    """A module path of the port's DeepLabV3Plus -> the attribute path of
    the reference's ``save_parameters`` file (``core/deeplab_convert.py``'s
    table, inverted)."""
    m = re.fullmatch(r"backbone\.stem_conv(\d)", path)
    if m:
        return f"conv1.{(0, 3, 6)[int(m.group(1))]}"
    m = re.fullmatch(r"backbone\.stem_bn(\d)", path)
    if m:
        return ("conv1.1", "conv1.4", "bn1")[int(m.group(1))]
    m = re.fullmatch(r"backbone\.layer(\d)_block(\d+)\.(conv|bn)(\d)", path)
    if m:
        i, b, kind, c = m.groups()
        return f"layer{i}.{b}.{kind}{c}"
    m = re.fullmatch(r"backbone\.layer(\d)_block0\.downsample_(conv|bn)", path)
    if m:
        return f"layer{m.group(1)}.0.downsample." \
               f"{0 if m.group(2) == 'conv' else 1}"
    m = re.fullmatch(r"aspp\.b(\d)_(conv|bn)", path)
    if m:
        return f"aspp.concurent.{m.group(1)}." \
               f"{0 if m.group(2) == 'conv' else 1}"
    m = re.fullmatch(r"head_sep(\d)\.(depthwise|pointwise)(_bn)?", path)
    if m:
        idx, kind, is_bn = m.groups()
        if is_bn:
            return f"head.block.{idx}.{'bn1' if kind == 'depthwise' else 'bn2'}"
        return f"head.block.{idx}.{kind}_conv"
    return {"skip_project.conv": "skip_project.skip_project.0",
            "skip_project.bn": "skip_project.skip_project.1",
            "aspp.pool_conv": "aspp.concurent.4.gap.1",
            "aspp.pool_bn": "aspp.concurent.4.gap.2",
            "aspp.project_conv": "aspp.project.0",
            "aspp.project_bn": "aspp.project.1",
            "head_classifier": "head.block.2",
            "auxlayer.conv0": "auxlayer.block.0",
            "auxlayer.bn0": "auxlayer.block.1",
            "auxlayer.conv1": "auxlayer.block.4"}[path]


def _backbone_legacy_name(path, prefix="resnetv1s_"):
    """A module path of the port's ResNetV1s -> gluoncv's legacy name_scope
    base name (``core/backbone_convert.py``'s map, inverted)."""
    m = re.fullmatch(r"stem_(conv|bn)(\d)", path)
    if m:
        kind = "conv" if m.group(1) == "conv" else "batchnorm"
        return f"{prefix}{kind}{m.group(2)}"
    m = re.fullmatch(r"layer(\d)_block(\d+)\.(conv|bn)(\d)", path)
    if m:
        i, b, kind, c = m.groups()
        kind = "conv" if kind == "conv" else "batchnorm"
        return f"{prefix}layers{i}_bottleneckv1b{b}_{kind}{int(c) - 1}"
    m = re.fullmatch(r"layer(\d)_block0\.downsample_(conv|bn)", path)
    kind = "conv0" if m.group(2) == "conv" else "batchnorm0"
    return f"{prefix}down{m.group(1)}_{kind}"


def _mx_named(state, base_name, sep):
    """``state_dict`` -> {mxnet name: array}: convs keep OIHW ``weight`` /
    ``bias``, a batch norm's ``weight`` / ``bias`` become ``gamma`` /
    ``beta``.  A batch norm is a module whose name holds ``bn``."""
    mx = {}
    for key, t in state.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        if "bn" in module.rsplit(".", 1)[-1]:
            leaf = _BN_NAMES[leaf]
        mx[f"{base_name(module)}{sep}{leaf}"] = t.detach().float().cpu(
            ).contiguous().numpy()
    return mx


def deeplab_mx_arrays(state):
    """A DeepLabV3Plus ``state_dict`` of the port -> the dotted attribute
    paths of the reference's ``save_parameters`` file."""
    return _mx_named(state, _deeplab_ref_name, ".")


def backbone_mx_arrays(state):
    """A ResNetV1s ``state_dict`` of the port -> gluoncv's legacy names,
    with the classifier a real file also holds and a loader must skip."""
    import numpy as np

    mx = _mx_named(state, _backbone_legacy_name, "_")
    mx["resnetv1s_dense0_weight"] = np.zeros((10, 2048), np.float32)
    mx["resnetv1s_dense0_bias"] = np.zeros(10, np.float32)
    return mx


def deeplab_batch(torch, batch=DL_BATCH, size=DL_CROP, seed=21, device="cuda"):
    """A seeded batch: uint8 NHWC images whose colour follows a blocky
    field, int8 masks {0, 1} from the same field with -1 on ~6% of the
    pixels."""
    g = torch.Generator().manual_seed(seed)
    cells = max(size // 32, 1)
    field = torch.rand((batch, cells, cells), generator=g) > 0.5
    field = field.repeat_interleave(size // cells, 1).repeat_interleave(
        size // cells, 2)
    colour = torch.tensor([[60.0, 90.0, 150.0], [190.0, 140.0, 70.0]])
    images = colour[field.long()] + 40.0 * torch.randn(
        (batch, size, size, 3), generator=g)
    masks = field.to(torch.int8)
    masks[torch.rand((batch, size, size), generator=g) < 0.06] = -1
    return (images.clamp(0, 255).to(torch.uint8).to(device),
            masks.to(device))


def rel_l2(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def deeplab_small_reference(torch):
    """Card against CPU at 2x96x96 in f32 (TF32 off)."""
    import copy

    from gan_segmentation_tpu_torch.models import resnext
    from gan_segmentation_tpu_torch.models.deeplab import (DeepLabV3,
                                                           DeepLabV3Plus)
    from gan_segmentation_tpu_torch.ops import losses
    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        make_optimizer, train_step)

    cuda = torch.device("cuda")
    images, masks = deeplab_batch(torch, 2, 96, seed=22, device="cpu")
    x = (images.float() / 255.0 - 0.45) / 0.225

    def both(model):
        perturb(torch, model, 23)
        return model, copy.deepcopy(model).to(cuda)

    cpu, card = both(DeepLabV3Plus(DL_CLASSES, use_dropout=False))
    for m in (cpu, card):
        m.eval()
    with torch.no_grad():
        want, got = cpu(x), card(x.to(cuda))
    errs = []
    for name, g, w in zip(("out", "aux"), got, want):
        assert g.shape == (2, 96, 96, DL_CLASSES)
        check_close(f"deeplab small eval {name}", g.cpu(), w, **DL_EVAL_TOL)
        errs.append(max_err(g.cpu(), w))
    # the loss's gradients with batch norm in eval mode
    eval_errs = {}
    grads = {}
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        out = [o.float() for o in m(x.to(dev))]
        losses.seg_loss_with_aux(out[0], out[1], masks.to(dev),
                                 aux_weight=DL_AUX_WEIGHT).mean().backward()
        grads[str(dev)] = {k: p.grad for k, p in m.named_parameters()}
    for name in DL_GRADS:
        k = f"{name}.weight"
        eval_errs[name] = rel_l2(grads["cuda"][k], grads["cpu"][k])
        assert eval_errs[name] < DL_GRAD_L2, (k, eval_errs[name])
    del grads

    readings = {}
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        opt, sched = make_optimizer(m, DL_LR, DL_TOTAL_ITERS, DL_WD,
                                    DL_MOMENTUM)
        loss, _ = train_step(m, opt, sched, images.to(dev), masks.to(dev),
                             aux_weight=DL_AUX_WEIGHT)
        readings[str(dev)] = (float(loss), {
            k: p.grad for k, p in m.named_parameters()}, m.state_dict())
    # the train-mode gradient's own conditioning: the CPU against itself
    # with the input scaled by 1 + 1e-7
    self_grads = []
    for factor in (1.0, 1.0 + 1e-7):
        m = copy.deepcopy(cpu)
        opt, sched = make_optimizer(m, DL_LR, DL_TOTAL_ITERS, DL_WD,
                                    DL_MOMENTUM)
        train_step(m, opt, sched, x * factor, masks,
                   aux_weight=DL_AUX_WEIGHT)
        self_grads.append({k: p.grad for k, p in m.named_parameters()})
    (lc, gc, sc), (lg, gg, sg) = readings["cpu"], readings["cuda"]
    self_errs = {name: rel_l2(self_grads[1][f"{name}.weight"],
                              self_grads[0][f"{name}.weight"])
                 for name in DL_GRADS}
    del self_grads
    assert abs(lg - lc) <= DL_LOSS_RTOL * abs(lc), (lg, lc)
    grad_errs = {}
    for name in DL_GRADS:
        k = f"{name}.weight"
        grad_errs[name] = rel_l2(gg[k], gc[k])
        assert grad_errs[name] < DL_TRAIN_GRAD_L2, (k, grad_errs[name])
    assert all(bool(torch.isfinite(g).all()) for g in gg.values())
    stat_err = 0.0
    for k, w in sc.items():
        if k.endswith(("running_mean", "running_var")):
            check_close(f"deeplab small {k}", sg[k].cpu(), w, **DL_STAT_TOL)
            stat_err = max(stat_err, max_err(sg[k].cpu(), w))
    log(f"deeplab small (DeepLabV3+ resnet50, 2x96x96, f32) card vs CPU: "
        f"eval out / aux max|err| {errs[0]:.3g} / {errs[1]:.3g} (tol "
        f"{DL_EVAL_TOL}); the loss's gradients with batch norm in eval "
        f"mode, relative L2 error "
        f"{ {k: float(f'{v:.2g}') for k, v in eval_errs.items()} } (< "
        f"{DL_GRAD_L2}); train_step loss {lg:.6f} vs {lc:.6f} (rtol "
        f"{DL_LOSS_RTOL}), its gradients "
        f"{ {k: float(f'{v:.2g}') for k, v in grad_errs.items()} } (< "
        f"{DL_TRAIN_GRAD_L2}; ill-conditioned in train mode: the CPU "
        f"against itself with its input scaled by 1 + 1e-7 "
        f"{ {k: float(f'{v:.2g}') for k, v in self_errs.items()} }); "
        f"running statistics max|err| {stat_err:.3g} (tol {DL_STAT_TOL})")
    del cpu, card, readings

    others = {}
    for name, make in (
            ("DeepLabV3", lambda: DeepLabV3(DL_CLASSES)),
            ("SE-ResNeXt-50", resnext.se_resnext50_32x4d)):
        cpu, card = both(make())
        for m in (cpu, card):
            m.eval()
        with torch.no_grad():
            want, got = cpu(x), card(x.to(cuda))
        for i, (g, w) in enumerate(zip(got, want)):
            check_close(f"{name} small eval output {i}", g.cpu(), w,
                        **DL_EVAL_TOL)
        others[name] = max(max_err(g.cpu(), w) for g, w in zip(got, want))
        del cpu, card

    g = torch.Generator().manual_seed(24)
    logits = 2.0 * torch.randn((3, 24, 20, 4), generator=g)
    flat = 2.0 * torch.randn((3, 24, 20), generator=g)
    labels = torch.randint(-1, 4, (3, 24, 20), generator=g)
    labels[-1] = -1
    binary = labels.clamp_max(1)
    area = 0.2 + torch.rand((3, 24, 20), generator=g)
    cases = {
        "weighted_softmax_ce": lambda d: losses.weighted_softmax_ce(
            logits.to(d), labels.to(d), area.to(d)),
        "softmax_ce_valid_norm": lambda d: losses.softmax_ce_valid_norm(
            logits.to(d), labels.to(d)),
        "normalized_focal_loss_softmax": lambda d:
            losses.normalized_focal_loss_softmax(logits.to(d), labels.to(d)),
        "area_normalized_focal_loss_softmax": lambda d:
            losses.area_normalized_focal_loss_softmax(
                logits.to(d), labels.to(d), area.to(d)),
        "normalized_focal_loss_sigmoid": lambda d:
            losses.normalized_focal_loss_sigmoid(flat.to(d), binary.to(d)),
        "focal_loss_sigmoid": lambda d: losses.focal_loss_sigmoid(
            flat.to(d), binary.to(d)),
        "seg_loss_with_aux": lambda d: losses.seg_loss_with_aux(
            logits.to(d), 0.5 * logits.to(d), labels.to(d)),
    }
    for name, call in cases.items():
        want, got = call("cpu"), call(cuda)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for gt, wt in zip(got, want):
            check_close(f"loss {name}", gt.cpu(), wt, atol=1e-6, rtol=1e-5)
    log(f"deeplab small: DeepLabV3 / SE-ResNeXt-50 eval max|err| "
        f"{others['DeepLabV3']:.3g} / {others['SE-ResNeXt-50']:.3g}; the "
        f"{len(cases)} losses on the card equal the CPU's (rtol 1e-5)")


def deeplab_train_run(torch, model, state, images, masks, dtype,
                      steps=DL_STEPS, seed=31):
    """``steps`` train steps on one batch with ``model`` set back to
    ``state``, a new optimizer and dropout on.  -> (losses, ms per step
    after the warm-up, peak bytes, the two rates before each step)."""
    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        make_optimizer, train_step)

    model.load_state_dict(state)
    opt, sched = make_optimizer(model, DL_LR, DL_TOTAL_ITERS, DL_WD,
                                DL_MOMENTUM)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses, rates = [], []
    for step in range(steps):
        if step == DL_WARMUP:
            start.record()
        rates.append([g["lr"] for g in opt.param_groups])
        loss, pred = train_step(model, opt, sched, images, masks, gen,
                                aux_weight=DL_AUX_WEIGHT, dtype=dtype)
        losses.append(loss)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / max(steps - DL_WARMUP, 1)
    assert pred.shape == (DL_BATCH, DL_CROP, DL_CROP, DL_CLASSES)
    assert pred.dtype == torch.float32
    return ([float(v) for v in torch.stack(losses).cpu()], ms,
            torch.cuda.max_memory_allocated(), rates)


def enqueue_ms(torch, step, n=5):
    """The host's time to enqueue one ``step`` on an idle card, after a
    synchronise (back-to-back steps would fill the launch queue and time
    the card instead): the median of ``n``."""
    import statistics

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def deeplab_profile(torch, model, state, images, masks, dtype, steps=3):
    """Where a full-width train step's time goes: wall time over 10 steps
    against the host's time to enqueue one (``enqueue_ms``), and the device
    time of ``steps`` profiled steps by kernel family (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        make_optimizer, train_step)

    model.load_state_dict(state)
    opt, sched = make_optimizer(model, DL_LR, DL_TOTAL_ITERS, DL_WD,
                                DL_MOMENTUM)
    gen = torch.Generator(device="cuda").manual_seed(32)

    def step():
        train_step(model, opt, sched, images, masks, gen,
                   aux_weight=DL_AUX_WEIGHT, dtype=dtype)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 100
    host_ms = enqueue_ms(torch, step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name, launches, fam = kernel_families(prof, steps)
    busy = sum(fam.values())
    log(f"deeplab train step {str(dtype).split('.')[1]}: wall {wall_ms:.3f} "
        f"ms per step over 10 steps, host enqueue of one step on an idle "
        f"card {host_ms:.3f} ms; device "
        f"kernel time {busy:.3f} ms per step in {launches // steps} launches "
        f"(profiler), busy share {busy / wall_ms:.3f}")
    for name, t in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {t:.3f} ms/step ({t / busy:.3f} of device time)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {t / steps:8.3f} ms/step  {name[:110]}")
    return dict(wall_ms=wall_ms, host_enqueue_ms=host_ms, busy_ms=busy,
                launches=launches // steps, families=fam)


def kernel_families(prof, steps):
    """A DeepLab step's device kernels in a ``torch.profiler`` trace of
    ``steps`` steps: (ms per kernel name, launches, ms per step by
    family)."""
    from torch.autograd import DeviceType

    by_name = kernel_times(prof)
    launches = sum(
        1 for evt in prof.events() if evt.device_type == DeviceType.CUDA
        and not (getattr(evt, "is_user_annotation", False)
                 or evt.name.startswith("Optimizer.")))

    def family(name):
        low = name.lower()
        if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low \
                or "bn_bw" in low:
            return "batch norm"
        if any(k in low for k in ("conv", "gemm", "xmma", "cudnn", "cutlass",
                                  "wgrad", "dgrad", "nhwc", "nchw")):
            return "cuDNN convs (forward, dgrad, wgrad, layout)"
        if "upsample" in low or "max_pool" in low:
            return "resize and max-pool"
        if "memcpy" in low or "memset" in low:
            return "memcpy / memset"
        return "elementwise and reductions (relu, add, casts, dropout, " \
               "loss, SGD)"

    return by_name, launches, families(by_name, steps, family)


DL_GRAPH_STEPS = 6    # eager steps held to as many graphed ones, bit for bit
DL_GRAPH_TIMED = 10   # replays timed per dtype


def deeplab_graph_twin(torch, model, state, images, masks, dtype, graphed,
                       steps=DL_GRAPH_STEPS, seed=33, group=None):
    """``steps`` train steps from ``state`` with the graphed optimizer
    (fused SGD, rate tensors) and dropout on: as ``GraphedTrainStep`` (two
    eager warm-up steps, the capture, replays) or as eager ``train_step``s
    (the graph's eager twin); ``group``: the gradient all-reduce over it.
    -> (losses, state after, generator state)."""
    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        GraphedTrainStep, make_optimizer, train_step)

    model.load_state_dict(state)
    opt, sched = make_optimizer(model, DL_LR, DL_TOTAL_ITERS, DL_WD,
                                DL_MOMENTUM, graphed=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step = (GraphedTrainStep(model, opt, sched, gen, aux_weight=DL_AUX_WEIGHT,
                             dtype=dtype, group=group) if graphed else None)
    losses = []
    for _ in range(steps):
        if graphed:
            loss, _ = step(images, masks)
        else:
            loss, _ = train_step(model, opt, sched, images, masks, gen,
                                 aux_weight=DL_AUX_WEIGHT, dtype=dtype,
                                 group=group)
        losses.append(loss.clone())
    torch.cuda.synchronize()
    out = (torch.stack(losses).cpu(),
           {k: v.clone() for k, v in model.state_dict().items()},
           gen.get_state())
    del step, opt, sched
    return out


def deeplab_graph_profile(torch, model, state, images, masks, dtype,
                          group=None):
    """The step as replays, default cuDNN mode: ms per step by CUDA events
    over ``DL_GRAPH_TIMED`` replays and the host's time to enqueue one
    (``enqueue_ms``), the
    memory the first calls keep reserved (the graph's pool, the optimizer's
    state, the static inputs), and a profile of 3 replays: device kernel
    time by family, launches per replay (the trace's kernels), NCCL's
    among them (``group``: the gradient all-reduce over it)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        GraphedTrainStep, make_optimizer)

    model.load_state_dict(state)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    opt, sched = make_optimizer(model, DL_LR, DL_TOTAL_ITERS, DL_WD,
                                DL_MOMENTUM, graphed=True)
    gen = torch.Generator(device="cuda").manual_seed(34)
    step = GraphedTrainStep(model, opt, sched, gen, aux_weight=DL_AUX_WEIGHT,
                            dtype=dtype, group=group)
    for _ in range(4):  # two warm-up steps, the capture, a replay
        step(images, masks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool_gib = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(DL_GRAPH_TIMED):
        step(images, masks)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / DL_GRAPH_TIMED
    host_ms = enqueue_ms(torch, lambda: step(images, masks))
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(images, masks)
        torch.cuda.synchronize()
    _, launches, fam = kernel_families(prof, steps)
    nccl = sum("nccl" in n.lower() for n in device_kernel_names(prof))
    busy = sum(fam.values())
    replays = sum(c.replays for c in step.fn.calls.values())
    del step, opt, sched
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=ms, host_enqueue_ms=host_ms, busy_ms=busy,
                busy_share=busy / ms, launches=launches // steps,
                nccl_launches=nccl / steps, pool_gib=pool_gib, families=fam,
                replays=replays)


def deeplab_graph_vs_eager(torch, model, state, images, masks, eager_prof,
                           smi):
    """The train step as a CUDA graph (``GraphedTrainStep``) at full width:
    in cuDNN's deterministic mode ``DL_GRAPH_STEPS`` graphed steps equal as
    many eager steps with the same optimizer bit for bit (losses, weights,
    running statistics, momentum-fed updates, the dropout generator), in
    f32 with TF32 convs and in bf16; then graph beside eager per step."""
    import math

    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with cudnn_deterministic(torch):
            eager = deeplab_graph_twin(torch, model, state, images, masks,
                                       dtype, graphed=False)
            graphed = deeplab_graph_twin(torch, model, state, images, masks,
                                         dtype, graphed=True)
        differ = [k for k in eager[1] if not torch.equal(eager[1][k],
                                                         graphed[1][k])]
        same = dict(losses=bool(torch.equal(eager[0], graphed[0])),
                    tensors_differ=len(differ),
                    generator=bool(torch.equal(eager[2], graphed[2])))
        check_later(same["losses"] and not differ and same["generator"],
                    f"deeplab {name}: {DL_GRAPH_STEPS} graphed steps differ "
                    f"from the eager steps in deterministic mode: {same}, "
                    f"first tensors {differ[:3]}, losses "
                    f"{eager[0].tolist()} vs {graphed[0].tolist()}")
        assert all(math.isfinite(v) for v in graphed[0].tolist())
        prof = deeplab_graph_profile(torch, model, state, images, masks,
                                     dtype)
        ep = eager_prof[name]
        log(f"deeplab train step {name} as a CUDA graph: {DL_GRAPH_STEPS} "
            f"graphed steps (2 eager warm-ups, the capture, replays) against "
            f"{DL_GRAPH_STEPS} eager steps in cuDNN's "
            f"deterministic mode: losses bit-equal {same['losses']}, "
            f"{len(eager[1]) - len(differ)}/{len(eager[1])} tensors of the "
            f"state bit-equal, generator {same['generator']}; per step, "
            f"graph (eager): {prof['ms']:.3f} ({ep['wall_ms']:.3f}) ms, "
            f"host enqueue of one step on an idle card "
            f"{prof['host_enqueue_ms']:.3f} ({ep['host_enqueue_ms']:.3f}) "
            f"ms, device kernels "
            f"{prof['busy_ms']:.3f} ({ep['busy_ms']:.3f}) ms, busy share "
            f"{prof['busy_share']:.3f} ({ep['busy_ms'] / ep['wall_ms']:.3f}),"
            f" {prof['launches']} ({ep['launches']}) launches per step in "
            f"the device trace; the graph keeps {prof['pool_gib']:.3f} GiB "
            f"reserved (pool, optimizer state, static inputs) on {smi}")
        out[name] = dict(bit_equal=same, **prof)
    return out


def deeplab_full_width(torch, smi):
    from gan_segmentation_tpu_torch.models import resnet
    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
    from gan_segmentation_tpu_torch.ops.norm import batch_norm_train
    from gan_segmentation_tpu_torch.ops.resize import bilinear_resize
    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        eval_step, poly_schedule)

    images, masks = deeplab_batch(torch)
    assert images.dtype == torch.uint8 and masks.dtype == torch.int8
    assert set(masks.unique().tolist()) == {-1, 0, 1}
    t0 = time.perf_counter()
    model = DeepLabV3Plus(DL_CLASSES, "resnet50", aux=True, crop_size=DL_CROP,
                          generator=torch.Generator().manual_seed(41))
    init_s = time.perf_counter() - t0
    state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    model.cuda()

    # (i) eval forward
    out = {}
    ms = {}
    for name, dtype, tf32, reps in (("f32_exact", torch.float32, False, 2),
                                    ("f32", torch.float32, True, REPS),
                                    ("bf16", torch.bfloat16, True, REPS)):
        torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        out[name] = eval_step(model, images, dtype=dtype)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        ms[name] = cuda_ms(lambda: eval_step(model, images, dtype=dtype),
                           reps)
        log(f"deeplab eval {name}: first call {first * 1e3:.1f} ms, then "
            f"{ms[name]:.3f} ms per batch of {DL_BATCH} at {DL_CROP}^2")
    for o in out.values():
        assert o.shape == (DL_BATCH, DL_CROP, DL_CROP, DL_CLASSES)
        assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
    diff = (out["bf16"] - out["f32"]).abs()
    flips = float((out["bf16"].argmax(-1) != out["f32"].argmax(-1)
                   ).float().mean())
    mean_diff, max_diff = float(diff.mean()), float(diff.max())
    scale = float(out["f32"].abs().mean())
    tf_diff = float((out["f32_exact"] - out["f32"]).abs().mean())
    log(f"deeplab eval bf16 logits against f32 logits (mean |logit| "
        f"{scale:.4f}): mean |difference| {mean_diff:.5f} (bound "
        f"{DL_BF16_MEAN}), max {max_diff:.4f}, argmax flips on {flips:.5f} "
        f"of the pixels; f32 with TF32 convs against exact f32: mean "
        f"{tf_diff:.6f}")
    assert mean_diff < DL_BF16_MEAN, (mean_diff, DL_BF16_MEAN)
    # what the layouts do: an NHWC tensor viewed as NCHW is channels-last
    with torch.no_grad():
        x = torch.zeros((1, 64, 64, 3), device="cuda")
        c1, c3, c4 = model.backbone(x)
        y = model.aspp(c4)
        layouts = {n: t.is_contiguous() for n, t in (
            ("c1", c1), ("c4", c4), ("aspp", y),
            ("resized", bilinear_resize(y, 16, 16)))}
    log(f"deeplab layouts, NHWC-contiguous (channels-last under F.conv2d): "
        f"{layouts}")
    assert layouts["c1"] and layouts["c4"] and layouts["aspp"], layouts
    del out, diff

    # (ii) train steps
    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        losses, step_ms, peak, rates = deeplab_train_run(
            torch, model, state, images, masks, dtype)
        assert all(l == l and abs(l) < 1e4 for l in losses), losses
        assert losses[-1] < 0.7 * losses[0], (name, losses)
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads), f"{name}: a gradient is missing or " \
                                    f"not finite"
        assert all(g.dtype == torch.float32 for g in grads)
        sched = poly_schedule(DL_LR, DL_TOTAL_ITERS)
        for step, (base, head) in enumerate(rates):
            assert abs(base - sched(step)) <= 1e-9 + 1e-6 * base, (step, base)
            assert abs(head - 10.0 * base) <= 1e-6 * head, (step, base, head)
        assert rates[-1][0] < rates[0][0]
        stats = model.state_dict()
        moved = float((stats["backbone.stem_bn0.running_mean"]
                       - state["backbone.stem_bn0.running_mean"].cuda()
                       ).abs().max())
        assert moved > 0, "running statistics did not move"
        del grads
        # the same seeds again: the first loss is a forward's; the second
        # follows a backward, whose weight gradients cuDNN sums with
        # atomics, and the third the ill-conditioned gradient of that
        again, _, _, _ = deeplab_train_run(torch, model, state, images,
                                           masks, dtype, steps=3)
        same = [a == b for a, b in zip(again, losses)]
        assert same[0], f"{name}: first-step loss differs between two runs"
        drift = [abs(a - b) / abs(b) for a, b in zip(again, losses)]
        assert drift[1] <= 1e-2, (name, drift)
        runs[name] = dict(losses=losses, ms=step_ms, peak=peak,
                          repeat_equal=same, repeat_drift=drift)
        log(f"deeplab train {name}: {DL_STEPS} steps on one batch of "
            f"{DL_BATCH} at {DL_CROP}^2, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, {step_ms:.3f} ms per step (steps "
            f"{DL_WARMUP + 1}-{DL_STEPS}, CUDA events), peak memory "
            f"{peak / 2 ** 30:.2f} GiB, rates {rates[0][0]:.6f} / "
            f"{rates[0][1]:.6f} -> {rates[-1][0]:.6f} / {rates[-1][1]:.6f} "
            f"on the poly curve; a second run's first 3 losses bit-equal: "
            f"{same}, relative differences "
            f"{[float(f'{d:.2g}') for d in drift]} (cuDNN sums the weight "
            f"gradients with atomics)")

    prof = {name: deeplab_profile(torch, model, state, images, masks, dtype)
            for name, dtype in (("f32", torch.float32),
                                ("bf16", torch.bfloat16))}
    graph = deeplab_graph_vs_eager(torch, model, state, images, masks, prof,
                                   smi)

    # the batch norm written out (the decoder's form) beside the fused one
    fused = resnet.batch_norm
    resnet.batch_norm = lambda x, bn, train, group=None: (
        batch_norm_train(x, bn, group) if train else fused(x, bn, False))
    plain = {}
    try:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            losses, step_ms, peak, _ = deeplab_train_run(
                torch, model, state, images, masks, dtype, steps=5)
            assert abs(losses[0] - runs[name]["losses"][0]) <= \
                (1e-4 if name == "f32" else 2e-2) * runs[name]["losses"][0]
            plain[name] = dict(ms=step_ms, peak=peak)
    finally:
        resnet.batch_norm = fused
        torch.backends.cudnn.allow_tf32 = False
    log(f"deeplab train with the batch norm written out "
        f"(ops/norm.py::batch_norm_train) instead of F.batch_norm: "
        f"{plain['f32']['ms']:.3f} ms per step and "
        f"{plain['f32']['peak'] / 2 ** 30:.2f} GiB in f32, "
        f"{plain['bf16']['ms']:.3f} ms and "
        f"{plain['bf16']['peak'] / 2 ** 30:.2f} GiB in bf16")
    return dict(
        config=f"DeepLabV3+ resnet50_v1s dilated, {DL_CLASSES} classes, aux "
               f"{DL_AUX_WEIGHT}, crop {DL_CROP}, batch {DL_BATCH}, SGD "
               f"{DL_MOMENTUM}, poly from {DL_LR}, wd {DL_WD}, head x10",
        params=n_params, init_s=init_s, eval_ms=ms,
        bf16_vs_f32=dict(mean=mean_diff, max=max_diff, argmax_flips=flips,
                         f32_mean_abs=scale, bound=DL_BF16_MEAN),
        tf32_vs_f32_mean=tf_diff, train=runs, train_profile=prof,
        train_graph=graph, train_plain_bn=plain, card=smi)


def deeplab_loaded_weights(torch):
    """A dotted-name DeepLabV3+ file and a legacy-name gluoncv backbone
    file in mxnet's format, fabricated from a seeded model: every tensor
    loads bit-identically and the eval forward equals the source's."""
    from gan_segmentation_tpu_torch.core.backbone_convert import \
        load_backbone_state_dict
    from gan_segmentation_tpu_torch.core.deeplab_convert import \
        load_deeplab_state_dict
    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus

    src = DeepLabV3Plus(DL_CLASSES, generator=torch.Generator().manual_seed(
        51))
    perturb(torch, src, 52)
    state = src.state_dict()
    images, _ = deeplab_batch(torch, 2, 96, seed=53)
    x = (images.float() / 255.0 - 0.45) / 0.225
    src.cuda().eval()
    with torch.no_grad():
        want = src(x)
    out = {}
    with tempfile.TemporaryDirectory() as base:
        path = join(base, "last_checkpoint.params")
        write_mx_file(path, deeplab_mx_arrays(state))
        t0 = time.perf_counter()
        loaded = DeepLabV3Plus(DL_CLASSES, generator=torch.Generator(
            ).manual_seed(54))
        loaded.load_state_dict(load_deeplab_state_dict(path))
        out["deeplab_s"] = time.perf_counter() - t0
        out["deeplab_mib"] = os.path.getsize(path) / 2 ** 20
        got_state = loaded.state_dict()
        assert got_state.keys() == state.keys()
        for k, v in state.items():
            assert torch.equal(got_state[k], v.cpu()), k
        loaded.cuda().eval()
        with torch.no_grad():
            got = loaded(x)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            "the loaded DeepLabV3+ gives another forward"

        bb_path = join(base, "resnet50_v1s.params")
        bb_state = {k[len("backbone."):]: v for k, v in state.items()
                    if k.startswith("backbone.")}
        write_mx_file(bb_path, backbone_mx_arrays(bb_state))
        fresh = DeepLabV3Plus(DL_CLASSES, generator=torch.Generator(
            ).manual_seed(55))
        before = fresh.backbone.layer4_block2.conv2.weight.clone()
        fresh.backbone.load_state_dict(load_backbone_state_dict(bb_path))
        out["backbone_mib"] = os.path.getsize(bb_path) / 2 ** 20
        assert not torch.equal(before,
                               fresh.backbone.layer4_block2.conv2.weight)
        for k, v in bb_state.items():
            assert torch.equal(fresh.backbone.state_dict()[k], v.cpu()), k
        fresh.cuda().eval()
        with torch.no_grad():
            taps, want_taps = fresh.backbone(x), src.backbone(x)
        assert all(torch.equal(g, w) for g, w in zip(taps, want_taps)), \
            "the loaded backbone gives other taps"
    log(f"deeplab loaded weights: last_checkpoint.params "
        f"{out['deeplab_mib']:.1f} MiB (mxnet format, dotted names, "
        f"{len(state)} tensors) loads bit-identically in "
        f"{out['deeplab_s']:.2f} s (model build included) and gives the "
        f"source's eval forward; resnet50_v1s.params "
        f"{out['backbone_mib']:.1f} MiB (legacy gluoncv names) loads the "
        f"backbone bit-identically, taps equal")
    return out


def phase_deeplab(torch, smi):
    deeplab_small_reference(torch)
    rec = deeplab_full_width(torch, smi)
    rec["loaded_weights"] = deeplab_loaded_weights(torch)
    torch.cuda.empty_cache()
    return rec


# Phase 9: the experiment 01_hair_deeplabv3_ffhq_pretrain_gan at its own
# widths (crop 480, base 512, scale factor 0.5, rotate 15, DeepLabV3+ on
# resnet50), cut to 2 epochs of 128 draws from 32 generated pairs.
# ``tests/test_torch_experiment_cli.py`` rehearses the phase on the CPU with
# a smaller ``STEP5``.
STEP5 = dict(exp="01_hair_deeplabv3_ffhq_pretrain_gan", gan="ffhq",
             res_log2=None, gen_batch=BATCH, n_train=32, n_val=8, batch=8,
             epochs=2, epoch_len=128, workers=4, feed_workers=7,
             test_batch=2,
             preempt_after=3, feed_draws=128, feed_reps=2, bare_steps=5,
             overrides=[],
             eval_check=dict(crop=32, base=48, scales=(0.75, 1.0),
                             hw=(40, 56), images=2))


class StepProbe:
    """Stands in for ``SegmentationTrainer.step`` while a run is driven: the
    host clock at each call, the rates before it (the scheduler's host
    floats: reading a graphed step's rate tensors would wait for the card)
    and a copy of its loss (a replay's loss tensor is the graph's, which the
    next replay overwrites); after ``stop_after`` steps it sends SIGTERM to
    this process, the signal a preemption notice brings."""

    def __init__(self, dt, stop_after=None):
        self.cls, self.step = dt.SegmentationTrainer, \
            dt.SegmentationTrainer.step
        self.stop_after = stop_after
        self.starts, self.rates, self.losses = [], [], []

    def __enter__(self):
        probe = self

        def step(trainer, *args, **kwargs):
            return probe(trainer, *args, **kwargs)

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.step

    def __call__(self, trainer, *args, **kwargs):
        import signal
        self.starts.append(time.perf_counter())
        self.rates.append(list(trainer.scheduler.get_last_lr()))
        out = self.step(trainer, *args, **kwargs)
        self.losses.append(out[0].clone())
        if len(self.starts) == self.stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out


def write_step5_dataset(torch, base, conf):
    """``run_generate`` (cv2 writer) with phase 4's seeded random generator
    and seeded decoder writes ``n_train`` pairs to dataset/train_generated;
    the same pipeline with generator seed 1 writes ``n_val`` to
    dataset/val.  -> (dataset dir, seconds)."""
    from gan_segmentation_tpu_torch.apps.main import (_write_pairs_cv2,
                                                      run_generate)
    from gan_segmentation_tpu_torch.core.config import AppConfig
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    t0 = time.perf_counter()
    cfg = AppConfig(BASE_DIR=base, GAN=conf["gan"],
                    GAN_DIR=join(base, "no-models"),
                    GAN_BATCH_SIZE_PER_GPU=conf["gen_batch"],
                    GENERATE_NUM=conf["n_train"],
                    MAX_RES_LOG2=conf["res_log2"])
    ckpt = join(base, "checkpoints")
    SegSolver(cfg.max_res_log2, "", ckpt, cfg=cfg.solver_config()).save()
    run_generate(cfg, writer="cv2")
    solver = SegSolver(cfg.max_res_log2, "", ckpt, cfg=cfg.solver_config())
    val = join(base, "dataset", "val")
    os.makedirs(val)
    _write_pairs_cv2(FusedPipeline(ImageGenerator(
        gan=conf["gan"], gan_dir=cfg.GAN_DIR, batch_size=conf["gen_batch"],
        max_res_log2=cfg.max_res_log2, seed=1), solver), conf["n_val"], val,
        0, None)
    return join(base, "dataset"), time.perf_counter() - t0


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# the feeds that phase 9 compares: one decode thread (``batch_iter``'s
# thread path), ``workers`` and ``feed_workers`` decode processes
def step5_feeds(conf):
    return {"thread": 1, "processes": conf["workers"],
            "more_processes": conf["feed_workers"]}


def step5_feed(dt, feedset, conf, workers):
    """``batch_iter`` alone over ``feedset`` with ``workers`` decoders (one
    thread, or processes), no model: -> (ms per batch after the first, the
    seconds to the first batch, the last batch)."""
    n, first = 0, None
    t0 = time.perf_counter()
    for batch in dt.batch_iter(feedset, conf["batch"], True, 0,
                               decode_workers=workers):
        if first is None:
            first = time.perf_counter()
        n += 1
    ms = (time.perf_counter() - first) * 1e3 / max(n - 1, 1)
    return ms, first - t0, batch


def step5_feed_and_bare_step(torch, trainer, args, spec, conf):
    """The feed alone (``batch_iter`` over the train set, no model), with
    each of ``step5_feeds`` in turn, ``feed_reps`` times: ms per batch after
    the first and the start-up; the bare step on one resident batch, wall ms
    per step
    as replays of the trainer's graph (``SegmentationTrainer.step``'s
    graphed step, without the staging) and as eager ``train_step``s with
    the same optimizer."""
    import dataclasses

    from gan_segmentation_tpu_torch.train import deeplab_trainer as dt
    from gan_segmentation_tpu_torch.train.rgb_experiments import datasets

    feedset, _ = datasets(args, dataclasses.replace(
        spec, train_epoch_len=conf["feed_draws"]))
    feed = {kind: dict(ms=[], start_s=[], workers=workers)
            for kind, workers in step5_feeds(conf).items()}
    for _ in range(conf["feed_reps"]):
        for kind, rec in feed.items():
            ms, start_s, (imgs, masks, _) = step5_feed(dt, feedset, conf,
                                                       rec["workers"])
            rec["ms"].append(ms)
            rec["start_s"].append(start_s)
    images, _ = trainer._inputs(imgs)
    labels = trainer._upload(trainer._feed(masks, feedset.num_class))
    kw = dict(aux_weight=trainer.aux_weight, dtype=trainer.compute_dtype)
    bare = {}
    runs = [("eager", lambda: dt.train_step(
        trainer.model, trainer.optimizer, trainer.scheduler, images, labels,
        trainer.generator, **kw))]
    if trainer.graphed:
        runs.insert(0, ("graph", lambda: trainer._train_graph(images,
                                                              labels)))
    for name, step in runs:
        step()
        _sync(torch, trainer.device)
        t0 = time.perf_counter()
        for _ in range(conf["bare_steps"]):
            step()
        _sync(torch, trainer.device)
        bare[name] = (time.perf_counter() - t0) * 1e3 / conf["bare_steps"]
    return feed, bare


# the timed epochs of ``step5_loop``: its feed (the run's ``workers``
# processes) and one decode thread, each twice, in this order
LOOP_FEEDS = ("processes", "thread", "thread", "processes")


def step5_loop(torch, trainer, dt, conf, smi):
    """More epochs of the trainer (the feed, the steps, the loss pulls; not
    the epoch's checkpoint, whose 167 MB pull to the host is no part of a
    step).  One epoch for each of ``LOOP_FEEDS`` is timed: the loop's ms
    per step is the time from its first step's start (the first batch in
    hand: the workers' start-up is not in it) to the end of its last
    step's work, synchronised, over its steps; the steps do not wait for
    the card, so the gaps between their starts are not step times.  A last
    epoch with the run's feed runs under ``torch.profiler`` (on the card
    only): device kernel time per step by family, and the busy share of
    the loop (the mean of its timed epochs with that feed)."""
    per = conf["epoch_len"] // conf["batch"]
    feeds = step5_feeds(conf)
    workers = trainer._decode_workers
    assert workers == feeds["processes"], (workers, feeds)
    loop_ms = {kind: [] for kind in LOOP_FEEDS}
    trainer.save_checkpoint = lambda: None  # shadows the method
    epoch = conf["epochs"]
    try:
        for kind in LOOP_FEEDS:
            trainer._decode_workers = feeds[kind]
            with StepProbe(dt) as probe:
                trainer.training(epoch)
                _sync(torch, trainer.device)
                end = time.perf_counter()
            epoch += 1
            loop_ms[kind].append((end - probe.starts[0]) * 1e3
                                 / len(probe.starts))
        trainer._decode_workers = workers
        rec = dict(loop_ms=loop_ms, steps=len(probe.starts))
        if trainer.device.type != "cuda":
            return rec
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.training(epoch)
            torch.cuda.synchronize()
    finally:
        trainer._decode_workers = workers
        del trainer.save_checkpoint
    by_name, launches, fam = kernel_families(prof, per)
    busy = sum(fam.values())
    mean = sum(loop_ms["processes"]) / len(loop_ms["processes"])
    log(f"step 5 trainer, {len(LOOP_FEEDS) + 1} more epochs of {per} "
        f"steps: loop ms per step (an epoch from its first step's start to "
        f"the end of its last, synchronised), in the order "
        f"{', '.join(LOOP_FEEDS)}: {workers} decode processes "
        f"{[round(v, 3) for v in loop_ms['processes']]}, one decode thread "
        f"{[round(v, 3) for v in loop_ms['thread']]}; the last epoch "
        f"profiled ({workers} processes): device kernel time {busy:.3f} ms "
        f"per step in {launches // per} launches, busy share "
        f"{busy / mean:.3f} of the processes' loop on {smi}")
    for name, t in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {t:.3f} ms/step ({t / busy:.3f} of device time)")
    return dict(rec, busy_ms=busy, busy_share=busy / mean,
                launches=launches // per, families=fam)


def _trainer_state(torch, trainer):
    """Copies of what a resume bundle holds."""
    opt = trainer.optimizer.state_dict()
    return dict(
        model={k: v.detach().clone() for k, v in
               trainer.model.state_dict().items()},
        momentum={k: s["momentum_buffer"].clone()
                  for k, s in opt["state"].items()},
        step=trainer.scheduler.last_epoch,
        lrs=[float(g["lr"]) for g in opt["param_groups"]],
        generator=trainer.generator.get_state().clone())


def check_resume_restores(torch, trainer):
    """The preempted trainer's state, scrambled and then restored by
    ``try_resume`` from its bundle, equals the state it saved, bit for
    bit: weights and statistics, momentum buffers, the scheduler's step
    and rates, the dropout generator."""
    saved = _trainer_state(torch, trainer)
    with torch.no_grad():
        for v in trainer.model.state_dict().values():
            v.zero_()
    for s in trainer.optimizer.state.values():
        s["momentum_buffer"].fill_(1.0)
    trainer.scheduler.last_epoch = 0
    for g in trainer.optimizer.param_groups:
        g["lr"] = -1.0
    trainer.generator.manual_seed(12345)
    pos = trainer.try_resume()
    got = _trainer_state(torch, trainer)
    for k, v in saved["model"].items():
        assert torch.equal(got["model"][k], v), f"resume: {k} differs"
    assert got["momentum"].keys() == saved["momentum"].keys()
    for k, v in saved["momentum"].items():
        assert torch.equal(got["momentum"][k], v), f"resume: momentum {k}"
    assert got["step"] == saved["step"] and got["lrs"] == saved["lrs"]
    assert torch.equal(got["generator"], saved["generator"]), \
        "resume: dropout generator state differs"
    return pos, len(saved["model"]), len(saved["momentum"])


def step5_eval_card_vs_cpu(torch, conf):
    """``MultiEvalModel`` scores of a seeded DeepLabV3+ on a (1, 1, 1, 1)
    backbone on the main device against the same model's on the CPU, in
    f32 with TF32 off: crop 32, base 48, two scales (sliding windows), flip.
    -> (max |difference|, model calls)."""
    import copy

    import numpy as np

    from gan_segmentation_tpu_torch.models import deeplab as tdl
    from gan_segmentation_tpu_torch.train.deeplab_trainer import \
        MultiEvalModel

    ec = conf["eval_check"]
    tdl._BACKBONE_LAYERS["tiny"] = (1, 1, 1, 1)
    try:
        model = tdl.DeepLabV3Plus(2, "tiny", generator=torch.Generator(
            ).manual_seed(61))
    finally:
        del tdl._BACKBONE_LAYERS["tiny"]
    perturb(torch, model, 62)
    rs = np.random.RandomState(63)
    images = [rs.randn(*ec["hw"], 3).astype(np.float32)
              for _ in range(ec["images"])]
    kw = dict(base_size=ec["base"], crop_size=ec["crop"], flip=True,
              scales=ec["scales"])
    want = MultiEvalModel(copy.deepcopy(model).cpu(), 2,
                          **kw).device_scores_batch(images)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ev = MultiEvalModel(model.to(conf["device"]), 2, **kw)
        got = ev.device_scores_batch(images).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == (ec["images"], *ec["hw"], 2), got.shape
    check_close("MultiEvalModel card vs CPU", got, want, **DL_EVAL_TOL)
    return max_err(got, want), ev.calls


def phase_step5(torch, smi, conf=None):
    """Step 5 of the pipeline through the port's experiment runner
    (``train.rgb_experiments.run``): generate a dataset, train two epochs
    with validation and checkpoints, preempt a second run by SIGTERM and
    resume it, test with the batched multi-scale evaluation, and hold the
    evaluator on the card to the CPU."""
    import math
    import signal
    import types

    from gan_segmentation_tpu_torch.train import deeplab_trainer as dt
    from gan_segmentation_tpu_torch.train import rgb_experiments as rx

    conf = dict(STEP5, **(conf or {}))
    device = conf.setdefault("device", "cuda")
    spec = rx.SPECS[conf["exp"]]
    t_phase = time.perf_counter()
    rec = {}
    with tempfile.TemporaryDirectory() as base:
        with LaunchTrace(torch) as trace:
            dataset, rec["dataset_s"] = write_step5_dataset(torch, base,
                                                            conf)
        rec["launches"] = {k: trace.device[k]
                           for k in ("conv_in_stats", "small_conv")}
        log(f"step 5 dataset: {conf['n_train']} pairs from run_generate "
            f"(cv2 writer) in dataset/train_generated and {conf['n_val']} "
            f"from generator seed 1 in dataset/val, {rec['dataset_s']:.2f} "
            f"s (traced), launches {rec['launches']} (the wrappers counted "
            f"{trace.wrapper}); the val split is synthetic too (the "
            f"repository holds no real annotated data)")
        common = ["--input-path", dataset, "--workers",
                  str(conf["workers"]), "--reader", "cv2"] + conf["overrides"]
        train_argv = ["train", "--batch-size", str(conf["batch"]),
                      "--test-batch-size", str(conf["batch"]), "--epochs",
                      str(conf["epochs"]), "--epoch-len",
                      str(conf["epoch_len"])] + common
        steps = conf["epochs"] * (conf["epoch_len"] // conf["batch"])
        sigterm = signal.getsignal(signal.SIGTERM)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
        try:
            # (a) the uninterrupted run
            with LogLines("gan_segmentation_tpu_torch") as lines, \
                    StepProbe(dt) as probe:
                t0 = time.perf_counter()
                trainer = rx.run(spec, train_argv, exp_path=join(base, "a"))
                _sync(torch, device)
                rec["train_run_s"] = time.perf_counter() - t0
            run_a = trainer.args.run_path
            vals = [m for m in lines.lines if " validation " in m]
            saves = [m for m in lines.lines if m.startswith(
                "saved checkpoint last_checkpoint.pt")]
            assert len(vals) == conf["epochs"], vals
            assert len(saves) == conf["epochs"], saves
            assert (run_a / "checkpoints" / "last_checkpoint.pt").is_file()
            assert (run_a / "run.py").is_file()
            assert (run_a / "logs" / "train_log.txt").stat().st_size > 0
            losses = [float(v) for v in torch.stack(probe.losses).cpu()]
            assert len(losses) == steps and all(map(math.isfinite, losses))
            poly = dt.poly_schedule(spec.lr, steps)
            for k, lrs in enumerate(probe.rates):
                want = [poly(k), 10 * poly(k)]
                assert all(abs(a - b) <= 1e-9 * max(b, 1e-30) + 1e-15
                           for a, b in zip(lrs, want)), (k, lrs, want)
            assert trainer.scheduler.last_epoch == steps
            per = conf["epoch_len"] // conf["batch"]
            gaps = [(probe.starts[i + 1] - probe.starts[i]) * 1e3
                    for i in range(steps - 1) if (i + 1) % per]
            rec["start_gaps_ms"] = gaps
            rec["losses"] = losses
            rec["validation"] = vals
            rec["profile"] = step5_loop(torch, trainer, dt, conf, smi)
            rec["loop_ms"] = rec["profile"]["loop_ms"]
            args = types.SimpleNamespace(input_path=dataset, reader="cv2")
            assert trainer.graphed == (torch.device(device).type == "cuda")
            rec["feed"], rec["bare_step_ms"] = step5_feed_and_bare_step(
                torch, trainer, args, rx.apply_overrides(
                    spec, trainer.args), conf)
            del trainer
            log(f"step 5 train: {steps} steps in {conf['epochs']} epochs, "
                f"losses {[round(v, 4) for v in losses]}, rates on the poly "
                f"curve, {len(vals)} validation lines ({vals[-1]}), "
                f"last_checkpoint.pt each epoch; run {rec['train_run_s']:.2f}"
                f" s (model build and checkpoints included) on {smi}")
            feed, bare = rec["feed"], rec["bare_step_ms"]
            log(f"step 5 pace: the trainer's loop, ms per step (timed "
                f"epochs of {rec['profile']['steps']} graphed steps): "
                + ", ".join(f"{step5_feeds(conf)[k]} {k.split('_')[-1]} "
                            f"{[round(v, 3) for v in vs]}"
                            for k, vs in rec['loop_ms'].items())
                + f" (gaps between step starts in the run: "
                f"{[round(g, 1) for g in gaps]}); the feed "
                f"alone (batch_iter, no model), ms per batch of "
                f"{conf['batch']} after the first (seconds to the first), "
                f"{conf['feed_reps']} rounds: "
                + ", ".join(f"{v['workers']} {k.split('_')[-1]} "
                            f"{[round(x, 3) for x in v['ms']]} "
                            f"({[round(x, 2) for x in v['start_s']]} s)"
                            for k, v in feed.items())
                + "; the bare step on a resident batch, wall ms: "
                + ", ".join(f"{k} {v:.3f}" for k, v in bare.items())
                + f" ({conf['bare_steps']} steps) on {smi}")

            # (b) preempted by SIGTERM after preempt_after steps, resumed
            with StepProbe(dt, stop_after=conf["preempt_after"]) as probe:
                trainer = rx.run(spec, train_argv, exp_path=join(base, "b"))
            run_b = trainer.args.run_path
            ck = run_b / "checkpoints"
            assert trainer.preempted and len(probe.starts) == \
                conf["preempt_after"], len(probe.starts)
            assert (ck / dt.RESUME_BUNDLE).is_file()
            assert not list(ck.glob("*.tmp")), list(ck.glob("*.tmp"))
            pos, n_tensors, n_buffers = check_resume_restores(torch, trainer)
            assert pos == (0, conf["preempt_after"]), pos
            del trainer
            with StepProbe(dt) as probe:
                trainer = rx.run(spec, train_argv + ["--resume", str(run_b)],
                                 exp_path=join(base, "b"))
            assert len(probe.starts) == steps - conf["preempt_after"]
            assert trainer.scheduler.last_epoch == steps
            assert not trainer.preempted
            assert not (ck / dt.RESUME_BUNDLE).exists()
            del trainer
            rec["resume"] = dict(position=pos, tensors=n_tensors,
                                 momentum_buffers=n_buffers)
            log(f"step 5 preemption: SIGTERM after step "
                f"{conf['preempt_after']}, resume bundle written (no .tmp "
                f"left), try_resume restored {n_tensors} tensors, "
                f"{n_buffers} momentum buffers, the scheduler's step and the "
                f"dropout generator bit-equal; --resume ran the remaining "
                f"{steps - conf['preempt_after']} steps to step {steps} and "
                f"epoch {conf['epochs'] - 1}, as the uninterrupted run")

            # (c) test: batched multi-scale + flip evaluation of run a
            test_argv = ["test", str(run_a), "--test-batch-size",
                         str(conf["test_batch"])] + common
            t0 = time.perf_counter()
            tester = rx.run(spec, test_argv, exp_path=join(base, "a"))
            rec["test_run_s"] = time.perf_counter() - t0
            assert tester.args.weights.endswith("last_checkpoint.pt")
            testset = rx.FFHQHairSegmentation(
                dataset, scale_factor=rx.apply_overrides(
                    spec, tester.args).scale_factor, split="val")
            first = tester.bucket_calls
            _sync(torch, device)
            t0 = time.perf_counter()
            result = tester.test(testset)
            _sync(torch, device)
            rec["test_ips"] = len(testset) / (time.perf_counter() - t0)
            assert tester.bucket_calls == first, (tester.bucket_calls, first)
            names, values = tester.metric.get()
            assert all(0.0 <= v <= 1.0 for v in result.values()), result
            assert all(math.isfinite(v) for v in values), values
            rec["metric"] = dict(zip(names, values))
            rec["metric_orig"] = result
            rec["bucket_calls"] = first
            ev = tester.evaluator
            h, w = testset[0][0].shape[:2]
            height, width, _ = ev._scaled_size(h, w, ev.scales[0])
            n_win = len(ev._window_positions(max(height, ev.crop_size),
                                             max(width, ev.crop_size)))
            del tester
            log(f"step 5 test: {len(testset)} images of {h}x{w}, "
                f"{n_win} windows x 2 flips each at test batch "
                f"{conf['test_batch']}: model calls per bucket {first} "
                f"({conf['test_batch'] * n_win * 2} windows a call); "
                f"{rec['test_ips']:.3f} images/s (warm; the run with its "
                f"model build {rec['test_run_s']:.2f} s); new metric "
                f"{ {k: round(v, 5) for k, v in rec['metric'].items()} }, "
                f"original {result} on {smi}")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
            signal.signal(signal.SIGTERM, sigterm)

    # (d) the evaluator on the card against the CPU
    rec["eval_card_vs_cpu_err"], calls = step5_eval_card_vs_cpu(torch, conf)
    log(f"step 5 MultiEvalModel card vs CPU (tiny backbone, crop 32, base "
        f"48, scales (0.75, 1.0), flip, f32 TF32 off): max |err| "
        f"{rec['eval_card_vs_cpu_err']:.3g} ({calls} model call)")
    rec["phase_s"] = time.perf_counter() - t_phase
    import importlib.util
    rec["optional"] = {m: importlib.util.find_spec(m) is not None
                       for m in ("tensorboardX", "sklearn")}
    log(f"step 5 phase: {rec['phase_s']:.1f} s on {smi}; optional packages "
        f"on this machine: {rec['optional']}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


# Phase 10: the closed-loop demo at bedrooms' own 256^2 (all 8 levels), its
# defaults otherwise: 12 annotations, decoder 10 epochs, 96 + 12 generated
# pairs, DeepLabV3+ resnet50 at crop 256, 2 epochs of 64 draws
DEMO_ARGS = ["--max-res-log2", "8"]


def phase_demo(torch, smi):
    """``examples/full_pipeline_demo.py`` on the card under a device trace:
    fixture annotations from the bedrooms generator (kernels 1 and 2), the
    decoder's graphed fit (kernels 2 and 3) and evaluation (kernel 2, mean
    IoU above 0.5), the fused generate (kernels 1 and 2), DeepLabV3+ through
    its graphed train step and validation.  The trace's counts of kernels
    1-3 equal the wrappers' counts plus the replays (``LaunchTrace``), and
    each kernel ran."""
    import gc

    from gan_segmentation_tpu_torch.examples import full_pipeline_demo

    t0 = time.perf_counter()
    work = tempfile.mkdtemp()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        with LaunchTrace(torch) as trace:
            out = full_pipeline_demo.main(["--workdir", work] + DEMO_ARGS)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(work, ignore_errors=True)
    for k, n in trace.device.items():
        assert n > 0, f"demo: {k} was not launched"
    dl = out["deeplab"]
    assert dl["graphed"], "the demo's DeepLab steps did not run as graphs"
    assert all(0.0 <= dl[k] <= 1.0 for k in ("accuracy", "mean-iou")), dl
    out.update(launches=trace.device, wrapper_launches=trace.wrapper,
               phase_s=time.perf_counter() - t0)
    log(f"demo (full_pipeline_demo {' '.join(DEMO_ARGS)}): stage seconds "
        f"{ {k: round(v, 2) for k, v in out['seconds'].items()} }, decoder "
        f"accuracy {out['decoder']['accuracy']:.4f} mean-iou "
        f"{out['decoder']['mean-iou']:.4f}, {out['pairs']} pairs, DeepLab "
        f"validation pixAcc {dl['accuracy']:.4f} mIoU {dl['mean-iou']:.4f} "
        f"(graphed steps); launches in the device trace {trace.device} "
        f"(the wrappers counted {trace.wrapper}, the rest are replays); "
        f"phase {out['phase_s']:.1f} s on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 11
SO_SAMPLES = 4           # ffhq 1024^2 samples of the scale-out fits
SO_EPOCHS = 2
SO_WORLD = 2             # processes sharing the one card over gloo
SO_TRAIN, SO_VAL = 16, 5  # the runner's synthetic 512^2 pairs (ragged val)
SO_GEN_PER_RANK = 16
SO_SPEC = "01_hair_deeplabv3_ffhq_pretrain_gan"
SO_TIMEOUT = 480         # seconds for the processes of (b)
SO_FIT_RTOL = 1e-4       # the CPU tests' bound on a fit's per-step losses
# the fits' optimizer, the CPU tests' SGD: a uniform scale on the gradients
# (a sum where a mean belongs) shows in the weights, where Adam cancels it
SO_FIT_OPT = dict(optimizer="sgd", momentum=0.9)
SO_PARAM_TOL = 1e-5      # the CPU tests' rtol and atol on a fit's weights
SO_CHANGE_REL = 1e-2     # the parameters' change over a fit, as one vector,
#                          rel. L2 (the ROADMAP's eval-mode bound)
SO_BN_REL = 1e-4         # fused against written-out global BN, rel. L2


@contextlib.contextmanager
def world_of_one(torch):
    """This process alone in an NCCL group on card 0, the group yielded to
    be passed explicitly (the port makes none at world 1 by itself)."""
    import torch.distributed as dist

    from gan_segmentation_tpu_torch.core.distributed import free_port
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def global_bn_card_vs_written(torch, grp):
    """``FusedGlobalBatchNorm`` (torch's fused primitives) against
    ``GlobalBatchNorm`` (the formula written out) on the card, f32, at the
    DeepLab step's first bottleneck shape (8 x 120 x 120 x 256): output,
    statistics and the three gradients of sum(y * dy) (relative L2), and
    ms per forward + backward of each."""
    from gan_segmentation_tpu_torch.ops.norm import (FusedGlobalBatchNorm,
                                                     GlobalBatchNorm)
    g = torch.Generator(device="cuda").manual_seed(51)
    shape = (DL_BATCH, DL_CROP // 4, DL_CROP // 4, 256)
    x = torch.randn(shape, device="cuda", generator=g) * 2 + 0.5
    dy = torch.randn(shape, device="cuda", generator=g)
    w = (1 + 0.3 * torch.randn(256, device="cuda", generator=g)
         ).requires_grad_()
    b = (0.2 * torch.randn(256, device="cuda", generator=g)).requires_grad_()
    outs, ms = {}, {}
    for name, fn in (("fused", FusedGlobalBatchNorm),
                     ("written", GlobalBatchNorm)):
        def run():
            xs = x.detach().requires_grad_()
            w.grad = b.grad = None
            y, mean, var = fn.apply(xs, w, b, 1e-5, grp)
            y.backward(dy)
            return [y.detach(), mean, var, xs.grad, w.grad, b.grad]
        outs[name] = run()
        ms[name] = cuda_ms(run, 5)
    names = ("y", "mean", "var", "dx", "dw", "db")
    rel = {n: rel_l2(a, c) for n, a, c in zip(names, outs["fused"],
                                               outs["written"])}
    check_later(max(rel.values()) <= SO_BN_REL,
                f"global BN: the fused version differs from the written-out "
                f"one on the card: {rel} (bound {SO_BN_REL})")
    return dict(rel_l2=rel, bound=SO_BN_REL, ms=ms, shape=list(shape))


def scale_out_deeplab(torch, grp, smi):
    """Phase 11 (a), DeepLab: the experiment's step (DeepLabV3+ resnet50,
    crop 480, batch 8, f32 with TF32 convs) with batch norm over ``grp``
    and the gradient all-reduce captured in the step's graph:
    ``DL_GRAPH_STEPS`` graphed steps against as many eager steps in cuDNN's
    deterministic mode, then ms per step as replays with and without the
    group, and the fused global BN against the written-out one."""
    import gc
    from unittest import mock

    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
    from gan_segmentation_tpu_torch.models.resnet import set_process_group
    from gan_segmentation_tpu_torch.ops import norm

    images, masks = deeplab_batch(torch)
    model = DeepLabV3Plus(DL_CLASSES, "resnet50", aux=True, crop_size=DL_CROP,
                          generator=torch.Generator().manual_seed(41))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.cuda()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        set_process_group(model, grp)
        with cudnn_deterministic(torch):
            eager = deeplab_graph_twin(torch, model, state, images, masks,
                                       torch.float32, graphed=False,
                                       group=grp)
            graphed = deeplab_graph_twin(torch, model, state, images, masks,
                                         torch.float32, graphed=True,
                                         group=grp)
        differ = [k for k in eager[1]
                  if not torch.equal(eager[1][k], graphed[1][k])]
        same = dict(losses=bool(torch.equal(eager[0], graphed[0])),
                    tensors_differ=len(differ),
                    generator=bool(torch.equal(eager[2], graphed[2])))
        check_later(same["losses"] and not differ and same["generator"],
                    f"scale-out deeplab: {DL_GRAPH_STEPS} graphed steps with "
                    f"the captured all-reduce differ from the eager steps: "
                    f"{same}, first tensors {differ[:3]}")
        with_group = deeplab_graph_profile(torch, model, state, images,
                                           masks, torch.float32, group=grp)
        with mock.patch.object(norm, "FusedGlobalBatchNorm",
                               norm.GlobalBatchNorm):
            written = deeplab_graph_profile(torch, model, state, images,
                                            masks, torch.float32, group=grp)
        set_process_group(model, None)
        without = deeplab_graph_profile(torch, model, state, images, masks,
                                        torch.float32)
        bn = global_bn_card_vs_written(torch, grp)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        set_process_group(model, None)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"scale-out (a) deeplab crop {DL_CROP} batch {DL_BATCH}, f32 with "
        f"TF32 convs, world of one over NCCL: {DL_GRAPH_STEPS} graphed steps "
        f"(global BN, the all-reduce captured) against eager: {same}; ms "
        f"per step as replays with the group {with_group['ms']:.3f} (its "
        f"batch norm written out {written['ms']:.3f}), without "
        f"{without['ms']:.3f}; launches per step "
        f"{with_group['launches']} ({without['launches']} without), NCCL "
        f"kernels among them {with_group['nccl_launches']:.2f}; fused "
        f"global BN against the written-out one: rel. L2 "
        f"{max(bn['rel_l2'].values()):.2e}, ms {bn['ms']['fused']:.3f} "
        f"against {bn['ms']['written']:.3f} on {smi}")
    keep = ("ms", "host_enqueue_ms", "busy_ms", "busy_share", "launches",
            "nccl_launches", "pool_gib", "replays")
    return dict(bit_equal=same, losses=graphed[0].tolist(),
                with_group={k: with_group[k] for k in keep},
                with_group_bn_written={k: written[k] for k in keep},
                without_group={k: without[k] for k in keep}, global_bn=bn)


def scale_out_cfg(**kw):
    import dataclasses

    from gan_segmentation_tpu_torch.core.config import SolverConfig
    return dataclasses.replace(SolverConfig(max_res_log2=10),
                               train_epochs=SO_EPOCHS, **{**SO_FIT_OPT, **kw})


def scale_out_fit(torch, base, tag, group=None, **kw):
    """A ``SO_EPOCHS``-epoch fit from the seeded init on ``base``/data ->
    (per-step losses, weights, wall seconds, whether it ran as graph
    replays, the initial weights)."""
    from gan_segmentation_tpu_torch.train.solver import SegSolver
    solver = SegSolver(10, join(base, "data"), join(base, f"ckpt-{tag}"),
                       cfg=scale_out_cfg(**kw), group=group)
    init = {k: v.clone() for k, v in solver.model.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = ([x for e in solver.history for x in e],
           {k: v.clone() for k, v in solver.model.state_dict().items()},
           wall, solver._scan_epochs(object()), init)
    del solver
    torch.cuda.empty_cache()
    return out


def losses_close(got, want, rtol=SO_FIT_RTOL):
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    return (got.shape == want.shape and bool(np.all(
        np.abs(got - want) <= rtol * np.abs(want)))), float(
        np.max(np.abs(got - want) / np.abs(want))) if len(want) else 0.0


def weights_close(got, want, init):
    """A fit's final weights against another's from the same ``init``
    (``state_dict``s): -> (whether every float tensor is within
    ``SO_PARAM_TOL``, rtol and atol, and the parameters' change from
    ``init`` within ``SO_CHANGE_REL``, rel. L2 as one vector; the tensor
    farthest apart and its largest difference; that rel. L2; the change's
    L2 over the parameters')."""
    import torch
    keys = [k for k in want if want[k].is_floating_point()]
    g, w, i = ({k: d[k].detach().double().cpu() for k in keys}
               for d in (got, want, init))
    close = all(torch.allclose(g[k], w[k], rtol=SO_PARAM_TOL,
                               atol=SO_PARAM_TOL) for k in keys)
    diffs = {k: float((g[k] - w[k]).abs().max()) for k in keys}
    worst = max(diffs, key=diffs.get)
    params = [k for k in keys  # not the running statistics
              if not k.endswith(("running_mean", "running_var"))]
    dg = torch.cat([(g[k] - i[k]).flatten() for k in params])
    dw = torch.cat([(w[k] - i[k]).flatten() for k in params])
    change = rel_l2(dg, dw)
    size = float(dw.norm() / torch.cat(
        [i[k].flatten() for k in params]).norm())
    return (close and change <= SO_CHANGE_REL, (worst, diffs[worst]),
            change, size)


def scale_out_decoder(torch, grp, base, smi):
    """Phase 11 (a), decoder: the fit at ffhq 1024^2, f32, graphed (the
    collection resident), with batch norm and the gradient all-reduce over
    ``grp``, under a device trace (kernels 2 and 3, NCCL), against the same
    fit without the group, in cuDNN's deterministic mode."""
    with cudnn_deterministic(torch), tf32(torch, False):
        plain = scale_out_fit(torch, base, "plain")
        with LaunchTrace(torch) as trace:
            grouped = scale_out_fit(torch, base, "group", group=grp)
    nccl = sum("nccl" in n.lower() for n in device_kernel_names(trace.prof))
    ok, dist = losses_close(grouped[0], plain[0])
    w_ok, worst, change, size = weights_close(grouped[1], plain[1], plain[4])
    check_later(ok and w_ok,
                f"scale-out decoder fit with the group: per-step losses "
                f"{grouped[0]} against {plain[0]} without; weights: "
                f"farthest {worst}, parameters' change rel. L2 {change:.3g}")
    check_later(grouped[3] and trace.device["bil_conv"] > 0
                and trace.device["small_conv"] > 0,
                f"scale-out decoder fit: not graphed or kernels 2 and 3 "
                f"missing from the trace: {trace.device}")
    steps = len(grouped[0])
    log(f"scale-out (a) decoder fit ffhq 1024^2, {SO_SAMPLES} samples x "
        f"{SO_EPOCHS} epochs, SGD, graphed, world of one over NCCL: "
        f"per-step losses within {dist:.2e} relative of the fit without the "
        f"group (bound {SO_FIT_RTOL}); weights: farthest {worst[0]} by "
        f"{worst[1]:.3g} (bound {SO_PARAM_TOL} rtol and atol), the "
        f"parameters' change within {change:.3g} rel. L2 (bound "
        f"{SO_CHANGE_REL}; the change is {size:.3g} of the parameters); "
        f"{grouped[2]:.2f} s against "
        f"{plain[2]:.2f} s; device trace {trace.device}, NCCL kernels "
        f"{nccl} over {steps} steps on {smi}")
    return dict(steps=steps, loss_rel_dist=dist, weights_worst=worst,
                change_rel_l2=change, change_size=size, seconds=grouped[2],
                seconds_without_group=plain[2], launches=trace.device,
                nccl_launches=nccl, losses=grouped[0])


SO_DP_BATCHES = 3        # the eager first batch, the capture's, a replay


def scale_out_dp_pipeline(torch, smi):
    """``FusedPipeline(mesh=[cuda:0, cuda:0])``, the machinery of
    ``generate --dp 2`` on the one card (two replicas, each its graph, half
    the batch each), at ffhq 1024^2, batch 8, bf16, under a device trace:
    its batches against the one-device pipeline's from the same seed.
    Equal bit for bit only if every kernel computes a sample of a batch of
    4 as it does in a batch of 8, so the differences are recorded; held bit
    for bit instead to the one-device program run eagerly on each half of
    the same z and noise (what each replica was given)."""
    import numpy as np

    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator,
                                                            _infer)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    none = tempfile.mkdtemp()
    try:
        solver = SegSolver(10, "", join(none, "no-checkpoints"))

        def pipeline(mesh=None):
            return FusedPipeline(ImageGenerator(
                gan="ffhq", gan_dir=none, batch_size=BATCH, seed=3),
                solver, mesh=mesh)

        with tf32(torch, False):
            one = pipeline()
            want = [[t.cpu() for t in one.sample_batch()]
                    for _ in range(SO_DP_BATCHES)]
            halves, draw = [], ImageGenerator(gan="ffhq", gan_dir=none,
                                              batch_size=BATCH, seed=3)
            for _ in range(SO_DP_BATCHES):
                z, noise = draw.draw_inputs(BATCH)
                parts = [_infer(one.program(), z[h].clone(), noise={
                    k: v[h].clone() for k, v in noise.items()})
                    for h in (slice(0, BATCH // 2), slice(BATCH // 2, None))]
                halves.append([torch.cat([p[i] for p in parts]).cpu()
                               for i in (0, 1)])
            del one, draw
            two = pipeline(["cuda:0", "cuda:0"])
            with LaunchTrace(torch) as trace:
                got = [[t.cpu() for t in two.sample_batch()]
                       for _ in range(SO_DP_BATCHES)]
        replays = [c.replays for c, _, _ in two._parts.values()]
        del two, solver
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(none, ignore_errors=True)
    equal = all(torch.equal(g, w) for gb, wb in zip(got, want)
                for g, w in zip(gb, wb))
    halves_equal = all(torch.equal(g, w) for gb, wb in zip(got, halves)
                       for g, w in zip(gb, wb))
    img_diff = max(int((g[0].int() - w[0].int()).abs().max())
                   for g, w in zip(got, want))
    bits = [np.unpackbits((g[1] ^ w[1]).numpy()) for g, w in zip(got, want)]
    bit_share = float(sum(int(b.sum()) for b in bits)) / sum(
        b.size for b in bits)
    check_later(halves_equal and trace.device["conv_in_stats"] > 0
                and trace.device["small_conv"] > 0
                and replays == [SO_DP_BATCHES - 1] * 2,
                f"generate --dp 2 on one card: halves equal {halves_equal}, "
                f"launches {trace.device}, replays {replays}")
    log(f"scale-out (a) generate split over two replicas on the one card "
        f"(--dp 2's machinery), ffhq 1024^2, batch 8 = 4 + 4, bf16: "
        f"{SO_DP_BATCHES} batches bit-equal to one device {equal} (largest "
        f"image difference {img_diff}, mask bits differing "
        f"{bit_share:.2e}), to the one-device program on each half of the "
        f"same inputs {halves_equal}; device trace {trace.device}, replays "
        f"{replays} on {smi}")
    return dict(bit_equal_to_one_device=equal,
                bit_equal_to_one_device_by_halves=halves_equal,
                max_image_diff=img_diff,
                mask_bits_differing=bit_share, launches=trace.device,
                replays=replays)


def nccl_pair_rank(index, port, out):
    """One of two processes that ask NCCL for a group on the one card."""
    import torch
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=index,
            world_size=2, device_id=torch.device("cuda", 0))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = f"all_reduce gave {t.item()}"
    except Exception as exc:  # the refusal is the expected outcome
        result = f"{type(exc).__name__}: {exc}"
    with open(join(out, f"nccl_{index}.txt"), "w") as fh:
        fh.write(result)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def run_processes(target, args, n, timeout):
    """``target(index, *args)`` in ``n`` spawned processes; -> whether all
    ended within ``timeout`` seconds (those that did not are killed).  A
    process that raises fails here."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(target, args=args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                return False
        return True
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def scale_out_dataset(torch, root):
    """``SO_TRAIN`` + ``SO_VAL`` synthetic 512^2 pairs (the blocky colour
    field of ``deeplab_batch``, ignore written as 255) in the layout
    ``generate`` writes."""
    import cv2
    import numpy as np
    images, masks = deeplab_batch(torch, batch=SO_TRAIN + SO_VAL, size=512,
                                  seed=61, device="cpu")
    for split, first, n in (("train_generated", 0, SO_TRAIN),
                            ("val", SO_TRAIN, SO_VAL)):
        d = join(root, split)
        os.makedirs(d)
        for j in range(n):
            m = masks[first + j].numpy().astype(np.int16)
            m[m < 0] = 255
            cv2.imwrite(join(d, f"img_{j:06d}.jpg"),
                        images[first + j].numpy()[:, :, ::-1])
            cv2.imwrite(join(d, f"mask_{j:06d}.png"), m.astype(np.uint8))


def scale_out_runner_argv(base):
    return ["train", "--input-path", join(base, "rgb"), "--crop-size", "480",
            "--base-size", "512", "--scale-factor", "1.0", "--epochs", "1",
            "--epoch-len", str(SO_TRAIN), "--batch-size", "8",
            "--test-batch-size", "8", "--workers", "1", "--no-preempt-save"]


def scale_out_app_config(base, world=SO_WORLD):
    from gan_segmentation_tpu_torch.core.config import AppConfig
    return AppConfig(BASE_DIR=join(base, "gen"), GAN="ffhq",
                     GAN_DIR=join(base, "no-models"),
                     GAN_BATCH_SIZE_PER_GPU=BATCH,
                     GENERATE_NUM=world * SO_GEN_PER_RANK)


@contextlib.contextmanager
def tf32(torch, convs, matmul=False):
    """cuDNN's and cuBLAS's TF32 switches for a span, restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = convs
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def scale_out_rank(base, out):
    """One of the ``SO_WORLD`` processes of phase 11 (b) on the one card,
    joined over gloo (started by the runner's ``_spawned``, which sets the
    launcher's environment): the decoder fit at global batch 2, the
    experiment runner's training and validation, and ``generate``; each
    with the kernel wrappers' counts set to 0 before it; -> a JSON file."""
    import torch

    from gan_segmentation_tpu_torch.apps import main as app
    from gan_segmentation_tpu_torch.core import distributed as dist_
    from gan_segmentation_tpu_torch.train import rgb_experiments as rx
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    assert dist_.initialize(cuda=True, backend="gloo")
    rank = dist_.process_index()
    fns = kernel_wrappers()

    def zero():
        for fn in fns.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in fns.items()}

    res = {"rank": rank, "device": torch.cuda.current_device()}
    zero()
    solver = SegSolver(10, join(base, "data"), join(out, f"fit-{rank}"),
                       cfg=scale_out_cfg(train_batch_size=SO_WORLD,
                                         use_dropout=False))
    with tf32(torch, False):  # as the one-process fit it is held to
        solver.fit()
    res["fit"] = dict(losses=[x for e in solver.history for x in e],
                      launches=counts(), cached=solver.cache_active,
                      graphed=solver._scan_epochs(object()))
    torch.save({k: v.cpu() for k, v in solver.model.state_dict().items()},
               join(out, f"fit-{rank}.pt"))
    del solver
    torch.cuda.empty_cache()
    with tf32(torch, True):  # f32 with TF32 convs, as the experiment runs
        trainer = rx.run(rx.SPECS[SO_SPEC], scale_out_runner_argv(base),
                         exp_path=join(out, "exp"))
    m = trainer.metric
    res["runner"] = dict(
        counters=[m.total_inter.tolist(), m.total_union.tolist(),
                  int(m.total_correct), int(m.total_label)],
        run_path=str(trainer.args.run_path), graphed=trainer.graphed,
        world=[trainer._pi, trainer._pc], steps=trainer.scheduler.last_epoch)
    del trainer
    torch.cuda.empty_cache()
    zero()
    with tf32(torch, False):
        app.run_generate(scale_out_app_config(base), writer="cv2")
    res["generate"] = counts()
    with open(join(out, f"rank-{rank}.json"), "w") as fh:
        json.dump(res, fh)


def scale_out_one_validation(torch, base, run_path, world=SO_WORLD):
    """The validation of the primary's checkpoint in one process, eager,
    each image scored once in the batches of 8 / ``world`` that the
    processes ran (the ragged tail's last image padded with itself): the
    confusion counters."""
    import dataclasses
    import types

    from gan_segmentation_tpu_torch.data.feed import stack_batch
    from gan_segmentation_tpu_torch.train import rgb_experiments as rx
    from gan_segmentation_tpu_torch.train.deeplab_trainer import (
        SegmentationTrainer)
    spec = dataclasses.replace(rx.SPECS[SO_SPEC], scale_factor=1.0,
                               num_epochs=1, train_epoch_len=SO_TRAIN)
    args = types.SimpleNamespace(
        input_path=join(base, "rgb"), reader="cv2", batch_size=8,
        test_batch_size=8 // world, workers=1, seed=0, logs_path=None,
        weights=join(run_path, "checkpoints", "last_checkpoint.pt"),
        checkpoints_path=join(base, "one-val"), device="cuda:0")
    model, model_cfg = rx.init_model(spec)
    trainset, valset = rx.datasets(args, spec)
    trainer = SegmentationTrainer(
        args, model, model_cfg, trainset, valset,
        {"baselr": spec.lr, "nepochs": 1, "wd": spec.weight_decay,
         "momentum": 0.9}, graphed=False)
    per = 8 // world
    trainer.metric.reset()
    for first in range(0, SO_VAL, per):
        idx = [min(i, SO_VAL - 1) for i in range(first, first + per)]
        imgs, masks, _ = stack_batch([valset[i] for i in idx])
        trainer._score(imgs, masks, per, min(per, SO_VAL - first))
    m = trainer.metric
    out = [m.total_inter.tolist(), m.total_union.tolist(),
           int(m.total_correct), int(m.total_label)]
    del trainer, model
    torch.cuda.empty_cache()
    return out


def scale_out_processes(torch, base, smi):
    """Phase 11 (b): two processes on the one card.  First whether NCCL
    refuses two ranks on one device; then, over gloo and eager, the
    decoder fit at global batch 2 = 1 + 1 against one process at batch 2,
    the runner's DeepLab training (global batch 8 = 4 + 4, one epoch of 2
    steps) and validation over a ragged set against the primary's
    checkpoint validated in one process, and ``generate`` of 16 pairs per
    process against one process with each one's seed, byte for byte."""
    from gan_segmentation_tpu_torch.apps.main import _write_pairs_cv2
    from gan_segmentation_tpu_torch.core.distributed import free_port
    from gan_segmentation_tpu_torch.train.experiments import _spawned
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    out = join(base, "ranks")
    os.makedirs(out)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ended = run_processes(nccl_pair_rank, (free_port(), out), SO_WORLD, 60)
    nccl = {}
    for r in range(SO_WORLD):
        path = join(out, f"nccl_{r}.txt")
        nccl[r] = open(path).read() if os.path.exists(path) else (
            "no result" + ("" if ended else " (killed after 60 s)"))
    nccl_s = time.perf_counter() - t0
    log(f"scale-out (b): NCCL with two ranks on the one card: {nccl}")

    scale_out_dataset(torch, join(base, "rgb"))
    app_cfg = scale_out_app_config(base)
    ckpt = join(app_cfg.BASE_DIR, "checkpoints")
    SegSolver(10, "", ckpt, cfg=app_cfg.solver_config()).save()
    t0 = time.perf_counter()
    ok = run_processes(_spawned, (["cuda:0"] * SO_WORLD, free_port(),
                                  scale_out_rank, (base, out)),
                       SO_WORLD, SO_TIMEOUT)
    assert ok, f"scale-out (b): the processes did not end in {SO_TIMEOUT} s"
    ranks_s = time.perf_counter() - t0
    ranks = [json.load(open(join(out, f"rank-{r}.json")))
             for r in range(SO_WORLD)]

    # the decoder fit: two processes against one at the global batch, from
    # the same seeded init
    with tf32(torch, False):
        one = scale_out_fit(torch, base, "one", train_batch_size=SO_WORLD,
                            use_dropout=False, scan_epochs=False)
    fit_ok, fit_dist = True, 0.0
    for r in ranks:
        ok, d = losses_close(r["fit"]["losses"], one[0])
        fit_ok, fit_dist = fit_ok and ok, max(fit_dist, d)
    w0 = torch.load(join(out, "fit-0.pt"), weights_only=True)
    w1 = torch.load(join(out, "fit-1.pt"), weights_only=True)
    replicas_equal = all(torch.equal(w0[k], w1[k]) for k in w0)
    w_ok, worst, change, size = weights_close(w0, one[1], one[4])
    check_later(fit_ok and w_ok and replicas_equal and all(
        not r["fit"]["graphed"] and r["fit"]["launches"]["bil_conv"] > 0
        for r in ranks),
        f"scale-out (b) fit: losses {[r['fit']['losses'] for r in ranks]} "
        f"against {one[0]}; weights: farthest {worst}, parameters' change "
        f"rel. L2 {change:.3g}; replicas equal {replicas_equal}")

    # the runner: one run dir, the primary's files, the counters
    runs = os.listdir(join(out, "exp", "runs"))
    run_path = ranks[0]["runner"]["run_path"]
    files = sorted(os.listdir(join(run_path, "checkpoints")))
    with tf32(torch, True):
        want = scale_out_one_validation(torch, base, run_path)
    counters_equal = all(r["runner"]["counters"] == want for r in ranks)
    check_later(len(runs) == 1 and files == ["last_checkpoint.pt"]
                and counters_equal and all(
                    r["runner"]["run_path"] == run_path
                    and r["runner"]["steps"] == SO_TRAIN // 8
                    and not r["runner"]["graphed"] for r in ranks),
                f"scale-out (b) runner: runs {runs}, checkpoints {files}, "
                f"counters {[r['runner']['counters'] for r in ranks]} "
                f"against {want}")

    # generate: each process's slice against one process with its seed
    solver = SegSolver(10, "", ckpt, cfg=app_cfg.solver_config())
    dst = join(app_cfg.BASE_DIR, "dataset", "train_generated")
    same_files = True
    for r in range(SO_WORLD):
        one_dir = join(base, f"one-gen-{r}")
        os.makedirs(one_dir)
        pipe = FusedPipeline(ImageGenerator(
            gan="ffhq", gan_dir=app_cfg.GAN_DIR, batch_size=BATCH, seed=r),
            solver)
        with tf32(torch, False):
            _write_pairs_cv2(pipe, SO_GEN_PER_RANK, one_dir,
                             r * SO_GEN_PER_RANK, None)
        for name in os.listdir(one_dir):
            with open(join(one_dir, name), "rb") as a, \
                    open(join(dst, name), "rb") as b:
                same_files = same_files and a.read() == b.read()
        del pipe
    written = len(os.listdir(dst))
    check_later(same_files and written == 2 * SO_WORLD * SO_GEN_PER_RANK
                and all(r["generate"]["conv_in_stats"] > 0
                        and r["generate"]["small_conv"] > 0 for r in ranks),
                f"scale-out (b) generate: files equal {same_files}, "
                f"{written} written, launches "
                f"{[r['generate'] for r in ranks]}")
    del solver
    torch.cuda.empty_cache()
    log(f"scale-out (b) {SO_WORLD} processes on the one card over gloo, "
        f"eager ({ranks_s:.1f} s): decoder fit at global batch "
        f"{SO_WORLD}, SGD: per-step losses within {fit_dist:.2e} relative of "
        f"one process at batch {SO_WORLD}, replicas bit-equal "
        f"{replicas_equal}, weights farthest {worst[0]} by {worst[1]:.3g} "
        f"(bound {SO_PARAM_TOL} rtol and atol), the parameters' change "
        f"within {change:.3g} rel. L2 (bound {SO_CHANGE_REL}; the change is "
        f"{size:.3g} of the parameters); runner: one run dir, "
        f"checkpoints {files}, validation counters equal to one process on "
        f"the primary's checkpoint {counters_equal}; generate "
        f"{SO_GEN_PER_RANK} pairs a process, files equal to one process "
        f"with the rank's seed {same_files}; launches "
        f"{[r['generate'] for r in ranks]} on {smi}")
    return dict(
        nccl_two_ranks_one_card=nccl, nccl_probe_s=nccl_s,
        processes_s=ranks_s,
        fit=dict(loss_rel_dist=fit_dist, replicas_bit_equal=replicas_equal,
                 weights_worst=worst, change_rel_l2=change,
                 change_size=size,
                 launches=[r["fit"]["launches"] for r in ranks]),
        runner=dict(run_dirs=len(runs), checkpoints=files,
                    counters_equal=counters_equal, counters=want),
        generate=dict(files_equal=same_files, written=written,
                      launches=[r["generate"] for r in ranks]))


def phase_scale_out(torch, smi):
    """Phase 11: (a) a world of one over NCCL in this process, the group
    passed explicitly: the DeepLab step and the decoder fit; (b) two
    processes on the one card over gloo."""
    from gan_segmentation_tpu_torch.train.generator import ImageGenerator

    base = tempfile.mkdtemp()
    try:
        gen = ImageGenerator(gan="ffhq", batch_size=BATCH, dtype="fp32",
                             gan_dir=join(base, "no-models"), seed=0)
        make_collection(gen, join(base, "data"), SO_SAMPLES)
        del gen
        torch.cuda.empty_cache()
        with world_of_one(torch) as grp:
            dl = scale_out_deeplab(torch, grp, smi)
            dec = scale_out_decoder(torch, grp, base, smi)
        dp = scale_out_dp_pipeline(torch, smi)
        procs = scale_out_processes(torch, base, smi)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return dict(deeplab=dl, decoder_fit=dec, generate_dp=dp,
                processes=procs)


# ------------------------------------------------- several cards (by hand)
MC_SAMPLES = 8           # ffhq 1024^2 samples of the fits across cards
MC_EPOCH_LEN = 32        # the runner's draws: 4 steps of 8, 2 of them replays
MC_TIMEOUT = 240         # seconds for the processes
MC_RATE_BATCHES = 6      # batches timed per generate pipeline


def multi_card_rank(base, out):
    """One process per card over NCCL (started by the runner's
    ``_spawned``, which sets the launcher's environment): the decoder fit
    at global batch P, graphed with the all-reduce captured; the DeepLab
    step as replays across the cards (batch 8 a card); the experiment
    runner's graphed training and ragged validation; ``generate`` of 16
    pairs a process.  -> a JSON file."""
    import torch

    from gan_segmentation_tpu_torch.apps import main as app
    from gan_segmentation_tpu_torch.core import distributed as dist_
    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
    from gan_segmentation_tpu_torch.models.resnet import set_process_group
    from gan_segmentation_tpu_torch.train import rgb_experiments as rx
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    assert dist_.initialize(cuda=True)
    rank, world, grp = (dist_.process_index(), dist_.process_count(),
                        dist_.group())
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    res = {"rank": rank, "device": torch.cuda.current_device()}
    solver = SegSolver(10, join(base, "data"), join(out, f"fit-{rank}"),
                       cfg=scale_out_cfg(train_batch_size=world,
                                         use_dropout=False))
    with tf32(torch, False):
        solver.fit()
    res["fit"] = dict(losses=[x for e in solver.history for x in e],
                      graphed=solver._scan_epochs(object()),
                      launches={k: fn.launches for k, fn in fns.items()})
    torch.save({k: v.cpu() for k, v in solver.model.state_dict().items()},
               join(out, f"fit-{rank}.pt"))
    del solver
    torch.cuda.empty_cache()
    images, masks = deeplab_batch(torch, seed=21 + rank)
    model = DeepLabV3Plus(DL_CLASSES, "resnet50", aux=True, crop_size=DL_CROP,
                          generator=torch.Generator().manual_seed(41))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.cuda()
    set_process_group(model, grp)
    with tf32(torch, True):
        prof = deeplab_graph_profile(torch, model, state, images, masks,
                                     torch.float32, group=grp)
    res["deeplab"] = {k: prof[k] for k in (
        "ms", "host_enqueue_ms", "busy_ms", "busy_share", "launches",
        "nccl_launches", "replays")}
    del model, state
    torch.cuda.empty_cache()
    with tf32(torch, True):
        trainer = rx.run(rx.SPECS[SO_SPEC], [
            "train", "--input-path", join(base, "rgb"), "--crop-size", "480",
            "--base-size", "512", "--scale-factor", "1.0", "--epochs", "1",
            "--epoch-len", str(MC_EPOCH_LEN), "--batch-size", "8",
            "--test-batch-size", "8", "--workers", "1",
            "--no-preempt-save"], exp_path=join(out, "exp"))
    m = trainer.metric
    res["runner"] = dict(
        counters=[m.total_inter.tolist(), m.total_union.tolist(),
                  int(m.total_correct), int(m.total_label)],
        run_path=str(trainer.args.run_path), graphed=trainer.graphed,
        world=[trainer._pi, trainer._pc], steps=trainer.scheduler.last_epoch,
        replays=sum(c.replays for c in
                    trainer._train_graph.fn.calls.values()))
    del trainer
    torch.cuda.empty_cache()
    for fn in fns.values():
        fn.launches = 0
    with tf32(torch, False):
        app.run_generate(scale_out_app_config(base, world), writer="cv2")
    res["generate"] = {k: fn.launches for k, fn in fns.items()}
    with open(join(out, f"rank-{rank}.json"), "w") as fh:
        json.dump(res, fh)


def generate_rate(torch, pipe, batches=MC_RATE_BATCHES):
    """Samples/s of ``pipe.generate_batches`` over ``batches`` batches after
    three (the eager first, the capture, a replay)."""
    b = pipe.gen.batch_size
    for _ in pipe.generate_batches(3 * b):
        pass
    t0 = time.perf_counter()
    for _ in pipe.generate_batches(batches * b):
        pass
    return batches * b / (time.perf_counter() - t0)


def multi_card_dp(torch, n, smi):
    """``generate --dp n`` in this process: each batch of 8 n split over
    the n cards, one replica and graph a card, against the one-device
    program on each part of the same inputs (bit for bit), and samples/s
    beside one card at batch 8; then the same split of the int8-full
    program (``--quant int8-full --dp n``: each card's replica serves the
    int8 state of the pipeline's primary)."""
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator,
                                                            _infer)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    none = tempfile.mkdtemp()
    try:
        solver = SegSolver(10, "", join(none, "no-checkpoints"))
        cards = [torch.device("cuda", i) for i in range(n)]
        with tf32(torch, False):
            one = FusedPipeline(ImageGenerator(
                gan="ffhq", gan_dir=none, batch_size=BATCH, seed=3), solver)
            one_rate = generate_rate(torch, one)
            dp = FusedPipeline(ImageGenerator(
                gan="ffhq", gan_dir=none, batch_size=BATCH * n, seed=3),
                solver, mesh=cards)
            draw = ImageGenerator(gan="ffhq", gan_dir=none,
                                  batch_size=BATCH * n, seed=3)
            with LaunchTrace(torch) as trace:
                got = [[t.cpu() for t in dp.sample_batch()] for _ in range(3)]
            want = []
            for _ in range(3):
                z, noise = draw.draw_inputs(BATCH * n)
                parts = [_infer(one.program(), z[k * BATCH:(k + 1) * BATCH]
                                .clone(), noise={
                                    name: v[k * BATCH:(k + 1) * BATCH].clone()
                                    for name, v in noise.items()})
                         for k in range(n)]
                want.append([torch.cat([p[i] for p in parts]).cpu()
                             for i in (0, 1)])
            dp_rate = generate_rate(torch, dp)
            equal = all(torch.equal(g, w) for gb, wb in zip(got, want)
                        for g, w in zip(gb, wb))
            replays = [c.replays for c, _, _ in dp._parts.values()]
            del one, dp, draw
            torch.cuda.empty_cache()
            q_equal, q_trace = multi_card_int8(torch, solver, cards, none)
        del solver
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(none, ignore_errors=True)
    check_later(equal and trace.device["conv_in_stats"] > 0,
                f"generate --dp {n}: parts equal to the one-device program "
                f"{equal}, launches {trace.device}")
    check_later(q_equal and all(q_trace.device[k] > 0 for k in S8_KERNELS),
                f"generate --quant int8-full --dp {n}: parts equal to the "
                f"one-device program {q_equal}, launches {q_trace.device}")
    log(f"several cards: generate --dp {n}, ffhq 1024^2, batch {BATCH * n} "
        f"= {n} x {BATCH}, bf16: each card's part bit-equal to the "
        f"one-device program on it {equal}; {dp_rate:.3f} samples/s against "
        f"{one_rate:.3f} on one card at batch {BATCH}; device trace "
        f"{trace.device}, replays {replays}; --quant int8-full --dp {n}: "
        f"each card's part bit-equal to the one-device int8-full program "
        f"on it {q_equal}, device trace {q_trace.device} on {smi}")
    return dict(parts_bit_equal=equal, samples_per_s=dp_rate,
                one_card_samples_per_s=one_rate, launches=trace.device,
                replays=replays, int8_full_parts_bit_equal=q_equal,
                int8_full_launches=q_trace.device)


def multi_card_int8(torch, solver, cards, gan_dir, batches=2):
    """The int8-full program split over ``cards`` (a batch of 8 a card)
    against the one-device int8-full program on each part of the same
    inputs: -> (bit-equal, the ``LaunchTrace`` of the split batches)."""
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator,
                                                            _infer)

    n = len(cards)

    def fresh(batch):
        return ImageGenerator(gan="ffhq", gan_dir=gan_dir, batch_size=batch,
                              seed=3)

    one = FusedPipeline(fresh(BATCH), solver, quant="int8-full")
    dp = FusedPipeline(fresh(BATCH * n), solver, mesh=cards,
                       quant="int8-full")
    with LaunchTrace(torch, s8=True) as trace:
        got = [[t.cpu() for t in dp.sample_batch()] for _ in range(batches)]
    draw, equal = fresh(BATCH * n), True
    for gb in got:
        z, noise = draw.draw_inputs(BATCH * n)
        parts = [_infer(one.program(), z[k * BATCH:(k + 1) * BATCH].clone(),
                        noise={name: v[k * BATCH:(k + 1) * BATCH].clone()
                               for name, v in noise.items()})
                 for k in range(n)]
        equal &= all(torch.equal(g, torch.cat([p[i] for p in parts]).cpu())
                     for i, g in enumerate(gb))
    del one, dp, draw
    torch.cuda.empty_cache()
    return equal, trace


# ------------------------------------------------------ generate --spatial
# (N, D): a D x N grid that repeats the one card (the default run); the
# four-card phase runs --spatial 4 and --spatial 2 --dp 2 on real cards.
SPATIAL_GRIDS = ((2, 1), (4, 1), (2, 2))
SPATIAL_BATCHES = 2          # batches a grid, under the device trace
SPATIAL_RATE_BATCHES = 3     # batches timed a pipeline
SPATIAL_LATENCY_REPS = 3     # batch-1 calls timed a path
SPATIAL_EXPORT_RES = 6       # the grid bundle and the --platforms artifact
SPATIAL_EXPORT_BATCH = 2     # (ffhq at full width, depth cut to 64^2)
BAND_TIMING = dict(reps=4, replays=3)

SPATIAL_SERVE_WORKER = r"""
import json, sys
import torch
from gan_segmentation_tpu_torch.core.export import draw_inputs, load_bundle
bundle, out, seed, n, devices = sys.argv[1:]
torch.backends.cudnn.allow_tf32 = False
serve = load_bundle(bundle, devices=[torch.device(d)
                                     for d in devices.split(",")])
gen = torch.Generator(device=serve.device)
outs = []
for i in range(int(n)):
    gen.manual_seed(int(seed) * 2 ** 32 + i)
    outs.append([t.cpu() for t in serve(*draw_inputs(serve.meta, gen))])
torch.save(outs, out)
models = [m for m in sys.modules
          if m.startswith("gan_segmentation_tpu_torch.models")
          or m.split(".")[0] in ("jax", "gan_segmentation_tpu")]
print(json.dumps({"grid": serve.meta["grid"], "model_modules": models}))
"""


def band_calls(gcfg, scfg, n, batch):
    """(kernel, batch, band rows, w, cin, cout, leaky) of every row-band
    kernel call of one spatial batch over ``n`` bands (``core/spatial.py``'s
    band rule; heights below n run the full-image kernels)."""
    from gan_segmentation_tpu_torch.core.spatial import BandPlan
    plan = BandPlan.of(gcfg, n)
    calls = []
    for (b, h, w, cin, cout) in kernel1_shapes(gcfg, batch):
        for s, e in plan.bounds(h) or ():
            calls.append(("conv_in_stats_rows", b, e - s, w, cin, cout, True))
    for (_, b, h, w, cin, cout, leaky) in kernel2_shapes(scfg, batch):
        for s, e in plan.bounds(h) or ():
            calls.append(("small_conv_rows", b, e - s, w, cin, cout, leaky))
    return calls


def phase_band_kernels(torch, gcfg, scfg):
    """Kernels 1 and 2 in their row-band form at every band shape of the
    phase's grids (N = 2 and 4 at batch 8, N = 2 at a row's batch of 4),
    bf16 and f32, against their plain twins with the full-image tolerances
    (kernel 1's band sums as band means), each repeat bit-identical; per
    spatial batch of 8 at N = 2 and N = 4, the bf16 device time (graph
    replay) of every band call beside its plain twin, F.conv2d alone on the
    same band and the bound."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = {}
    for n, d in SPATIAL_GRIDS:
        for c in band_calls(gcfg, scfg, n, BATCH // d):
            shapes[c] = None
    errs = {k: {"f32": 0.0, "bf16": 0.0} for k in ("conv_in_stats_rows",
                                                    "small_conv_rows")}
    times = {}  # call -> (kernel, plain, library, bound) ms, bf16
    timed = set(band_calls(gcfg, scfg, 2, BATCH)
                + band_calls(gcfg, scfg, 4, BATCH))
    for call in shapes:
        kind, b, h, w, cin, cout, leaky = call
        x32 = torch.randn((b, h + 2, w, cin), generator=g, device=dev)
        w32 = torch.randn((3, 3, cin, cout), generator=g,
                          device=dev) / (9 * cin) ** 0.5
        bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
        noise = torch.randn((b, h, w), generator=g, device=dev)
        nscale = 0.1 * torch.randn((cout,), generator=g, device=dev)
        for tag, dt in dtypes.items():
            x, wt = x32.to(dt), w32.to(dt)
            name = f"{kind} {tag} {(b, h, w, cin, cout)}"
            if kind == "conv_in_stats_rows":
                args = (x, wt, noise, nscale, bias)
                fn = functools.partial(
                    k1m.conv3x3_noise_bias_lrelu_instats_rows, *args)
                plain = functools.partial(
                    k1m.conv3x3_noise_bias_lrelu_instats_rows_plain, *args)
                got, want = fn(), plain()
                check_close(name + " y", got[0], want[0], **TOL[tag])
                for s, (a_, b_) in zip(("sum", "sum of squares"),
                                       zip(got[1:], want[1:])):
                    check_close(f"{name} band {s} / pixels", a_ / (h * w),
                                b_ / (h * w), **STAT_TOL[tag])
                again = fn()
                y, yp = got[0], want[0]
                extra = 4 * (b * h * w + 2 * cout + 2 * b * cout)
            else:
                kw = dict(leaky=0.2) if leaky else {}
                fn = functools.partial(k2m.conv3x3_small_rows, x, wt, bias,
                                       **kw)
                plain = functools.partial(k2m.conv3x3_small_rows_plain, x,
                                          wt, bias, **kw)
                got, want = (fn(),), (plain(),)
                check_close(name, got[0], want[0], **TOL[tag])
                again = (fn(),)
                y, yp = got[0], want[0]
                extra = 4 * cout
            assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again)), (
                f"{name}: a repeat differs")
            errs[kind][tag] = max(errs[kind][tag], max_err(y, yp))
            if tag == "bf16" and call in timed:
                # the band's input (H + 2 rows) read once, its output written
                # once; the conv's operations over the output rows
                nbytes = 2 * (b * (h + 2) * w * cin + b * h * w * cout
                              + 9 * cin * cout) + extra
                floor = bound(nbytes, 18 * b * h * w * cin * cout,
                              PEAK["bf16"])
                with mma_sync_body():
                    old = graph_ms(fn, **BAND_TIMING)
                times[call] = dict(kernel=graph_ms(fn, **BAND_TIMING),
                                   mma_sync=old,
                                   plain=graph_ms(plain, **BAND_TIMING),
                                   library=library_ms(
                                       torch, x, wt, padding=(0, 1),
                                       **BAND_TIMING),
                                   bound=floor)
                stats = kind == "conv_in_stats_rows"
                log(f"  {name}: {bf16_plan(b, h, w, cin, cout, stats)};"
                    + times_line(times[call], floor))
        del x32, w32, x, wt, got, want, again, y, yp
    per_batch = {}
    for n in (2, 4):
        acc = {k: {} for k in errs}
        for call in band_calls(gcfg, scfg, n, BATCH):
            add_times(acc[call[0]], {k: v for k, v in times[call].items()
                                     if k != "bound"}, times[call]["bound"])
        for kind, a in acc.items():
            total, by = summed_bound(a.pop("bounds"))
            a.update(bound=total, bound_by=by)
            log(f"{kind}: per spatial batch of 8 at N = {n} (bf16, device "
                f"time by graph replay, {len(band_calls(gcfg, scfg, n, 8))}"
                f" band calls of both kernels): kernel {a['kernel']:.3f} ms"
                f" (the mma.sync body {a['mma_sync']:.3f}), plain "
                f"{a['plain']:.3f}, F.conv2d on the same bands "
                f"{a['library']:.3f}, bound {total:.3f} ({by})")
        per_batch[n] = acc
    log(f"row-band kernels: {len(shapes)} band shapes, bf16 and f32, within "
        f"the full-image tolerances of their plain twins, repeats "
        f"bit-identical; max abs err {errs}")
    return dict(errs=errs, per_batch=per_batch, shapes=len(shapes))


def slice_floats(torch, program, z, noise):
    """(uint8 images, f32 logits, masks) of the one-device program."""
    from gan_segmentation_tpu_torch.train.generator import (_to_uint8,
                                                            class_mask)
    with torch.inference_mode():
        rgb, feats = program.model(z, noise=noise)
        logits = program.decoder(feats, program.folded(), program.dtype)
        return (_to_uint8(rgb, program.imrange).cpu(), logits.cpu(),
                class_mask(logits).cpu())


def grid_floats(torch, grid, z, noise):
    """The same of a ``GridProgram``: each row's bands gathered, the rows
    concatenated on the host."""
    from gan_segmentation_tpu_torch.core.spatial import band_rows, gather
    from gan_segmentation_tpu_torch.train.generator import (_to_uint8,
                                                            class_mask)
    out = []
    dev = z.device
    with torch.inference_mode():
        for row, (a, b) in zip(grid.rows, band_rows(len(z), len(grid.rows))):
            rgb, logits = grid.floats(row, z[a:b], {k: v[a:b] for k, v in
                                                    noise.items()})
            rgb, logits = gather(rgb, dev), gather(logits, dev)
            out.append((_to_uint8(rgb, grid.programs[0].imrange).cpu(),
                        logits.cpu(), class_mask(logits).cpu()))
    return tuple(torch.cat([o[i] for o in out]) for i in range(3))


def batch_seconds(torch, step, n):
    """Wall seconds per call of ``step`` over ``n`` calls after two warm
    calls (a graphed path's eager first call and its capture), each call
    ending in a sync (a latency, not a pipelined rate)."""
    step()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def spatial_pipelines(torch, smi, cards=None, grids=SPATIAL_GRIDS):
    """``FusedPipeline(mesh=grid)`` at ffhq 1024^2, batch 8, bf16: each
    grid's batches under a device trace, its (image, logits, mask) on the
    same z and noise held to the one-device pipeline's as
    ``check_bf16_slice`` holds the kernels' bf16 slice (the one-device bf16
    slice's own distance from the f32 slice, measured here, is the scale),
    samples/s against the one-device eager and graph paths, and batch-1
    latency.  ``cards``: the grid's cards in row order (default: the grid
    repeats the one card)."""
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator,
                                                            _infer)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    none = tempfile.mkdtemp()
    out = {}
    try:
        solver = SegSolver(10, "", join(none, "no-checkpoints"))

        def generator(batch=BATCH, dtype="bf16"):
            gen = ImageGenerator(gan="ffhq", gan_dir=none, batch_size=batch,
                                 seed=5, dtype=dtype)
            perturb(torch, gen.model, 35)  # the noise inputs show
            return gen

        with tf32(torch, False):
            one = FusedPipeline(generator(), solver)
            ref = FusedPipeline(generator(dtype="fp32"), solver,
                                inference_dtype=torch.float32)
            z, noise = one.gen.draw_inputs(BATCH)
            z, noise = z.clone(), {k: v.clone() for k, v in noise.items()}
            plain = slice_floats(torch, one.program(), z, noise)
            f32 = slice_floats(torch, ref.program(), z, noise)
            del ref
            eager_s = batch_seconds(
                torch, lambda: _infer(one.program(), z, noise=noise),
                SPATIAL_RATE_BATCHES)
            graph_s = batch_seconds(torch, lambda: one._batch(BATCH),
                                    SPATIAL_RATE_BATCHES)
            one1 = FusedPipeline(generator(1), solver)
            z1 = z[:1].clone()
            n1 = {k: v[:1].clone() for k, v in noise.items()}
            lat = dict(one_eager=batch_seconds(
                torch, lambda: _infer(one1.program(), z1, noise=n1),
                SPATIAL_LATENCY_REPS),
                one_graph=batch_seconds(torch, lambda: one1._batch(1),
                                        SPATIAL_LATENCY_REPS))
            del one1
            for n, d in grids:
                rows = ([[cards[r * n + k] for k in range(n)]
                         for r in range(d)] if cards is not None
                        else [[torch.device("cuda", 0)] * n] * d)
                tag = f"{d}x{n}"
                sp = FusedPipeline(generator(), solver, mesh=rows)
                with LaunchTrace(torch, rows=True) as trace:
                    for _ in range(SPATIAL_BATCHES):
                        sp.sample_batch()
                got = grid_floats(torch, sp.grid_program(), z, noise)
                reading = check_bf16_slice(f"spatial {tag}", got, plain, f32)
                rate_s = batch_seconds(torch, lambda: sp._batch(BATCH),
                                       SPATIAL_RATE_BATCHES)
                rec = dict(launches=trace.device, reading=reading,
                           samples_per_s=BATCH / rate_s)
                if d == 1:
                    sp1 = FusedPipeline(generator(1), solver,
                                        mesh=[rows[0]])
                    rec["batch1_latency_s"] = batch_seconds(
                        torch, lambda: sp1.grid_program()(z1, n1),
                        SPATIAL_LATENCY_REPS)
                    del sp1
                check_later(
                    trace.device["conv_in_stats_rows"] > 0
                    and trace.device["small_conv_rows"] > 0,
                    f"spatial {tag}: row-band kernels not launched "
                    f"{trace.device}")
                log(f"generate --spatial {n} --dp {d} ({tag} grid on "
                    f"{'the cards' if cards else 'the one card'}), ffhq "
                    f"1024^2, batch 8, bf16, eager: {reading}; "
                    f"{BATCH / rate_s:.3f} samples/s (one device: eager "
                    f"{BATCH / eager_s:.3f}, graph {BATCH / graph_s:.3f}); "
                    f"batch-1 latency "
                    f"{rec.get('batch1_latency_s', float('nan')):.4f} s "
                    f"(one device: eager {lat['one_eager']:.4f} s, graph "
                    f"{lat['one_graph']:.4f} s); device trace "
                    f"{trace.device} on {smi}")
                out[tag] = rec
                del sp
                torch.cuda.empty_cache()
        del one, solver
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(none, ignore_errors=True)
    return dict(grids=out, one_device_eager_samples_per_s=BATCH / eager_s,
                one_device_graph_samples_per_s=BATCH / graph_s,
                one_device_batch1_latency_s=lat)


def small_export_pipeline(torch, device, gan_dir, mesh=None):
    """ffhq at full width cut to ``SPATIAL_EXPORT_RES`` (seeded generator,
    noise scales moved off zero, seeded decoder) on ``device``."""
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver
    gen = ImageGenerator(gan="ffhq", gan_dir=gan_dir,
                         batch_size=SPATIAL_EXPORT_BATCH, seed=6,
                         max_res_log2=SPATIAL_EXPORT_RES, device=device)
    perturb(torch, gen.model, 36)
    solver = SegSolver(SPATIAL_EXPORT_RES, "", join(gan_dir, "none"),
                       device=device)
    return FusedPipeline(gen, solver, mesh=mesh)


def serve_grid_fresh(torch, bundle, base, devices, n):
    """Serve batches 0..n-1 from seed 6 with a grid bundle in a fresh
    interpreter that imports only ``core.export``; -> its batches."""
    out = join(base, "grid_served.pt")
    proc = subprocess.run(
        [sys.executable, "-c", SPATIAL_SERVE_WORKER, bundle, out, "6",
         str(n), ",".join(str(d) for d in devices)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not rec["model_modules"], rec
    return torch.load(out, weights_only=True)


def spatial_exports(torch, smi, cards=None, grid=(2, 1), platforms=True):
    """(a) The bundle of a grid pipeline (ffhq, full width, cut to 64^2;
    D x N = ``grid``, on ``cards`` or repeating the one card) served from a
    fresh interpreter equals the live grid pipeline bit for bit.  (b) A
    ``--platforms cpu,cuda`` artifact exported on the CPU serves on the
    card, bit for bit equal to one exported on the card (and to the live
    pipeline there; skipped without ``platforms``)."""
    from gan_segmentation_tpu_torch.core import export as tex

    base = tempfile.mkdtemp()
    try:
        n, d = grid
        dev = torch.device("cuda", 0)
        devices = (cards[:n * d] if cards is not None else [dev] * (n * d))
        rows = [devices[r * n:(r + 1) * n] for r in range(d)]
        with tf32(torch, False):
            pipe = small_export_pipeline(torch, dev, base, mesh=rows)
            bdir = join(base, "grid.bundle")
            t0 = time.perf_counter()
            tex.export_fused_pipeline_bundle(pipe, SPATIAL_EXPORT_BATCH, bdir)
            export_s = time.perf_counter() - t0
            live = [[t.cpu() for t in pipe.sample_batch()] for _ in range(2)]
            del pipe
            torch.cuda.empty_cache()
            served = serve_grid_fresh(torch, bdir, base, devices, 2)
            grid_equal = same_batches(torch, served, live)
            check_later(grid_equal, f"grid bundle {d}x{n} served from a "
                                    f"fresh process differs from the live "
                                    f"grid pipeline")
            if not platforms:
                log(f"the {d}x{n} grid's bundle ({export_s:.1f} s to "
                    f"export) served from a fresh process on "
                    f"{[str(x) for x in devices]} equal to the live grid "
                    f"pipeline {grid_equal} on {smi}")
                return dict(grid=[d, n], grid_bundle_fresh_equal=grid_equal,
                            grid_export_s=export_s)

            cpu_path, card_path = (join(base, "cpu.pt2"),
                                   join(base, "card.pt2"))
            cpu_pipe = small_export_pipeline(torch, torch.device("cpu"),
                                             base)
            tex.export_fused_pipeline(cpu_pipe, SPATIAL_EXPORT_BATCH,
                                      cpu_path, platforms=("cpu", "cuda"))
            folded = {k: (w.clone(), b.clone())
                      for k, (w, b) in cpu_pipe._prepared().items()}
            del cpu_pipe
            card_pipe = small_export_pipeline(torch, dev, base)
            # the decoder's batch norm is folded where the pipeline lives,
            # and rsqrt on the CPU and on the card may differ in the last
            # place: the card's pipeline takes the CPU's fold, so that both
            # exports hold the same weights
            with torch.no_grad():
                for k, (w, b) in card_pipe._prepared().items():
                    w.copy_(folded[k][0])
                    b.copy_(folded[k][1])
            tex.export_fused_pipeline(card_pipe, SPATIAL_EXPORT_BATCH,
                                      card_path)
            outs = {}
            for tag, path in (("cpu", cpu_path), ("card", card_path)):
                serve = tex.load_artifact(path, device=dev)
                gen = torch.Generator(device=dev)
                outs[tag] = []
                for i in range(2):
                    gen.manual_seed(6 * 2 ** 32 + i)
                    outs[tag].append([t.cpu() for t in serve(
                        *tex.draw_inputs(serve.meta, gen))])
                outs[tag + "_platforms"] = serve.meta["platforms"]
                del serve
            want = [[t.cpu() for t in card_pipe.sample_batch()]
                    for _ in range(2)]
            del card_pipe
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    xplat_equal = same_batches(torch, outs["cpu"], outs["card"])
    live_equal = same_batches(torch, outs["card"], want)
    check_later(xplat_equal and live_equal
                and outs["cpu_platforms"] == ["cpu", "cuda"],
                f"--platforms cpu,cuda artifact exported on the CPU: equal "
                f"to the card's export {xplat_equal}, to the live pipeline "
                f"{live_equal}, platforms {outs['cpu_platforms']}")
    log(f"spatial export (ffhq full width cut to {2 ** SPATIAL_EXPORT_RES}^2,"
        f" batch {SPATIAL_EXPORT_BATCH}): the {d}x{n} grid's bundle "
        f"({export_s:.1f} s to export) served from a fresh process equal to "
        f"the live grid pipeline {grid_equal}; a --platforms cpu,cuda "
        f"artifact exported on the CPU, served on the card, equal to one "
        f"exported on the card {xplat_equal} (and to the live pipeline "
        f"{live_equal}) on {smi}")
    return dict(grid=[d, n], grid_bundle_fresh_equal=grid_equal,
                grid_export_s=export_s,
                platforms_cpu_export_equal_card_export=xplat_equal,
                platforms_card_export_equal_live=live_equal)


def phase_spatial(torch, gcfg, scfg, smi):
    """``generate --spatial``: the row-band kernels at every band shape,
    the grids of ``SPATIAL_GRIDS`` on the one card, the grid bundle and the
    ``--platforms`` artifact."""
    kern = phase_band_kernels(torch, gcfg, scfg)
    pipes = spatial_pipelines(torch, smi)
    exports = spatial_exports(torch, smi)
    launches = {}
    for tag, rec in pipes["grids"].items():
        for k in ("conv_in_stats_rows", "small_conv_rows"):
            launches.setdefault(k, {})[f"spatial_{tag}"] = \
                rec["launches"][k]
    return dict(kernels=kern, pipelines=pipes, exports=exports,
                launches=launches)


def multi_card_spatial(torch, n, smi):
    """``generate --spatial 4`` and ``--spatial 2 --dp 2`` on the first four
    cards, on the grids ``core/mesh.py::generate_devices`` gives, held to
    the one-device pipeline as on one card (``spatial_pipelines``), then
    the 2 x 2 grid's bundle served from a fresh process on those cards."""
    from gan_segmentation_tpu_torch.core.mesh import generate_devices

    assert n >= 4, f"--spatial 4 needs four cards, found {n}"
    cards = [torch.device("cuda", i) for i in range(4)]
    assert generate_devices(4, None, cards) == [cards]
    assert generate_devices(2, 2, cards) == [cards[:2], cards[2:]]
    pipes = spatial_pipelines(torch, smi, cards=cards,
                              grids=((4, 1), (2, 2)))
    exports = spatial_exports(torch, smi, cards=cards, grid=(2, 2),
                              platforms=False)
    return dict(pipelines=pipes, exports=exports)


def phase_multi_card(torch, smi):
    """Scale-out across the machine's cards (two or more; not part of the
    script's default run, which needs one card): ``generate --dp`` in one
    process, ``--spatial 4`` and ``--spatial 2 --dp 2`` with four cards or
    more (``multi_card_spatial``), then one process per card over NCCL
    through the runner's
    spawn entry: the decoder fit against one process at the global batch,
    the DeepLab step as replays across the cards beside one card's, the
    runner's graphed training and ragged validation (counters equal to
    one process on the primary's checkpoint), and ``generate``'s slices
    (each equal to one process with the rank's seed, byte for byte)."""
    import gc

    from gan_segmentation_tpu_torch.apps.main import _write_pairs_cv2
    from gan_segmentation_tpu_torch.core.distributed import free_port
    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
    from gan_segmentation_tpu_torch.train.experiments import _spawned
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    n = torch.cuda.device_count()
    assert n >= 2, f"phase_multi_card needs two cards or more, found {n}"
    base = tempfile.mkdtemp()
    try:
        dp = multi_card_dp(torch, n, smi)
        spatial = multi_card_spatial(torch, n, smi) if n >= 4 else None
        gen = ImageGenerator(gan="ffhq", batch_size=BATCH, dtype="fp32",
                             gan_dir=join(base, "no-models"), seed=0)
        make_collection(gen, join(base, "data"), MC_SAMPLES)
        del gen
        scale_out_dataset(torch, join(base, "rgb"))
        app_cfg = scale_out_app_config(base, n)
        ckpt = join(app_cfg.BASE_DIR, "checkpoints")
        SegSolver(10, "", ckpt, cfg=app_cfg.solver_config()).save()
        # one card's DeepLab step as replays, the baseline of the cards'
        images, masks = deeplab_batch(torch)
        model = DeepLabV3Plus(DL_CLASSES, "resnet50", aux=True,
                              crop_size=DL_CROP,
                              generator=torch.Generator().manual_seed(41))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        model.cuda()
        with tf32(torch, True):
            one_step = deeplab_graph_profile(torch, model, state, images,
                                             masks, torch.float32)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()

        out = join(base, "ranks")
        os.makedirs(out)
        t0 = time.perf_counter()
        ended = run_processes(_spawned, ([f"cuda:{i}" for i in range(n)],
                                         free_port(), multi_card_rank,
                                         (base, out)), n, MC_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        check_later(ended, f"several cards: the processes did not end in "
                           f"{MC_TIMEOUT} s")
        ranks = [json.load(open(join(out, f"rank-{r}.json")))
                 for r in range(n)]

        with tf32(torch, False):
            one = scale_out_fit(torch, base, "one", train_batch_size=n,
                                use_dropout=False, scan_epochs=False)
        fit_ok, fit_dist = True, 0.0
        for r in ranks:
            ok, d = losses_close(r["fit"]["losses"], one[0])
            fit_ok, fit_dist = fit_ok and ok, max(fit_dist, d)
        w_ok, worst, change, _ = weights_close(
            torch.load(join(out, "fit-0.pt"), weights_only=True), one[1],
            one[4])
        check_later(fit_ok and w_ok
                    and all(r["fit"]["graphed"] for r in ranks),
                    f"several cards, fit: losses "
                    f"{[r['fit']['losses'] for r in ranks]} against {one[0]}; "
                    f"weights: farthest {worst}, parameters' change rel. L2 "
                    f"{change:.3g}")

        run_path = ranks[0]["runner"]["run_path"]
        with tf32(torch, True):
            want = scale_out_one_validation(torch, base, run_path, n)
        counters_equal = all(r["runner"]["counters"] == want for r in ranks)
        check_later(counters_equal and all(
            r["runner"]["graphed"] and r["runner"]["replays"] > 0
            for r in ranks),
            f"several cards, runner: counters "
            f"{[r['runner']['counters'] for r in ranks]} against {want}")

        solver = SegSolver(10, "", ckpt, cfg=app_cfg.solver_config())
        dst = join(app_cfg.BASE_DIR, "dataset", "train_generated")
        same_files = True
        for r in range(n):
            one_dir = join(base, f"one-gen-{r}")
            os.makedirs(one_dir)
            pipe = FusedPipeline(ImageGenerator(
                gan="ffhq", gan_dir=app_cfg.GAN_DIR, batch_size=BATCH,
                seed=r), solver)
            with tf32(torch, False):
                _write_pairs_cv2(pipe, SO_GEN_PER_RANK, one_dir,
                                 r * SO_GEN_PER_RANK, None)
            for name in os.listdir(one_dir):
                with open(join(one_dir, name), "rb") as a, \
                        open(join(dst, name), "rb") as b:
                    same_files = same_files and a.read() == b.read()
            del pipe
        check_later(same_files, "several cards, generate: a process's "
                                "pairs differ from one process's")
        del solver
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    step = [r["deeplab"] for r in ranks]
    log(f"several cards ({n}, NCCL, {ranks_s:.1f} s): decoder fit at global "
        f"batch {n}, SGD, graphed: losses within {fit_dist:.2e} relative of "
        f"one process, weights farthest {worst[0]} by {worst[1]:.3g}, the "
        f"parameters' change within {change:.3g} rel. L2; DeepLab step at 8 a card (global {8 * n}) as replays "
        f"{[round(s['ms'], 3) for s in step]} ms against {one_step['ms']:.3f} "
        f"on one card at 8, NCCL kernels a step "
        f"{[s['nccl_launches'] for s in step]}; runner graphed, ragged "
        f"validation counters equal to one process {counters_equal}; "
        f"generate slices equal to one process by seed {same_files} on "
        f"{smi}")
    return dict(cards=n, processes_s=ranks_s, processes_ended=ended,
                generate_dp=dp, generate_spatial=spatial,
                fit=dict(loss_rel_dist=fit_dist, weights_worst=worst,
                         change_rel_l2=change,
                         launches=[r["fit"]["launches"] for r in ranks]),
                deeplab=dict(per_card=step, one_card={
                    k: one_step[k] for k in ("ms", "launches", "busy_share")}),
                runner=dict(counters_equal=counters_equal,
                            runs=[r["runner"] for r in ranks]),
                generate=dict(files_equal=same_files,
                              launches=[r["generate"] for r in ranks]))


def phase_build(torch):
    """Phase 2: build the kernels (timed) and hold ptxas's report to the
    rules the tensor-core kernels keep: no spill, every Hopper-body kernel
    of entries 1, 2, 6 and 7, every s8 tile ``tc_plan.plan_s8`` can return
    and every tf32 tile ``tc_plan.plan_tf32`` can (entries 3 and 8) and
    ``plan_tf32_in_stats`` (entry 9, with its tap layout kernel), the wide
    Hopper tiles at 168 registers."""
    from gan_segmentation_tpu_torch.kernels import _build, tc_plan

    t0 = time.perf_counter()
    so = _build.build_library()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(so)}")
    regs = {}
    spills = ptxas_report(so + ".ptxas.txt", regs)
    tc = {k: v for k, v in spills.items()
          if "conv3x3_tc" in k or "conv3x3_tf32" in k
          or "conv3x3_sm90" in k or "quantize_s8_kernel" in k
          or "tf32_taps_kernel" in k}
    assert any("conv3x3_tc" in k for k in tc), "no bf16 tensor-core kernel"
    # the bf16 Hopper body, launched by entries 1, 2, 6 and 7; its wide
    # tiles (BN 64, 128) hand registers from the loader warpgroup to the
    # consumers (setmaxnreg 56 / 224), which balances only at the 168
    # registers a thread of __launch_bounds__(384, 1) launches with
    sm90 = {k: v for k, v in regs.items() if "conv3x3_sm90_kernel" in k}
    for entry in "1267":
        assert any(re.search(rf"Li{entry}EEEv", k) for k in sm90), (
            f"no Hopper-body kernel of entry {entry}")
    # the s8 entries 4 and 5: every (BN, MI, CK) tc_plan.plan_s8 can return
    s8_tiles = [(*t, 4 if k1 else 5)
                for k1, tiles in tc_plan.S8_SM90_TILES.items()
                for t in sorted(tiles)]
    missing = [t for t in s8_tiles if not any(re.search(
        r"sm90_kernelILi%dELi%dELi%dELi%dEEEv" % t, k) for k in sm90)]
    assert not missing, f"s8 Hopper-body kernels missing: {missing}"
    # the f32 (3xTF32) entries 3 and 8: every (BN, MI, CK) of
    # tc_plan.TF32_SM90_TILES; entry 9 (kernel 1) every one of
    # tc_plan.TF32_K1_SM90_TILES, and its K-major tap layout
    tf32_tiles = [(*t, k) for k in (3, 8)
                  for t in sorted(tc_plan.TF32_SM90_TILES)]
    tf32_tiles += [(*t, 9) for t in sorted(tc_plan.TF32_K1_SM90_TILES)]
    missing = [t for t in tf32_tiles if not any(re.search(
        r"sm90_kernelILi%dELi%dELi%dELi%dEEEv" % t, k) for k in sm90)]
    assert not missing, f"tf32 Hopper-body kernels missing: {missing}"
    assert any("tf32_taps_kernel" in k for k in tc), "no tf32 tap layout"
    k1_regs = {"/".join(map(str, t[:2])): v for k, v in sm90.items()
               for t in tf32_tiles if t[3] == 9 and re.search(
                   r"sm90_kernelILi%dELi%dELi%dELi%dEEEv" % t, k)}
    wide = {k: v for k, v in sm90.items()
            if re.search(r"sm90_kernelILi(64|128)E", k)}
    assert wide and all(v == 168 for v in wide.values()), (
        f"the wide Hopper-body kernels launch with {set(wide.values())} "
        f"registers, not 168")
    assert any("conv3x3_tf32" in k for k in tc), "no 3xTF32 kernel"
    # the mma.sync s8 body: the tensor-core kernel launched by entry 4 or 5
    n_s8 = sum("conv3x3_tc_kernel" in k and re.search(r"Li[45]EEEv", k)
               is not None for k in tc)
    assert n_s8 > 0, "no mma.sync s8 tensor-core kernel"
    assert any("quantize_s8_kernel" in k for k in tc), "no quantize kernel"
    # the row-band forms: the tensor-core kernels launched by entry 6 or 7
    n_rows = sum(re.search(r"conv3x3_(?:tc|tf32|sm90)_kernel.*Li[67]EEEv",
                           k)
                 is not None for k in tc)
    assert n_rows > 0, "no row-band kernel"
    bad = {k: v for k, v in tc.items() if v != (0, 0)}
    assert not bad, f"tensor-core kernels spill: {bad}"
    log(f"ptxas: {len(tc)} tensor-core and quantize kernels (bf16 "
        f"mma.sync, {len(sm90)} Hopper-body of which "
        f"{len(s8_tiles)} s8 and {len(tf32_tiles)} tf32, 3xTF32, {n_s8} "
        f"mma.sync s8, {n_rows} "
        f"row-band), 0 bytes of spill in each, the wide Hopper tiles at 168 "
        f"registers ({len(wide)}); tf32 Hopper-body registers "
        f"{sorted(v for k, v in sm90.items() if re.search('Li[38]EEEv', k))}"
        f", kernel 1's (entry 9, BN/MI) {k1_regs}; spills "
        f"elsewhere: "
        f"{ {k: v for k, v in spills.items() if v != (0, 0)} or 'none'}")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    try:
        from gan_segmentation_tpu_torch.core.config import (SolverConfig,
                                                            gan_config)
        from gan_segmentation_tpu_torch.kernels import _build  # noqa: F401
    except ImportError as exc:
        sys.exit(f"chip_smoke: run from the repository root ({exc})")

    # 1. device
    marks = [("start", time.perf_counter())]  # seconds per phase, logged
    smi = smi_line()
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, {torch.cuda.device_count()} "
        f"device(s); nvidia-smi: {smi}")
    version = tuple(int(v) for v in re.findall(r"\d+",
                                                torch.__version__)[:2])
    assert version >= (2, 4), (
        f"torch {torch.__version__}: kernels 1 and 2 are torch.library "
        f"custom ops, which need torch 2.4 or later")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    phase_build(torch)

    # 3. kernels
    gcfg, scfg = gan_config("ffhq"), SolverConfig(max_res_log2=10)
    marks.append(("build", time.perf_counter()))
    rec = phase_kernels(torch, gcfg, scfg)
    marks.append(("kernels", time.perf_counter()))

    # 4. generate
    phase_small_reference(torch)
    sl = phase_slice(torch)
    log(f"ffhq 1024^2 generate: {sl['pipeline_sps']:.3f} samples/s "
        f"(device pipeline; generator {sl['gen_ms']:.3f} ms, decoder "
        f"{sl['dec_ms']:.3f} ms per batch), {sl['end_to_end_sps']:.3f} "
        f"samples/s (with the cv2 writer) on {smi}")
    marks.append(("generate", time.perf_counter()))
    og = phase_other_gans(torch)
    marks.append(("cars and bedrooms", time.perf_counter()))
    gg = phase_graph_generate(torch)
    marks.append(("generate as graphs", time.perf_counter()))
    i8 = phase_int8(torch, smi)
    marks.append(("int8", time.perf_counter()))
    sp = phase_spatial(torch, gcfg, scfg, smi)
    marks.append(("spatial", time.perf_counter()))

    # 5. train and evaluate, 5b. the serving export of the trained decoder
    phase_small_train_reference(torch)
    trained = tempfile.mkdtemp()
    try:
        tr = phase_train(torch, trained)
        log(f"ffhq 1024^2 train: {tr['sps']:.3f} samples/s, "
            f"{tr['step_ms']:.3f} ms per step over the fit loop after its "
            f"first epoch (graph replays), {tr['prof']['graph_ms']:.3f} ms "
            f"per step as graph replays and {tr['prof']['step_ms']:.3f} ms "
            f"per eager step by CUDA events; evaluate {tr['metrics']} on "
            f"{smi}")
        marks.append(("train", time.perf_counter()))
        ex = phase_export(torch, trained, smi)
    finally:
        shutil.rmtree(trained, ignore_errors=True)

    # 6. foreign weights, 7. annotation
    marks.append(("export", time.perf_counter()))
    fw = phase_foreign_weights(torch, gcfg, scfg)
    an = phase_annotation(torch)
    marks.append(("foreign weights and annotation", time.perf_counter()))
    log(f"ffhq 1024^2 annotation run: Retrain {an['retrain_s']:.2f} s "
        f"(warm {an['retrain_warm_s']:.2f} s, per-step path "
        f"{an['retrain_eager_s']:.2f} s), "
        f"Generate {an['generate_s']:.2f} s; foreign weights: generator "
        f"loaded in {fw['gen_load_s']:.2f} s, decoder in "
        f"{fw['dec_load_s']:.2f} s on {smi}")

    # 8. deeplab
    dl = phase_deeplab(torch, smi)
    marks.append(("deeplab", time.perf_counter()))
    log(f"deeplab crop {DL_CROP} batch {DL_BATCH}: eval "
        f"{dl['eval_ms']['f32']:.3f} ms (f32) / {dl['eval_ms']['bf16']:.3f} "
        f"ms (bf16) per batch, train {dl['train']['f32']['ms']:.3f} ms (f32) "
        f"/ {dl['train']['bf16']['ms']:.3f} ms (bf16) per step on {smi}")

    # 9. step 5: the DeepLab experiment end to end
    s5 = phase_step5(torch, smi)
    marks.append(("step 5", time.perf_counter()))

    # 10. the closed-loop demo
    demo = phase_demo(torch, smi)
    marks.append(("demo", time.perf_counter()))

    # 11. scale-out: a world of one over NCCL, two processes over gloo
    so = phase_scale_out(torch, smi)
    marks.append(("scale-out", time.perf_counter()))
    log("seconds per phase: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))
    log(f"step 5 at crop 480, batch 8 (f32, cuDNN's TF32 convs): the "
        f"trainer's loop {s5['loop_ms']} ms per step, the feed alone "
        f"{ {k: v['ms'] for k, v in s5['feed'].items()} } ms per batch, "
        f"the bare step "
        f"{s5['bare_step_ms']} ms; test {s5['test_ips']:.3f} images/s "
        f"on {smi}")

    launches = {
        "conv_in_stats": {"generate": sl["launches"]["conv_in_stats"],
                          "collection": tr["collection_launches"]},
        "small_conv": {"generate": sl["launches"]["small_conv"],
                       "train": tr["launches"]["small_conv"],
                       "evaluate": tr["eval_launches"]},
        "bil_conv": {"train": tr["launches"]["bil_conv"]}}
    so_procs = so["processes"]
    for path, counted in (("step5_dataset", s5["launches"]),
                          ("demo", demo["launches"]),
                          ("scale_out_fit", {
                              k: so["decoder_fit"]["launches"][k]
                              for k in ("small_conv", "bil_conv")}),
                          ("scale_out_fit_two_processes", {
                              k: sum(r[k] for r in so_procs["fit"]["launches"])
                              for k in ("small_conv", "bil_conv")}),
                          ("scale_out_generate_dp", {
                              k: so["generate_dp"]["launches"][k]
                              for k in ("conv_in_stats", "small_conv")}),
                          ("scale_out_generate_two_processes", {
                              k: sum(r[k] for r in
                                     so_procs["generate"]["launches"])
                              for k in ("conv_in_stats", "small_conv")}),
                          ("generate_graph_vs_eager", gg["launches"]),
                          ("cars", og["cars"]["launches"]),
                          ("bedrooms", og["bedrooms"]["launches"]),
                          ("foreign_weights", fw["launches"]),
                          ("export", ex["launches"]),
                          ("annotation", an["launches"])):
        for name, n in counted.items():
            assert n > 0, f"{path}: {name} was not launched"
            launches[name][path] = n
    # every main path's launches of kernels 1 and 2 went through the Hopper
    # body (bf16) or the 3xTF32 body (f32); the mma.sync body only where
    # TMA's rules refuse a shape, none of them a path's
    for name in ("conv_in_stats", "small_conv", "conv_in_stats_rows",
                 "small_conv_rows"):
        assert BODY_LAUNCHES.get((name, "sm90"), 0) > 0, (
            f"{name}: no traced launch of the Hopper body")
    # f32: kernel 3's calls on the Hopper body's tf32 form (phase 5 holds
    # a train step's to 37 of 38), kernel 2's evaluate calls too
    for name in ("bil_conv", "small_conv"):
        assert BODY_LAUNCHES.get((name, "sm90_tf32"), 0) > 0, (
            f"{name}: no traced launch of the tf32 Hopper body")

    def by_body(name):
        return {body: n for (k, body), n in sorted(BODY_LAUNCHES.items())
                if k == name}

    # kernel 1 in f32 on entry 9 (phase 5 holds the collection's count)
    k1_f32_launches = BODY_LAUNCHES.get(("conv_in_stats", "sm90_tf32"), 0)
    assert k1_f32_launches > 0, "conv_in_stats: no traced f32 Hopper launch"

    tc_design = ("bf16: the Hopper body (conv3x3_sm90.cuh): one TMA box "
                 "per halo stage into an mbarrier ring filled by a producer "
                 "warp, taps by TMA or resident, wgmma m64nBNk16 (A from "
                 "registers by ldmatrix of the swizzled halo, B by "
                 "descriptor; BN 128 for Cout >= 128), the epilogue from "
                 "the accumulators and y by TMA store, split-K for Cin 512 "
                 "at 4^2-16^2; the mma.sync body (conv3x3_tc.cuh) where "
                 "TMA's rules refuse a shape; f32: 3xTF32 mma.sync m16n8k8 "
                 "implicit "
                 "GEMM fed by a cp.async ring, taps resident or per stage, "
                 "split-K with a fixed-order finish kernel where the items "
                 "are fewer than the SMs (conv3x3_tf32.cuh)")
    tf32_design = ("f32: the Hopper body's 3xTF32 form (conv3x3_sm90.cuh, "
                   "entries 3 and 8): TMA boxes of the f32 halo into the "
                   "mbarrier ring, the block's taps split into resident "
                   "K-major tf32 hi and lo, per k8 step wgmma A_hi [B_hi | "
                   "B_lo] then A_lo B_hi (A by ldmatrix, its lo computed in "
                   "registers), 8-channel blocks on small grids, y from "
                   "registers, where tc_plan.plan_tf32 takes the call; else "
                   "the mma.sync 3xTF32 body (conv3x3_tf32.cuh)")
    k1_design = (tc_design + "; statistics from the accumulators by "
                 "xor-shuffles and per-slot sums in a fixed order, one "
                 "partial per (image, tile); f32 on the Hopper body's "
                 "3xTF32 form (entry 9, the next entry of this line)")
    k1_f32_design = (
        "f32: the Hopper body's 3xTF32 form with kernel 1's epilogue "
        "(conv3x3_sm90.cuh entry 9): TMA boxes of the f32 halo and the "
        "noise into the mbarrier ring, the taps streamed as one TMA box "
        "(16, BN, 2, 9) a stage from a K-major tf32 (hi, lo) layout of w "
        "made by tf32_taps_kernel each call (resident, split by the blocks, "
        "where one wave holds every item), per k8 step wgmma A_hi [B_hi | "
        "B_lo] then A_lo B_hi, split-K within 8 chunks a chain (Cin 512: 4 "
        "splits, 256: 2) with conv3x3_tc.cuh's fixed-order finish, the "
        "halves added, then noise * nscale + bias, leaky and the "
        "statistics' slots from the f32 values, y from registers; where "
        "tc_plan.plan_tf32_in_stats takes the call, else the mma.sync "
        "3xTF32 body (conv3x3_tf32.cuh)")
    sources = {"conv_in_stats": (
        "gan_segmentation_tpu_torch/csrc/conv_in_stats.cu",
        "experiments/pallas_archive/conv_in_stats.py:118", k1_design),
        "small_conv": ("gan_segmentation_tpu_torch/csrc/small_conv.cu",
                       "experiments/pallas_archive/small_conv.py:84",
                       tc_design + "; " + tf32_design
                       + " (csrc/small_conv_f32.cu; Cin > 128 on the "
                       "mma.sync body)"),
        "bil_conv": ("gan_segmentation_tpu_torch/csrc/bil_conv_sm90.cu",
                     "experiments/pallas_archive/bil_conv.py:115",
                     tf32_design + " (csrc/bil_conv.cu, no split); bf16 "
                     "(on no path): FFMA (conv3x3_core.cuh)")}
    kernels = []
    for name, (src, replaces, design) in sources.items():
        r = rec[name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            design=design,
            launches=sum(launches[name].values()),
            launches_by_path=launches[name],
            launches_counted_by="device traces (torch.profiler) of the "
                                "main path's runs")
        entry["traced_launches_by_body"] = by_body(name)
        if name == "bil_conv":  # the train path runs f32
            entry.update(max_abs_err=r["errs"]["f32"],
                         max_abs_err_bf16=r["errs"]["bf16"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"],
                         library_tf32_ms=r["library_tf32_ms"],
                         mma_sync_ms=r["mma_sync_ms"],
                         on_mma_sync_body=r["on_mma_sync_body"],
                         train_launches_by_body=tr["launches_by_body"],
                         accumulator_rounding=r["rounding"],
                         timed="f32, device time (graph replay) per train "
                               "step at batch 1, 38 calls, on the rule's "
                               "body; mma_sync_ms: every call on the "
                               "mma.sync 3xTF32 body on the same inputs; "
                               "bound 3xTF32")
        else:
            dev = r["dev"]
            total, by = summed_bound(dev["bounds"])
            entry.update(max_abs_err=r["errs"]["bf16"],
                         max_abs_err_f32=r["errs"]["f32"],
                         ms=dev["kernel"], plain_ms=dev["plain"],
                         bound_ms=total, bound_by=by,
                         library_ms=dev["library"],
                         mma_sync_ms=dev["mma_sync"],
                         timed="bf16, device time (graph replay) per "
                               "generate batch of 8 on the Hopper body; "
                               "mma_sync_ms: the mma.sync body on the same "
                               "inputs; library: F.conv2d alone, without "
                               "the epilogue")
            if name == "small_conv":
                b1 = r["b1_dev"]
                entry.update(eval_launches_by_body=tr[
                                 "eval_launches_by_body"],
                             eval_sample_ms_f32=b1["kernel"],
                             eval_sample_mma_sync_ms_f32=b1["mma_sync"],
                             eval_sample_plain_ms_f32=b1["plain"],
                             eval_sample_library_ms_f32=b1["library"],
                             eval_sample_bound_ms_f32=summed_bound(
                                 b1["bounds"])[0])
            else:  # the f32 generator's batch of 8 (the collection)
                f32 = r["f32_dev"]
                entry.update(batch_ms_f32=f32["kernel"],
                             batch_plain_ms_f32=f32["plain"],
                             batch_library_ms_f32=f32["library"],
                             batch_mma_sync_ms_f32=f32["mma_sync"])
        kernels.append(entry)
        if name == "conv_in_stats":  # its f32 entry on the Hopper body
            f32 = r["f32_dev"]
            total, by = summed_bound(f32["bounds"])
            kernels.append(dict(
                name="conv_in_stats_f32", route="cuda",
                source="gan_segmentation_tpu_torch/csrc/conv_in_stats_f32.cu",
                replaces="experiments/pallas_archive/conv_in_stats.py:118",
                design=k1_f32_design, launches=k1_f32_launches,
                launches_by_path={"collection": tr[
                    "collection_launches_by_body"].get(
                        "conv_in_stats sm90_tf32", 0)},
                launches_counted_by="device traces (torch.profiler) of the "
                                    "main path's runs: kernel 1's launches "
                                    "of entry 9",
                max_abs_err=r["f32_err"]["rule"],
                mma_sync_max_abs_err=r["f32_err"]["mma_sync"],
                ms=f32["kernel"], plain_ms=f32["plain"], bound_ms=total,
                bound_by=by, library_ms=f32["library"],
                mma_sync_ms=f32["mma_sync"],
                traced_launches_by_body=by_body(name),
                timed="f32, device time (graph replay) per batch of 8 of "
                      "the f32 generator, its 9 calls, on the rule's body; "
                      "mma_sync_ms: every call on the mma.sync 3xTF32 body "
                      "on the same inputs; bound 3xTF32; library: F.conv2d "
                      "alone (TF32 off), without the epilogue"))
    s8_design = ("s8: the Hopper body (conv3x3_sm90.cuh, entries 4 and 5): "
                 "one TMA box of s8 (as u8) per halo stage and the K-major "
                 "tap slice [9][BN][CK] as one box (or resident) into an "
                 "mbarrier ring filled by a producer warp, wgmma m64nBNk32 "
                 "s32 (A from registers by ldmatrix of the swizzled halo, "
                 "B by a K-major descriptor), split-K in exact s32 with a "
                 "fixed-order finish kernel, the epilogue from the "
                 "accumulators: float(acc) * deq (+ bias) rounded step by "
                 "step, y by TMA store; the mma.sync s8 body "
                 "(conv3x3_tc.cuh: m16n8k32 fed by a cp.async ring) where "
                 "TMA's rules refuse a shape (Cin % 16, kernel 1 at W % 4, "
                 "an unaligned view)")
    s8_sources = {
        "conv_in_stats_s8": (
            "gan_segmentation_tpu_torch/csrc/conv_in_stats_s8.cu",
            "experiments/pallas_archive/conv_in_stats.py:118",
            s8_design + "; + noise * nscale, leaky, statistics from the "
            "f32 values"),
        "small_conv_s8": (
            "gan_segmentation_tpu_torch/csrc/small_conv_s8.cu",
            "experiments/pallas_archive/small_conv.py:84",
            s8_design + "; none / relu / leaky; Cout up to 4 x 512 (the "
            "sub-pixel up-sampling convs)"),
        "quantize_s8": (
            "gan_segmentation_tpu_torch/csrc/quantize_s8.cu",
            "gan_segmentation_tpu/ops/quant.py:125",
            "elementwise bf16 / f32 -> s8, 8 elements a thread (16-byte "
            "loads), round half to even, saturating, the scale read from "
            "the device (quantize_act: XLA on the TPU, no Pallas kernel)")}
    for name, (src, replaces, design) in s8_sources.items():
        r = i8["kernels"][name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            design=design, launches=sum(i8["launches"][name].values()),
            launches_by_path=i8["launches"][name],
            launches_counted_by="device traces (torch.profiler) of the "
                                "int8 phase's main-path runs",
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
        if name == "quantize_s8":
            entry.update(exact=r["exact"], calls_per_batch=r["calls"],
                         timed="device time (graph replay) of every "
                               "quantize of an int8-full generate batch of "
                               "8; library: none")
        else:
            entry.update(exact_s32=r["exact"], y_bit_equal=r["equal"],
                         repeats_and_replays=r["repeats"],
                         mma_sync_ms=r["mma_sync_ms"],
                         bf16_body_ms=r["bf16_ms"],
                         traced_launches_by_body=i8[
                             "traced_launches_by_body"][name],
                         shapes_on_hopper_body=r["sm90_shapes"],
                         timed="bf16 out, device time (graph replay) per "
                               "int8-full generate batch of 8 on the Hopper "
                               "body, bound at 1,979 int8 TOPS; "
                               "mma_sync_ms: the mma.sync s8 body on the "
                               "same inputs; library: none (no single "
                               "PyTorch call computes an s8 3x3 conv); "
                               "bf16_body_ms: the bf16 Hopper body on the "
                               "same shapes")
        kernels.append(entry)
    rows_design = ("the bf16 (conv3x3_sm90.cuh; conv3x3_tc.cuh where "
                   "TMA's rules refuse the band) and f32 (conv3x3_tf32.cuh) "
                   "bodies of the full-image kernel over one row band: x "
                   "holds the band's rows and the halo row above and below "
                   "(exchanged by core/spatial.py), the halo box starts at "
                   "the band's first input row, no pad in H; plans for the "
                   "band's output rows")
    rows_sources = {
        "conv_in_stats_rows": (
            "gan_segmentation_tpu_torch/csrc/conv_in_stats_rows.cu",
            "experiments/pallas_archive/conv_in_stats.py:118",
            rows_design + "; the band's sums of v and v^2 per (image, "
            "channel), added over the bands in a fixed order"),
        "small_conv_rows": (
            "gan_segmentation_tpu_torch/csrc/small_conv_rows.cu",
            "experiments/pallas_archive/small_conv.py:84", rows_design)}
    for name, (src, replaces, design) in rows_sources.items():
        k2 = sp["kernels"]["per_batch"][2][name]
        k4 = sp["kernels"]["per_batch"][4][name]
        by_path = sp["launches"][name]
        assert all(n > 0 for n in by_path.values()), (name, by_path)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            design=design, launches=sum(by_path.values()),
            launches_by_path=by_path,
            launches_counted_by="device traces (torch.profiler) of the "
                                "spatial phase's grid pipelines",
            max_abs_err=sp["kernels"]["errs"][name]["bf16"],
            max_abs_err_f32=sp["kernels"]["errs"][name]["f32"],
            ms=k2["kernel"], plain_ms=k2["plain"], bound_ms=k2["bound"],
            bound_by=k2["bound_by"], library_ms=k2["library"],
            mma_sync_ms=k2["mma_sync"],
            n4_ms=k4["kernel"], n4_plain_ms=k4["plain"],
            n4_bound_ms=k4["bound"], n4_library_ms=k4["library"],
            n4_mma_sync_ms=k4["mma_sync"],
            traced_launches_by_body=by_body(name),
            timed="bf16, device time (graph replay) of every band call of "
                  "one spatial batch of 8 at N = 2 (n4_*: N = 4) on the "
                  "Hopper body; mma_sync_ms: the mma.sync body on the "
                  "same bands; library: F.conv2d alone on the same bands "
                  "(padding (0, 1))"))
    prof = tr["prof"]
    print(json.dumps({"graphs": {
        "generate": gg["gans"],
        "train": dict(graph_windows=prof["graph_windows"],
                      eager_windows=prof["windows"],
                      graph_busy_ms=prof["graph_busy_ms"],
                      eager_busy_ms=prof["busy_ms"],
                      graph_ms=prof["graph_ms"],
                      eager_ms=prof["step_ms"], fit_step_ms=tr["step_ms"],
                      fit_s=tr["fit_s"], traced_fit_s=tr["traced_fit_s"],
                      pool_gib=prof["pool_gib"], versus=tr["versus"],
                      mma_sync_tf32=dict(
                          graph_windows=tr["prof_mma_sync"]["graph_windows"],
                          graph_ms=tr["prof_mma_sync"]["graph_ms"],
                          graph_busy_ms=tr["prof_mma_sync"]["graph_busy_ms"],
                          graph_families=tr["prof_mma_sync"][
                              "graph_families"]),
                      graph_families=prof["graph_families"]),
        "retrain_s": {k: an[k] for k in ("retrain_s", "retrain_warm_s",
                                         "retrain_eager_s")}}}), flush=True)
    print(json.dumps({"int8": {k: v for k, v in i8.items()
                               if k != "kernels"}}), flush=True)
    print(json.dumps({"spatial": {k: v for k, v in sp.items()
                                  if k != "launches"}}), flush=True)
    print(json.dumps({"deeplab": dl}), flush=True)
    print(json.dumps({"export": ex}), flush=True)
    print(json.dumps({"step5": {k: v for k, v in s5.items()
                                if k != "losses"}}), flush=True)
    print(json.dumps({"demo": demo}), flush=True)
    print(json.dumps({"scale_out": so}), flush=True)
    if FAILED:
        raise AssertionError("checks failed: " + "; ".join(FAILED))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

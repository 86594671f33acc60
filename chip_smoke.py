#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``gan_segmentation_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device  — requires CUDA; prints torch, the capability, the card's name and
   power limit (nvidia-smi).
2. build   — compiles the CUDA kernels of ``gan_segmentation_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints ptxas's registers and
   spills; every tensor-core kernel (``conv3x3_tc.cuh``, bf16, and
   ``conv3x3_tf32.cuh``, 3xTF32) must spill 0 bytes.
3. kernels — each kernel against its plain PyTorch version, with the error
   and the tolerance, and per call its device time by CUDA-graph replay
   beside the plain version's, ``F.conv2d`` alone (the library call) and
   the floor (bytes once over HBM or operations over the type's peak; f32
   as 3xTF32): kernel 1 at every shape the ffhq 1024^2 generator gives it
   at batch 8, in f32 (TF32 off on the plain side) and bf16, both timed;
   kernel 2 at every decoder conv at batch 8 in f32 and bf16 (bf16 timed)
   and at batch 1 in f32 (evaluate, timed); kernel 3 (bil_conv) in f32 at
   every call of a train step at batch 1 (forward and input gradient),
   timed beside ``F.conv2d`` with TF32 on too, and at its edge cases, with
   bit-identical repeats; kernel 3's bf16 body at generate's 16 -> 16
   convs at batch 8; Conv3x3's output, dX, dW and db against
   torch.autograd at every train shape.  Kernels 1 and 2 run the bf16
   tensor-core kernel in bf16 and the 3xTF32 one in f32; both are also
   checked at their edge cases (4^2 tiles spanning images with Cin 512 and
   split-K, ragged tiles, Cout = 2, Cin = 3, batch 1; kernel 2 with its
   three epilogues, kernel 1 with its statistics) and for bit-identical
   repeats; every f32 path shape that splits K is timed beside one split.
4. generate — ``run_generate`` at ffhq 1024^2, batch 8, 24 pairs, with a
   seeded random generator and a seeded decoder checkpoint; the launch
   counters must show that it went through kernels 1 and 2; a repeated
   batch must be bit-identical; a small slice on the card must agree with
   the same slice on the CPU (plain versions); samples/s beside the
   generator's and the decoder's stage times per batch (CUDA events).
5. train   — three fit steps at res 32 on the card agree with the CPU; then
   ``main train`` and ``main evaluate`` at ffhq 1024^2 with the defaults
   (24 epochs, batch 1, Adam 1e-4, dropout on) on 20 + 4 samples of the
   seeded f32 generator (kernel 1 in f32, 9 launches per batch of 8):
   launch counts per step, falling loss, checkpoint,
   metrics above the untrained decoder's; the fit loop's rate, the step
   time by CUDA events, host vs device time, and the device time by
   kernel family.
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
   family, a step with the batch norm written out beside the fused one.  Loaded weights: a dotted-name DeepLabV3+ file and a
   legacy-name gluoncv backbone file, fabricated in mxnet's format from a
   seeded model, load bit-identically and give the source's eval forward.
9. step 5 — the experiment ``01_hair_deeplabv3_ffhq_pretrain_gan`` through
   the port's runner (``train/rgb_experiments.py::run``), which launches
   no hand-written kernel of its own: ``run_generate`` writes 32 pairs at
   ffhq 1024^2 (phase 4's seeded generator and decoder, cv2 writer) and
   generator seed 1 writes 8 more as the val split (synthetic: the
   repository holds no real annotated data); ``train`` at the spec's crop
   480, base 512, scale factor 0.5, rotate 15, DeepLabV3+ on resnet50, f32
   with cuDNN's TF32 convs, batch 8, 2 epochs of 32 draws, 4 decode
   threads: a validation line and a checkpoint per epoch, finite losses,
   the rates on the poly curve; the trainer's loop ms per step beside the
   feed alone (``batch_iter``, no model) and the bare ``train_step`` on a
   resident batch; a second run stopped by SIGTERM after step 3 (bundle,
   no ``.tmp``, ``try_resume`` restoring weights, momentum, scheduler and
   dropout generator bit-equal) and continued with ``--resume`` to the
   uninterrupted run's step and epoch; ``test`` with flip at test batch 2
   on the sliding-window path (one model call per bucket of 16 windows),
   images/s and both metrics; ``MultiEvalModel`` on the card against the
   CPU (tiny backbone, crop 32, base 48, scales 0.75 and 1.0, TF32 off).

The last lines are the kernels' JSON record (per kernel: launches on the
main path, max error, device ms of the kernel, its plain version and the
library call, and its bound), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

import contextlib
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(path):
    """ptxas -v's report: registers per kernel (printed) and {mangled
    kernel name: (spill store bytes, spill load bytes)}."""
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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, after a warm-up call
    outside the graph.  The host's time per call (the wrappers' ctypes and
    checks, 30-180 us) is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
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


# The card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s
# and operations/s by type.  3xTF32 does three TF32 MMAs per f32 product.
HBM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


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


def library_ms(torch, x, wt, b=None):
    """Device ms (graph replay) of F.conv2d alone on the same NHWC inputs
    (cuDNN, channels-last): the library call beside a conv kernel."""
    xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    bc = None if b is None else b.to(x.dtype)
    return graph_ms(lambda: torch.nn.functional.conv2d(xc, wc, bc, padding=1))


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
    return (f"  device: kernel {times['kernel']:.4f} ms, plain "
            f"{times['plain']:.4f}, F.conv2d {times['library']:.4f}; floor "
            f"{floor[0]:.4f} ({floor[1]}), share "
            f"{floor[0] / times['kernel']:.3f}")


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
    from gan_segmentation_tpu_torch.kernels.tc_plan import plan_f32

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    inputs = conv_inputs(torch, g)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rec = {}

    # kernel 1
    errs = {"f32": 0.0, "bf16": 0.0}
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
            add_times(dev_t[tag], times, floor)
            if tag == "f32":
                line += (f" splits "
                         f"{plan_f32(n, h, w, cin, cout, stats=True).splits}")
            log(line + ";" + times_line(times, floor))
        del x32, w32, x, wt, y, yp
    rec["conv_in_stats"] = dict(errs=errs, dev=dev_t["bf16"],
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
                floor = bound(*conv_floors(n, h, w, cin, cout, 2, 4 * cout),
                              PEAK["bf16"])
                add_times(dev_t, times, floor)
                line += ";" + times_line(times, floor)
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
        torch.cuda.synchronize()
        name = f"small_conv f32 {cname} {(n, h, w, cin, cout)}"
        check_close(name, y, yp, **TOL["f32"])
        b1_err = max(b1_err, max_err(y, yp))
        times = device_times(
            torch, lambda: k2m.conv3x3_small(x, wt, b, **kw),
            lambda: k2m.conv3x3_small_plain(x, wt, b, **kw), x, wt, b)
        nbytes, flop = conv_floors(n, h, w, cin, cout, 4, 4 * cout)
        floor = bound(nbytes, 3 * flop, PEAK["tf32"])
        add_times(b1_dev, times, floor)
        log(f"  {name}: max|err| {max_err(y, yp):.3g} (tol {TOL['f32']});"
            + times_line(times, floor)
            + f"; splits {plan_f32(n, h, w, cin, cout).splits}")
        del x, wt, y, yp
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
            f"{r['dev']['kernel']:.3f} ms, plain {r['dev']['plain']:.3f}, "
            f"F.conv2d {r['dev']['library']:.3f}, floor {fl[0]:.3f} "
            f"({fl[1]})")
    k1_f32 = rec["conv_in_stats"]["f32_dev"]
    fl = summed_bound(k1_f32["bounds"])
    log(f"conv_in_stats: f32 per batch of 8 over the path's 9 shapes, device "
        f"time (graph replay): kernel {k1_f32['kernel']:.3f} ms, plain "
        f"{k1_f32['plain']:.3f}, F.conv2d {k1_f32['library']:.3f}, floor "
        f"{fl[0]:.3f} ({fl[1]}, 3xTF32), share "
        f"{fl[0] / k1_f32['kernel']:.3f}")
    fl = summed_bound(b1_dev["bounds"])
    log(f"small_conv: f32 per evaluate sample (batch 1, its 26 convs), "
        f"device time (graph replay): kernel {b1_dev['kernel']:.3f} ms, "
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
    """Every f32 path shape of kernels 1 and 2 whose plan splits K: device
    time (graph replay) with the plan's split beside the same body with one
    split (the plan function swapped for that launch only), so that the
    record shows where the split wins and what the chain cap costs."""
    import functools
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
        planned = graph_ms(call)
        one = functools.partial(tc_plan.plan_f32, splits=1)
        _build._tc_plan_c.cache_clear()
        try:
            with mock.patch.object(tc_plan, "plan_f32", one):
                unsplit = graph_ms(call)
        finally:
            _build._tc_plan_c.cache_clear()
        log(f"  split-K {kernel} f32 {(n, h, w, cin, cout)}: {p.splits} "
            f"splits of {p.cps} chunks, {p.blocks} blocks: {planned:.4f} ms; "
            f"one split, {p.blocks // p.splits} blocks: {unsplit:.4f} ms")
        del x, wt


# Edge cases of the tensor-core kernels (n, h, w, cin, cout), run in bf16
# and f32: 4^2 tiles spanning images with Cin 512 (split-K), ragged 12 x 20
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


def phase_tc_edges(torch, g, inputs):
    """Kernels 1 and 2 in bf16 and f32 at the tensor-core kernels' edge
    cases, against the plain versions: kernel 1's y and statistics, kernel 2
    with its three epilogues, and a repeat of each call bit-identical."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        worst = 0.0
        shapes = TC_EDGES + (F32_EDGES if tag == "f32" else [])
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
            check_close(name + " conv_in_stats y", got[0], want[0],
                        **TOL[tag])
            for what, a, r in zip(("mean", "var"), got[1:], want[1:]):
                check_close(f"{name} conv_in_stats {what}", a, r,
                            **STAT_TOL[tag])
            assert all(torch.equal(a, r) for a, r in zip(got, again)), \
                name + ": conv_in_stats repeat differs"
            err = max_err(got[0], want[0])
            for kw in (dict(leaky=0.2), dict(relu=True), {}):
                ys = k2m.conv3x3_small(x, wt, b, **kw)
                ysp = k2m.conv3x3_small_plain(x, wt, b, **kw)
                torch.cuda.synchronize()
                check_close(f"{name} small_conv {kw}", ys, ysp, **TOL[tag])
                assert torch.equal(ys, k2m.conv3x3_small(x, wt, b, **kw)), \
                    name + ": small_conv repeat differs"
                err = max(err, max_err(ys, ysp))
            worst = max(worst, err)
            log(f"  {name}: max|y err| {err:.3g} (tol {TOL[tag]}, stats "
                f"{STAT_TOL[tag]}), repeats bit-identical")
        log(f"tensor-core edge cases {tag}: {len(shapes)} shapes, kernel 1 "
            f"with statistics and kernel 2 x 3 epilogues, max |err| "
            f"{worst:.3g}")


def phase_annotation_shapes(torch, gcfg, scfg, g, inputs):
    """Kernels 1 and 2 in bf16 at every ffhq path shape at the annotation
    run's batch (its sampler and Generate run ANN_BATCH images at a time, and
    the launch plan depends on the batch), against the plain versions."""
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.kernels.tc_plan import plan

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
        if plan(n, h, w, cin, cout, True).splits > 1:
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
        if plan(n, h, w, cin, cout, False).splits > 1:
            split.append((n, h, w, cin, cout))
        del x, wt, y, yp
    log(f"annotation run's shapes (bf16, batch {ANN_BATCH}): kernel 1 at "
        f"{len(kernel1_shapes(gcfg))} and kernel 2 at "
        f"{len(kernel2_shapes(scfg))} ffhq shapes against the plain "
        f"versions, max|y err| {worst} (tol {TOL['bf16']}, stats "
        f"{STAT_TOL['bf16']}); split-K at {split}")


def phase_bil(torch, scfg, g, inputs):
    """Kernel 3 in f32 (the 3xTF32 tensor-core body) at every call of a
    train step (batch 1, forward and input gradient): against its plain
    version, a repeat bit-identical, and device time by graph replay beside
    F.conv2d with TF32 off (the library call) and on, and plain, with the
    call's floors; then the edge cases, and the bf16 body (FFMA, on no path)
    at generate's design case."""
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    err = 0.0
    tot = {}
    floors = {"hbm": 0.0, "tf32x3": 0.0, "ffma": 0.0}
    bounds, losses = [], []
    for (label, n, h, w, cin, cout, bias) in bil_shapes(scfg):
        x, wt = inputs(n, h, w, cin, cout)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        args = (x, wt, b) if bias else (x, wt)
        y = k3m.conv3x3_bil(*args)
        yp = k3m.conv3x3_bil_plain(*args)
        ys = k2m.conv3x3_small(*args)
        again = k3m.conv3x3_bil(*args)
        torch.cuda.synchronize()
        name = f"bil_conv f32 {label} {(n, h, w, cin, cout)}"
        check_close(name, y, yp, **TOL["f32"])
        check_close(f"small_conv f32 {label}", ys, yp, **TOL["f32"])
        assert torch.equal(y, again), name + ": repeat differs"
        err = max(err, max_err(y, yp))
        times = device_times(torch, lambda: k3m.conv3x3_bil(*args),
                             lambda: k3m.conv3x3_bil_plain(*args), *args)
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
        log(f"  {name}: max|err| {max_err(y, yp):.3g} (tol {TOL['f32']}), "
            f"repeat bit-identical; device ms: kernel {times['kernel']:.4f}, "
            f"F.conv2d "
            f"{times['library']:.4f} (TF32 on {times['library_tf32']:.4f}), "
            f"plain {times['plain']:.4f}; floor {floor[0]:.4f} ({floor[1]}, "
            f"3xTF32), share {floor[0] / times['kernel']:.3f}")
        del x, wt, y, yp, ys, again
    n_calls = len(bil_shapes(scfg))
    log(f"bil_conv: f32 per train step over its {n_calls} calls, device "
        f"time (graph replay): kernel {tot['kernel']:.3f} ms, F.conv2d "
        f"TF32 off "
        f"{tot['library']:.3f}, TF32 on {tot['library_tf32']:.3f}, plain "
        f"{tot['plain']:.3f}; floors: HBM {floors['hbm']:.3f}, 3xTF32 "
        f"{floors['tf32x3']:.3f} (share "
        f"{floors['tf32x3'] / tot['kernel']:.3f}), "
        f"FFMA {floors['ffma']:.3f}; max abs err {err:.3g}; slower than "
        f"F.conv2d TF32 off at: {', '.join(losses) or 'none'}")

    edge_err = 0.0
    for (n, h, w, cin, cout) in k3m.EDGE_SHAPES:
        x, wt = inputs(n, h, w, cin, cout)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        for kw in ({}, dict(leaky=0.2), dict(relu=True)):
            got = k3m.conv3x3_bil(x, wt, b, **kw)
            again = k3m.conv3x3_bil(x, wt, b, **kw)
            want = k3m.conv3x3_bil_plain(x, wt, b, **kw)
            torch.cuda.synchronize()
            name = f"bil_conv f32 edge {(n, h, w, cin, cout)} {kw}"
            check_close(name, got, want, **TOL["f32"])
            assert torch.equal(got, again), name + ": repeat differs"
            edge_err = max(edge_err, max_err(got, want))
        del x, wt, got, again, want
    log(f"bil_conv f32 edge cases: {len(k3m.EDGE_SHAPES)} shapes x 3 "
        f"epilogues, "
        f"max |err| {edge_err:.3g} (tol {TOL['f32']}), repeats bit-identical")

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
                ms=tot["kernel"], plain_ms=tot["plain"],
                library_ms=tot["library"],
                library_tf32_ms=tot["library_tf32"], bound_ms=total,
                bound_by=by)


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
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
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

        k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
        k2m.conv3x3_small.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cv2 is not None:
            run_generate(cfg, writer="cv2")
        else:
            log("no host encoder on this machine (cv2 missing, the native "
                "writer is not used here): checking generate_batches instead")
            solver = SegSolver(cfg.max_res_log2, "",
                               os.path.join(base, "checkpoints"),
                               cfg=cfg.solver_config())
            pipe = FusedPipeline(ImageGenerator(
                gan="ffhq", gan_dir=cfg.GAN_DIR, batch_size=BATCH), solver)
            batches = list(pipe.generate_batches(GENERATE_NUM))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n1 = k1m.conv3x3_noise_bias_lrelu_instats.launches
        n2 = k2m.conv3x3_small.launches
        log(f"slice launches: conv_in_stats {n1}, small_conv {n2} "
            f"({n_batches} batches)")
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
            f"end including the cv2 writer ({wall:.2f} s)")

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

        for _ in pipe.generate_batches(BATCH):  # warm-up
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in pipe.generate_batches(GENERATE_NUM):
            pass
        rate = GENERATE_NUM / (time.perf_counter() - t0)
        log(f"device pipeline (generate_batches, no writer): {rate:.3f} "
            f"samples/s at 1024^2, batch {BATCH}; stages per batch (CUDA "
            f"events, 5 batches): generator {gen_ms:.3f} ms, decoder "
            f"{dec_ms:.3f} ms")
    return dict(launches={"conv_in_stats": n1, "small_conv": n2},
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


def profile_train_step(torch, base, scfg, steps=5):
    """A train step at ffhq 1024^2, batch 1: its time (CUDA events over 10
    steps), whether the host or the device bounds it (three windows of 10
    steps: wall time, the time the host took to enqueue them, and the
    process's CPU time), and its device time by kernel family
    (torch.profiler)."""
    from torch.autograd import DeviceType
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
    by_name = {}
    for evt in prof.events():
        # kernels only: user ranges such as "Optimizer.step#Adam.step" also
        # sit on the device timeline and overlap the kernels they enclose
        annotation = (getattr(evt, "is_user_annotation", False)
                      or evt.name.startswith("Optimizer."))
        if evt.device_type == DeviceType.CUDA and not annotation:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)

    def family(name):
        low = name.lower()
        # the 3xTF32 kernels carry their kernel's number as the last
        # template argument; only kernels 1 and 2 split K (finish kernel)
        tf32 = re.search(r"conv3x3_tf32_kernel<[^>]*,\s*(\d)>", name)
        if tf32:
            return {"1": "conv_in_stats", "2": "small_conv",
                    "3": "bil_conv"}[tf32.group(1)]
        if "conv3x3_tf32_finish" in low:
            return "small_conv"
        if "conv3x3_bil" in low:
            return "bil_conv"
        if "wgrad" in low:
            return "cuDNN wgrad"
        if any(k in low for k in ("conv", "gemm", "xmma", "cudnn",
                                  "cutlass")):
            return "cuDNN other"
        return "elementwise + reductions (BN, leaky, dropout, loss, Adam)"

    fam = {}
    for name, t in by_name.items():
        fam[family(name)] = fam.get(family(name), 0.0) + t / steps
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
    return dict(step_ms=step_ms, windows=windows, families=fam, busy_ms=busy)


def phase_train(torch):
    """``main train`` then ``main evaluate`` at ffhq 1024^2 with the
    defaults (24 epochs, batch 1, Adam 1e-4, dropout on) on a collection
    of the port's seeded generator; launch counts, falling loss,
    checkpoint, metrics, and mean-iou above the untrained decoder's."""
    import contextlib
    import io
    import math

    from gan_segmentation_tpu_torch.apps.main import main as cli
    from gan_segmentation_tpu_torch.core.config import load_config_file
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.train.generator import ImageGenerator
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    with tempfile.TemporaryDirectory() as base:
        free = shutil.disk_usage(base).free / 2 ** 30
        k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
        t0 = time.perf_counter()
        gen = ImageGenerator(gan="ffhq", batch_size=BATCH, dtype="fp32",
                             gan_dir=join(base, "no-models"), seed=0)
        make_collection(gen, join(base, "data"), TRAIN_SAMPLES)
        # eval: the same generator, the next z of its stream
        make_collection(gen, join(base, "eval"), EVAL_SAMPLES)
        del gen
        torch.cuda.empty_cache()
        n_k1 = k1m.conv3x3_noise_bias_lrelu_instats.launches
        batches = -(-TRAIN_SAMPLES // BATCH) + -(-EVAL_SAMPLES // BATCH)
        log(f"train collection: {TRAIN_SAMPLES} + {EVAL_SAMPLES} ffhq 1024^2 "
            f"samples (f32 pyramids) written in "
            f"{time.perf_counter() - t0:.1f} s ({free:.1f} GiB free before); "
            f"conv_in_stats (f32) launches {n_k1} over {batches} batches of "
            f"{BATCH}")
        assert n_k1 == 9 * batches, "conv_in_stats must run 9x per batch"
        config = join(base, "config.yml")
        with open(config, "w") as fh:
            fh.write(f"BASE_DIR: {base}\nGAN: ffhq\n"
                     f"GAN_DIR: {join(base, 'no-models')}\n")
        scfg = load_config_file(config).solver_config()
        steps = scfg.train_epochs * (TRAIN_SAMPLES // scfg.train_batch_size)

        k3m.conv3x3_bil.launches = 0
        k2m.conv3x3_small.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with LogLines("gan_segmentation_tpu_torch.train.solver") as lines:
            cli(["train", "--config", config])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_bil, n_small = k3m.conv3x3_bil.launches, k2m.conv3x3_small.launches
        log(f"train launches: bil_conv {n_bil}, small_conv {n_small} over "
            f"{steps} steps (expected {BIL_PER_STEP} and {SMALL_PER_STEP} "
            f"per step)")
        assert n_bil == BIL_PER_STEP * steps, n_bil
        assert n_small == SMALL_PER_STEP * steps, n_small
        epoch_loss = lines.floats("Train-total-loss")
        epoch_acc = lines.floats("Train-accuracy")
        cost = lines.floats("Time cost")
        assert len(epoch_loss) == scfg.train_epochs, epoch_loss
        assert all(math.isfinite(v) for v in epoch_loss), epoch_loss
        assert epoch_loss[-1] < epoch_loss[0], epoch_loss
        ckpt = join(base, "checkpoints", "checkpoint_last.pt")
        assert os.path.isfile(ckpt), "no checkpoint written"
        # the fit loop's rate: every step after the first epoch over the
        # wall time of those epochs (each epoch's log line follows a sync)
        later = sorted(cost[1:])
        fit_steps = len(later) * TRAIN_SAMPLES
        fit_s = sum(later)
        log(f"train: epoch loss {epoch_loss[0]:.4f} -> {epoch_loss[-1]:.4f}, "
            f"accuracy {epoch_acc[0]:.4f} -> {epoch_acc[-1]:.4f}; "
            f"{fit_steps / fit_s:.3f} train samples/s, "
            f"{fit_s / fit_steps * 1e3:.3f} ms per step ({fit_steps} steps "
            f"of epochs 2-{len(cost)} in {fit_s:.3f} s; epoch times min "
            f"{later[0]:.3f} median {later[len(later) // 2]:.3f} max "
            f"{later[-1]:.3f} s), first epoch {cost[0]:.2f} s, "
            f"whole run {wall:.1f} s including the collection's load; "
            f"checkpoint {os.path.basename(ckpt)}")
        train_launches = {"bil_conv": n_bil, "small_conv": n_small}

        k3m.conv3x3_bil.launches = 0
        k2m.conv3x3_small.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli(["evaluate", "--config", config])
        n_eval = k2m.conv3x3_small.launches
        line = out.getvalue().strip().splitlines()[-1]
        log(f"evaluate prints: {line}")
        metrics = dict(kv.split(": ") for kv in line.split(", "))
        assert list(metrics) == ["accuracy", "mean-iou", "total-loss"], line
        metrics = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in metrics.values()), metrics
        assert n_eval == SMALL_PER_EVAL_SAMPLE * EVAL_SAMPLES, n_eval
        assert k3m.conv3x3_bil.launches == 0

        untrained = SegSolver(scfg.max_res_log2, "",
                              join(base, "no-checkpoints"), cfg=scfg)
        assert not untrained.is_trained
        before = dict(untrained.evaluate(join(base, "eval")))
        log(f"untrained decoder on the same eval set: mean-iou "
            f"{before['mean-iou']:.4f}, accuracy {before['accuracy']:.4f}")
        assert metrics["mean-iou"] > before["mean-iou"], (metrics, before)
        prof = profile_train_step(torch, base, scfg)
    return dict(launches=train_launches, eval_launches=n_eval,
                collection_launches=n_k1, steps=steps, step_ms=fit_s / fit_steps * 1e3,
                sps=fit_steps / fit_s, metrics=metrics, prof=prof)


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

            k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
            k2m.conv3x3_small.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_generate(cfg, writer="cv2")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n1 = k1m.conv3x3_noise_bias_lrelu_instats.launches
            n2 = k2m.conv3x3_small.launches
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
            for _ in pipe.generate_batches(BATCH):  # warm-up
                pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in pipe.generate_batches(OTHER_RATE_NUM):
                pass
            rate = OTHER_RATE_NUM / (time.perf_counter() - t0)

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
                f"{BATCH}: launches conv_in_stats {n1}, small_conv {n2} "
                f"({n_convs} convs x {n_batches} batches); "
                f"{rate:.3f} samples/s (device pipeline, "
                f"{OTHER_RATE_NUM} samples), "
                f"{OTHER_NUM / wall:.3f} samples/s end to end with the cv2 "
                f"writer and the first launches ({wall:.2f} s) on {smi}; "
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
            out[gan] = dict(launches={"conv_in_stats": n1, "small_conv": n2},
                            pipeline_sps=rate)
            del gen32, pipe, solver, img_k, img_p, logit_k, logit_p
            torch.cuda.empty_cache()
    return out


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
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
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
        k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
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
        img_a, feats_a, z_a = loaded.sample_batch()
        img_b, feats_b, z_b = want.sample_batch()
        torch.cuda.synchronize()
        n1 = k1m.conv3x3_noise_bias_lrelu_instats.launches
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
        k2m.conv3x3_small.launches = 0
        got, ref = solver.predict_logits(feats), source.predict_logits(feats)
        torch.cuda.synchronize()
        n2 = k2m.conv3x3_small.launches
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
                    epochs=2, max_res_log2=None, counts=None):
    """A whole annotation run through ``SegmentationAnnotator``'s own
    handlers under the tk stub: ``n_images`` annotations (a drag sets
    ``has_changes``; the trimap the handlers save is the sign of channel 0
    of the sample's last feature, top two rows ignored, in place of the
    rasterized strokes, so that the decoder can learn it), the last one
    saved by Retrain itself, Retrain of ``epochs`` epochs with its preview,
    one more image (now with a predicted mask), Generate of ``n_generate``
    pairs.  Asserts what the run must show and returns what it saw;
    ``counts()`` is read after each stage into ``marks``."""
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

        # a pipeline built before Retrain must see the new weights after it
        reused = FusedPipeline(a.netG, a.solver)
        before = reused._prepared()
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
        for b in (a.ok_btn, a.skip_btn, a.retrain_btn, a.generate_btn):
            assert b.state == "normal"
        device = a.solver.device
        del a, reused

    # Generate's masks are those of a fresh pipeline on the saved
    # checkpoint at the same place of the same seeded stream
    dst = join(root_dir, "dataset", "train_generated")
    gen = ImageGenerator(gan=gan, gan_dir=gan_dir, batch_size=batch,
                         max_res_log2=max_res_log2, device=device)
    gen.skip_batches(consumed)
    solver = short_solver(gen.cfg.max_res_log2, data,
                          join(root_dir, "checkpoints"), device=device)
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
                generate_s=generate_s, res=res,
                mask_share=ones / (n_generate * res * res))


ANN_BATCH = 2        # gan_batch_size of the run
ANN_IMAGES = 6
ANN_EPOCHS = 2
ANN_GENERATE = 16


def phase_annotation(torch):
    """The annotation run at ffhq 1024^2 on the card (see
    ``drive_annotator``), with the kernels' launch counts per stage."""
    from gan_segmentation_tpu_torch.kernels import bil_conv as k3m
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    wrappers = {"conv_in_stats": k1m.conv3x3_noise_bias_lrelu_instats,
                "small_conv": k2m.conv3x3_small, "bil_conv": k3m.conv3x3_bil}
    for fn in wrappers.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as base, LogLines(
            "gan_segmentation_tpu_torch.train.solver") as lines:
        seen = drive_annotator(
            base, "ffhq", join(base, "no-models"), ANN_BATCH, ANN_IMAGES,
            ANN_GENERATE, epochs=ANN_EPOCHS,
            counts=lambda: {k: fn.launches for k, fn in wrappers.items()})
    epoch_s = lines.floats("Time cost")
    assert len(epoch_s) == ANN_EPOCHS, epoch_s
    total = {k: fn.launches for k, fn in wrappers.items()}
    m = seen["marks"]
    steps = ANN_EPOCHS * ANN_IMAGES
    # the sampler: one batch of ANN_BATCH per two images shown, kernel 1
    # nine times a batch; no decoder before Retrain
    assert m["constructed"] == {"conv_in_stats": 9, "small_conv": 0,
                                "bil_conv": 0}, m
    assert m["annotated"]["conv_in_stats"] == 9 * -(-ANN_IMAGES // 2), m
    assert m["annotated"]["small_conv"] == m["annotated"]["bil_conv"] == 0, m
    # Retrain: kernels 3 and 2 in every step, kernel 2 in each epoch's
    # preview and in the predict of the check after it
    assert m["retrained"]["bil_conv"] == BIL_PER_STEP * steps, m
    assert (m["retrained"]["small_conv"] == SMALL_PER_STEP * steps
            + SMALL_PER_EVAL_SAMPLE * ANN_EPOCHS), m
    assert m["retrained"]["conv_in_stats"] == m["annotated"]["conv_in_stats"]
    # predict for the next image (and the check's own predict before it)
    assert (m["predicted"]["small_conv"] - m["retrained"]["small_conv"]
            == 2 * SMALL_PER_EVAL_SAMPLE), m
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
        f"took {' + '.join(f'{t:.3f}' for t in epoch_s)} s and the rest is "
        f"the last annotation's save, the collection's load and upload, "
        f"the previews and the checkpoint; epoch loss "
        f"{sum(hist[0]) / len(hist[0]):.4f} -> "
        f"{sum(hist[-1]) / len(hist[-1]):.4f}, last preview = predict; "
        f"Generate {ANN_GENERATE} pairs {seen['generate_s']:.2f} s "
        f"({ANN_GENERATE / seen['generate_s']:.3f} samples/s with the cv2 "
        f"writer), masks equal a fresh pipeline's on the saved checkpoint "
        f"(class 1 on {seen['mask_share']:.4f} of the pixels), the pipeline "
        f"built before Retrain refolded; launches by stage {m} on {smi}")
    return dict(launches=total, retrain_s=seen["retrain_s"],
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


def deeplab_profile(torch, model, state, images, masks, dtype, steps=3):
    """Where a full-width train step's time goes: wall time against the
    host's time to enqueue 10 steps, and the device time of ``steps`` profiled
    steps by kernel family (torch.profiler)."""
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
    enqueued = time.perf_counter()
    torch.cuda.synchronize()
    wall_ms, host_ms = ((time.perf_counter() - t0) * 100,
                        (enqueued - t0) * 100)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name, launches, fam = kernel_families(prof, steps)
    busy = sum(fam.values())
    log(f"deeplab train step {str(dtype).split('.')[1]}: wall {wall_ms:.3f} "
        f"ms per step over 10 steps, host enqueue {host_ms:.3f} ms; device "
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

    by_name, launches = {}, 0
    for evt in prof.events():
        annotation = (getattr(evt, "is_user_annotation", False)
                      or evt.name.startswith("Optimizer."))
        if evt.device_type == DeviceType.CUDA and not annotation:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
            launches += 1

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

    fam = {}
    for name, t in by_name.items():
        fam[family(name)] = fam.get(family(name), 0.0) + t / steps
    return by_name, launches, fam


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

    # the batch norm written out (the decoder's form) beside the fused one
    fused = resnet.batch_norm
    resnet.batch_norm = lambda x, bn, train: (
        batch_norm_train(x, bn) if train else fused(x, bn, False))
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
        train_plain_bn=plain, card=smi)


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
# resnet50), cut to 2 epochs of 32 draws from 32 generated pairs.
# ``tests/test_torch_experiment_cli.py`` rehearses the phase on the CPU with
# a smaller ``STEP5``.
STEP5 = dict(exp="01_hair_deeplabv3_ffhq_pretrain_gan", gan="ffhq",
             res_log2=None, gen_batch=BATCH, n_train=32, n_val=8, batch=8,
             epochs=2, epoch_len=32, workers=4, test_batch=2,
             preempt_after=3, feed_draws=64, bare_steps=5, overrides=[],
             eval_check=dict(crop=32, base=48, scales=(0.75, 1.0),
                             hw=(40, 56), images=2))


class StepProbe:
    """Stands in for ``deeplab_trainer.train_step`` while a run is driven:
    the host clock at each call, the rates before it and its loss; after
    ``stop_after`` steps it sends SIGTERM to this process, the signal a
    preemption notice brings."""

    def __init__(self, dt, stop_after=None):
        self.dt, self.train_step = dt, dt.train_step
        self.stop_after = stop_after
        self.starts, self.rates, self.losses = [], [], []

    def __enter__(self):
        self.dt.train_step = self
        return self

    def __exit__(self, *exc):
        self.dt.train_step = self.train_step

    def __call__(self, model, optimizer, scheduler, *args, **kwargs):
        import signal
        self.starts.append(time.perf_counter())
        self.rates.append([g["lr"] for g in optimizer.param_groups])
        out = self.train_step(model, optimizer, scheduler, *args, **kwargs)
        self.losses.append(out[0])
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


def step5_feed_and_bare_step(torch, trainer, args, spec, conf):
    """(samples/s of ``batch_iter`` alone over the train set with
    ``workers`` decode threads, no model; wall ms per ``train_step`` on one
    resident batch, the trainer's model, optimizer and dtype)."""
    import dataclasses

    from gan_segmentation_tpu_torch.train import deeplab_trainer as dt
    from gan_segmentation_tpu_torch.train.rgb_experiments import datasets

    feedset, _ = datasets(args, dataclasses.replace(
        spec, train_epoch_len=conf["feed_draws"]))
    n = 0
    t0 = time.perf_counter()
    for imgs, masks, _ in dt.batch_iter(feedset, conf["batch"], True, 0,
                                        decode_workers=conf["workers"]):
        n += len(imgs)
    feed_sps = n / (time.perf_counter() - t0)
    images, _ = trainer._inputs(imgs)
    labels = trainer._upload(trainer._feed(masks, feedset.num_class))
    kw = dict(aux_weight=trainer.aux_weight, dtype=trainer.compute_dtype)
    dt.train_step(trainer.model, trainer.optimizer, trainer.scheduler,
                  images, labels, trainer.generator, **kw)
    _sync(torch, trainer.device)
    t0 = time.perf_counter()
    for _ in range(conf["bare_steps"]):
        dt.train_step(trainer.model, trainer.optimizer, trainer.scheduler,
                      images, labels, trainer.generator, **kw)
    _sync(torch, trainer.device)
    return feed_sps, (time.perf_counter() - t0) * 1e3 / conf["bare_steps"]


def step5_profile(torch, trainer, dt, conf, smi):
    """One more epoch of the trainer under ``torch.profiler`` (the feed,
    the steps, the loss pulls; not the epoch's checkpoint, whose 167 MB
    pull to the host is no part of a step): ms per step of the loop, device
    kernel time per step by family, the device's busy share of the loop.
    Profiled on the card only."""
    if torch.device(conf["device"]).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    per = conf["epoch_len"] // conf["batch"]
    trainer.save_checkpoint = lambda: None  # shadows the method
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                StepProbe(dt) as probe:
            trainer.training(conf["epochs"])
            torch.cuda.synchronize()
    finally:
        del trainer.save_checkpoint
    gaps = [(b - a) * 1e3 for a, b in zip(probe.starts, probe.starts[1:])]
    loop_ms = sum(gaps) / len(gaps)
    by_name, launches, fam = kernel_families(prof, per)
    busy = sum(fam.values())
    log(f"step 5 trainer profiled (one more epoch, {per} steps): loop "
        f"{loop_ms:.3f} ms per step (profiler on), device kernel time "
        f"{busy:.3f} ms per step in {launches // per} launches, busy share "
        f"{busy / loop_ms:.3f} on {smi}")
    for name, t in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {t:.3f} ms/step ({t / busy:.3f} of device time)")
    return dict(loop_ms=loop_ms, busy_ms=busy, busy_share=busy / loop_ms,
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
        lrs=[g["lr"] for g in opt["param_groups"]],
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

    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m
    from gan_segmentation_tpu_torch.train import deeplab_trainer as dt
    from gan_segmentation_tpu_torch.train import rgb_experiments as rx

    conf = dict(STEP5, **(conf or {}))
    device = conf.setdefault("device", "cuda")
    spec = rx.SPECS[conf["exp"]]
    t_phase = time.perf_counter()
    rec = {}
    with tempfile.TemporaryDirectory() as base:
        k1m.conv3x3_noise_bias_lrelu_instats.launches = 0
        k2m.conv3x3_small.launches = 0
        dataset, rec["dataset_s"] = write_step5_dataset(torch, base, conf)
        rec["launches"] = {
            "conv_in_stats": k1m.conv3x3_noise_bias_lrelu_instats.launches,
            "small_conv": k2m.conv3x3_small.launches}
        log(f"step 5 dataset: {conf['n_train']} pairs from run_generate "
            f"(cv2 writer) in dataset/train_generated and {conf['n_val']} "
            f"from generator seed 1 in dataset/val, {rec['dataset_s']:.2f} "
            f"s, launches {rec['launches']}; the val split is synthetic too "
            f"(the repository holds no real annotated data)")
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
            rec["loop_ms"] = sorted(gaps)[len(gaps) // 2]
            rec["loop_ms_all"] = gaps
            rec["losses"] = losses
            rec["validation"] = vals
            rec["profile"] = step5_profile(torch, trainer, dt, conf, smi)
            args = types.SimpleNamespace(input_path=dataset, reader="cv2")
            rec["feed_sps"], rec["bare_step_ms"] = step5_feed_and_bare_step(
                torch, trainer, args, rx.apply_overrides(
                    spec, trainer.args), conf)
            del trainer
            log(f"step 5 train: {steps} steps in {conf['epochs']} epochs, "
                f"losses {[round(v, 4) for v in losses]}, rates on the poly "
                f"curve, {len(vals)} validation lines ({vals[-1]}), "
                f"last_checkpoint.pt each epoch; run {rec['train_run_s']:.2f}"
                f" s (model build and checkpoints included) on {smi}")
            log(f"step 5 pace: the trainer's loop {rec['loop_ms']:.3f} ms "
                f"per step (median of {len(gaps)} gaps between step starts "
                f"within an epoch: {[round(g, 1) for g in gaps]}); the feed "
                f"alone (batch_iter, {conf['workers']} decode threads, no "
                f"model) {rec['feed_sps']:.2f} samples/s = "
                f"{conf['batch'] * 1e3 / rec['feed_sps']:.3f} ms per batch "
                f"of {conf['batch']}; the bare train_step on a resident "
                f"batch {rec['bare_step_ms']:.3f} ms (wall, "
                f"{conf['bare_steps']} steps) on {smi}")

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


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    try:
        from gan_segmentation_tpu_torch.core.config import (SolverConfig,
                                                            gan_config)
        from gan_segmentation_tpu_torch.kernels import _build
    except ImportError as exc:
        sys.exit(f"chip_smoke: run from the repository root ({exc})")

    # 1. device
    smi = smi_line()
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, {torch.cuda.device_count()} "
        f"device(s); nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    so = _build.build_library()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(so)}")
    spills = ptxas_report(so + ".ptxas.txt")
    tc = {k: v for k, v in spills.items()
          if "conv3x3_tc" in k or "conv3x3_tf32" in k}
    assert any("conv3x3_tc" in k for k in tc), "no bf16 tensor-core kernel"
    assert any("conv3x3_tf32" in k for k in tc), "no 3xTF32 kernel"
    bad = {k: v for k, v in tc.items() if v != (0, 0)}
    assert not bad, f"tensor-core kernels spill: {bad}"
    log(f"ptxas: {len(tc)} tensor-core kernels (bf16 and 3xTF32), 0 bytes "
        f"of spill in each; spills elsewhere: "
        f"{ {k: v for k, v in spills.items() if v != (0, 0)} or 'none'}")

    # 3. kernels
    gcfg, scfg = gan_config("ffhq"), SolverConfig(max_res_log2=10)
    rec = phase_kernels(torch, gcfg, scfg)

    # 4. generate
    phase_small_reference(torch)
    sl = phase_slice(torch)
    log(f"ffhq 1024^2 generate: {sl['pipeline_sps']:.3f} samples/s "
        f"(device pipeline; generator {sl['gen_ms']:.3f} ms, decoder "
        f"{sl['dec_ms']:.3f} ms per batch), {sl['end_to_end_sps']:.3f} "
        f"samples/s (with the cv2 writer) on {smi}")
    og = phase_other_gans(torch)

    # 5. train and evaluate
    phase_small_train_reference(torch)
    tr = phase_train(torch)
    log(f"ffhq 1024^2 train: {tr['sps']:.3f} samples/s, {tr['step_ms']:.3f} "
        f"ms per step over the fit loop after its first epoch, "
        f"{tr['prof']['step_ms']:.3f} ms per step by CUDA events; evaluate "
        f"{tr['metrics']} on {smi}")

    # 6. foreign weights, 7. annotation
    fw = phase_foreign_weights(torch, gcfg, scfg)
    an = phase_annotation(torch)
    log(f"ffhq 1024^2 annotation run: Retrain {an['retrain_s']:.2f} s, "
        f"Generate {an['generate_s']:.2f} s; foreign weights: generator "
        f"loaded in {fw['gen_load_s']:.2f} s, decoder in "
        f"{fw['dec_load_s']:.2f} s on {smi}")

    # 8. deeplab
    dl = phase_deeplab(torch, smi)
    log(f"deeplab crop {DL_CROP} batch {DL_BATCH}: eval "
        f"{dl['eval_ms']['f32']:.3f} ms (f32) / {dl['eval_ms']['bf16']:.3f} "
        f"ms (bf16) per batch, train {dl['train']['f32']['ms']:.3f} ms (f32) "
        f"/ {dl['train']['bf16']['ms']:.3f} ms (bf16) per step on {smi}")

    # 9. step 5: the DeepLab experiment end to end
    s5 = phase_step5(torch, smi)
    log(f"step 5 at crop 480, batch 8 (f32, cuDNN's TF32 convs): the "
        f"trainer's loop {s5['loop_ms']:.3f} ms per step, the feed alone "
        f"{s5['feed_sps']:.2f} samples/s, the bare step "
        f"{s5['bare_step_ms']:.3f} ms; test {s5['test_ips']:.3f} images/s "
        f"on {smi}")

    launches = {
        "conv_in_stats": {"generate": sl["launches"]["conv_in_stats"],
                          "collection": tr["collection_launches"]},
        "small_conv": {"generate": sl["launches"]["small_conv"],
                       "train": tr["launches"]["small_conv"],
                       "evaluate": tr["eval_launches"]},
        "bil_conv": {"train": tr["launches"]["bil_conv"]}}
    for path, counted in (("step5_dataset", s5["launches"]),
                          ("cars", og["cars"]["launches"]),
                          ("bedrooms", og["bedrooms"]["launches"]),
                          ("foreign_weights", fw["launches"]),
                          ("annotation", an["launches"])):
        for name, n in counted.items():
            assert n > 0, f"{path}: {name} was not launched"
            launches[name][path] = n
    tc_design = ("bf16: mma.sync m16n8k16 implicit GEMM fed by a 2- or "
                 "3-stage cp.async ring, split-K for Cin 512 at 4^2-16^2 "
                 "(conv3x3_tc.cuh); f32: 3xTF32 mma.sync m16n8k8 implicit "
                 "GEMM fed by a cp.async ring, taps resident or per stage, "
                 "split-K with a fixed-order finish kernel where the items "
                 "are fewer than the SMs (conv3x3_tf32.cuh)")
    k1_design = (tc_design + "; statistics from the accumulators by "
                 "xor-shuffles and per-slot sums in a fixed order, one "
                 "partial per (image, tile)")
    sources = {"conv_in_stats": (
        "gan_segmentation_tpu_torch/csrc/conv_in_stats.cu",
        "experiments/pallas_archive/conv_in_stats.py:118", k1_design),
        "small_conv": ("gan_segmentation_tpu_torch/csrc/small_conv.cu",
                       "experiments/pallas_archive/small_conv.py:84",
                       tc_design),
        "bil_conv": ("gan_segmentation_tpu_torch/csrc/bil_conv.cu",
                     "experiments/pallas_archive/bil_conv.py:115",
                     "f32: 3xTF32 mma.sync m16n8k8 implicit GEMM fed by a "
                     "cp.async ring, taps resident (conv3x3_tf32.cuh); "
                     "bf16 (on no path): FFMA (conv3x3_core.cuh)")}
    kernels = []
    for name, (src, replaces, design) in sources.items():
        r = rec[name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            design=design,
            launches=sum(launches[name].values()),
            launches_by_path=launches[name])
        if name == "bil_conv":  # the train path runs f32
            entry.update(max_abs_err=r["errs"]["f32"],
                         max_abs_err_bf16=r["errs"]["bf16"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"],
                         library_tf32_ms=r["library_tf32_ms"],
                         timed="f32, device time (graph replay) per train "
                               "step at batch 1, 38 calls; bound 3xTF32")
        else:
            dev = r["dev"]
            total, by = summed_bound(dev["bounds"])
            entry.update(max_abs_err=r["errs"]["bf16"],
                         max_abs_err_f32=r["errs"]["f32"],
                         ms=dev["kernel"], plain_ms=dev["plain"],
                         bound_ms=total, bound_by=by,
                         library_ms=dev["library"],
                         timed="bf16, device time (graph replay) per "
                               "generate batch of 8; library: F.conv2d "
                               "alone, without the epilogue")
            if name == "small_conv":
                b1 = r["b1_dev"]
                entry.update(eval_sample_ms_f32=b1["kernel"],
                             eval_sample_plain_ms_f32=b1["plain"],
                             eval_sample_library_ms_f32=b1["library"])
            else:  # the f32 generator's batch of 8 (the collection)
                f32 = r["f32_dev"]
                entry.update(batch_ms_f32=f32["kernel"],
                             batch_plain_ms_f32=f32["plain"],
                             batch_library_ms_f32=f32["library"])
        kernels.append(entry)
    print(json.dumps({"deeplab": dl}), flush=True)
    print(json.dumps({"step5": {k: v for k, v in s5.items()
                                if k != "losses"}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

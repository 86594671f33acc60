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

The last lines are the kernels' JSON record (per kernel: launches on the
main path, max error, device ms of the kernel, its plain version and the
library call, and its bound), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

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


def kernel1_shapes(gcfg):
    """(n, h, w, cin, cout) of conv_2 in every synthesis block."""
    out = []
    for res in range(2, gcfg.max_res_log2 + 1):
        c = gcfg.num_features(res)
        out.append((BATCH, 2 ** res, 2 ** res, c, c))
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
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

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

    # 5. train and evaluate
    phase_small_train_reference(torch)
    tr = phase_train(torch)
    log(f"ffhq 1024^2 train: {tr['sps']:.3f} samples/s, {tr['step_ms']:.3f} "
        f"ms per step over the fit loop after its first epoch, "
        f"{tr['prof']['step_ms']:.3f} ms per step by CUDA events; evaluate "
        f"{tr['metrics']} on {smi}")

    launches = {
        "conv_in_stats": {"generate": sl["launches"]["conv_in_stats"],
                          "collection": tr["collection_launches"]},
        "small_conv": {"generate": sl["launches"]["small_conv"],
                       "train": tr["launches"]["small_conv"],
                       "evaluate": tr["eval_launches"]},
        "bil_conv": {"train": tr["launches"]["bil_conv"]}}
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

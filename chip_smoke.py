#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``gan_segmentation_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device  — requires CUDA; prints torch, the capability, the card's name and
   power limit (nvidia-smi).
2. build   — compiles the CUDA kernels of ``gan_segmentation_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version at every shape
   the ffhq 1024^2 generate path gives it at batch 8, in f32 (TF32 off on the
   plain side) and in bf16, with the error, the tolerance and both times.
4. slice   — ``run_generate`` at ffhq 1024^2, batch 8, 24 pairs, with a
   seeded random generator and a seeded decoder checkpoint; the kernels'
   launch counters must show that it went through both kernels; a repeated
   batch must be bit-identical; a small slice on the card must agree with
   the same slice on the CPU (plain versions); samples/s.

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

BATCH = 8
GENERATE_NUM = 24
REPS = 10


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol, rtol):
    import torch
    bad = ((got.float() - want.float()).abs()
           > atol + rtol * want.float().abs())
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


def kernel2_shapes(scfg):
    """(name, n, h, w, cin, cout, leaky) of every decoder 3x3 conv."""
    f, cin = scfg.features, scfg.in_channels
    last = len(cin) - 1
    out = []
    for i in range(last + 1):
        r = 2 ** (i + 2)
        out.append((f"cvt_{i}", BATCH, r, r, cin[i], f[i], True))
        c_in = f[i] * (2 if i > 0 else 1)
        if i < last:
            out.append((f"main_{i}.conv_0", BATCH, 2 * r, 2 * r, c_in,
                        f[i + 1], True))
            out.append((f"main_{i}.conv_1", BATCH, 2 * r, 2 * r, f[i + 1],
                        f[i + 1], True))
        else:
            out.append((f"main_{i}_conv", BATCH, r, r, c_in, f[i + 1], False))
    return out


def phase_kernels(torch, gcfg, scfg):
    from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
    from gan_segmentation_tpu_torch.kernels import small_conv as k2m

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rec = {}

    def inputs(n, h, w, cin, cout):
        x = torch.randn((n, h, w, cin), generator=g, device=dev)
        wt = torch.randn((3, 3, cin, cout), generator=g, device=dev)
        return x, wt / (9 * cin) ** 0.5

    # kernel 1
    errs = {"f32": 0.0, "bf16": 0.0}
    ms = plain_ms = 0.0
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
            if tag == "bf16":
                t = cuda_ms(lambda: k1m.conv3x3_noise_bias_lrelu_instats(*args))
                tp = cuda_ms(
                    lambda: k1m.conv3x3_noise_bias_lrelu_instats_plain(*args))
                ms, plain_ms = ms + t, plain_ms + tp
                line += f"  kernel {t:.4f} ms  plain {tp:.4f} ms"
            log(line)
        del x32, w32, x, wt, y, yp
    rec["conv_in_stats"] = dict(errs=errs, ms=ms, plain_ms=plain_ms)

    # kernel 2
    errs = {"f32": 0.0, "bf16": 0.0}
    ms = plain_ms = 0.0
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
                t = cuda_ms(lambda: k2m.conv3x3_small(x, wt, b, **kw))
                tp = cuda_ms(lambda: k2m.conv3x3_small_plain(x, wt, b, **kw))
                ms, plain_ms = ms + t, plain_ms + tp
                line += f"  kernel {t:.4f} ms  plain {tp:.4f} ms"
            log(line)
        del x32, w32, x, wt, y, yp
    # the relu epilogue is not on the path; check it once
    x, wt = inputs(2, 16, 16, 16, 16)
    check_close("small_conv relu", k2m.conv3x3_small(x, wt, relu=True),
                k2m.conv3x3_small_plain(x, wt, relu=True), **TOL["f32"])
    rec["small_conv"] = dict(errs=errs, ms=ms, plain_ms=plain_ms)
    for k, r in rec.items():
        log(f"{k}: max abs err f32 {r['errs']['f32']:.3g}, bf16 "
            f"{r['errs']['bf16']:.3g}; bf16 per batch of 8 over the path's "
            f"shapes: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    return rec


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

        for _ in pipe.generate_batches(BATCH):  # warm-up
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in pipe.generate_batches(GENERATE_NUM):
            pass
        rate = GENERATE_NUM / (time.perf_counter() - t0)
        log(f"device pipeline (generate_batches, no writer): {rate:.3f} "
            f"samples/s at 1024^2, batch {BATCH}")
    return dict(launches={"conv_in_stats": n1, "small_conv": n2},
                end_to_end_sps=GENERATE_NUM / wall, pipeline_sps=rate)


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
    with open(so + ".ptxas.txt") as fh:
        for line in fh:
            if "registers" in line:
                log("  ptxas:", line.strip())

    # 3. kernels
    gcfg, scfg = gan_config("ffhq"), SolverConfig(max_res_log2=10)
    rec = phase_kernels(torch, gcfg, scfg)

    # 4. slice
    phase_small_reference(torch)
    sl = phase_slice(torch)
    log(f"ffhq 1024^2 generate: {sl['pipeline_sps']:.3f} samples/s "
        f"(device pipeline), {sl['end_to_end_sps']:.3f} samples/s "
        f"(with the cv2 writer) on {smi}")

    sources = {"conv_in_stats": (
        "gan_segmentation_tpu_torch/csrc/conv_in_stats.cu",
        "experiments/pallas_archive/conv_in_stats.py:118"),
        "small_conv": ("gan_segmentation_tpu_torch/csrc/small_conv.cu",
                       "experiments/pallas_archive/small_conv.py:84")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rec[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sl["launches"][name], max_abs_err=r["errs"]["bf16"],
            max_abs_err_f32=r["errs"]["f32"], ms=r["ms"],
            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

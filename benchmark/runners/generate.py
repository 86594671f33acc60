"""Traffic runner ``generate``: the synthetic-dataset emitter, a closed loop.

The program under test is ``FusedPipeline.generate_batches`` (z -> the
generator -> the decoder, BN folded -> class mask -> bit-packed mask, as
CUDA-graph replays, the copies to pinned host memory enqueued with one
batch ahead) over the benchmark's seeded weights.  One consumer asks for
each batch as soon as it has the last one and does nothing else with it;
no image writer runs.

Traffic parameters (``traffic/<name>.json``): ``batch`` (samples a batch),
``trace_lead`` / ``trace_settle`` / ``trace_batches`` / ``trace_tail``
(with ``--trace 1``: batches of the window before the profiler starts,
under it before the profiled stretch, in the stretch, and after it before
the profiler stops).  Set-up runs batches until one has run on a replay
of the batch's graph.

End-to-end: ``gen_samples_per_s`` (pairs readable on the host in the
window over its seconds) and ``gen_batch_p95_ms`` (the 95th percentile
over every batch of the window of the time from asking for it to its
arrays being readable).  Spans: ``enqueue`` (host seconds inside
``_enqueue``, outside the profiled stretch).  Counter: ``samples_per_unit``.

Compared after the window: ``CHECK_BATCHES`` batches of the window, drawn
from the seed, their images and masks against the plain f32 reference
on the same z and noise, worked out again from the seed as the program
draws them (the masks unpacked with ``np.unpackbits``): ``image_far``,
the share of their image values (pixels x channels) that differ from the
reference's by more than ``FAR_LEVELS`` levels, and ``mask_err``, the
share of their mask pixels that differ (each sample's own, and its mean
|difference| in levels, on standard error).  bf16 moves many values a few
levels; a far-off value is rare unless the arithmetic is wrong.

Controls (``--control``): ``int8-full``, the program's own lower-precision
path (``FusedPipeline(quant="int8-full")``).
"""

import gc
import json
import random
import statistics
import sys
import tempfile
import time

import numpy as np

from gsbench import harness, program, weights
from gsbench import trace as tracing
from gsbench.trace import STRETCH

CONTROLS = ("int8-full",)
CHECK_BATCHES = 3
CHECKS = ("image_far", "mask_err")
FAR_LEVELS = 48
# warm-up's batches at the most, for a pipeline that shows no graph
WARM_MAX = 10


def draw_inputs(torch, pseed, index, batch, gan, device):
    """(z, noise) of batch ``index``, drawn as the program draws them: a
    generator seeded with ``pseed * 2**32 + index`` fills z, then every
    noise input in block order (noise_1, noise_2 a block)."""
    g = torch.Generator(device=device)
    g.manual_seed(pseed * 2 ** 32 + index)
    z = torch.empty((batch, gan["latent_size"]), device=device)
    z.normal_(generator=g)
    noise = {}
    for res in range(2, gan["max_res_log2"] + 1):
        s = gan["base"] * 2 ** res // 4
        for j in (1, 2):
            t = torch.empty((batch, s, s, 1), device=device)
            t.normal_(generator=g)
            noise[f"block_{res}.noise_{j}"] = t
    return z, noise


def build(torch, cfg, traffic, seed, device, gw, dw, quant=None):
    """The pipeline under test on the benchmark's weights."""
    from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                            ImageGenerator)
    gan, dec = cfg["gan"], cfg["decoder"]
    pseed = program.program_seed(seed)
    tmp = tempfile.gettempdir()
    gen = ImageGenerator(gan=cfg["gan_name"], gan_dir=tmp + "/no-gan-files",
                         batch_size=traffic["batch"],
                         dtype=cfg["precision"], seed=pseed, params=gw,
                         max_res_log2=gan["max_res_log2"], device=device)
    program.check_gan_config(gen.cfg, gan)
    solver = program.solver(torch, gan["max_res_log2"], dec,
                            cfg["solver"], pseed, device, tmp, dw)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["precision"]]
    return FusedPipeline(gen, solver, inference_dtype=dtype, quant=quant)


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length, from
    the seed (algorithm R)."""

    def __init__(self, k, seed):
        self.k, self.items, self.seen = k, [], 0
        self.rng = random.Random(seed)

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def timed_enqueue(pipe, spans, state):
    """Wrap the pipeline's ``_enqueue`` to record its host seconds (in the
    window, outside the profiler) and to mark it in a trace; a pipeline
    without one records nothing."""
    real = getattr(pipe, "_enqueue", None)
    if real is None:
        return

    def enqueue(batch_size):
        import torch
        t = time.perf_counter()
        with torch.profiler.record_function("gsbench.enqueue"):
            out = real(batch_size)
        if state["record"]:
            spans.setdefault("enqueue", []).append(time.perf_counter() - t)
        return out

    pipe._enqueue = enqueue


def replayed(pipe, batch, device):
    """Whether the pipeline's graph of ``batch`` has replayed (always, off
    a card, where nothing is captured)."""
    call = getattr(pipe, "_graphs", {}).get(batch)
    return device.type != "cuda" or getattr(call, "replays", 0) > 0


def compare(torch, ref, cfg, pseed, kept, gw, dw, device):
    """(image_far, mask_err) of the kept batches (index, images, masks,
    packed) against the reference on the weights ``gw`` and ``dw``: the
    means over their samples (of equal sizes)."""
    gan, dec = cfg["gan"], cfg["decoder"]
    per = {"image_far": [], "mask_err": [], "image_err": []}
    for index, imgs, masks, packed in kept:
        batch = len(imgs)
        z, noise = draw_inputs(torch, pseed, index, batch, gan, device)
        if packed:
            masks = np.unpackbits(masks, axis=-1)
        for s in range(batch):
            with torch.no_grad(), ref.full_precision():
                rgb, feats = ref.generator_forward(
                    gw, gan, z[s:s + 1],
                    {k: v[s:s + 1] for k, v in noise.items()})
                logits = ref.decoder_forward(dw, dec, feats)
                want_img = ref.to_uint8(rgb)[0].cpu().numpy()
                want_mask = ref.class_mask(logits)[0].cpu().numpy()
            got_img, got_mask = imgs[s], masks[s]
            if (got_img.shape != want_img.shape
                    or got_mask.shape != want_mask.shape):
                return float("inf"), float("inf")
            d = np.abs(got_img.astype(np.int16) - want_img.astype(np.int16))
            per["image_far"].append(float((d > FAR_LEVELS).mean()))
            per["mask_err"].append(float((got_mask != want_mask).mean()))
            per["image_err"].append(float(d.mean()))
            del rgb, feats, logits
    print("per sample " + json.dumps(per), file=sys.stderr)
    return float(np.mean(per["image_far"])), float(np.mean(per["mask_err"]))


def run(cell, seed, seconds, trace, device, t0, control=None):
    import torch

    cfg, tr = cell.config, cell.traffic
    if control is not None and control not in CONTROLS:
        raise SystemExit(f"unknown control {control!r}: {CONTROLS}")
    phases = harness.Phases(t0, device)
    ref = harness.load_reference(cfg)
    program.build_kernels(device)
    phases.mark("imports and kernel library")
    gw = weights.generator_weights(cfg["gan"], seed, device)
    dw = weights.decoder_weights(cfg["decoder"], seed, device)
    phases.mark("weights")
    pipe = build(torch, cfg, tr, seed, device, gw, dw, quant=control)
    phases.mark("pipeline")
    batch = tr["batch"]
    record = harness.Record(cell, counters={"samples_per_unit": batch})
    state = {"record": False}
    if trace:
        timed_enqueue(pipe, record.spans, state)
    # batches until one has run on a replay of the batch's graph; the
    # program draws batch i's inputs from seed * 2**32 + i, so the window's
    # first batch is batch ``base``
    base = 0
    while True:
        ready = replayed(pipe, batch, device)
        for _ in pipe.generate_batches(batch):
            base += 1
        if ready or base >= WARM_MAX:
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    pseed = program.program_seed(seed)
    kept = Reservoir(CHECK_BATCHES, seed)
    lat, n_samples, k = [], 0, 0
    prof = mark = None
    # with --trace 1: the profiler starts, the stretch starts once the loop
    # has settled under it, ends, and the profiler stops (batch counts)
    p_at = m_at = m_end = p_end = -1
    if trace:
        p_at = tr["trace_lead"]
        m_at = p_at + tr["trace_settle"]
        m_end = m_at + tr["trace_batches"]
        p_end = m_end + tr["trace_tail"]
    it = pipe.generate_batches(10 ** 12)
    state["record"] = True
    setup_s = time.perf_counter() - t0
    phases.mark("warm-up")
    start = time.perf_counter()
    while True:
        if k == p_at:
            state["record"] = False
            prof = tracing.profiler(torch, device)
            prof.__enter__()
        if k == m_at:
            mark = torch.profiler.record_function(STRETCH)
            mark.__enter__()
        t = time.perf_counter()
        imgs, masks, packed = next(it)
        now = time.perf_counter()
        lat.append(now - t)
        n_samples += len(imgs)
        kept.offer((base + k, imgs, masks, packed))
        k += 1
        if k == m_end:
            mark.__exit__(None, None, None)
        if k == p_end:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            record.stretch = tracing.Stretch(tracing.from_profiler(prof),
                                             tr["trace_batches"])
            state["record"] = True
        if now - start >= seconds and (not trace or k >= p_end):
            break
    window = now - start
    it.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del pipe, it
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    errs = compare(torch, ref, cfg, pseed, kept.items, gw, dw, device)
    phases.mark("window and check")
    phases.report()
    e2e = {"gen_samples_per_s": n_samples / window,
           "gen_batch_p95_ms": statistics.quantiles(
               lat, n=20, method="inclusive")[-1] * 1e3}
    return harness.Outcome(e2e, attempted=k, failed=0,
                           compared=list(zip(CHECKS, errs)),
                           memory_peak_bytes=peak, record=record,
                           setup_s=setup_s)

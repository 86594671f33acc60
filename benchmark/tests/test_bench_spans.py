"""The readers of the program's own spans (``gsbench/spans.py`` and the five
``metrics/*`` that use it) on synthetic traces whose answers are worked
out by hand, and the spans in a tiny traced run on the CPU."""

import time

import pytest
import torch

import bench_tiny
from gsbench import harness, spans
from gsbench.trace import STRETCH, Event, Stretch

GLUE = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >")
H2D = "Memcpy HtoD (Pinned -> Device)"
D2H = "Memcpy DtoH (Device -> Pinned)"
GEN, FIT = "ffhq1024-gen-b8", "ffhq1024-fit-b1"
GEN_METRICS = ("pipe_host_ms.gen", "replay_launch_ms.gen")
FIT_METRICS = ("step_host_ms.fit", "replay_launch_ms.fit",
               "epoch_edge_idle_ms.fit")


def dev(name, a, b):
    return Event(name, True, float(a), float(b))


def host(name, a, b):
    return Event(name, False, float(a), float(b))


def record(cell, events, units):
    r = harness.Record(harness.load_cell(cell))
    r.stretch = Stretch(events, units=units)
    return r


def read(metric, rec):
    return harness.load_metric(metric).read(rec)


def gen_trace():
    """A 1000 µs stretch of 2 batches; each batch's enqueue (a draw, a
    replay, a copy inside) and wait, and one batch's spans before the
    stretch and one after it, which are left out."""
    batch = []
    for t0 in (-400, 100, 600, 1100):
        batch += [host("gst.pipe.enqueue", t0, t0 + 100),
                  host("gst.pipe.draw", t0 + 5, t0 + 25),
                  host("gst.graph.replay", t0 + 30, t0 + 60),
                  host("gst.pipe.copy", t0 + 60, t0 + 90),
                  host("gst.pipe.wait", t0 + 110, t0 + 400)]
    return [host(STRETCH, 0, 1000), dev(GLUE, 0, 980)] + batch


def fit_trace():
    """A 1000 µs stretch of 2 epochs of 2 steps each, each step a replay
(launch 60, 60, 50, 50 µs; the step's own host time 100, 60, 30,
70).  Epoch 1 starts at
    100 after the last epoch's series copy (D2H, 40-60); its stage's index
    copy (H2D, 120-130) and a step's glue (150-160) run before its first
    replay's first kernel at 300: idle (60-120) + (130-150) + (160-300) =
    220 µs.  Epoch 2 starts at 600; the last operation before it ends at
    580, an overlapped one (560-590) keeps the device busy to 590, its
    first replay begins at 640 and its first kernel after that at 700:
    idle 110 µs.  An epoch before the stretch is left out."""
    events = [host(STRETCH, 0, 1000),
              host("gst.fit.epoch", -300, -100),
              host("gst.graph.replay", -250, -240),
              dev(D2H, 40, 60),
              host("gst.fit.epoch", 100, 500),
              host("gst.fit.stage", 100, 120),
              dev(H2D, 120, 130),
              host("gst.fit.step", 140, 300),
              dev(GLUE, 150, 160),
              host("gst.graph.replay", 200, 260),
              dev(GLUE, 300, 400),
              host("gst.fit.step", 300, 420),
              host("gst.graph.replay", 320, 380),
              dev(GLUE, 420, 540),
              dev(GLUE, 560, 590),
              dev(D2H, 570, 580),
              host("gst.fit.epoch", 600, 900),
              host("gst.fit.stage", 600, 610),
              host("gst.fit.step", 620, 700),
              host("gst.graph.replay", 640, 690),
              dev(GLUE, 700, 800),
              host("gst.fit.step", 700, 820),
              host("gst.graph.replay", 710, 760),
              dev(GLUE, 800, 950)]
    return events


@pytest.mark.parametrize("metric,want", [
    ("pipe_host_ms.gen", 2 * 100 / 1e3 / 2),
    ("replay_launch_ms.gen", 2 * 30 / 1e3 / 2)])
def test_gen_span_readers(metric, want):
    """Spans that start in the stretch, over its batches; those before and
    after it left out (the wait of the batch at 600 ends after the
    stretch and counts whole)."""
    assert read(metric, record(GEN, gen_trace(), 2)) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("step_host_ms.fit", (60 + 70) / 2 / 1e3),
    ("replay_launch_ms.fit", (60 + 50) / 2 / 1e3),
    ("epoch_edge_idle_ms.fit", (220 + 110) / 1e3 / 2)])
def test_fit_span_readers(metric, want):
    assert read(metric, record(FIT, fit_trace(), 4)) == pytest.approx(want)


def long_epoch(replays, calls=None):
    """One epoch of a step every 1000 µs in a 10 ms stretch, step k's graph
    call ``calls[k]`` (a replay by default) lasting ``replays[k]`` µs and
    the step's own host time 20 µs."""
    calls = calls or ["gst.graph.replay"] * len(replays)
    events = [host(STRETCH, 0, 10000), dev(GLUE, 0, 9990),
              host("gst.fit.epoch", 5, 5 + 1000 * len(replays))]
    for k, (us, call) in enumerate(zip(replays, calls)):
        t = 10 + 1000 * k
        events += [host("gst.fit.step", t, t + 20 + us),
                   host(call, t + 10, t + 10 + us)]
    return events


@pytest.mark.parametrize("metric,want", [("replay_launch_ms.fit", 0.040),
                                         ("step_host_ms.fit", 0.020)])
def test_fit_readers_take_an_epochs_first_steps(metric, want):
    """Steps after the epoch's first ``HEAD_STEPS`` (whose launches wait for
    room in the queue: 600 µs here) are left out, and a hiccup among the
    first is the median's to drop."""
    assert spans.HEAD_STEPS == 3
    rec = record(FIT, long_epoch([30, 40, 900, 600, 600]), 5)
    assert read(metric, rec) == pytest.approx(want)


def test_launch_leaves_out_steps_without_a_replay():
    """An eager graph call (the warm-up) is no launch; it is still taken
    from the step's own host time."""
    calls = ["gst.graph.eager", "gst.graph.capture", "gst.graph.replay"]
    rec = record(FIT, long_epoch([500, 700, 30], calls), 3)
    assert read("replay_launch_ms.fit", rec) == pytest.approx(0.030)
    assert read("step_host_ms.fit", rec) == pytest.approx(0.020)


def test_edge_idle_counts_the_copies_inside_as_busy():
    """The stage's index copy and the step's glue before the first replay
    are busy time; taking them out leaves the whole edge idle."""
    events = [e for e in fit_trace() if e.start != 120 and e.start != 150]
    rec = record(FIT, events, 4)
    assert read("epoch_edge_idle_ms.fit", rec) == \
        pytest.approx((240 + 110) / 1e3 / 2)


def test_idle_between_two_times():
    st = record(FIT, fit_trace(), 4).stretch
    assert spans.idle_ms(st, 60, 300) == pytest.approx(0.220)
    assert spans.idle_ms(st, 300, 400) == 0.0
    assert spans.idle_ms(st, 590, 560) == 0.0


@pytest.mark.parametrize("metric", GEN_METRICS + FIT_METRICS)
def test_nothing_to_read(metric):
    """No stretch, a stretch without a device operation (a CPU run), and
    a stretch with device work but none of the program's spans (a program
    without them): no number."""
    cell = GEN if metric.endswith(".gen") else FIT
    rec = harness.Record(harness.load_cell(cell))
    assert read(metric, rec) is None
    rec.stretch = Stretch([host(STRETCH, 0, 10),
                           host("gst.fit.epoch", 1, 5),
                           host("gst.pipe.enqueue", 1, 5)], units=1)
    assert read(metric, rec) is None
    rec.stretch = Stretch([host(STRETCH, 0, 100), dev(GLUE, 0, 90),
                           host("gsbench.epoch", 0, 90),
                           host("cudaGraphLaunch", 10, 20)], units=1)
    assert read(metric, rec) is None


@pytest.mark.parametrize("metric", GEN_METRICS + FIT_METRICS)
def test_spans_outside_the_stretch_read_nothing(metric):
    """Spans of the program only before and after the stretch."""
    cell, trace = (GEN, gen_trace) if metric.endswith(".gen") else \
        (FIT, fit_trace)
    events = [e for e in trace()
              if e.device or not e.name.startswith("gst.")
              or not 0 <= e.start < 1000]
    assert read(metric, record(cell, events, 2)) is None


def test_edge_needs_a_replay_in_its_epoch():
    """An epoch whose steps ran no replay (the eager warm-up) has no
    edge."""
    events = [e for e in fit_trace() if e.name != "gst.graph.replay"]
    assert read("epoch_edge_idle_ms.fit", record(FIT, events, 4)) is None


@pytest.mark.parametrize("cell,names", [
    (GEN, {"gst.pipe.enqueue", "gst.pipe.draw", "gst.pipe.copy",
           "gst.pipe.wait", "gst.graph.eager"}),
    (FIT, {"gst.fit.epoch", "gst.fit.stage", "gst.fit.step",
           "gst.graph.eager"})])
def test_tiny_traced_run_holds_the_spans(cell, names):
    """A traced run of the tiny cell on the CPU: the program's spans are in
    the stretch's host events (the readers stay silent there, as on every
    run without device work), and none is a device operation."""
    tiny = bench_tiny.tiny_cell(cell)
    runner = harness.load_runner(tiny.traffic["runner"])
    outcome = runner.run(tiny, seed=2 ** 31 + 7, seconds=0.2, trace=True,
                         device=torch.device("cpu"), t0=time.perf_counter())
    st = outcome.record.stretch
    assert names <= {e.name for e in st.host
                     if st.start <= e.start < st.end}
    assert not [e for e in st.device_ops if e.name.startswith("gst.")]

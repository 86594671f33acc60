"""The port's spans (``utils/profiling.py::span``) on the CPU: with no
profiler running a span reads one flag and touches nothing else; under
``torch.profiler.profile`` the generate pipeline's batches, the graphed
epochs of ``SegSolver`` and the calls of ``GraphedCall`` leave their
``gst.*`` spans, each inside its batch's or epoch's span, and every one a
``cpu_op`` range (never a ``user_annotation``, which kineto would mirror
onto the device's timeline)."""

import pytest
import torch
from test_torch_graphs import StandInGraph
from test_torch_pipeline import _tiny_generator

from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver
from gan_segmentation_tpu_torch.utils import profiling

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")
IN_CHANNELS = [32, 32, 16, 8]          # a narrow res-32 pyramid
FEATURES = [16, 16, 16, 8, 2]
SAMPLES = 5
BATCHES = 3


def _generate(tmp_path):
    """Three CPU batches of ``generate_batches``."""
    solver = SegSolver(3, "", str(tmp_path / "none"), device=CPU)
    pipe = tgen.FusedPipeline(_tiny_generator(seed=3), solver,
                              inference_dtype=torch.float32)
    got = list(pipe.generate_batches(BATCHES * pipe.gen.batch_size))
    assert len(got) == BATCHES


def _epochs(tmp_path, epochs=2):
    """``epochs`` epochs of ``_graphed_epochs`` over a resident collection
    of ``SAMPLES`` narrow pyramids (NHWC) at batch 1, dropout on."""
    cfg = SolverConfig(max_res_log2=5, features=list(FEATURES),
                       in_channels=list(IN_CHANNELS))
    s = SegSolver(5, "", str(tmp_path / "c"), cfg=cfg, device=CPU)
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn((SAMPLES, 2 ** (k + 2), 2 ** (k + 2), c),
                         generator=g) for k, c in enumerate(IN_CHANNELS)]
    masks = (feats[-1][..., 0] > 0).to(torch.int8)
    masks[:, :2] = -1
    opt, lr = s._make_optimizer(SAMPLES, graphed=True)
    s.model.train()
    run = s._graphed_epochs(opt, lr, (feats, masks),
                            torch.Generator().manual_seed(1))
    step = 0
    for epoch in range(epochs):
        rows = s._global_mean(run(epoch, step), None)
        assert rows.shape == (SAMPLES, 2) and bool(torch.isfinite(rows).all())
        step += len(rows)


def _graph_calls(tmp_path):
    """Four calls of a card's ``GraphedCall``: warm-up, capture (and its
    first replay), two replays."""
    call = StandInGraph(lambda: torch.ones(3) * 2)
    for _ in range(4):
        call()
    assert call.replays == 3


RUNS = {"generate": _generate, "epochs": _epochs, "graph": _graph_calls}


def _spans(run, tmp_path):
    """The ``gst.*`` events of ``run`` under a CPU profiler: [(name, kind,
    thread, start ns, end ns)] in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(tmp_path)
    out = [(e.name(), e.activity_type(), e.start_thread_id(), e.start_ns(),
            e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("gst.")]
    return sorted(out, key=lambda e: (e[3], -e[4]))


def _inside(child, parents):
    """The parent of ``parents`` whose interval holds ``child``'s on the
    same thread, or None."""
    for p in parents:
        if p[2] == child[2] and p[3] <= child[3] and child[4] <= p[4]:
            return p
    return None


@pytest.mark.parametrize("run", sorted(RUNS) + ["span"])
def test_no_profiler_no_range(run, tmp_path, monkeypatch):
    """With no profiler running, neither a bare span nor the program's
    spans open a range: ``_RecordFunctionFast`` made to raise is never
    called."""
    def refuse(name):
        raise AssertionError(f"a range for {name} with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    if run == "span":
        with profiling.span("gst.test"):
            pass
    else:
        RUNS[run](tmp_path)


class CountingFlags:
    """``torch.autograd.profiler`` as ``span`` sees it, counting reads."""

    def __init__(self):
        object.__setattr__(self, "reads", [])

    def __getattribute__(self, name):
        if name != "reads":
            object.__getattribute__(self, "reads").append(name)
            return False
        return object.__getattribute__(self, name)


@pytest.mark.parametrize("spans", [1, 5])
def test_span_off_reads_one_flag(spans, monkeypatch):
    """Off, a span costs one read of ``_is_profiler_enabled`` and nothing
    else, and its context is a no-op."""
    flags = CountingFlags()
    monkeypatch.setattr(profiling, "_autograd_profiler", flags)
    flags.reads.clear()  # the patch's own look at the object
    for _ in range(spans):
        with profiling.span("gst.test") as ctx:
            assert ctx is None
    assert flags.reads == ["_is_profiler_enabled"] * spans


@pytest.mark.parametrize("run", sorted(RUNS))
def test_spans_are_cpu_ops(run, tmp_path):
    """Every ``gst.*`` event is a ``cpu_op`` (``_RecordFunctionFast``),
    never a ``user_annotation`` (``record_function``, which kineto mirrors
    onto the device)."""
    spans = _spans(RUNS[run], tmp_path)
    assert spans and {kind for _, kind, *_ in spans} == {"cpu_op"}


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("child", ["gst.pipe.draw", "gst.graph.eager",
                                   "gst.pipe.copy"])
def test_each_enqueue_holds_its_batch(child, tmp_path):
    """Three batches leave three ``gst.pipe.enqueue`` spans and three
    ``gst.pipe.wait`` spans outside them; each enqueue holds one
    ``child``, and every ``child`` lies in an enqueue."""
    spans = _spans(_generate, tmp_path)
    enq = _named(spans, "gst.pipe.enqueue")
    assert len(enq) == BATCHES
    waits = _named(spans, "gst.pipe.wait")
    assert len(waits) == BATCHES
    assert all(_inside(w, enq) is None for w in waits)
    kids = _named(spans, child)
    assert len(kids) == BATCHES
    assert sorted(_inside(k, enq) for k in kids) == enq


@pytest.mark.parametrize("child,per_epoch", [("gst.fit.stage", 1),
                                             ("gst.fit.step", SAMPLES),
                                             ("gst.graph.eager", SAMPLES)])
def test_each_epoch_holds_its_steps(child, per_epoch, tmp_path):
    """Two epochs leave two ``gst.fit.epoch`` spans; each holds one
    ``gst.fit.stage`` and one ``gst.fit.step`` a step, each step the
    graph's call."""
    spans = _spans(_epochs, tmp_path)
    epochs = _named(spans, "gst.fit.epoch")
    assert len(epochs) == 2
    kids = _named(spans, child)
    assert len(kids) == 2 * per_epoch
    for e in epochs:
        assert sum(_inside(k, [e]) is not None for k in kids) == per_epoch
    steps = _named(spans, "gst.fit.step")
    if child == "gst.graph.eager":
        assert all(_inside(k, steps) is not None for k in kids)


def test_graph_spans_follow_the_card_path(tmp_path):
    """A card's call: the warm-up eager, then the capture and its replay,
    then replays."""
    spans = _spans(_graph_calls, tmp_path)
    assert [s[0] for s in spans] == [
        "gst.graph.eager", "gst.graph.capture", "gst.graph.replay",
        "gst.graph.replay", "gst.graph.replay"]


def test_spans_record_one_range_each():
    """Under a running profiler each span records one host range: a
    thousand of them leave a thousand events, in order, on one thread."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(1000):
            with profiling.span(f"gst.test.{i % 2}"):
                pass
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith("gst.test.")]
    assert [e.name() for e in ev] == [f"gst.test.{i % 2}"
                                      for i in range(1000)]
    assert len({e.start_thread_id() for e in ev}) == 1
    starts = [e.start_ns() for e in ev]
    assert starts == sorted(starts)

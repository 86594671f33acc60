"""The DeepLab cell (``deeplab-r50-sync4``): its readers on synthetic
traces, its FLOP count, and its check against the program broken
underneath.

On the CPU, in a world of two gloo ranks at a small crop
(``deeplab_tiny.py``): a sound run is correct, and each fault the world
can have, planted in the program of every rank, is not: batch norm over
each rank's own samples, the gradients left unaveraged.  On four cards
(``-m cuda``, skipped with fewer), the runner's three controls at the
cell's size:

    python -m pytest benchmark/tests/test_bench_deeplab.py -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from gsbench import deeplab, harness
from gsbench.trace import Event, Stretch, STRETCH

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "deeplab-r50-sync4"


def test_flop_from_the_shapes():
    """158.5 GMAC a sample's forward at crop 480, 69 convs; a train
    sample is three forwards less the stem's input gradient."""
    model = harness.load_cell(CELL).config["model"]
    convs = deeplab.convs(model, 480)
    assert len(convs) == 69
    fwd = sum(2 * px * ci * co * k * k for _, px, ci, co, k, _ in convs)
    assert round(fwd / 2e9, 1) == 158.5
    stem = 2 * 240 * 240 * 3 * 64 * 9
    assert deeplab.train_flop_per_sample(model, 480) == 3 * fwd - stem


def stretch(names, units=2):
    """A stretch of ``names`` run back to back, 10 µs each."""
    events = [Event(STRETCH, False, 0.0, 10.0 * len(names) + 5)]
    events += [Event(n, True, 10.0 * i, 10.0 * i + 10) for i, n in
               enumerate(names)]
    return Stretch(events, units)


def test_trace_families():
    """NCCL's kernels by name; the batch norms' own kernels and the cats
    of their sums (a cat after a batch norm's kernel, before an
    all-reduce), not the gradients' flat cat after a library kernel nor a
    cat before a conv."""
    bn_stats = "batch_norm_collect_statistics_channels_last_kernel"
    cat = "CatArrayBatchedCopy_contig<float, unsigned int, 1, 128, 1>"
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)"
    conv = "sm90_xmma_fprop_implicit_gemm_tf32f32_nhwc"
    st = stretch([bn_stats, "elementwise_kernel", cat, nccl,
                  "batch_norm_elemt_channels_last_kernel", conv, cat,
                  conv, "batch_norm_backward_reduce_kernel", cat, nccl,
                  "batch_norm_backward_elemt_kernel", "wgrad_kernel", cat,
                  nccl, "memcpy HtoD"])
    assert deeplab.nccl_ms_per_unit(st) == pytest.approx(3 * 0.01 / 2)
    assert deeplab.nccl_launches_per_unit(st) == 1.5
    # 4 batch-norm kernels and 2 sums' cats
    assert deeplab.bn_ms_per_unit(st) == pytest.approx(6 * 0.01 / 2)
    assert deeplab.bn_ms_per_unit(None) is None


def test_head_step_host_ms():
    """The first three ``gst.dl.step`` spans of the stretch, less the graph
    call inside each: the median."""
    events = [Event(STRETCH, False, 0.0, 5000.0),
              Event("kernel", True, 0.0, 900.0)]
    for i, (own, graph) in enumerate(((100, 50), (300, 40), (200, 60),
                                      (900, 10))):
        t = 1000.0 * i
        events.append(Event("gst.dl.step", False, t, t + own + graph))
        events.append(Event("gst.graph.replay", False, t + own,
                            t + own + graph))
    st = Stretch(events, 4)
    assert deeplab.head_step_host_ms(st) == pytest.approx(0.2)


def test_mfu_over_the_tf32_peak():
    st = stretch(["kernel"] * 10, units=20)
    want = 100.0 * 1e12 * 2 * 20 / st.seconds / 495e12
    assert deeplab.mfu_pct(st, 1e12, 2) == pytest.approx(want)


def test_gaps():
    import torch
    want = {"a": torch.ones(4), "b": 2 * torch.ones(4), "c": torch.zeros(4)}
    got = dict(want, b=-2 * torch.ones(4))
    assert deeplab.gap_of_norms(got, want, list(want))[0] == 0.0
    assert deeplab.gap_of_differences(got, want, list(want)) == (2.0, "b")
    assert deeplab.whole_gap(want, want, list(want)) == 0.0


def run_tiny(*args):
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
        "PYTHONPATH")}
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "deeplab_tiny.py"), *args],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sound_tiny_world_is_correct():
    line = run_tiny()
    assert line["correct"], line["checks"]
    assert line["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["local-bn", "no-allreduce"])
def test_planted_fault_is_not_correct(fault):
    line = run_tiny("--fault", fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("control,seed", [("bf16", 3100000101),
                                          ("local-bn", 3100000103),
                                          ("no-allreduce", 3100000107)])
def test_control_is_not_correct_on_four_cards(control, seed):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the cell runs one process a "
                    "card")
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         CELL, "--seed", str(seed), "--seconds", "5", "--trace", "0",
         "--control", control],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(control, json.dumps(line["checks"]))
    assert line["correct"] is False, line["checks"]

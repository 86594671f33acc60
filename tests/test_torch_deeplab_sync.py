"""DeepLabV3+ over the dilated resnet50_v1s at every published width, as
the benchmark's cell ``deeplab-r50-sync4`` trains it, against the cell's
plain reference (``benchmark/configs/deeplab_sync_ref.py``, plain torch
f32) on the CPU at a small crop: one process's eager ``train_step`` with
the dropout draws given, and a world of two gloo processes (global batch
4 = 2 + 2, batch norm over both, the gradients averaged) against the
reference on the whole batch; the all-reduces the program counts
(``core/distributed.py::counters``: 135 a step, 2 a batch norm and one for
the gradients, none moved by a graph's replay); and the trainer's
``gst.dl.*`` spans under a profiler.

Tolerances.  The loss is one forward: f32 round-off, 1e-5 relative; the
running statistics' change likewise, 1e-3 of their norm.  The gradients
and the update are held by the worst leaf's error over the larger of its
and the median leaf's reference norm, and by the whole model's relative
error.  In one process the program's batch norms run the same
``F.batch_norm`` kernels as the reference, and they agree to 3e-4: 1e-3.
Over the world the program's batch norm is its own formula
(``ops/norm.py::GlobalBatchNorm``), and the two f32 computations part by
up to 5 %: at the seeded weights the gradients grow a hundredfold from the
heads to the stem through 50 layers, and the round-off with them (the
reference in f32 lies 4 % from its own float64 run at the stem's batch
norms): 0.15.  A fault moves them by its whole size (the unaveraged
gradients of one rank, local statistics: tens of percent).
"""

import numpy as np
import pytest
import torch

import test_torch_spawn as spawn

from gan_segmentation_tpu_torch.core import distributed as dist_
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.train import deeplab_trainer as T
from gan_segmentation_tpu_torch.utils import profiling

torch.set_num_threads(2)  # the test workers share the host's cores

LOSS_TOL = 1e-5
STATS_TOL = 1e-3
ONE_PROCESS_TOL = 1e-3
WORLD_TOL = 0.15


def held(gaps, grad_tol):
    assert gaps["loss"] < LOSS_TOL, gaps
    assert max(gaps["stats"]) < STATS_TOL, gaps
    for k in ("grad", "update"):
        assert max(gaps[k]) < grad_tol, (k, gaps[k])


def test_eager_train_step_matches_the_reference():
    """One process, batch 2 at 64^2, batch norm over the process's batch."""
    images, masks, uniforms = spawn.sync_inputs(2, 64)
    model = spawn.sync_model(64)
    opt, sch = T.make_optimizer(model, 0.005, 25000, 2e-4, 0.9)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = T.train_step(model, opt, sch, torch.from_numpy(images),
                           torch.from_numpy(masks),
                           dropout_u=[torch.from_numpy(u) for u in uniforms])
    ref = spawn.sync_ref()
    want = ref.train_step(before, {
        "layers": [3, 4, 6, 3], "stem_width": 64, "in_channels": 3,
        "atrous_rates": [12, 24, 36], "nclass": 2, "aux": True},
        spawn.SYNC_HYPER, torch.from_numpy(images), torch.from_numpy(masks),
        [torch.from_numpy(u).permute(0, 3, 1, 2) for u in uniforms], 0)
    grads = {k: p.grad for k, p in model.named_parameters()}
    held(spawn.sync_gaps(ref, before, model.state_dict(), grads, float(loss),
                         want, slice(0, 2)), ONE_PROCESS_TOL)


@pytest.fixture(scope="module")
def world():
    return spawn.run_world(spawn.deeplab_sync, 2, *spawn.sync_inputs(4))


def test_two_process_world_matches_the_reference_on_the_whole_batch(world):
    for out in world:
        held(out["gaps"], WORLD_TOL)


def test_collectives_counted_where_issued(world):
    """An eager step issues 2 all-reduces a batch norm (67 of them) and one
    for the gradients, their bytes the sums' (forward: sum, sum of
    squares and count; backward: two sums) and the gradients'; a capture
    records the same into ``GraphedCall.collectives``; its replays move no
    counter."""
    for out in world:
        bn = out["bn_channels"]
        assert len(bn) == 67
        want = {"distributed.allreduce.calls": 2 * len(bn) + 1,
                "distributed.allreduce.bytes": 4 * (
                    sum(2 * c + 1 for c in bn) + sum(2 * c for c in bn)
                    + out["parameters"])}
        assert want["distributed.allreduce.calls"] == 135
        assert out["step_calls"] == want
        assert out["captured"] == want and out["held"] == want
        assert out["replayed"] == {k: 0 for k in want}


def test_counters_without_a_world_stay():
    before = dict(dist_.counters)
    assert dist_.allreduce_sum(np.arange(3), None).tolist() == [0, 1, 2]
    dist_.allreduce_mean_([torch.ones(2)], None)
    assert dist_.counters == before


def test_trainer_spans_under_a_profiler(monkeypatch, tmp_path):
    """A graphed trainer's step on the CPU (its graphed body runs eagerly)
    leaves ``gst.dl.step`` holding ``gst.dl.stage`` and ``gst.dl.draw``,
    then the graph's call, each a ``cpu_op`` range."""
    import types

    monkeypatch.setitem(tdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
    model = tdl.DeepLabV3Plus(2, "tiny", crop_size=32)
    args = types.SimpleNamespace(batch_size=2, test_batch_size=2,
                                 checkpoints_path=str(tmp_path),
                                 device="cpu", seed=0, workers=1)
    class Crops:
        num_class = 2

        def __len__(self):
            return 8

    trainer = T.SegmentationTrainer(
        args, model, {"aux_weight": 0.5}, Crops(), None,
        {"baselr": 0.005, "nepochs": 1, "wd": 2e-4, "momentum": 0.9},
        graphed=True)
    images, masks, _ = spawn.sync_inputs(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(images, masks)
    events = sorted(((e.name(), e.activity_type(), e.start_ns(),
                      e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("gst.")), key=lambda e: e[2])
    names = [e[0] for e in events]
    assert names == ["gst.dl.step", "gst.dl.stage", "gst.dl.draw",
                     "gst.graph.eager"], names
    step = events[0]
    assert all(step[2] <= e[2] and e[3] <= step[3] for e in events[1:])
    assert {e[1] for e in events} == {events[0][1]}
    assert "gst.dl.step" in profiling.__doc__

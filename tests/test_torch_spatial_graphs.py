"""``generate --spatial N`` as CUDA graphs (``FusedPipeline(mesh=grid)``
with N > 1 replaying one ``core/graphs.py::GraphedCall`` per batch size,
whose capture spans the grid's cards; ``core/export.py::Served`` serving a
grid program the same way) on the CPU, f32, at ``tests/test_torch_spatial.
py``'s sizes.

On the CPU ``GraphedCall`` runs its callable eagerly, so the capture is
stood in for by ``tests/test_torch_graphs.py::StandInGraph``: its replays
rerun the body into the static outputs, after the pipeline has drawn the
next batch's z and noise into the static inputs, as a card's replays
read them.  Every comparison is bit for bit: the graphed grid against the
eager grid (``GridProgram`` called on the same draws), a refold read in
place, ``run_generate --spatial 2`` and ``--resume`` against the eager
path's files.  The capture itself runs on the card (``chip_smoke.py``
phase 4c).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gan_segmentation_tpu_torch.apps import main as app
from gan_segmentation_tpu_torch.core import config as tconfig
from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.core import export as tex
from gan_segmentation_tpu_torch.core import graphs
from gan_segmentation_tpu_torch.core import mesh as tmesh
from gan_segmentation_tpu_torch.core import spatial
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver
from test_torch_graphs import StandInGraph

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")
BATCH = 4


def _generator(res=5, seed=3, batch=BATCH):
    """``tests/test_torch_spatial.py``'s: nonzero noise scales and biases,
    so that a band that read another band's noise would show."""
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=batch, dtype="fp32",
                              max_res_log2=res, gan_dir="/nonexistent",
                              device=CPU, seed=seed)
    g = torch.Generator().manual_seed(seed + 10)
    with torch.no_grad():
        for name, p in gen.model.named_parameters():
            if name.endswith(("scale_factors", "bias")) and \
                    "mapping" not in name:
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return gen


def _solver(res, tmp_path, seed=5):
    solver = SegSolver(res, "", str(tmp_path / "none"), device=CPU)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in solver.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                       generator=g))
                m.running_var.copy_(1 + torch.rand(m.num_features,
                                                   generator=g))
    solver.weights_version += 1
    return solver


def _grid(solver, n, d, res=5):
    return tgen.FusedPipeline(_generator(res), solver,
                              inference_dtype=torch.float32,
                              mesh=[[CPU] * n for _ in range(d)])


def _eager_batch(pipe):
    """The next batch of ``pipe``'s stream through its ``GridProgram``,
    called directly (no ``GraphedCall``)."""
    z, noise = pipe.gen.draw_inputs(pipe.gen.batch_size)
    pipe.program()  # refolds first, as ``_batch`` does
    imgs, masks = tgen._infer(pipe.grid_program(), z, noise)
    return imgs.clone(), masks.clone()


@pytest.mark.parametrize("n,d", [(2, 1), (3, 1), (2, 2)])
def test_graphed_grid_equals_the_eager_grid(n, d, tmp_path, monkeypatch):
    """Batches 0-2 of one stream (the eager first batch, the capture and
    its replay, a replay) equal the eager grid's batches of the same
    stream bit for bit; the graph spans the grid's devices and replays
    from the second batch."""
    monkeypatch.setattr(tgen, "GraphedCall", StandInGraph)
    solver = _solver(5, tmp_path)
    graphed, eager = _grid(solver, n, d), _grid(solver, n, d)
    kept = [graphed.sample_batch() for _ in range(3)]
    for got in kept:
        want = _eager_batch(eager)
        assert got[0].shape == (BATCH, 32, 32, 3)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(kept[0][0], kept[1][0])
    call = graphed._graphs[BATCH]
    assert isinstance(call, StandInGraph)
    assert call.graph == "captured" and call.replays == 2
    assert call.spans_asked == graphed.grid_program().devices
    assert graphed.grid_program().shape == (d, n)


def test_graphed_grid_reads_a_refold_in_place(tmp_path, monkeypatch):
    """When the solver's weights move, the next replay reads the new fold
    from the tensors the capture saw: the grid's programs keep every
    weight tensor (none replaced), the folded ones change value, and the
    batch equals the eager grid's batch of the new weights."""
    monkeypatch.setattr(tgen, "GraphedCall", StandInGraph)
    solver = _solver(5, tmp_path)
    pipe = _grid(solver, 2, 1)
    for _ in range(2):  # the eager first batch, then the capture
        pipe.sample_batch()
    grid = pipe.grid_program()
    seen = {(j, k): t for j, p in enumerate(grid.programs)
            for k, t in p.state_dict(keep_vars=True).items()}
    old = {k: t.clone() for k, t in seen.items()}
    with torch.no_grad():
        for p in solver.model.parameters():
            p.mul_(1.5)
    solver.weights_version += 1
    got = pipe.sample_batch()
    assert pipe._graphs[BATCH].replays == 2 and pipe.grid_program() is grid
    now = {(j, k): t for j, p in enumerate(grid.programs)
           for k, t in p.state_dict(keep_vars=True).items()}
    assert now.keys() == seen.keys()
    assert all(now[k] is t for k, t in seen.items())
    moved = {k[1].split(".")[0] for k in seen
             if not torch.equal(now[k], old[k])}
    assert moved == {"decoder", "fold"}  # not the generator's
    fresh = _grid(solver, 2, 1)  # folds the new weights
    fresh.gen.skip_batches(2)
    want = _eager_batch(fresh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _app_config(base, tmp_path, n=5):
    SegSolver(4, "", str(base / "checkpoints"), device=CPU).save()
    return tconfig.AppConfig(BASE_DIR=str(base), GAN="bedrooms",
                             GAN_DIR=str(tmp_path / "no-models"),
                             GAN_BATCH_SIZE_PER_GPU=2, GENERATE_NUM=n,
                             MAX_RES_LOG2=4)


@pytest.mark.parametrize("cards", [2, 4])
def test_run_generate_spatial_graphed_and_resume(cards, tmp_path,
                                                 monkeypatch):
    """``generate --spatial 2`` on 2 and 4 devices (a 1 x 2 and a 2 x 2
    grid) through the graphed grid (its 3 batches: the eager first, the
    capture, a replay) writes the eager grid's files byte for byte, and
    ``--resume`` after losing the tail rewrites it so."""
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    real = tmesh.generate_devices
    rows = real(2, None, [CPU] * cards)
    assert len(rows) == cards // 2
    monkeypatch.setattr(app, "generate_devices", lambda s, dp=None: real(
        s, dp, [CPU] * cards))
    base = tmp_path / "exp"
    cfg = _app_config(base, tmp_path)
    out = base / "dataset" / "train_generated"
    calls = []

    class Counted(StandInGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            calls.append(self)

    monkeypatch.setattr(tgen, "GraphedCall", Counted)
    app.run_generate(cfg, spatial=2, writer="cv2")
    assert len(calls) == 1 and calls[0].replays == 2
    graphed = {p.name: p.read_bytes() for p in out.iterdir()}
    assert len(graphed) == 10
    # the eager grid: the CPU's own GraphedCall runs its callable eagerly
    monkeypatch.setattr(tgen, "GraphedCall", graphs.GraphedCall)
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, max_res_log2=4,
                              seed=0, device=CPU,
                              gan_dir=str(tmp_path / "no-models"))
    pipe = tgen.FusedPipeline(gen, app.build_solver(cfg), mesh=rows)
    dst = tmp_path / "direct"
    dst.mkdir()
    app._write_pairs_cv2(pipe, 5, str(dst), 0, None)
    assert {p.name: p.read_bytes() for p in dst.iterdir()} == graphed
    assert pipe._graphs[2].graph is None  # ran eagerly
    monkeypatch.setattr(tgen, "GraphedCall", Counted)
    for name in ("img_000003.jpg", "mask_000003.png", "img_000004.jpg",
                 "mask_000004.png"):
        (out / name).unlink()
    app.run_generate(cfg, spatial=2, writer="cv2", resume=True)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == graphed


# ------------------------------------------------------ graphs.py, export
@pytest.mark.parametrize("device,spans,want", [
    ("cuda:0", ["cuda:0", "cuda:0"], []),
    ("cuda:0", ["cuda:0", "cuda:1", "cuda:1", "cuda:3"],
     ["cuda:1", "cuda:3"]),
    ("cuda:2", ["cuda:0", "cuda:2"], ["cuda:0"]),
    ("cpu", ["cpu", "cpu"], []),
])
def test_spans_are_the_other_devices_once(device, spans, want):
    """A call spans each other device of its grid once, in the grid's
    order; a grid that repeats the call's device spans none."""
    call = graphs.GraphedCall(lambda: None, device, spans=spans)
    assert call.spans == [torch.device(d) for d in want]


def test_a_call_spans_no_device_of_another_type():
    with pytest.raises(ValueError, match="cannot span"):
        graphs.GraphedCall(lambda: None, "cuda:0", spans=["cpu"])


@pytest.mark.parametrize("meta,moves,want", [
    ({"devices": ["cuda:0"]}, {}, []),
    ({"grid": [1, 2], "devices": ["cuda:0", "cuda:1"]}, {},
     ["cuda:0", "cuda:1"]),
    ({"grid": [2, 2], "devices": ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]},
     {"cuda:1": "cuda:5", "cuda:3": "cuda:0"},
     ["cuda:0", "cuda:5", "cuda:2", "cuda:0"]),
    ({"grid": [1, 2], "devices": ["cpu"]}, {}, ["cpu"]),
])
def test_served_grid_spans_its_serving_devices(meta, moves, want):
    """A served grid program's graph spans the record's devices where the
    loader moved them (the call drops its own device and repeats)."""
    assert tex._spans(meta, moves) == [torch.device(d) for d in want]


def test_served_grid_bundle_replays_as_the_live_grid(tmp_path, monkeypatch):
    """A 1 x 2 grid's bundle served under the stand-in capture: the served
    callable is one graph over the grid's devices, its batches (the eager
    first, the capture, a replay) equal the live graphed grid's from the
    same seed."""
    monkeypatch.setattr(tgen, "GraphedCall", StandInGraph)
    monkeypatch.setattr(tex, "GraphedCall", StandInGraph)
    solver = SegSolver(4, "", str(tmp_path / "none"), device=CPU)
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, max_res_log2=4,
                              seed=6, device=CPU,
                              gan_dir=str(tmp_path / "no-models"))
    pipe = tgen.FusedPipeline(gen, solver, mesh=[[CPU, CPU]])
    bdir = str(tmp_path / "grid.bundle")
    tex.export_fused_pipeline_bundle(pipe, 2, bdir)
    live = [pipe.sample_batch() for _ in range(3)]
    serve = tex.load_bundle(bdir)
    served = []
    for i in range(3):
        g = torch.Generator().manual_seed(6 * 2 ** 32 + i)
        served.append(serve(*tex.draw_inputs(serve.meta, g)))
    assert isinstance(serve.call, StandInGraph)
    assert serve.call.replays == 2 and serve.call.spans_asked == [CPU]
    for got, want in zip(served, live):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------ launch bookkeeping
GRID_CALL = {"conv_in_stats_rows": 18, "small_conv_rows": 52}  # N = 2


@pytest.fixture
def counters():
    saved = graphs.launch_counts()
    for fn in graphs.COUNTED:
        fn.launches = 0
    yield graphs.COUNTED
    for fn, n in saved.items():
        fn.launches = n


def test_a_grids_capture_records_its_row_band_launches(counters):
    """The row-band wrappers are counted in a capture (``COUNTED``): a
    grid's capture keeps their launches in ``deltas`` and
    ``chip_smoke.ReplayTally`` adds them once a replay, as for the
    full-image forms, so ``LaunchTrace(rows=True)`` holds a graphed grid's
    device trace to the wrappers' counts and the replays."""
    wrappers = chip_smoke.kernel_wrappers(rows=True)
    rows = {wrappers[k]: n for k, n in GRID_CALL.items()}
    assert all(fn in counters for fn in rows)
    zero = dict.fromkeys(counters, 0)

    def fn():  # one N = 2 grid batch's band calls
        for w, n in rows.items():
            w.launches += n
        return torch.zeros(2)

    call = StandInGraph(fn, spans=[CPU, CPU])
    with chip_smoke.ReplayTally() as tally:
        call()  # eager
        call()  # the capture (recorded, not run) and its replay
        assert call.deltas == {**zero, **rows}
        for _ in range(3):
            call()
        assert call.replays == 4
        assert {k: w.launches for k, w in wrappers.items()} == {
            "conv_in_stats": 0, "small_conv": 0, "bil_conv": 0,
            "conv_in_stats_rows": 36, "small_conv_rows": 104}
        assert tally.ran(graphs.launch_counts()) == {
            **zero, **{w: 5 * n for w, n in rows.items()}}


def test_block_weights_are_made_once_a_module():
    """The kernels a banded block derives from its parameters: one tuple a
    distinct module (a grid that repeats one device shares it), equal to
    what each band made before (``up_weights``, conv_2's effective
    kernel)."""
    gen = _generator(5)
    a = gen.model.block_3
    b = tgen.copy.deepcopy(a)
    shared = spatial.block_weights([a, a, a], up=True)
    assert shared[0] is shared[1] is shared[2]
    split = spatial.block_weights([a, b], up=True)
    assert split[0] is not split[1]
    for (up, k2), blk in zip(split, (a, b)):
        w, bias = spatial.up_weights(blk)
        assert torch.equal(up[0], w)
        assert (up[1] is None) == (bias is None)
        assert torch.equal(k2, blk.conv_2.effective_weight())
    assert spatial.block_weights([a], up=False)[0][0] is None
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 6, 8, shared[0][0][0].shape[2]).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(spatial.up_rows(a, x, shared[0][0]),
                           spatial.up_rows(a, x))

"""The port's CUDA-graph paths on the CPU, at small sizes: the draws made
before a replay (``StyleGanGenerator.draw_noise``, ``Decoder.draw_dropout``)
against the eager draws, the launch bookkeeping of ``core/graphs.py`` and
``chip_smoke.py`` with a stand-in for the capture, the copies and the
refold of the graphed generate batch, the ``scan_epochs`` rule, and the
graphed fit's loop and its post-hoc log lines against the per-step path.

On the CPU ``GraphedCall`` runs its callable eagerly, so the graphed fit's
loop runs here as it runs on a card, only without the capture; the capture
itself runs on the card (``chip_smoke.py``).  Every comparison of draws is
bit for bit: the same generator, the same order and shapes.
"""

import logging
import re

import numpy as np
import pytest
import torch

import chip_smoke
from gan_segmentation_tpu_torch.core import graphs
from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
from gan_segmentation_tpu_torch.data.collection import save_annotation_sample
from gan_segmentation_tpu_torch.models import decoder as tdec
from gan_segmentation_tpu_torch.models.layers import AddNoise
from gan_segmentation_tpu_torch.models.stylegan import init_generator
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train import solver as tsolver
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")
NARROW = dict(fmap_base=512, fmap_max=32, latent_size=32, dtype="fp32")
# the three GANs' stacks cut to res 32-64; one with a non-square base, so
# that the noise's H and W cannot be swapped unseen
STACKS = {"ffhq": dict(max_res_log2=6), "cars": dict(max_res_log2=6,
                                                     base_scale_y=3),
          "bedrooms": dict(max_res_log2=5)}
IN_CHANNELS = [32, 32, 16, 8]          # a narrow res-32 pyramid
FEATURES = [16, 16, 16, 8, 2]


def _noisy(model, seed=2):
    """Nonzero noise scales (their init is 0), so the noise shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AddNoise):
                m.scale_factors.normal_(generator=g)
    return model


@pytest.mark.parametrize("gan", sorted(STACKS))
def test_draw_noise_is_the_eager_draw(gan):
    cfg = GanConfig(**NARROW, **STACKS[gan])
    model = _noisy(init_generator(cfg, seed=1).eval())
    z = torch.from_numpy(np.random.RandomState(0).randn(3, 32)
                         .astype(np.float32))
    with torch.no_grad():
        want = model(z, generator=torch.Generator().manual_seed(5))
        noise = model.draw_noise(3, torch.Generator().manual_seed(5))
        got = model(z, noise=noise)
        other = model(z, generator=torch.Generator().manual_seed(6))
    shapes = model.noise_shapes(3)
    assert list(noise) == list(shapes)
    assert all(tuple(noise[k].shape) == s for k, s in shapes.items())
    assert shapes[f"block_{cfg.max_res_log2}.noise_2"][1:3] == (
        cfg.base_scale_y * 2 ** (cfg.max_res_log2 - 2),
        cfg.base_scale_x * 2 ** (cfg.max_res_log2 - 2))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert not torch.equal(other[0], want[0])  # the noise reaches the image
    out = {k: torch.empty(s) for k, s in shapes.items()}
    assert model.draw_noise(3, torch.Generator().manual_seed(5),
                            out=out) is out
    assert all(torch.equal(out[k], noise[k]) for k in shapes)


def test_draw_dropout_is_the_eager_draw():
    model = tdec.Decoder(FEATURES, IN_CHANNELS).train()
    model.reset_parameters(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    feats = [torch.from_numpy(rs.randn(2, 2 ** (i + 2), 2 ** (i + 2), c)
                              .astype(np.float32))
             for i, c in enumerate(IN_CHANNELS)]
    shapes = [tuple(f.shape) for f in feats]
    assert model.dropout_shapes(shapes) == [
        (2, 2 ** (i + 2), 2 ** (i + 2), FEATURES[i]) for i in range(4)]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    want = model(feats, generator=torch.Generator().manual_seed(7))
    model.load_state_dict(state)  # the running statistics moved
    drawn = model.draw_dropout(shapes, torch.Generator().manual_seed(7))
    got = model(feats, dropout_u=drawn)
    assert torch.equal(got, want)
    model.load_state_dict(state)
    assert not torch.equal(
        model(feats, generator=torch.Generator().manual_seed(8)), want)


REAL_CALL = graphs.GraphedCall.__call__


class StandInGraph(graphs.GraphedCall):
    """A capture stand-in that needs no card: ``_capture`` runs ``fn`` and
    keeps its outputs as the static ones, and ``_replay`` overwrites them
    in place with a new run of ``fn`` whose launches it takes back (a
    replay runs no wrapper), as a CUDA graph's replays do.  ``spans``
    (a grid's devices) is kept as asked, in ``spans_asked``."""

    def __init__(self, fn, device=None, warmup=1, pool=None, spans=()):
        super().__init__(fn, "cuda", warmup, pool)
        self.captured_at = None
        self.spans_asked = list(spans)

    def _warm(self):
        return self.fn()

    def _capture(self):
        self.graph = "captured"
        self.captured_at = self.calls
        return self.fn()

    def _replay(self):
        if self.calls == self.captured_at:
            return  # the capture's own outputs
        counts = graphs.launch_counts()
        with torch.inference_mode():
            new = self.fn()
            for static, t in zip(graphs._tensors(self.outputs),
                                 graphs._tensors(new)):
                static.copy_(t)
        for fn, n in counts.items():
            fn.launches = n


@pytest.fixture
def counters():
    saved = graphs.launch_counts()
    for fn in graphs.COUNTED:
        fn.launches = 0
    yield graphs.COUNTED
    for fn, n in saved.items():
        fn.launches = n


def test_launch_bookkeeping_adds_the_capture_delta_per_replay(counters):
    """A wrapper counts its own launches only: the eager calls' and those a
    capture records into its graph (kept in ``deltas``); a replay moves no
    counter.  ``chip_smoke.ReplayTally`` adds the capture's delta per
    replay and takes the capture's recording back: what the card ran, to
    which ``chip_smoke.LaunchTrace`` holds the device trace."""
    k1, k2, k3 = counters[:3]  # the int8 wrappers launch nothing here
    zero = dict.fromkeys(counters, 0)
    per_call = {**zero, k1: 9, k2: 26, k3: 0}

    def fn():  # a call launching 9 + 26 kernels, as a generate batch does
        for w, n in per_call.items():
            w.launches += n
        return torch.zeros(2)

    call = StandInGraph(fn, warmup=2)
    with chip_smoke.ReplayTally() as tally:
        call()
        call()
        assert (k1.launches, k2.launches, k3.launches) == (18, 52, 0)
        assert call.graph is None and call.replays == 0
        call()  # the capture (recorded, not run) and the first replay
        assert call.graph == "captured" and call.deltas == per_call
        assert (k1.launches, k2.launches, call.replays) == (27, 78, 1)
        for _ in range(4):
            out = call()
        assert out is call.outputs
        assert (k1.launches, k2.launches, k3.launches) == (27, 78, 0)
        assert call.calls == 7 and call.replays == 5
        assert tally.ran(graphs.launch_counts()) == {**zero, k1: 63,
                                                     k2: 182}

        eager = graphs.GraphedCall(fn, CPU)  # the CPU runs fn at every call
        for _ in range(3):
            eager()
        assert eager.graph is None and eager.replays == 0
        assert (k1.launches, k2.launches) == (54, 156)
        assert tally.ran(graphs.launch_counts()) == {**zero, k1: 90,
                                                     k2: 260}
    assert graphs.GraphedCall.__call__ is REAL_CALL  # the spy is gone


@pytest.mark.parametrize("name,kernel", [
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<16, 8, 16, 1>"
     "(gst::tc::(anonymous namespace)::Args)", "conv_in_stats"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<64, 4, 32, 2>"
     "(gst::tc::(anonymous namespace)::Args)", "small_conv"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<16, 4, 4, "
     "16, 1>(gst::tf32::(anonymous namespace)::Args)", "conv_in_stats"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<32, 8, 2, "
     "16, 2>(gst::tf32::(anonymous namespace)::Args)", "small_conv"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<16, 4, 4, "
     "16, 3>(gst::tf32::(anonymous namespace)::Args)", "bil_conv"),
    ("void gst::bil::conv3x3_bil_kernel<__nv_bfloat16, 4, 8>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, "
     "int, int, int, int, int, int, float)", "bil_conv"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_finish_kernel"
     "(gst::tf32::(anonymous namespace)::Args, int)", None),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_finish_kernel(gst::tc"
     "::(anonymous namespace)::Args, int, int)", None),
    ("void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int)",
     None),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<16, 8, 64, 4>"
     "(gst::tc::(anonymous namespace)::Args)", "conv_in_stats_s8"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<64, 8, 32, 5>"
     "(gst::tc::(anonymous namespace)::Args)", "small_conv_s8"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_finish_kernel<true>("
     "gst::tc::(anonymous namespace)::Args, int, int)", None),
    ("void gst::(anonymous namespace)::quantize_s8_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, float const*, signed char*, unsigned long, int)",
     "quantize_s8"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<128, 2, "
     "16, 1>(gst::sm90::(anonymous namespace)::Args)", "conv_in_stats"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, 16, "
     "2>(gst::sm90::(anonymous namespace)::Args)", "small_conv"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<32, 2, 32, "
     "6>(gst::sm90::(anonymous namespace)::Args)", "conv_in_stats_rows"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 1, 32, "
     "7>(gst::sm90::(anonymous namespace)::Args)", "small_conv_rows")])
def test_kernel_of_tells_the_three_kernels_apart(name, kernel):
    """A device trace's kernel names (as the card's profiler gives them)
    map to the hand-written kernel that launched them: one main kernel per
    wrapper call; finish kernels and library kernels count as none."""
    assert chip_smoke.kernel_of(name) == kernel


def test_graphed_call_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        graphs.GraphedCall(lambda: None, "meta")


def _tiny_generator(**kw):
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, dtype="fp32",
                              max_res_log2=4, gan_dir="/nonexistent",
                              device=CPU, **kw)
    _noisy(gen.model)
    return gen


def _eager_batch(ref):
    z, g = ref.next_inputs(2)
    with torch.inference_mode():
        rgb, feats = ref.model(z, generator=g)
    return tgen._to_uint8(rgb, ref.cfg.imrange), feats, z


@pytest.mark.parametrize("stand_in", [False, True])
def test_sample_batch_is_the_eager_batch_and_a_copy(monkeypatch, stand_in):
    """Batch i of ``sample_batch`` equals the eager batch i (z, then the
    noise from the same seeded generator), also under a stand-in graph
    whose replays overwrite their outputs: a kept batch stays as it was."""
    if stand_in:
        monkeypatch.setattr(tgen, "GraphedCall", StandInGraph)
    gen, ref = _tiny_generator(seed=3), _tiny_generator(seed=3)
    kept = [gen.sample_batch() for _ in range(4)]
    for imgs, feats, z in kept:
        want_imgs, want_feats, want_z = _eager_batch(ref)
        assert torch.equal(z, want_z) and torch.equal(imgs, want_imgs)
        assert all(torch.equal(a, b) for a, b in zip(feats, want_feats))
    assert not torch.equal(kept[0][0], kept[1][0])
    assert gen._graphs[2].replays == (3 if stand_in else 0)
    resumed = _tiny_generator(seed=3)  # generate --resume
    resumed.skip_batches(3)
    assert torch.equal(resumed.sample_batch()[0], kept[3][0])


def _pipeline(tmp_path, gen):
    solver = SegSolver(4, "", str(tmp_path / "none"), device=CPU)
    return tgen.FusedPipeline(gen, solver, inference_dtype=torch.float32)


def test_fused_pipeline_refolds_into_the_captured_tensors(monkeypatch,
                                                          tmp_path):
    """Under a stand-in graph: batches equal the eager ``_fused`` of the
    same draws; when the solver's weights move, the next replay reads the
    new fold from the tensors the capture saw (not a new dict), and its
    batch equals the eager batch of the new weights."""
    monkeypatch.setattr(tgen, "GraphedCall", StandInGraph)
    pipe = _pipeline(tmp_path, _tiny_generator(seed=5))
    ref_gen = _tiny_generator(seed=5)
    for _ in range(2):  # the eager first batch, then the capture
        imgs, masks = pipe.sample_batch()
        z, g = ref_gen.next_inputs(2)
        want = pipe._fused(z, g)
        assert torch.equal(imgs, want[0]) and torch.equal(masks, want[1])
    folded = pipe._prepared()
    tensors = {k: (w, b) for k, (w, b) in folded.items()}
    old = {k: w.clone() for k, (w, _) in folded.items()}
    version = pipe.solver.weights_version
    pipe.solver.model.reset_parameters(torch.Generator().manual_seed(9))
    pipe.solver.weights_version += 1
    imgs, masks = pipe.sample_batch()
    assert pipe._graphs[2].replays == 2
    assert pipe._prepared() is folded and pipe._folded_at == version + 1
    assert all(folded[k][0] is w and folded[k][1] is b
               for k, (w, b) in tensors.items())
    assert any(not torch.equal(folded[k][0], old[k]) for k in old)
    fresh = _pipeline(tmp_path, _tiny_generator(seed=5))
    fresh.solver.model.load_state_dict(pipe.solver.model.state_dict())
    z, g = ref_gen.next_inputs(2)
    want = fresh._fused(z, g)
    assert torch.equal(imgs, want[0]) and torch.equal(masks, want[1])


def test_fold_holds_no_graph_on_the_parameters():
    """The eval fold is constants: no autograd graph and no parameter's
    storage, also for the last conv, which has no BN (its bias was the
    parameter itself).  A caller that keeps a fold, or a graph made from
    one on the default stream, would otherwise hold that parameter's
    gradient accumulator on the default stream, and a later captured train
    step fails on it (the annotation run on the card did)."""
    dec = tdec.Decoder(FEATURES, IN_CHANNELS)
    dec.reset_parameters(torch.Generator().manual_seed(0))
    storages = {p.untyped_storage().data_ptr() for p in dec.parameters()}
    folded = dec.fold_bn(torch.float32)
    assert "main_3_conv" in folded and not hasattr(dec, "main_3_bn")
    for w, b in folded.values():
        for t in (w, b):
            assert not t.requires_grad and t.grad_fn is None
            assert t.untyped_storage().data_ptr() not in storages
            assert t.clone().grad_fn is None


def test_scan_epochs_rule(tmp_path):
    """Auto: on when the collection is resident on a CUDA device; off on the
    CPU; ``True`` on the CPU raises; ``False`` is the per-step path."""
    s = SegSolver(3, "", str(tmp_path), device=CPU)
    resident = object()
    assert s.cfg.scan_epochs is None
    assert not s._scan_epochs(resident) and not s._scan_epochs(None)
    s.cfg.scan_epochs = True
    with pytest.raises(ValueError, match="CUDA graph"):
        s._scan_epochs(resident)
    s.cfg.scan_epochs = False
    assert not s._scan_epochs(resident)
    s.device = torch.device("cuda")  # the rule reads the device type only
    s.cfg.scan_epochs = None
    assert s._scan_epochs(resident) and not s._scan_epochs(None)
    s.cfg.scan_epochs = True
    assert s._scan_epochs(resident) and not s._scan_epochs(None)
    s.cfg.scan_epochs = False
    assert not s._scan_epochs(resident)


@pytest.fixture(scope="module")
def narrow_dir(tmp_path_factory):
    """Six annotated samples of a narrow res-32 pyramid, drawn with numpy;
    the mask is the sign of channel 0 of the last scale."""
    d = tmp_path_factory.mktemp("narrow")
    rs = np.random.RandomState(0)
    for i in range(6):
        feats = [rs.randn(2 ** (k + 2), 2 ** (k + 2), c).astype(np.float32)
                 for k, c in enumerate(IN_CHANNELS)]
        trimap = (feats[-1][..., 0] > 0).astype(np.int32)
        trimap[:2] = -1
        img = rs.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        save_annotation_sample(str(d), i, img, trimap, feats)
    return d


def _cfg(**kw):
    cfg = SolverConfig(max_res_log2=5, features=list(FEATURES),
                       in_channels=list(IN_CHANNELS), **kw)
    cfg.train_epochs, cfg.train_display_iters = 2, 2
    return cfg


def test_scan_epochs_true_on_the_cpu_raises_before_a_step(narrow_dir,
                                                          tmp_path):
    s = SegSolver(5, str(narrow_dir), str(tmp_path / "c"),
                  cfg=_cfg(scan_epochs=True), device=CPU)
    with pytest.raises(ValueError, match="CUDA graph"):
        s.fit()
    assert s.history == [] and not s.is_trained


def _fit(narrow_dir, ckpt, monkeypatch, graphed, caplog, **cfg):
    """A 2-epoch fit (cos schedule, dropout on) from the same init; the
    graphed loop is forced on the CPU.  -> (history, log lines, the keep
    masks of every dropout draw, the final weights)."""
    masks = []
    real = tdec.dropout

    def spy(x, generator=None, rate=0.5, uniform=None):
        if uniform is None:
            uniform = torch.rand(x.shape, generator=generator,
                                 device=x.device)
        masks.append(uniform < 1 - rate)
        return real(x, rate=rate, uniform=uniform)

    monkeypatch.setattr(tdec, "dropout", spy)
    if graphed:
        monkeypatch.setattr(SegSolver, "_scan_epochs",
                            lambda self, cached: cached is not None)
    s = SegSolver(5, str(narrow_dir), str(ckpt),
                  cfg=_cfg(scheduler="cos", **cfg), device=CPU)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=tsolver.log.name):
        s.fit()
    monkeypatch.undo()
    assert s.cache_active
    lines = [r.getMessage() for r in caplog.records
             if r.name == tsolver.log.name and "Epoch[" in r.getMessage()
             and "Time cost" not in r.getMessage()]
    return s.history, lines, masks, s.model.state_dict()


def _unspeed(line):
    return re.sub(r"Speed: +[0-9.]+", "Speed: X", line)


@pytest.mark.parametrize("opt", [
    dict(), dict(optimizer="sgd", momentum=0.9, wd=1e-4)])
def test_graphed_fit_rehearses_the_per_step_fit(narrow_dir, tmp_path,
                                                monkeypatch, caplog, opt):
    """The graphed loop (batch order, rates, dropout bits, series and
    post-hoc lines) against the per-step path, with Adam and with SGD:
    equal dropout bits at every step, the same losses and final weights bit
    for bit, the same lines but the speed (on the CPU both use the per-step
    optimizer; the card's capturable update is held to its eager steps by
    ``chip_smoke.py``)."""
    want_h, want_lines, want_bits, want_w = _fit(
        narrow_dir, tmp_path / "a", monkeypatch, False, caplog, **opt)
    got_h, got_lines, got_bits, got_w = _fit(
        narrow_dir, tmp_path / "b", monkeypatch, True, caplog, **opt)
    assert len(want_bits) == len(got_bits) == 2 * 6 * len(IN_CHANNELS)
    assert all(torch.equal(a, b) for a, b in zip(got_bits, want_bits))
    assert [len(h) for h in got_h] == [len(h) for h in want_h] == [6, 6]
    assert got_h == want_h
    assert all(torch.equal(got_w[k], want_w[k]) for k in want_w)
    assert len(got_lines) == len(want_lines) == 2 * (3 + 2)
    assert [_unspeed(x) for x in got_lines] == [_unspeed(x)
                                                for x in want_lines]


@pytest.mark.parametrize("opt", [
    dict(), dict(optimizer="sgd", momentum=0.9, wd=1e-4)])
def test_graph_optimizer_off_the_card_is_the_per_step_one(tmp_path, opt):
    """``_make_optimizer(graphed=True)`` builds the capturable update only
    for a card (Adam ``capturable``, SGD ``fused``, the rate a device
    tensor); on the CPU, where the graphed loop runs eagerly, it is the
    per-step path's optimizer with the rate as a number."""
    s = SegSolver(5, "", str(tmp_path), cfg=_cfg(**opt), device=CPU)
    for graphed in (False, True):
        o, lr = s._make_optimizer(6, graphed)
        group = o.param_groups[0]
        assert group["lr"] == lr(0) and not isinstance(group["lr"],
                                                       torch.Tensor)
        assert not group.get("capturable", False)
        assert not group.get("fused")


def test_set_rate_fills_a_device_rate_in_place():
    """The graph reads its optimizer's rate from the tensor it captured:
    ``_set_rate`` fills that tensor and keeps it; a number is replaced."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    rate = torch.tensor(1e-3)
    held = torch.optim.SGD(p, lr=rate)
    plain = torch.optim.SGD(p, lr=1e-3)
    tsolver._set_rate(held, 2.5e-4)
    tsolver._set_rate(plain, 2.5e-4)
    assert held.param_groups[0]["lr"] is rate
    assert float(rate) == np.float32(2.5e-4)
    assert plain.param_groups[0]["lr"] == 2.5e-4


def test_post_hoc_lines_are_the_per_step_lines(narrow_dir, tmp_path,
                                               monkeypatch, caplog):
    """``_log_epoch`` on a given (loss, accuracy) series writes the per-step
    path's lines (but the speed) and ``history``, to the digit: the series
    here is the per-step fit's own."""
    series = []
    real = SegSolver._train_step

    def record(self, *a, **kw):
        loss, acc = real(self, *a, **kw)
        series.append((float(loss), float(acc)))
        return loss, acc

    monkeypatch.setattr(SegSolver, "_train_step", record)
    s = SegSolver(5, str(narrow_dir), str(tmp_path / "c"), cfg=_cfg(),
                  device=CPU)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=tsolver.log.name):
        s.fit()
        per_step = [_unspeed(r.getMessage()) for r in caplog.records
                    if "Time cost" not in r.getMessage()
                    and "Epoch[" in r.getMessage()]
        history = s.history
        s.history = []
        caplog.clear()
        t = torch.tensor(series, dtype=torch.float32)
        for epoch in range(2):
            s._log_epoch(epoch, t[6 * epoch:6 * (epoch + 1)], 0.5)
        post_hoc = [_unspeed(r.getMessage()) for r in caplog.records]
    assert post_hoc == per_step
    assert s.history == history
    assert re.search(r"Speed: +12\.00 samples/sec",
                     caplog.records[0].getMessage())

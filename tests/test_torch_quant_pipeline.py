"""Int8 generation through the port's entry points on the CPU:
``FusedPipeline(quant="int8" | "int8-full")`` (train/generator.py),
``run_generate(quant=...)`` (apps/main.py), the int8-full program through
the serving export (core/export.py), and the s8 launch plans
(kernels/tc_plan.py).  The kernels take their plain versions here.

- The calibration stream is the pipeline's own, so int8's images equal
  the float pipeline's byte for byte (only the decoder is int8) and
  ``--resume`` stays byte-identical;
- masks agree with the float pipeline on >= 97% of pixels (random weights,
  the JAX package's worst-case bound for int8-full);
- a refold requantizes into the tensors the program (and a CUDA graph)
  reads; a mesh of two CPU devices equals one device bit for bit, before
  and after a refold.

This file imports no jax, so its ``cuda`` test (the s8 bodies and the
quantize pass on the card against their plain versions) runs on the
card's machine.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

from gan_segmentation_tpu_torch.apps import main as app
from gan_segmentation_tpu_torch.core import config as tconfig
from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.core import export as texport
from gan_segmentation_tpu_torch.core.config import (GanConfig, SolverConfig,
                                                    gan_config)
from gan_segmentation_tpu_torch.kernels import _build
from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
from gan_segmentation_tpu_torch.kernels import quantize as kqm
from gan_segmentation_tpu_torch.kernels import small_conv as k2m
from gan_segmentation_tpu_torch.kernels import tc_plan
from gan_segmentation_tpu_torch.ops import quant as tq
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")


def _generator(seed=3, batch=5):
    return tgen.ImageGenerator(gan="bedrooms", batch_size=batch,
                               dtype="fp32", max_res_log2=4,
                               gan_dir="/nonexistent", device=CPU, seed=seed)


def _masks(pipe, batch):
    m = batch[1].numpy()
    return np.unpackbits(m, axis=-1) if pipe._pack_masks else m


@pytest.mark.parametrize("quant", ["int8", "int8-full"])
def test_int8_pipeline_against_the_float_pipeline(tmp_path, quant):
    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    ref = tgen.FusedPipeline(_generator(), solver)
    pipe = tgen.FusedPipeline(_generator(), solver, quant=quant)
    want, got = ref.sample_batch(), pipe.sample_batch()
    assert got[0].dtype == got[1].dtype == torch.uint8
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    # int8 leaves the generator float; int8-full quantizes it
    assert torch.equal(got[0], want[0]) == (quant == "int8")
    assert (_masks(pipe, got) == _masks(ref, want)).mean() >= 0.97
    program = pipe.program()
    assert (program.gen_quant is not None) == (quant == "int8-full")
    assert program.dec_quant.names == tuple(tq.decoder_sites(solver.model))
    assert program.fold_names == ()


def test_int8_requantizes_in_place(tmp_path):
    """New decoder weights requantize into the same tensors before the
    next batch, which then equals a fresh pipeline's on those weights."""
    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    pipe = tgen.FusedPipeline(_generator(), solver, quant="int8")
    pipe.sample_batch()
    state = pipe.program().dec_quant
    tensors = {k: (v.data_ptr(), v.clone()) for k, v in state.named_buffers()}
    with torch.no_grad():
        for p in solver.model.parameters():
            p.mul_(-1.5)
    solver.weights_version += 1
    got = pipe.sample_batch()
    assert pipe.program().dec_quant is state
    moved = 0
    for k, v in state.named_buffers():
        ptr, before = tensors[k]
        assert v.data_ptr() == ptr, k
        moved += not torch.equal(v, before)
    assert moved > 0
    fresh = tgen.FusedPipeline(_generator(), solver, quant="int8")
    fresh.gen.skip_batches(1)
    assert all(torch.equal(a, b) for a, b in zip(got, fresh.sample_batch()))


@pytest.mark.parametrize("quant", ["int8", "int8-full"])
def test_int8_over_two_devices_equals_one(tmp_path, quant):
    """``generate --dp`` with ``--quant``: each batch of 5 split 3 + 2 over
    two replicas that serve the int8 state, equal bit for bit to one
    device, and again after a refold (the replicas take the new state)."""
    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    one = tgen.FusedPipeline(_generator(), solver, quant=quant)
    two = tgen.FusedPipeline(_generator(), solver, mesh=[CPU, "cpu"],
                             quant=quant)
    for _ in range(2):
        a, b = one.sample_batch(), two.sample_batch()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        replica = two._replicas[0]
        assert replica.dec_quant is not None
        assert all(torch.equal(x, y) for x, y in zip(
            replica.dec_quant.buffers(), two.program().dec_quant.buffers()))
        with torch.no_grad():  # the solver's weights move
            for p in solver.model.parameters():
                p.mul_(1.01)
        solver.weights_version += 1


def test_unknown_quant_mode_is_refused(tmp_path):
    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    with pytest.raises(ValueError, match="unknown quant mode"):
        tgen.FusedPipeline(_generator(), solver, quant="int4")


def test_run_generate_int8_and_resume(tmp_path, monkeypatch):
    """``generate --quant int8`` on the CPU through the test-only device
    override: the images equal a float run's byte for byte (the
    calibration draws no z from the emission stream), and ``--resume``
    after losing the tail rewrites it byte for byte."""
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    base = tmp_path / "exp"
    SegSolver(4, "", str(base / "checkpoints"), device=CPU).save()
    cfg = tconfig.AppConfig(BASE_DIR=str(base), GAN="bedrooms",
                            GAN_DIR=str(tmp_path / "no-models"),
                            GAN_BATCH_SIZE_PER_GPU=2, GENERATE_NUM=5,
                            MAX_RES_LOG2=4)
    out = base / "dataset" / "train_generated"
    app.run_generate(cfg, writer="cv2")
    plain = {p.name: p.read_bytes() for p in out.iterdir()}
    for p in out.iterdir():
        p.unlink()
    app.run_generate(cfg, writer="cv2", quant="int8")
    ref = {p.name: p.read_bytes() for p in out.iterdir()}
    assert sorted(ref) == sorted(plain) and len(ref) == 10
    assert all(ref[k] == plain[k] for k in ref if k.startswith("img_"))
    for name in ("img_000003.jpg", "mask_000003.png", "img_000004.jpg",
                 "mask_000004.png"):
        (out / name).unlink()
    app.run_generate(cfg, writer="cv2", quant="int8", resume=True)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == ref


SMALL = dict(max_res_log2=5, fmap_base=128, fmap_max=32, latent_size=32)


def test_int8_full_bundle_roundtrip(tmp_path):
    """The int8-full program exports through the bundle form (the s8 ops
    are ``torch.ops.gst.*`` with fake implementations): served from seed s
    it equals the live pipeline's batches bit for bit, and its weights
    carry the int8 states."""
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, dtype="fp32",
                              max_res_log2=5, gan_dir=str(tmp_path),
                              device=CPU, seed=4)
    gen.cfg = GanConfig(**SMALL, dtype="fp32")
    from gan_segmentation_tpu_torch.models.stylegan import init_generator
    gen.model = init_generator(gen.cfg, seed=4).eval()
    scfg = SolverConfig(max_res_log2=5, features=[8, 8, 8, 8, 2],
                        in_channels=gen.cfg.feature_channels)
    solver = SegSolver(5, str(tmp_path), str(tmp_path / "none"), cfg=scfg,
                       device=CPU)
    pipe = tgen.FusedPipeline(gen, solver, quant="int8-full")
    d = str(tmp_path / "gen_int8.bundle")
    texport.export_fused_pipeline_bundle(pipe, 2, d)
    serve = texport.load_bundle(d)
    assert serve.meta["quant"] == "int8-full"
    weights = torch.load(os.path.join(d, "weights.pt"), weights_only=True)
    assert any(t.dtype == torch.int8 for t in weights.values())
    assert any(k.startswith("gen_quant.") for k in weights)
    for i in range(2):
        args = texport.draw_inputs(serve.meta, torch.Generator().manual_seed(
            4 * 2 ** 32 + i))
        want = pipe.sample_batch()
        assert all(torch.equal(a, b) for a, b in zip(serve(*args), want))


@pytest.mark.parametrize("batch", [8, 1, 2])
def test_s8_plan_fits_every_int8_shape(batch):
    """The s8 launch plan of every s8 3x3 call of int8-full generation at
    ffhq 1024^2, cars and bedrooms: within a block's shared memory, a
    stage of 32 or 64 channels, the split-K covering every Cin chunk once,
    a grid inside CUDA's limits; Cout up to 4 x 512 (the sub-pixel convs)
    and 4 x 32 (a block stage's conv_0)."""
    shapes = set()
    for gan in ("ffhq", "cars", "bedrooms"):
        gcfg = gan_config(gan)
        got = tq.conv3x3_s8_shapes(
            gcfg, SolverConfig(max_res_log2=gcfg.max_res_log2), batch)
        shapes |= {(s, k == "conv_in_stats_s8") for k, v in got.items()
                   for s in v}
    assert max(s[0][4] for s in shapes) == 4 * 512
    assert (batch, 128, 128, 64, 4 * 32) in {s for s, _ in shapes}
    for (n, h, w, cin, cout), noise in shapes:
        p = tc_plan.plan(n, h, w, cin, cout, noise, s8=True)
        assert p.s8 and p.ck in (32, 64), p
        assert p.smem_bytes <= tc_plan.MAX_SMEM, p
        assert p.tw * p.th * p.g == p.bm == 32 * p.wm, p
        chunks = -(-cin // p.ck)
        assert (p.splits - 1) * p.cps < chunks <= p.splits * p.cps, p
        assert p.blocks < 2 ** 31 and p.groups <= 65535


def test_s8_shapes_match_the_pipeline(tmp_path):
    """``conv3x3_s8_shapes`` lists what an int8-full batch calls: the s8
    wrappers' calls on the CPU, shape for shape."""
    seen = {"conv_in_stats_s8": [], "small_conv_s8": []}
    real = (k1m.conv3x3_noise_bias_lrelu_instats_s8_plain,
            k2m.conv3x3_small_s8_plain)

    def spy(key, fn):
        def call(x, w, *a, **k):
            seen[key].append((*x.shape, w.shape[2]))
            return fn(x, w, *a, **k)
        return call

    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    pipe = tgen.FusedPipeline(_generator(batch=3), solver, quant="int8-full")
    pipe.program()
    k1m.conv3x3_noise_bias_lrelu_instats_s8_plain = spy("conv_in_stats_s8",
                                                        real[0])
    k2m.conv3x3_small_s8_plain = spy("small_conv_s8", real[1])
    try:
        pipe.sample_batch()
    finally:
        (k1m.conv3x3_noise_bias_lrelu_instats_s8_plain,
         k2m.conv3x3_small_s8_plain) = real
    want = tq.conv3x3_s8_shapes(pipe.gen.cfg, solver.cfg, 3)
    assert {k: sorted(v) for k, v in seen.items()} == {
        k: sorted(v) for k, v in want.items()}


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels build with nvcc)")
    return torch.device("cuda")


@contextlib.contextmanager
def _mma_sync_s8_body():
    """The s8 calls on the mma.sync s8 body inside: the rule's Hopper plan
    swapped for ``tc_plan.plan(s8=True)``."""
    _build._tc_plan_c.cache_clear()
    try:
        with mock.patch.object(
                tc_plan, "plan_s8",
                lambda n, h, w, cin, cout, noise=False, aligned=True:
                tc_plan.plan(n, h, w, cin, cout, noise, s8=True)):
            yield
    finally:
        _build._tc_plan_c.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4, 4, 512, 512), (8, 8, 8, 512, 2048),
                                   (2, 64, 64, 64, 128), (3, 12, 20, 3, 5),
                                   (8, 128, 128, 32, 2)])
def test_cuda_s8_bodies_are_exact(cuda, shape):
    """Both s8 entries and the quantize pass on the card equal their plain
    versions bit for bit (deq = 1, f32 out), split-K and ragged shapes
    included; with real scales, bias and activation y is equal, on the
    Hopper body the rule picks and on the mma.sync s8 body alike."""
    n, h, w, cin, cout = shape
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((n, h, w, cin), device=cuda, generator=g).bfloat16()
    inv = torch.tensor([40.0], device=cuda)
    xq = kqm.quantize_s8(x, inv)
    assert torch.equal(xq, kqm.quantize_s8_plain(x, inv))
    wq = torch.randint(-127, 128, (3, 3, cout, cin), dtype=torch.int8,
                       device=cuda, generator=g)
    one = torch.ones(cout, device=cuda)
    deq = torch.rand(cout, device=cuda, generator=g) * 1e-4
    b = torch.randn(cout, device=cuda, generator=g)
    noise = torch.randn((n, h, w), device=cuda, generator=g)
    assert tc_plan.plan_s8(n, h, w, cin, cout).sm90 == (cin % 16 == 0)
    for body in (contextlib.nullcontext, _mma_sync_s8_body):
        with body():
            assert torch.equal(
                k2m.conv3x3_small_s8(xq, wq, one, out_dtype=torch.float32),
                k2m.conv3x3_small_s8_plain(xq, wq, one,
                                           out_dtype=torch.float32))
            got = k2m.conv3x3_small_s8(xq, wq, deq, b, leaky=0.2)
            want = k2m.conv3x3_small_s8_plain(xq, wq, deq, b, leaky=0.2)
            assert torch.equal(got, want)
            y, mean, var = k1m.conv3x3_noise_bias_lrelu_instats_s8(
                xq, wq, deq, noise, b, b)
            yp, mp, vp = k1m.conv3x3_noise_bias_lrelu_instats_s8_plain(
                xq, wq, deq, noise, b, b)
            assert torch.equal(y, yp)
            torch.testing.assert_close(mean, mp, atol=1e-2, rtol=1e-2)
            torch.testing.assert_close(var, vp, atol=1e-2, rtol=1e-2)

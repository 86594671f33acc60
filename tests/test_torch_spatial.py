"""``generate --spatial N`` in the port (gan_segmentation_tpu_torch/core/
{mesh,spatial}.py, ``FusedPipeline(mesh=grid)``, ``run_generate``) on the
CPU, f32, with z and the noise injected.

- The grid equals the JAX package's ``spatial_mesh`` case by case (shape
  and device order) on the 8 virtual CPU devices of ``conftest.py``.
- The banded pipeline on grids of CPU devices, N in {2, 3, 4, 8} and D in
  {1, 2}, at 32^2 and 64^2 against the one-device port: logits within
  2e-4 (the JAX package's own bound for its sharded forward,
  ``tests/test_spatial.py``), the share of image bytes more than 1 apart
  and the share of mask pixels that differ each under 1e-3
  (``tests/test_generator_pipeline.py``'s bounds).  The noise scales and
  biases are drawn nonzero, so that a band that read another band's noise
  would show.
- At 32^2 one grid is held to the JAX package's unsharded
  ``FusedPipeline(s2d=False)`` on the same parameters, as
  ``tests/test_torch_pipeline.py`` holds the one-device port (noise scales
  at zero there: the two packages' noise streams differ).
- ``run_generate --spatial`` writes what a grid pipeline gives and
  ``--resume`` rewrites a lost tail byte for byte; the refusals: quant
  with a spatial grid, spatial under several processes, a grid larger
  than the cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.core.config import GanConfig as JGanConfig
from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.core.mesh import spatial_mesh
from gan_segmentation_tpu.models.stylegan import \
    StyleGanGenerator as JStyleGan
from gan_segmentation_tpu.train import generator as jgen
from gan_segmentation_tpu.train.solver import SegSolver as JSegSolver

from gan_segmentation_tpu_torch.apps import main as app
from gan_segmentation_tpu_torch.core import config as tconfig
from gan_segmentation_tpu_torch.core import distributed as dist_
from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.core import mesh as tmesh
from gan_segmentation_tpu_torch.core import spatial
from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import (
    decoder_state_dict, generator_state_dict)
from gan_segmentation_tpu_torch.models.stylegan import StyleGanGenerator
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")
LOGIT_TOL = 2e-4
SHARE_TOL = 1e-3


# ------------------------------------------------------------------ grid
@pytest.mark.parametrize("spatial_n,dp", [
    (1, None), (1, 1), (1, 0), (1, 2), (1, 8), (2, None), (4, None),
    (8, None), (2, 0), (4, 0), (3, 0), (2, 1), (2, 2), (4, 2), (3, 2),
    (2, 4), (8, 1)])
def test_grid_is_spatial_mesh(spatial_n, dp):
    """``generate_devices`` over 8 labelled devices against ``spatial_mesh``
    over the 8 virtual CPU devices: None together, else the same (data,
    space) shape and the same devices in the same places (N = 1: the
    ``--dp`` list, a mesh of one column)."""
    jdevs = jax.devices()
    assert len(jdevs) == 8
    cards = [torch.device("cuda", i) for i in range(8)]
    want = spatial_mesh(spatial_n, dp=dp, devices=jdevs)
    got = tmesh.generate_devices(spatial_n, dp, cards)
    if want is None:
        assert got is None
        return
    ids = np.vectorize(lambda d: jdevs.index(d))(want.devices)
    if spatial_n <= 1:
        assert ids.shape[1] == 1
        assert [d.index for d in got] == ids[:, 0].tolist()
    else:
        assert [[d.index for d in row] for row in got] == ids.tolist()


@pytest.mark.parametrize("spatial_n,dp", [(3, None), (2, 5), (4, 3),
                                          (2, -1), (1, 9), (1, -1)])
def test_grid_refusals_are_spatial_meshs(spatial_n, dp):
    """A grid larger than the cards, an N that does not divide them (no
    ``--dp``), a negative ``--dp``: ``ValueError``, as ``spatial_mesh``."""
    cards = [torch.device("cuda", i) for i in range(8)]
    with pytest.raises(ValueError):
        spatial_mesh(spatial_n, dp=dp, devices=jax.devices())
    with pytest.raises(ValueError):
        tmesh.generate_devices(spatial_n, dp, cards)


@pytest.mark.parametrize("h,n", [(4, 2), (4, 3), (4, 4), (8, 3), (13, 5),
                                 (1024, 8)])
def test_band_rows_are_tensor_split(h, n):
    got = spatial.band_rows(h, n)
    want = torch.tensor_split(torch.arange(h), n)
    assert [b - a for a, b in got] == [len(t) for t in want]
    assert got[0][0] == 0 and got[-1][1] == h
    assert all(got[k][1] == got[k + 1][0] for k in range(n - 1))


def test_band_plan_doubles_the_first_split():
    """ffhq at N = 3: 4^2 is the first height with 4 >= 3 rows (2 + 1 + 1),
    and each later height doubles the bounds; at N = 8 the 4^2 block runs
    whole; an image with fewer rows than bands is refused."""
    heights = [4 * 2 ** k for k in range(9)]
    plan = spatial.BandPlan(heights, 3)
    assert plan.bounds(4) == ((0, 2), (2, 3), (3, 4))
    assert plan.bounds(1024) == ((0, 512), (512, 768), (768, 1024))
    plan8 = spatial.BandPlan(heights, 8)
    assert plan8.bounds(4) is None and plan8.bounds(8) == tuple(
        (k, k + 1) for k in range(8))
    with pytest.raises(ValueError, match="fewer than the bands"):
        spatial.BandPlan([4, 8], 16)
    with pytest.raises(ValueError, match="none of"):
        plan.bounds(12)


def test_halo_and_moments():
    """``with_halo``: each band with its neighbours' edge rows and zeros at
    the image's ends, the same cut from a whole tensor; ``band_moments``:
    the whole image's mean and variance from the bands' sums."""
    x = torch.randn(2, 7, 3, 4, generator=torch.Generator().manual_seed(1))
    bounds = spatial.band_rows(7, 3)
    devs = [CPU] * 3
    banded = spatial.as_bands(spatial.whole(x), bounds, devs)
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    for src in (banded, spatial.whole(x)):
        for (a, b), t in zip(bounds, spatial.with_halo(src, bounds, devs)):
            assert torch.equal(t, padded[:, a:b + 2])
    assert torch.equal(spatial.gather(banded, CPU), x)
    stats = spatial.band_moments(
        [(t.sum(dim=(1, 2)), (t * t).sum(dim=(1, 2))) for t in banded.parts],
        7 * 3, devs)
    mean = x.mean(dim=(1, 2))
    var = (x * x).mean(dim=(1, 2)) - mean * mean
    for m, v in stats:
        torch.testing.assert_close(m, mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(v, var, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- banded pipeline
def _generator(res, seed=3, batch=4):
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=batch, dtype="fp32",
                              max_res_log2=res, gan_dir="/nonexistent",
                              device=CPU, seed=seed)
    g = torch.Generator().manual_seed(seed + 10)
    with torch.no_grad():  # nonzero noise scales and biases
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


def _one_device_floats(pipe, z, noise):
    """(rgb, logits) of the one-device program on z and the noise."""
    prog = pipe.program()
    with torch.inference_mode():
        rgb, feats = prog.model(z, noise=noise)
        return rgb, prog.decoder(feats, prog.folded(), prog.dtype)


def _shares(a, b):
    """(share of image bytes more than 1 apart, share of mask pixels that
    differ) of two (images, packed masks) batches."""
    img = (a[0].int() - b[0].int()).abs() > 1
    ma = np.unpackbits(a[1].numpy(), axis=-1)
    mb = np.unpackbits(b[1].numpy(), axis=-1)
    return img.float().mean().item(), float(np.mean(ma != mb))


@pytest.mark.parametrize("res", [5, 6])
@pytest.mark.parametrize("n,d", [(2, 1), (3, 1), (4, 1), (8, 1), (2, 2),
                                 (3, 2), (4, 2), (8, 2)])
def test_banded_pipeline_matches_one_device(res, n, d, tmp_path):
    solver = _solver(res, tmp_path)
    one = tgen.FusedPipeline(_generator(res), solver,
                             inference_dtype=torch.float32)
    grid = tgen.FusedPipeline(_generator(res), solver,
                              inference_dtype=torch.float32,
                              mesh=[[CPU] * n for _ in range(d)])
    assert grid.spatial == n and grid.grid_program().shape == (d, n)
    for _ in range(2):  # two batches of the same stream
        want, got = one.sample_batch(), grid.sample_batch()
        assert got[0].shape == want[0].shape == (4, 2 ** res, 2 ** res, 3)
        assert got[1].shape == want[1].shape
        img_share, mask_share = _shares(want, got)
        assert img_share < SHARE_TOL and mask_share < SHARE_TOL
    z, noise = one.gen.draw_inputs(4)
    _, want_logits = _one_device_floats(one, z, noise)
    program = grid.grid_program()
    for row, (a, b) in zip(program.rows, spatial.band_rows(4, d)):
        with torch.inference_mode():
            rgb, logits = program.floats(
                row, z[a:b], {k: v[a:b] for k, v in noise.items()})
        assert logits.bounds == spatial.BandPlan.of(
            one.gen.cfg, n).bounds(2 ** res)
        np.testing.assert_allclose(spatial.gather(logits, CPU).numpy(),
                                   want_logits[a:b].numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_grid_refolds_with_the_solver(tmp_path):
    """When the solver's weights move, every band's copy of the decoder
    takes them (a grid of two devices of one type: one copy; the program
    reads the refolded tensors)."""
    solver = _solver(5, tmp_path)
    one = tgen.FusedPipeline(_generator(5), solver,
                             inference_dtype=torch.float32)
    grid = tgen.FusedPipeline(_generator(5), solver,
                              inference_dtype=torch.float32,
                              mesh=[[CPU, CPU]])
    before = grid.sample_batch()
    one.sample_batch()
    with torch.no_grad():
        for p in solver.model.parameters():
            p.mul_(1.5)
    solver.weights_version += 1
    want, got = one.sample_batch(), grid.sample_batch()
    assert _shares(want, got)[1] < SHARE_TOL
    assert not torch.equal(got[1], before[1])


# ------------------------------------------------ against the JAX package
NARROW = dict(max_res_log2=5, fmap_base=128, fmap_max=32, latent_size=32,
              dtype="fp32")
FEATURES = [8, 8, 8, 8]


def _jax_params():
    model = JStyleGan(JGanConfig(**NARROW))
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32), jnp.float32))["params"]
    rng = np.random.RandomState(0)

    def draw(path, p):
        leaf = path[-1].key
        if leaf in ("scale_factors", "latent_avg"):
            return np.zeros(p.shape, np.float32)
        if leaf == "truncation_psi":
            return np.ones(p.shape, np.float32)
        if leaf == "bias":
            return (0.1 * rng.randn(*p.shape)).astype(np.float32)
        std = 100.0 if path[0].key == "mapping" else 1.0
        return (std * rng.randn(*p.shape)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [draw(path, p) for path, p in flat])


def test_grid_matches_the_jax_unsharded_pipeline(tmp_path):
    """A 2 x 3 grid at 32^2 against the JAX package's unsharded
    ``FusedPipeline(s2d=False)`` (the program its own sharded one is held
    to): images within 1 LSB, masks equal wherever the top-2 logit margin
    exceeds 1e-3."""
    params = _jax_params()
    jg = jgen.ImageGenerator(gan="bedrooms", batch_size=4, dtype="fp32",
                             max_res_log2=5, params=params)
    jg.cfg = JGanConfig(**NARROW)
    jg.model = JStyleGan(jg.cfg, jnp.float32)
    jcfg = JSolverConfig(max_res_log2=5, features=FEATURES + [2],
                         in_channels=jg.cfg.feature_channels)
    js = JSegSolver(5, str(tmp_path), str(tmp_path / "none"), cfg=jcfg)
    jpipe = jgen.FusedPipeline(jg, js, inference_dtype=jnp.float32,
                               s2d=False)

    tg = tgen.ImageGenerator(gan="bedrooms", batch_size=4, dtype="fp32",
                             max_res_log2=5, gan_dir=str(tmp_path),
                             device=CPU)
    tg.cfg = GanConfig(**NARROW)
    tg.model = StyleGanGenerator(tg.cfg).eval()
    tg.model.load_state_dict(generator_state_dict(params))
    ts = SegSolver(5, str(tmp_path), str(tmp_path / "none"),
                   cfg=SolverConfig(max_res_log2=5, features=FEATURES + [2],
                                    in_channels=tg.cfg.feature_channels),
                   device=CPU)
    ts.model.load_state_dict(decoder_state_dict(
        jax.device_get(js.params), jax.device_get(js.batch_stats)))
    grid = tgen.FusedPipeline(tg, ts, inference_dtype=torch.float32,
                              mesh=[[CPU] * 3] * 2)

    z = np.random.RandomState(7).randn(4, 32).astype(np.float32)
    jimg, jmask = jpipe._fused(jpipe._gen_params, jpipe._prepared(),
                               jnp.asarray(z), jax.random.PRNGKey(0))
    zt = torch.from_numpy(z)
    noise = tg.model.draw_noise(4, torch.Generator().manual_seed(1))
    with torch.inference_mode():
        timg, tmask = grid.grid_program()(zt, noise)
        _, want_logits = _one_device_floats(grid, zt, noise)
    lsb = np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert lsb.max() <= 1
    top2 = np.sort(want_logits.numpy(), axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 1e-3
    jm = np.unpackbits(np.asarray(jmask), axis=-1)
    tm = np.unpackbits(tmask.numpy(), axis=-1)
    np.testing.assert_array_equal(tm[confident], jm[confident])
    assert confident.mean() > 0.9


# ------------------------------------------------------------ run_generate
def _app_config(base, tmp_path, n=5):
    SegSolver(4, "", str(base / "checkpoints"), device=CPU).save()
    return tconfig.AppConfig(BASE_DIR=str(base), GAN="bedrooms",
                             GAN_DIR=str(tmp_path / "no-models"),
                             GAN_BATCH_SIZE_PER_GPU=2, GENERATE_NUM=n,
                             MAX_RES_LOG2=4)


def test_run_generate_spatial_and_resume(tmp_path, monkeypatch):
    """``generate --spatial 2 --dp 2`` on four CPU devices through the
    test-only device override: the pairs a 2 x 2 grid pipeline gives, and
    ``--resume`` after losing the tail rewrites it byte for byte; the log
    names the grid."""
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    real = tmesh.generate_devices
    monkeypatch.setattr(app, "generate_devices", lambda s, dp=None: real(
        s, dp, [CPU] * 4))
    base = tmp_path / "exp"
    cfg = _app_config(base, tmp_path)
    out = base / "dataset" / "train_generated"
    lines = []
    monkeypatch.setattr(app.log, "info",
                        lambda msg, *a: lines.append(msg % a))
    app.run_generate(cfg, spatial=2, dp=2, writer="cv2")
    assert any("grid (data=2, space=2)" in s for s in lines)
    ref = {p.name: p.read_bytes() for p in out.iterdir()}
    assert len(ref) == 10
    # the same pairs from a grid pipeline written by the same writer
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, max_res_log2=4,
                              seed=0, device=CPU,
                              gan_dir=str(tmp_path / "no-models"))
    pipe = tgen.FusedPipeline(gen, app.build_solver(cfg),
                              mesh=[[CPU, CPU], [CPU, CPU]])
    dst = tmp_path / "direct"
    dst.mkdir()
    app._write_pairs_cv2(pipe, 5, str(dst), 0, None)
    assert {p.name: p.read_bytes() for p in dst.iterdir()} == ref
    for name in ("img_000003.jpg", "mask_000003.png", "img_000004.jpg",
                 "mask_000004.png"):
        (out / name).unlink()
    app.run_generate(cfg, spatial=2, dp=2, writer="cv2", resume=True)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == ref


def test_quant_with_spatial_is_refused(tmp_path, monkeypatch):
    """As the JAX package: ``ValueError`` naming spatial from the pipeline,
    ``SystemExit`` from ``run_generate``."""
    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, max_res_log2=4,
                              gan_dir="/nonexistent", device=CPU)
    with pytest.raises(ValueError, match="spatial"):
        tgen.FusedPipeline(gen, solver, mesh=[[CPU, CPU]], quant="int8")
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    real = tmesh.generate_devices
    monkeypatch.setattr(app, "generate_devices", lambda s, dp=None: real(
        s, dp, [CPU] * 2))
    cfg = _app_config(tmp_path / "exp", tmp_path)
    with pytest.raises(SystemExit, match="spatial"):
        app.run_generate(cfg, spatial=2, writer="cv2", quant="int8")


def test_spatial_under_several_processes_is_refused(monkeypatch):
    monkeypatch.setattr(dist_, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="single-process"):
        app.run_generate(tconfig.AppConfig(), spatial=2)


def test_grid_larger_than_the_cards_is_refused(monkeypatch):
    """Two cards: ``--spatial 2 --dp 2`` needs four; ``--spatial 4`` alone
    does not divide them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for kw in (dict(spatial=2, dp=2), dict(spatial=4)):
        with pytest.raises(SystemExit, match="devices|divide"):
            app.run_generate(tconfig.AppConfig(), **kw)
    with pytest.raises(ValueError, match="fewer than the bands"):
        tgen.FusedPipeline(
            tgen.ImageGenerator(gan="bedrooms", max_res_log2=2,
                                gan_dir="/nonexistent", device=CPU),
            SegSolver(2, "", "/nonexistent", device=CPU),
            mesh=[[CPU] * 8])

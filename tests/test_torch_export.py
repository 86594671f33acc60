"""The port's serving export (gan_segmentation_tpu_torch/core/export.py,
apps/export.py, kernels/ops.py), on the CPU at small widths, case by case
as tests/test_export.py holds the JAX package's.

On the CPU an artifact runs the same ATen ops as its live program (the
custom ops of kernels 1 and 2 take their plain versions there), so every
round trip here is equal bit for bit: no tolerance.  Against the JAX
package's artifacts on the same parameters: DeepLab-eval scores within
2e-3 of the largest score (``test_torch_multiscale_eval.py::_close``);
generate images within 1 LSB and masks equal wherever the top-2 logit
margin exceeds 1e-3 (``test_torch_pipeline.py::
test_fused_slice_matches_jax``; noise scales at their init of zero, so the
packages' different noise streams do not matter).

The JAX package is imported inside the cross-package tests only, so that
the ``cuda``-marked test runs on the card's machine, which has no flax.
"""

import os
import subprocess
import sys
import zipfile
from os.path import dirname

import numpy as np
import pytest
import torch

from gan_segmentation_tpu_torch.core import export as texport
from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import deeplab_state_dict
from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
from gan_segmentation_tpu_torch.kernels import small_conv as k2m
from gan_segmentation_tpu_torch.models.resnet import Conv2d
from gan_segmentation_tpu_torch.models.stylegan import init_generator
from gan_segmentation_tpu_torch.train import deeplab_trainer as ttrainer
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

REPO = dirname(dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NCLASS = 2
# a narrow generator at res 32 and a decoder over its pyramid
SMALL = dict(max_res_log2=5, fmap_base=128, fmap_max=32, latent_size=32)
SMALL_FEATURES = [8, 8, 8, 8]


# ------------------------------------------------------------ DeepLab eval
class TorchSeg(torch.nn.Module):
    """The two-conv segmenter of tests/test_torch_multiscale_eval.py."""

    def __init__(self, nclass=NCLASS):
        super().__init__()
        self.conv0 = Conv2d(3, 8, 3, padding=1, bias=True)
        self.conv1 = Conv2d(8, nclass, 3, padding=1, bias=True)

    def forward(self, x):
        return (self.conv1(torch.relu(self.conv0(x))),)


def seg_params(seed=0):
    """numpy params of the JAX ``JaxSeg`` tree (HWIO kernels)."""
    rs = np.random.RandomState(seed)
    draw = lambda *s: (0.5 * rs.randn(*s)).astype(np.float32)
    return {"conv0": {"kernel": draw(3, 3, 3, 8), "bias": draw(8)},
            "conv1": {"kernel": draw(3, 3, 8, NCLASS), "bias": draw(NCLASS)}}


def port_eval(params, **kw):
    model = TorchSeg()
    model.load_state_dict(deeplab_state_dict(params, {}))
    return ttrainer.MultiEvalModel(model, NCLASS, **kw)


def _images(b, h, w, seed=0):
    return np.random.RandomState(seed).randn(b, h, w, 3).astype(np.float32)


def test_eval_roundtrip_matches_live_program(tmp_path):
    ev = port_eval(seg_params(), crop_size=32, base_size=48,
                   scales=(0.5, 1.0), flip=True)
    imgs = _images(2, 40, 40)
    path = str(tmp_path / "eval.pt2")
    texport.export_eval_model(ev, 2, 40, 40, 3, path)
    serve = texport.load_artifact(path)
    assert serve.meta["kind"] == "deeplab_eval"
    assert serve.meta["device"] == "cpu"
    live = ev.device_scores_batch(list(imgs))
    got = serve(imgs)
    assert got.dtype == torch.float32 and got.shape == (2, 40, 40, NCLASS)
    assert torch.equal(got, live)


def test_artifact_is_weight_hermetic(tmp_path):
    """Zeroing the live weights after the export leaves the artifact's
    outputs as they were (the weights are inside the file)."""
    ev = port_eval(seg_params(1), crop_size=32, base_size=32, flip=False)
    imgs = _images(1, 32, 32, seed=1)
    path = str(tmp_path / "eval.pt2")
    texport.export_eval_model(ev, 1, 32, 32, 3, path)
    before = texport.load_artifact(path)(imgs)
    with torch.no_grad():
        for p in ev.model.parameters():
            p.zero_()
    after = texport.load_artifact(path)(imgs)
    assert torch.equal(before, after)
    assert not torch.allclose(before, ev.device_scores_batch(list(imgs)))


def test_eval_artifact_matches_jax_artifact(tmp_path):
    from gan_segmentation_tpu.core.export import \
        export_eval_model as jexport_eval
    from gan_segmentation_tpu.core.export import load_artifact as jload
    from gan_segmentation_tpu.train import deeplab_trainer as jtrainer
    from test_torch_multiscale_eval import JaxSeg, _close

    params = seg_params(2)
    kw = dict(crop_size=32, base_size=48, scales=(0.5, 1.0), flip=True)
    imgs = _images(2, 40, 40, seed=2)
    jpath, tpath = str(tmp_path / "j.stablehlo"), str(tmp_path / "t.pt2")
    jexport_eval(jtrainer.MultiEvalModel(JaxSeg(), params, {}, NCLASS, **kw),
                 2, 40, 40, 3, jpath)
    texport.export_eval_model(port_eval(params, **kw), 2, 40, 40, 3, tpath)
    _close(texport.load_artifact(tpath)(imgs), jload(jpath)(imgs))


def test_loader_refuses_another_device(tmp_path):
    ev = port_eval(seg_params(), crop_size=32, base_size=32, flip=False)
    path = str(tmp_path / "eval.pt2")
    texport.export_eval_model(ev, 1, 32, 32, 3, path)
    with pytest.raises(ValueError, match="exported for cpu"):
        texport.load_artifact(path, device="cuda")
    with pytest.raises(ValueError, match="not an artifact"):
        bad = tmp_path / "bad.zip"
        with zipfile.ZipFile(bad, "w") as zf:
            zf.writestr("x/other.json", "{}")
        texport.load_artifact(str(bad))


# ------------------------------------------------------------------ bundles
class Affine(torch.nn.Module):
    def __init__(self, n=512):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((n, n), 2.0 / n))
        self.register_buffer("b", torch.arange(n, dtype=torch.float32))

    def forward(self, x):
        return x @ self.w + self.b


def test_bundle_roundtrip_and_weight_swap(tmp_path):
    """The bundle keeps its weights in weights.pt: the program file holds
    none of their bytes, the outputs match, and rewriting weights.pt alone
    changes what is served."""
    n = 512
    d = str(tmp_path / "bundle")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, n).astype(
        np.float32))
    module = Affine(n)
    texport.save_bundle(d, module, (x,))
    assert sorted(os.listdir(d)) == ["meta.json", "program.pt2",
                                     "weights.pt"]
    assert torch.equal(texport.load_bundle(d)(x), module(x).detach())
    program = os.path.getsize(os.path.join(d, "program.pt2"))
    weights = os.path.getsize(os.path.join(d, "weights.pt"))
    assert weights > n * n * 4 and program < 100_000, (program, weights)
    meta = texport.load_bundle_meta(d)
    assert meta["device"] == "cpu" and meta["n_weights"] == 2
    assert meta["torch"] == torch.__version__
    torch.save({"w": torch.eye(n), "b": torch.zeros(n)},
               os.path.join(d, "weights.pt"))
    assert torch.equal(texport.load_bundle(d)(x), x)
    # a weights.pt that does not fit the program is refused
    torch.save({"w": torch.eye(n)}, os.path.join(d, "weights.pt"))
    with pytest.raises(ValueError, match="weights.pt"):
        texport.load_bundle(d)
    torch.save({"w": torch.eye(n + 1), "b": torch.zeros(n)},
               os.path.join(d, "weights.pt"))
    with pytest.raises(ValueError, match="the program takes"):
        texport.load_bundle(d)


# ---------------------------------------------------------------- generate
def small_pipeline(tmp_path, dtype="fp32", seed=0):
    """A FusedPipeline on the CPU at res 32, narrow, with the noise scales
    and the decoder's batch-norm statistics moved off their init (so the
    noise inputs and the fold show in the outputs)."""
    gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2, dtype=dtype,
                              max_res_log2=5, gan_dir=str(tmp_path),
                              device=CPU, seed=seed)
    gen.cfg = GanConfig(**SMALL, dtype=dtype)
    gen.model = init_generator(gen.cfg, seed=seed,
                               compute_dtype=gen.model.compute_dtype).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in gen.model.named_parameters():
            if name.endswith("scale_factors"):
                p.copy_(torch.randn(p.shape, generator=g))
    scfg = SolverConfig(max_res_log2=5, features=SMALL_FEATURES + [NCLASS],
                        in_channels=gen.cfg.feature_channels)
    solver = SegSolver(5, str(tmp_path), str(tmp_path / "none"), cfg=scfg,
                       device=CPU)
    with torch.no_grad():
        for m in solver.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                       generator=g))
                m.running_var.copy_(1 + torch.rand(m.num_features,
                                                   generator=g))
    solver.weights_version += 1
    return tgen.FusedPipeline(gen, solver)


def _seeded(meta, seed, i):
    return texport.draw_inputs(meta, torch.Generator().manual_seed(
        seed * 2 ** 32 + i))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_generate_artifact_is_the_pipeline(tmp_path, dtype):
    """Served from seed s, batches 0 and 1 equal FusedPipeline.sample_batch
    from seed s bit for bit (draw_inputs draws z and the noise in the
    pipeline's order); the record names the noise in draw order."""
    pipe = small_pipeline(tmp_path, dtype, seed=3)
    path = str(tmp_path / "gen.pt2")
    texport.export_fused_pipeline(pipe, 2, path)
    serve = texport.load_artifact(path)
    meta = serve.meta
    assert meta["kind"] == "generate" and meta["batch"] == 2
    assert meta["masks_packed"] and meta["z"] == [2, 32]
    assert [k for k, _ in meta["noise"]] == list(
        pipe.gen.model.noise_shapes(2))
    assert meta["decoder_dtype"] == "bfloat16"
    for i in range(2):
        imgs, masks = serve(*_seeded(meta, 3, i))
        want = pipe.sample_batch()
        assert imgs.dtype == torch.uint8 and masks.shape == (2, 32, 4)
        assert torch.equal(imgs, want[0]) and torch.equal(masks, want[1])
    assert not torch.equal(imgs, serve(*_seeded(meta, 3, 0))[0])


def test_bundle_matches_hermetic(tmp_path):
    pipe = small_pipeline(tmp_path)
    hpath, bdir = str(tmp_path / "gen.pt2"), str(tmp_path / "gen.bundle")
    texport.export_fused_pipeline(pipe, 2, hpath)
    texport.export_fused_pipeline_bundle(pipe, 2, bdir)
    h, b = texport.load_artifact(hpath), texport.load_bundle(bdir)
    assert h.meta == {k: v for k, v in b.meta.items() if k != "weights"}
    for i in range(2):
        args = _seeded(h.meta, 0, i)
        for x, y in zip(h(*args), b(*args)):
            assert torch.equal(x, y)
    # the program file holds the graph and no weight bytes: it is smaller
    # than the artifact by (nearly) all of them
    weights = torch.load(os.path.join(bdir, "weights.pt"), weights_only=True)
    nbytes = sum(t.numel() * t.element_size() for t in weights.values())
    saved = os.path.getsize(hpath) - os.path.getsize(
        os.path.join(bdir, "program.pt2"))
    assert saved > 0.95 * nbytes, (saved, nbytes)


def test_generate_bundle_weight_swap(tmp_path):
    """A decoder refolded into weights.pt changes the served masks, and
    serves what the pipeline serves after the same refold."""
    pipe = small_pipeline(tmp_path, seed=1)
    d = str(tmp_path / "gen.bundle")
    texport.export_fused_pipeline_bundle(pipe, 2, d)
    args = _seeded(texport.load_bundle_meta(d), 1, 0)
    before = texport.load_bundle(d)(*args)
    with torch.no_grad():
        for p in pipe.solver.model.parameters():
            p.neg_()
    pipe.solver.weights_version += 1
    pipe.program()  # refolds into the program's buffers
    weights = torch.load(os.path.join(d, "weights.pt"), weights_only=True)
    state = pipe.program().state_dict()
    torch.save({k: state[k] for k in weights}, os.path.join(d, "weights.pt"))
    after = texport.load_bundle(d)(*args)
    assert torch.equal(after[0], before[0])  # the generator is unchanged
    assert not torch.equal(after[1], before[1])
    want = pipe._fused(args[0], noise=args[1])
    assert torch.equal(after[1], want[1])


def test_eager_batch_after_an_export_is_unchanged(tmp_path):
    """An export fills no cache with a traced tensor: the eager batch after
    it equals the one before it."""
    pipe = small_pipeline(tmp_path, "bf16", seed=2)
    args = _seeded({"z": [2, 32], "noise": [
        [k, list(s)] for k, s in pipe.gen.model.noise_shapes(2).items()]},
        2, 0)
    before = pipe._fused(args[0], noise=args[1])
    tgen._bit_weights.cache_clear()  # the export is the first to need them
    texport.export_fused_pipeline(pipe, 2)
    after = pipe._fused(args[0], noise=args[1])
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    assert type(tgen._bit_weights(CPU)) is torch.Tensor


WORKER = r"""
import sys
import torch
from gan_segmentation_tpu_torch.core.export import (draw_inputs,
                                                    load_artifact,
                                                    load_bundle)
artifact, bundle, out, seed = sys.argv[1:]
outs = {}
for kind, serve in (("artifact", load_artifact(artifact)),
                    ("bundle", load_bundle(bundle))):
    outs[kind] = []
    for i in range(2):
        g = torch.Generator().manual_seed(int(seed) * 2 ** 32 + i)
        outs[kind].append(serve(*draw_inputs(serve.meta, g)))
torch.save(outs, out)
bad = [m for m in sys.modules
       if m.startswith("gan_segmentation_tpu_torch.models")
       or m.split(".")[0] in ("jax", "flax", "gan_segmentation_tpu")]
assert not bad, bad
print("serve-ok")
"""


def test_serves_in_fresh_process(tmp_path):
    """A fresh interpreter that imports only core.export (no model code,
    no jax) loads both forms and reproduces the pipeline's batches bit for
    bit."""
    pipe = small_pipeline(tmp_path, "bf16", seed=4)
    hpath, bdir = str(tmp_path / "gen.pt2"), str(tmp_path / "gen.bundle")
    texport.export_fused_pipeline(pipe, 2, hpath)
    texport.export_fused_pipeline_bundle(pipe, 2, bdir)
    want = [pipe.sample_batch() for _ in range(2)]
    out = str(tmp_path / "out.pt")
    r = subprocess.run([sys.executable, "-c", WORKER, hpath, bdir, out, "4"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO},
                       cwd=str(tmp_path))
    assert r.returncode == 0 and "serve-ok" in r.stdout, \
        (r.stdout + r.stderr)[-3000:]
    got = torch.load(out, weights_only=True)
    for kind in ("artifact", "bundle"):
        for g, w in zip(got[kind], want):
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]), kind


GRID_WORKER = r"""
import sys
import torch
from gan_segmentation_tpu_torch.core.export import draw_inputs, load_bundle
bundle, out, n = sys.argv[1:]
serve = load_bundle(bundle, devices=[torch.device("cpu")] * int(n))
outs = []
for i in range(2):
    g = torch.Generator().manual_seed(4 * 2 ** 32 + i)
    outs.append(serve(*draw_inputs(serve.meta, g)))
torch.save(outs, out)
bad = [m for m in sys.modules
       if m.startswith("gan_segmentation_tpu_torch.models")
       or m.split(".")[0] in ("jax", "flax", "gan_segmentation_tpu")]
assert not bad, bad
print("serve-ok")
"""


@pytest.mark.parametrize("grid", [[[CPU, CPU], [CPU, CPU]],
                                  [[CPU] * 3], [CPU, CPU]],
                         ids=["2x2", "1x3", "dp2"])
def test_grid_bundle_is_the_live_grid_pipeline(tmp_path, grid):
    """A pipeline with a grid (``--spatial`` rows, or a ``--dp`` list)
    exports one bundle of the grid's program, ``"grid": [D, N]`` in its
    record; served on D x N CPU devices, in this process and from a fresh
    interpreter that imports only core.export, it equals the live grid
    pipeline bit for bit; fewer devices are refused."""
    pipe = small_pipeline(tmp_path, seed=4)
    pipe = tgen.FusedPipeline(pipe.gen, pipe.solver, mesh=grid)
    d, n = (len(grid), 1) if isinstance(grid[0], torch.device) else (
        len(grid), len(grid[0]))
    bdir = str(tmp_path / "grid.bundle")
    texport.export_fused_pipeline_bundle(pipe, 2, bdir)
    meta = texport.load_bundle_meta(bdir)
    assert meta["grid"] == [d, n] and meta["grid_devices"] == ["cpu"] * (
        d * n)
    want = [pipe.sample_batch() for _ in range(2)]
    serve = texport.load_bundle(bdir, devices=[CPU] * (d * n))
    for i, w in enumerate(want):
        got = serve(*_seeded(meta, 4, i))
        assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])
    with pytest.raises(ValueError, match="needs %d devices" % (d * n)):
        texport.load_bundle(bdir, devices=[CPU] * (d * n - 1))
    out = str(tmp_path / "out.pt")
    r = subprocess.run([sys.executable, "-c", GRID_WORKER, bdir, out,
                        str(d * n)], capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": REPO},
                       cwd=str(tmp_path))
    assert r.returncode == 0 and "serve-ok" in r.stdout, \
        (r.stdout + r.stderr)[-3000:]
    for g, w in zip(torch.load(out, weights_only=True), want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


def test_platforms_artifact_serves_on_each_listed_type(tmp_path):
    """``platforms=("cpu", "cuda")``: the record lists both, the CPU serves
    it equal to the live pipeline, a type not listed is refused, and so is
    a list that leaves out the device it is traced on."""
    pipe = small_pipeline(tmp_path, seed=2)
    path = str(tmp_path / "xplat.pt2")
    texport.export_fused_pipeline(pipe, 2, path, platforms=("cpu", "cuda"))
    serve = texport.load_artifact(path)
    assert serve.meta["platforms"] == ["cpu", "cuda"]
    assert serve.meta["devices"] == ["cpu"]
    want = pipe.sample_batch()
    got = serve(*_seeded(serve.meta, 2, 0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="exported for cpu and cuda"):
        texport.load_artifact(path, device="meta")
    with pytest.raises(ValueError, match="leave out cpu"):
        texport.export_fused_pipeline(pipe, 2, str(tmp_path / "x.pt2"),
                                      platforms=("cuda",))
    bdir = str(tmp_path / "xplat.bundle")
    texport.export_fused_pipeline_bundle(pipe, 2, bdir, ("cpu", "cuda"))
    assert texport.load_bundle_meta(bdir)["platforms"] == ["cpu", "cuda"]
    with pytest.raises(ValueError, match="devices= is for a grid"):
        texport.load_bundle(bdir, devices=[CPU])


def _jax_gen_params(tpp):
    """test_torch_pipeline.py's narrow JAX generator parameters: conv and
    dense weights drawn with numpy, noise scales and biases zero."""
    import jax
    import jax.numpy as jnp
    from gan_segmentation_tpu.core.config import GanConfig as JGanConfig
    from gan_segmentation_tpu.models.stylegan import \
        StyleGanGenerator as JStyleGan

    shapes = jax.eval_shape(
        JStyleGan(JGanConfig(**tpp.NARROW)).init,
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64), jnp.float32))["params"]
    rng = np.random.RandomState(0)

    def draw(path, p):
        leaf = path[-1].key
        if leaf in ("scale_factors", "bias", "latent_avg"):
            return np.zeros(p.shape, np.float32)
        if leaf == "truncation_psi":
            return np.ones(p.shape, np.float32)
        std = 100.0 if path[0].key == "mapping" else 1.0
        return (std * rng.randn(*p.shape)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [draw(path, p) for path, p in flat])


def test_generate_artifact_matches_jax_artifact(tmp_path):
    """The port's generate artifact against the JAX package's
    ``export_fused_pipeline`` artifact on the same parameters (f32)."""
    import jax
    from gan_segmentation_tpu.core.export import \
        export_fused_pipeline as jexport_fused
    from gan_segmentation_tpu.core.export import load_artifact as jload
    import test_torch_pipeline as tpp

    params = _jax_gen_params(tpp)
    jpipe, tpipe = tpp._pipelines(params, NCLASS, tmp_path)
    jpath, tpath = str(tmp_path / "j.stablehlo"), str(tmp_path / "t.pt2")
    jexport_fused(jpipe, 2, jpath)
    texport.export_fused_pipeline(tpipe, 2, tpath)
    serve = texport.load_artifact(tpath)
    z = np.random.RandomState(7).randn(2, 64).astype(np.float32)
    noise = {k: torch.zeros(s) for k, s in serve.meta["noise"]}
    timg, tmask = serve(z, noise)
    jimg, jmask = jload(jpath)(z, np.asarray(jax.random.key_data(
        jax.random.PRNGKey(0))))
    lsb = np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert lsb.max() <= 1
    with torch.no_grad():
        _, feats = tpipe.gen.model(torch.from_numpy(z), noise=noise)
        logits = tpipe.solver.model(feats).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 1e-3
    tm = np.unpackbits(tmask.numpy(), axis=-1)
    jm = np.unpackbits(np.asarray(jmask), axis=-1)
    np.testing.assert_array_equal(tm[confident], jm[confident])
    assert confident.mean() > 0.9


# ---------------------------------------------------------------------- CLI
def _trained_config(tmp_path):
    """A config over a util_fixtures annotation dir at res 32 with a
    decoder trained on it for one epoch (on the CPU)."""
    from util_fixtures import make_annotation_dir

    base = tmp_path / "base"
    make_annotation_dir(str(base / "data"), n_samples=4, max_res_log2=5,
                        seed=0)
    scfg = SolverConfig(max_res_log2=5, train_epochs=1)
    SegSolver(5, str(base / "data"), str(base / "checkpoints"), cfg=scfg,
              device=CPU).fit()
    cfg_file = tmp_path / "config.yml"
    cfg_file.write_text(f"""
BASE_DIR: {base}
GAN: bedrooms
GAN_DIR: {tmp_path}/no-models
GAN_GPU_IDS: [0]
GAN_BATCH_SIZE_PER_GPU: 2
SOLVER_GPU_IDS: [0]
ANNOTATION: segmentation
GENERATE_NUM: 4
MAX_RES_LOG2: 5
""")
    return str(cfg_file)


def test_export_cli_generate(tmp_path, monkeypatch):
    """apps.export generate: config -> artifact and bundle -> they serve
    what the pipeline of the same config generates."""
    from gan_segmentation_tpu_torch.apps import export as export_cli
    from gan_segmentation_tpu_torch.core import dtypes
    from gan_segmentation_tpu_torch.core.config import load_config_file
    from gan_segmentation_tpu_torch.apps.main import build_solver

    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    config = _trained_config(tmp_path)
    out, bdir = str(tmp_path / "gen.pt2"), str(tmp_path / "gen.bundle")
    export_cli.main(["generate", "--config", config, "-o", out,
                     "--batch", "2"])
    export_cli.main(["generate", "--config", config, "-o", bdir, "--bundle"])
    cfg = load_config_file(config)
    gen = tgen.ImageGenerator(gan="bedrooms", gan_dir=cfg.GAN_DIR,
                              batch_size=2, max_res_log2=5)
    pipe = tgen.FusedPipeline(gen, build_solver(cfg))
    want = pipe.sample_batch()
    for serve in (texport.load_artifact(out), texport.load_bundle(bdir)):
        assert serve.meta["batch"] == 2
        imgs, masks = serve(*_seeded(serve.meta, 0, 0))
        assert imgs.shape == (2, 32, 32, 3) and imgs.dtype == torch.uint8
        assert torch.equal(imgs, want[0]) and torch.equal(masks, want[1])
    # --platforms cpu,cuda: traced on the CPU here (no card), recorded for
    # both types, served on the CPU equal to the pipeline; an unknown type
    # is refused
    xplat = str(tmp_path / "xplat.pt2")
    export_cli.main(["generate", "--config", config, "-o", xplat,
                     "--batch", "2", "--platforms", "cpu,cuda"])
    serve = texport.load_artifact(xplat)
    assert serve.meta["platforms"] == ["cpu", "cuda"]
    imgs, masks = serve(*_seeded(serve.meta, 0, 0))
    assert torch.equal(imgs, want[0]) and torch.equal(masks, want[1])
    with pytest.raises(SystemExit, match="--platforms"):
        export_cli.main(["generate", "--config", config, "-o", out,
                         "--platforms", "cpu,tpu"])


def test_export_cli_refuses_an_untrained_decoder(tmp_path, monkeypatch):
    from gan_segmentation_tpu_torch.apps import export as export_cli
    from gan_segmentation_tpu_torch.core import dtypes

    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    cfg_file = tmp_path / "config.yml"
    cfg_file.write_text(f"BASE_DIR: {tmp_path}\nGAN: bedrooms\n"
                        f"MAX_RES_LOG2: 5\n")
    with pytest.raises(SystemExit, match="train Decoder first"):
        export_cli.main(["generate", "--config", str(cfg_file), "-o",
                         str(tmp_path / "x.pt2")])


def test_export_cli_deeplab(tmp_path, monkeypatch):
    """apps.export deeplab: a DeepLabV3+ checkpoint as train/deeplab_trainer
    .py saves it -> an eval artifact equal to the live evaluator."""
    from gan_segmentation_tpu_torch.apps import export as export_cli
    from gan_segmentation_tpu_torch.core import dtypes
    from gan_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus

    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    model = DeepLabV3Plus(nclass=NCLASS, backbone="resnet50", aux=True,
                          crop_size=32,
                          generator=torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "last_checkpoint.pt")
    ttrainer.save_checkpoint_file(ckpt, model.state_dict())
    out = str(tmp_path / "deeplab.pt2")
    export_cli.main(["deeplab", "--weights", ckpt, "-o", out, "--shape",
                     "1,40,40,3", "--crop-size", "32", "--base-size", "40",
                     "--scales", "0.75,1.0"])
    serve = texport.load_artifact(out)
    assert serve.meta["scales"] == [0.75, 1.0] and serve.meta["flip"]
    ev = ttrainer.MultiEvalModel(model, NCLASS, base_size=40, crop_size=32,
                                 flip=True, scales=(0.75, 1.0))
    imgs = _images(1, 40, 40, seed=5)
    assert torch.equal(serve(imgs), ev.device_scores_batch(list(imgs)))
    assert serve.meta["platforms"] == ["cpu"]
    xplat = str(tmp_path / "xplat.pt2")
    export_cli.main(["deeplab", "--weights", ckpt, "-o", xplat, "--shape",
                     "1,40,40,3", "--crop-size", "32", "--base-size", "40",
                     "--scales", "0.75,1.0", "--platforms", "cpu,cuda"])
    serve = texport.load_artifact(xplat)
    assert serve.meta["platforms"] == ["cpu", "cuda"]
    assert torch.equal(serve(imgs), ev.device_scores_batch(list(imgs)))
    with pytest.raises(SystemExit, match="--platforms"):
        export_cli.main(["deeplab", "--weights", ckpt, "-o", out,
                         "--platforms", "tpu"])


def test_serving_demo_on_the_cpu(tmp_path, monkeypatch):
    """examples/serving_demo.py end to end at res 32: train, export a
    bundle, serve it from a fresh interpreter through the pair writer."""
    from gan_segmentation_tpu_torch.examples import serving_demo

    monkeypatch.setenv("PYTHONPATH", REPO)
    work = tmp_path / "demo"
    serving_demo.main(["--cpu", "--workdir", str(work), "--max-res-log2",
                       "5", "--n-annotations", "2", "--batch", "2",
                       "--n-serve", "3", "--decoder-epochs", "1"])
    assert sorted(os.listdir(work / "generate.bundle")) == [
        "meta.json", "program.pt2", "weights.pt"]
    assert sorted(os.listdir(work / "served")) == [
        f"{kind}_{i:06d}.{ext}" for kind, ext in (("img", "jpg"),
                                                  ("mask", "png"))
        for i in range(3)]


# ---------------------------------------------------------------------- ops
def _op_args(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 5, 6, 8, generator=g).to(dtype)
    w = (torch.randn(3, 3, 8, 4, generator=g) / 8).to(dtype)
    noise = torch.randn(2, 5, 6, generator=g)
    b = 0.1 * torch.randn(4, generator=g)
    return x, w, noise, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_opcheck(dtype):
    x, w, noise, b = _op_args(dtype)
    for args in ((x, w, b, "leaky", 0.2), (x, w, None, "none", 0.0),
                 (x, w, b, "relu", 0.0)):
        torch.library.opcheck(torch.ops.gst.conv3x3_small.default, args)
    torch.library.opcheck(torch.ops.gst.conv3x3_in_stats.default,
                          (x, w, noise, b, b, 0.2))


def test_ops_on_the_cpu_are_the_plain_versions():
    x, w, noise, b = _op_args(torch.float32)
    before = (k1m.conv3x3_noise_bias_lrelu_instats.launches,
              k2m.conv3x3_small.launches)
    assert torch.equal(torch.ops.gst.conv3x3_small(x, w, b, "leaky", 0.2),
                       k2m.conv3x3_small_plain(x, w, b, leaky=0.2))
    for got, want in zip(
            torch.ops.gst.conv3x3_in_stats(x, w, noise, b, b, 0.2),
            k1m.conv3x3_noise_bias_lrelu_instats_plain(x, w, noise, b, b)):
        assert torch.equal(got, want)
    assert (k1m.conv3x3_noise_bias_lrelu_instats.launches,
            k2m.conv3x3_small.launches) == before


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels build with nvcc)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_ops_match_plain_eager_and_in_a_graph(cuda, dtype, tol):
    """Both ops through torch.ops.gst.* launch their kernels (one count
    each), agree with the plain versions, and replay inside a captured
    CUDA graph bit for bit as they ran eagerly."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n, h, w, cin, cout = 4, 32, 32, 64, 64
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
          / (9 * cin) ** 0.5).to(dtype)
    noise = torch.randn((n, h, w), generator=g, device=cuda)
    b = 0.1 * torch.randn((cout,), generator=g, device=cuda)
    k1, k2 = k1m.conv3x3_noise_bias_lrelu_instats, k2m.conv3x3_small

    def both():
        return (torch.ops.gst.conv3x3_small(x, wt, b, "leaky", 0.2),
                *torch.ops.gst.conv3x3_in_stats(x, wt, noise, b, b, 0.2))

    before = (k1.launches, k2.launches)
    eager = both()
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)
    want = (k2m.conv3x3_small_plain(x, wt, b, leaky=0.2),
            *k1m.conv3x3_noise_bias_lrelu_instats_plain(x, wt, noise, b, b))
    for got, ref in zip(eager, want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = both()
    graph.replay()
    torch.cuda.synchronize()
    for got, ref in zip(static, eager):
        assert torch.equal(got, ref)

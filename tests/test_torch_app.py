"""The port's entry point, checkpoints, configs and import boundary.

- ``run_generate`` end to end on the CPU (the main path's device is
  overridden to the CPU, where every kernel wrapper takes its plain
  version): a few pairs at res 32, then ``--resume`` reproduces the tail
  byte for byte;
- ``resume_offset`` and the config dataclasses agree with the JAX copies;
- the package imports with jax, flax, yaml and cv2 blocked.
"""

import dataclasses
import importlib
import pkgutil
import re
import subprocess
import sys
from os.path import dirname, join

import numpy as np
import pytest
import torch

import gan_segmentation_tpu.core.config as jconfig
from gan_segmentation_tpu.apps.main import resume_offset as jax_resume_offset

import gan_segmentation_tpu_torch
from gan_segmentation_tpu_torch.apps import main as app
from gan_segmentation_tpu_torch.core import config as tconfig
from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

REPO = dirname(dirname(__file__))
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["GanConfig", "SolverConfig", "AppConfig"])
def test_config_dataclasses_match_jax(name):
    ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
    fields = lambda c: [(f.name, f.type) for f in dataclasses.fields(c)]
    assert fields(ours) == fields(theirs)
    a, b = ours(), theirs()
    for f in dataclasses.fields(ours):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert ours.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen


def test_config_helpers_match_jax(tmp_path):
    assert tconfig.MAX_RES_LOG2 == jconfig.MAX_RES_LOG2
    for gan in tconfig.MAX_RES_LOG2:
        assert tconfig.gan_config(gan).feature_channels == \
            jconfig.gan_config(gan).feature_channels
    path = tmp_path / "config.yml"
    path.write_text("GAN: cars\nGENERATE_NUM: 7\nNUM_CLASSES: 3\nJUNK: 1\n")
    ours = tconfig.load_config_file(str(path))
    theirs = jconfig.load_config_file(str(path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.solver_config()) == \
        dataclasses.asdict(theirs.solver_config())


def _touch_pairs(d, indices):
    for i in indices:
        (d / f"img_{i:06d}.jpg").write_bytes(b"x")
        (d / f"mask_{i:06d}.png").write_bytes(b"x")


@pytest.mark.parametrize("present,start,n,batch", [
    (range(5), 0, 8, 2), (range(5), 0, 8, 3), ([0, 1, 3, 4], 0, 8, 2),
    (range(10, 15), 10, 8, 2), ([], 0, 8, 2), (range(8), 0, 8, 4)])
def test_resume_offset_matches_jax(tmp_path, present, start, n, batch):
    _touch_pairs(tmp_path, present)
    assert app.resume_offset(str(tmp_path), start, n, batch) == \
        jax_resume_offset(str(tmp_path), start, n, batch)


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtypes.cuda_device()


def _trained_base(tmp_path, res_log2=5):
    base = tmp_path / "exp"
    SegSolver(res_log2, "", str(base / "checkpoints"), device=CPU).save()
    return base


def test_run_generate_and_resume(tmp_path, monkeypatch):
    """The entry point on the CPU through the test-only device override;
    ``--resume`` after losing the tail rewrites it byte for byte."""
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    base = _trained_base(tmp_path)
    cfg = tconfig.AppConfig(BASE_DIR=str(base), GAN="bedrooms",
                            GAN_DIR=str(tmp_path / "no-models"),
                            GAN_BATCH_SIZE_PER_GPU=2, GENERATE_NUM=5,
                            MAX_RES_LOG2=5)
    app.run_generate(cfg)
    out = base / "dataset" / "train_generated"
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted([f"img_{i:06d}.jpg" for i in range(5)]
                           + [f"mask_{i:06d}.png" for i in range(5)])
    ref = {p.name: p.read_bytes() for p in out.iterdir()}
    for name in ("img_000003.jpg", "mask_000003.png", "img_000004.jpg",
                 "mask_000004.png"):
        (out / name).unlink()
    app.run_generate(cfg, resume=True)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == ref


def test_run_generate_cv2_writer_masks(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    base = _trained_base(tmp_path, res_log2=3)
    cfg = tconfig.AppConfig(BASE_DIR=str(base), GAN="bedrooms",
                            GAN_DIR=str(tmp_path / "no-models"),
                            GAN_BATCH_SIZE_PER_GPU=2, GENERATE_NUM=3,
                            MAX_RES_LOG2=3)
    app.run_generate(cfg, writer="cv2")
    out = base / "dataset" / "train_generated"
    for i in range(3):
        img = cv2.imread(str(out / f"img_{i:06d}.jpg"))
        mask = cv2.imread(str(out / f"mask_{i:06d}.png"),
                          cv2.IMREAD_GRAYSCALE)
        assert img.shape == (8, 8, 3) and mask.shape == (8, 8)
        assert set(np.unique(mask)) <= {0, 1}


@pytest.mark.parametrize("kw", [dict(spatial=2), dict(dp=2),
                                dict(quant="int4")])
def test_run_generate_refuses_what_is_not_ported(kw):
    with pytest.raises(SystemExit):
        app.run_generate(tconfig.AppConfig(), **kw)


def test_untrained_solver_stops_generate(tmp_path, monkeypatch):
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    cfg = tconfig.AppConfig(BASE_DIR=str(tmp_path), GAN="bedrooms",
                            MAX_RES_LOG2=3)
    with pytest.raises(SystemExit):
        app.run_generate(cfg)


@pytest.mark.parametrize("action", ["train", "evaluate", "annotation"])
def test_main_says_other_actions_are_not_ported(action, tmp_path,
                                                monkeypatch):
    """No action is refused any more: each reaches its runner
    (tests/test_torch_train.py and tests/test_torch_annotator.py drive
    them)."""
    ran = []
    for name in ("train", "evaluate", "annotation"):
        monkeypatch.setattr(app, f"run_{name}",
                            lambda cfg, name=name: ran.append(name))
    config = tmp_path / "config.yml"
    config.write_text(f"BASE_DIR: {tmp_path}\n")
    app.main([action, "--config", str(config)])
    assert ran == [action]


def test_main_default_action_builds_the_annotator(tmp_path, monkeypatch):
    """``main([])`` is ``annotation``: under the tk stub it constructs the
    annotator on ``config.yml``'s settings and enters the main loop."""
    import chip_smoke
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yml").write_text(
        f"BASE_DIR: {tmp_path / 'exp'}\nGAN: bedrooms\n"
        f"GAN_DIR: {tmp_path / 'none'}\nGAN_BATCH_SIZE_PER_GPU: 2\n")
    monkeypatch.setitem(tconfig.MAX_RES_LOG2, "bedrooms", 4)
    loops = []
    with chip_smoke.stub_tk():
        tk = sys.modules["tkinter"]
        monkeypatch.setattr(tk.Tk, "mainloop",
                            lambda self: loops.append(self), raising=False)
        app.main([])
        assert len(loops) == 1 and loops[0].kw["title"] == "Image Viewer"
        assert (tmp_path / "exp" / "data").is_dir()
        # an unknown annotation type says so and starts no loop
        app.run_annotation(tconfig.AppConfig(ANNOTATION="points"))
        assert len(loops) == 1


def test_checkpoint_roundtrip(tmp_path):
    a = SegSolver(4, "", str(tmp_path), seed=1, device=CPU)
    assert not a.is_trained
    a.save()
    assert (tmp_path / "checkpoint_last.pt").is_file()
    b = SegSolver(4, "", str(tmp_path), seed=2, device=CPU)
    assert b.is_trained and b.params_file == "checkpoint_last.pt"
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    feats = [np.zeros((4, 4, 512), np.float32), np.ones((8, 8, 512),
                                                        np.float32),
             np.ones((16, 16, 512), np.float32)]
    logits = b.predict_logits(feats)
    assert tuple(logits.shape) == (1, 16, 16, 2)
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("name", ["checkpoint_last.params", "x.msgpack"])
def test_foreign_checkpoint_raises(tmp_path, name):
    """A ``*.params`` / ``*.msgpack`` in the checkpoint directory is loaded
    (tests/test_torch_convert.py); one that holds no decoder raises and is
    never passed over for a random decoder."""
    (tmp_path / name).write_bytes(b"\0")
    with pytest.raises(ValueError, match="no 'params' tree"):
        SegSolver(4, "", str(tmp_path), device=CPU)


def _modules():
    pkg = gan_segmentation_tpu_torch
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")]


def test_no_jax_on_the_import_path():
    """Every module of the port (the annotator, the checkpoint readers and
    the viz helpers among them) imports with jax, flax, msgpack, yaml, cv2,
    tkinter, PIL and the JAX package itself blocked, and none of them is
    loaded afterwards (the first dotted component tells
    ``gan_segmentation_tpu`` apart from ``gan_segmentation_tpu_torch``)."""
    pkg = gan_segmentation_tpu_torch.__name__
    assert {f"{pkg}.apps.annotator", f"{pkg}.core.mx_params",
            f"{pkg}.core.decoder_convert", f"{pkg}.core.checkpoint",
            f"{pkg}.utils.viz", f"{pkg}.models.resnet",
            f"{pkg}.models.resnext", f"{pkg}.models.deeplab",
            f"{pkg}.core.backbone_convert", f"{pkg}.core.deeplab_convert",
            f"{pkg}.train.deeplab_trainer", f"{pkg}.ops.dropout",
            f"{pkg}.train.experiments", f"{pkg}.train.rgb_experiments",
            f"{pkg}.data.augment", f"{pkg}.data.segmentation",
            f"{pkg}.data.batchify", f"{pkg}.utils.image", f"{pkg}.utils.log",
            f"{pkg}.core.yaml_config", f"{pkg}.core.graphs",
            f"{pkg}.core.export", f"{pkg}.kernels.ops", f"{pkg}.apps.export",
            f"{pkg}.examples.serving_demo",
            f"{pkg}.examples.full_pipeline_demo",
            f"{pkg}.data.feed", f"{pkg}.core.distributed",
            f"{pkg}.core.mesh", f"{pkg}.ops.quant",
            f"{pkg}.kernels.quantize", f"{pkg}.core.spatial",
            f"{pkg}.utils.profiling"} <= set(_modules())
    code = f"""
import importlib, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "cv2",
           "tkinter", "PIL", "gan_segmentation_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {_modules()!r}:
    importlib.import_module(m)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# an import statement of the JAX package (not of gan_segmentation_tpu_torch),
# also inside a function, where the import-path test above cannot see it
_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import)\s+gan_segmentation_tpu(\.|\s|$)", re.M)


def test_sources_name_no_jax():
    pkg = gan_segmentation_tpu_torch.__name__
    assert {f"{pkg}.core.distributed", f"{pkg}.core.mesh",
            f"{pkg}.ops.quant", f"{pkg}.kernels.quantize"} <= set(_modules())
    paths = [importlib.util.find_spec(m).origin for m in _modules()]
    for path in paths + [join(REPO, "chip_smoke.py")]:
        with open(path) as fh:
            src = fh.read()
        for bad in ("import jax", "from jax", "flax", "import optax",
                    "from optax"):
            assert bad not in src, (path, bad)
        assert not _JAX_PACKAGE_IMPORT.search(src), path

"""The port's data-parallel paths (gan_segmentation_tpu_torch: the decoder
fit of train/solver.py, the DeepLab trainer of train/deeplab_trainer.py,
the experiment runner, ``generate`` of apps/main.py and ``FusedPipeline
(mesh=...)``) on the CPU, where two spawned gloo processes
(``tests/test_torch_spawn.py``) stand for two cards.

- Decoder fit: 2 processes at res 32, global batch 4 (2 + 2), SGD, dropout
  off, 2 epochs, against the JAX ``SegSolver.fit`` at batch 4 from the same
  weights: parameters within 1e-5 (f32; the pre-BN conv biases, whose true
  gradient is 0, are rounding noise on both sides, within the same atol),
  from the collection on disk and from the resident one; batch 1 resident
  (replicated on both) within 1e-5 of one process at batch 1.
- DeepLab trainer: 2 processes x batch 1 at crop 32 against the port's one
  process at batch 2, dropout off, train-mode batch norm: the epoch loss,
  and the epoch's change of the weights as one vector, within 1e-2 (the
  ROADMAP's eval-mode bound; train-mode gradients are ill-conditioned, and
  the rule allows 0.15 there, but the two runs differ only in sum orders:
  1.8e-4 measured); validation counters exactly (the same forward at
  batch 1 per image, the ragged tail padded).
- The agreed stop, the primary's files, the resume on every process; the
  runner under a launcher; ``generate``'s slices bit for bit.
"""


import jax
import numpy as np
import pytest
import torch

import test_torch_spawn as spawn
from test_deeplab import make_rgb_dataset
from test_torch_train import _jcfg, _pyramid

from gan_segmentation_tpu.core.mesh import make_mesh
from gan_segmentation_tpu.train.solver import SegSolver as JSegSolver

from gan_segmentation_tpu_torch.apps import main as app
from gan_segmentation_tpu_torch.core import config as tconfig
from gan_segmentation_tpu_torch.core.params_bridge import decoder_state_dict
from gan_segmentation_tpu_torch.data.collection import save_annotation_sample
from gan_segmentation_tpu_torch.train import generator as tgen
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")


# ------------------------------------------------------------- decoder fit
@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    """Eight annotated samples of the narrow res-32 pyramid; the JAX fit at
    batch 4 and the two processes' fits from its initial weights."""
    tmp = tmp_path_factory.mktemp("fit")
    data = tmp / "data"
    data.mkdir()
    rs = np.random.RandomState(0)
    for i in range(8):
        feats = [f[0] for f in _pyramid(rs)]
        trimap = (feats[-1][..., 0] > 0).astype(np.int32)
        trimap[:2] = -1
        save_annotation_sample(str(data), i, rs.randint(
            0, 256, (32, 32, 3)).astype(np.uint8), trimap, feats)
    jcfg = _jcfg(use_dropout=False, optimizer="sgd", momentum=0.9,
                 device_cache=False)
    jcfg.train_epochs, jcfg.train_batch_size = 2, 4
    js = JSegSolver(5, str(data), str(tmp / "jax"),
                    mesh=make_mesh(jax.devices()[:1]), keep_weights=True,
                    cfg=jcfg)
    init = decoder_state_dict(jax.device_get(js.params),
                              jax.device_get(js.batch_stats))
    torch.save(init, tmp / "init.pt")
    js.fit()
    want = decoder_state_dict(jax.device_get(js.params),
                              jax.device_get(js.batch_stats))
    got = spawn.run_world(spawn.fit, 2, str(data), str(tmp / "init.pt"),
                          str(tmp / "mp"))
    one = SegSolver(5, str(data), str(tmp / "one"),
                    cfg=spawn.narrow_cfg(1, device_cache=True), device=CPU)
    one.model.load_state_dict(init)
    one.fit()
    return want, got, one.model.state_dict()


@pytest.mark.parametrize("path", ["steps", "cached"])
def test_two_process_fit_matches_jax(fit_run, path):
    want, got, _ = fit_run
    for rank in (0, 1):
        assert got[rank][path].keys() == want.keys()
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):  # no JAX counterpart
                continue
            np.testing.assert_allclose(got[rank][path][k], v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # the logged losses are the global batch's, the same on both
    assert got[0][path + "_history"] == got[1][path + "_history"]
    assert [len(e) for e in got[0][path + "_history"]] == [2, 2]


def test_replicated_fit_matches_one_process(fit_run):
    """Batch 1 does not split over 2 processes: each runs it whole on the
    resident collection and the gradients are averaged."""
    _, got, one = fit_run
    for rank in (0, 1):
        for k, v in one.items():
            np.testing.assert_allclose(got[rank]["replicated"][k], v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_only_the_primary_saves_the_decoder(fit_run):
    _, got, _ = fit_run
    for path in ("steps", "cached", "replicated"):
        assert got[0][path + "_wrote"] == ["checkpoint_last.pt"]
        assert got[1][path + "_wrote"] == []


# ----------------------------------------------------------------- DeepLab
@pytest.fixture(scope="module")
def rgb_root(tmp_path_factory):
    """6 training pairs (3 steps of 2) and a ragged val set of 3 (2
    processes x 1)."""
    root = tmp_path_factory.mktemp("rgb")
    make_rgb_dataset(root, "train_generated", 6, size=40, seed=3)
    make_rgb_dataset(root, "val", 3, size=40, seed=4)
    return root


@pytest.fixture(scope="module")
def deeplab_run(rgb_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deeplab")
    got = spawn.run_world(spawn.deeplab, 2, str(rgb_root), str(tmp))
    one = spawn.deeplab_trainer(rgb_root, tmp / "one", 2, 1)
    one.validation(0)
    val = spawn.counters(one.metric)
    loss = one.training(0)
    return got, val, loss, one.model.state_dict()


def _update(weights, init):
    """The epoch's change of every float tensor, as one vector."""
    return np.concatenate([
        (np.asarray(weights[k], np.float64) - v.numpy()).ravel()
        for k, v in init.items() if v.is_floating_point()])


def test_two_process_deeplab_trainer_matches_one_process(deeplab_run):
    """The epoch's loss within 1e-2 and the change of the weights within
    1e-2 of the one-process change (norm of the difference over the norm of
    the change): a sum instead of a mean of the gradients, or batch norm
    over each process's one image, is off by far more."""
    got, _, loss, weights = deeplab_run
    init = spawn.tiny_deeplab().state_dict()
    want = _update(weights, init)
    for out in got:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-2)
        diff = _update(out["weights"], init) - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want)
    for k, v in got[0]["weights"].items():  # the replicas stay one model
        np.testing.assert_array_equal(v, got[1]["weights"][k], err_msg=k)


def test_sharded_validation_counts_the_ragged_tail_once(deeplab_run):
    got, want, _, _ = deeplab_run
    for out in got:
        for g, w in zip(out["val"], want):
            np.testing.assert_array_equal(g, w)
    assert want[3] == 3 * 32 * 32 - np.sum(want[3] < 0)  # 3 images scored


def test_stop_is_agreed_and_the_primary_writes(deeplab_run):
    """Only the last process asked to stop after its second step; both stop
    at the next agreement (step 2 of log interval 2), the primary alone
    writes the checkpoints and the bundle, and every process resumes from
    it with its own dropout generator."""
    got, _, _, _ = deeplab_run
    for rank, out in enumerate(got):
        assert out["preempted"] and out["steps_run"] == 2
        assert out["resumed_at"] == (1, 2)
        np.testing.assert_array_equal(out["resumed_generator"],
                                      out["generator"])
    assert got[0]["wrote"] == ["last_checkpoint.pt", "resume_bundle.pt"]
    assert got[1]["wrote"] == []
    assert not np.array_equal(got[0]["generator"], got[1]["generator"])


def test_runner_under_a_launcher(rgb_root, tmp_path):
    """``rgb_experiments`` in two processes of a launcher's world: one run
    dir, made by the primary, used by both."""
    got = spawn.run_world(spawn.runner, 2, str(rgb_root), str(tmp_path))
    assert got[0]["run_path"] == got[1]["run_path"]
    assert [g["world"] for g in got] == [(0, 2), (1, 2)]
    assert [g["ngpus"] for g in got] == [2, 2]
    runs = list((tmp_path / "runs").iterdir())
    assert [str(r) for r in runs] == [got[0]["run_path"]]
    assert sorted(p.name for p in (runs[0] / "checkpoints").iterdir()) == [
        "last_checkpoint.pt"]


# ---------------------------------------------------------------- generate
def test_two_process_generate_writes_disjoint_slices(tmp_path):
    """5 pairs over 2 processes: rank r writes indices 3r.. from its own z
    stream (seed r), byte for byte what one process with seed r writes
    there; ``--resume`` rewrites a lost pair of each slice the same."""
    base = tmp_path / "exp"
    SegSolver(5, "", str(base / "checkpoints"), device=CPU).save()
    got = spawn.run_world(spawn.generate, 2, str(base),
                          str(tmp_path / "no-models"))
    names = sorted([f"img_{i:06d}.jpg" for i in range(5)]
                   + [f"mask_{i:06d}.png" for i in range(5)])
    for out in got:
        assert sorted(out["first"]) == names
        assert out["resumed"] == out["first"] == got[0]["first"]
    solver = SegSolver(5, "", str(base / "checkpoints"), device=CPU)
    for rank, (start, n) in enumerate([(0, 3), (3, 2)]):
        dst = tmp_path / f"one_{rank}"
        dst.mkdir()
        gen = tgen.ImageGenerator(gan="bedrooms", batch_size=2,
                                  max_res_log2=5, seed=rank, device=CPU,
                                  gan_dir=str(tmp_path / "no-models"))
        app._write_pairs_cv2(tgen.FusedPipeline(gen, solver), n, str(dst),
                             start, None)
        for p in dst.iterdir():
            assert got[0]["first"][p.name] == p.read_bytes(), p.name


def _cpu_generator(seed=3):
    return tgen.ImageGenerator(gan="bedrooms", batch_size=5, dtype="fp32",
                               max_res_log2=4, gan_dir="/nonexistent",
                               device=CPU, seed=seed)


def test_pipeline_over_two_devices_equals_one(tmp_path):
    """``FusedPipeline(mesh=[cpu, cpu])``: each batch of 5 split 3 + 2 over
    two replicas, equal bit for bit to the one-device pipeline, batch by
    batch, and after the decoder's weights changed (a refold)."""
    solver = SegSolver(4, "", str(tmp_path), device=CPU)
    one = tgen.FusedPipeline(_cpu_generator(), solver)
    two = tgen.FusedPipeline(_cpu_generator(), solver, mesh=[CPU, "cpu"])
    for round_ in range(2):
        for _ in range(2):
            a, b = one.sample_batch(), two.sample_batch()
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        want = list(one.generate_batches(7))
        got = list(two.generate_batches(7))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
        with torch.no_grad():  # the solver's weights move
            for p in solver.model.parameters():
                p.mul_(1.01)
        solver.weights_version += 1
    assert len(two._replicas) == 1 and len(two._parts) == 2


@pytest.mark.parametrize("kw", [dict(spatial=2), dict(dp=3), dict(dp=0),
                                dict(dp=-1)])
def test_run_generate_refuses_devices_it_lacks(kw):
    """No second card here: ``--dp`` beyond the cards and ``--spatial 2``
    exit before anything is built; ``--dp 0`` (every card) too, as there
    is none."""
    if kw == dict(dp=0):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.run_generate(tconfig.AppConfig(), **kw)
        return
    with pytest.raises(SystemExit):
        app.run_generate(tconfig.AppConfig(), **kw)

"""The port's experiment runner (gan_segmentation_tpu_torch/train/
{rgb_experiments,experiments}.py) on the CPU with ``--no-cuda``.

- ``chip_smoke.py``'s phase 9 rehearsed at a small size: ``run_generate``
  writes the dataset, then ``train`` (2 epochs, checkpoints, validation),
  a second ``train`` preempted by SIGTERM and continued with ``--resume``,
  and ``test`` on the newest checkpoint of the run dir, all through
  ``rgb_experiments.run``; the DeepLab model on the tiny (1, 1, 1, 1)
  backbone at crop 32, base 48;
- the run dir layout, the checkpoint test mode picks, ``--resume`` on a
  directory that is not a run, the two specs;
- without ``--no-cuda`` on a machine without a card the runner refuses
  before it creates anything; with it, card lists resolve to the CPU.
"""

import os
import subprocess
import sys
from os.path import dirname
from pathlib import Path

import pytest
import torch

import chip_smoke
from test_deeplab import make_rgb_dataset

from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.train import experiments as texp
from gan_segmentation_tpu_torch.train import rgb_experiments as rx

torch.set_num_threads(2)  # the test workers share the host's cores

REPO = dirname(dirname(__file__))
SMALL = ["--no-cuda", "--crop-size", "32", "--base-size", "48",
         "--scale-factor", "1.0"]


@pytest.fixture()
def tiny_resnet50(monkeypatch):
    """The experiment's model on a (1, 1, 1, 1) backbone."""
    monkeypatch.setitem(tdl._BACKBONE_LAYERS, "resnet50", (1, 1, 1, 1))


def test_chip_smoke_step5_rehearsal(tiny_resnet50, monkeypatch):
    """Phase 9 end to end on the CPU: bedrooms at 64^2 for the generated
    pairs, batch 2, 2 epochs of 2 steps, preempted after step 1."""
    monkeypatch.setattr(dtypes, "cuda_device", lambda: torch.device("cpu"))
    conf = dict(gan="bedrooms", res_log2=6, gen_batch=2, n_train=6,
                n_val=3, batch=2, epochs=2, epoch_len=4, workers=2,
                test_batch=2, preempt_after=1, feed_draws=4, bare_steps=1,
                device="cpu", overrides=SMALL)
    rec = chip_smoke.phase_step5(torch, "CPU", conf)
    assert len(rec["losses"]) == 4 and len(rec["validation"]) == 2
    assert rec["resume"]["position"] == (0, 1)
    # 64^2 resized to 48 at base 48: 4 windows of 32, flipped, 2 images
    assert rec["bucket_calls"] == [1, 1]
    assert set(rec["metric_orig"]) == {"accuracy", "mean-iou"}
    assert rec["eval_card_vs_cpu_err"] == 0.0
    assert {k: v["workers"] for k, v in rec["feed"].items()} == dict(
        thread=1, processes=2, more_processes=7)
    assert all(len(v["ms"]) == 2 and min(v["ms"]) > 0
               for v in rec["feed"].values())
    assert {k: len(v) for k, v in rec["loop_ms"].items()} == dict(
        processes=2, thread=2)
    assert min(min(v) for v in rec["loop_ms"].values()) > 0
    assert rec["bare_step_ms"]["eager"] > 0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    make_rgb_dataset(root, "train_generated", 4, size=48, seed=1)
    make_rgb_dataset(root, "val", 2, size=48, seed=2)
    return root


def test_train_then_test_run_dir(tiny_resnet50, dataset, tmp_path):
    spec = rx.SPECS["01_hair_deeplabv3_ffhq_pretrain_gan"]
    argv = ["--input-path", str(dataset)] + SMALL
    trainer = rx.run(spec, ["train", "--batch-size", "2", "--epochs", "1",
                            "--epoch-len", "8", "--workers", "1"] + argv,
                     exp_path=tmp_path)
    run = trainer.args.run_path
    assert run.parent == tmp_path / "runs" and run.name.startswith("train_")
    assert (run / "run.py").read_text() == Path(rx.__file__).read_text()
    assert trainer.scheduler.last_epoch == 4
    assert "Epoch 0 validation" in (run / "logs" / "train_log.txt"
                                    ).read_text()
    ck = run / "checkpoints"
    assert sorted(p.name for p in ck.iterdir()) == ["last_checkpoint.pt"]

    # test mode takes the newest *.pt, never the resume bundle, before any
    # *.params
    (ck / "000_checkpoint.pt").write_bytes((ck / "last_checkpoint.pt")
                                           .read_bytes())
    (ck / "zzz.params").write_bytes(b"")
    (ck / "resume_bundle.pt").write_bytes(b"")
    assert texp.newest_checkpoint(run) == ck / "last_checkpoint.pt"
    tester = rx.run(spec, ["test", str(run), "--test-batch-size", "2"] + argv)
    assert tester.args.weights == str(ck / "last_checkpoint.pt")
    assert tester.bucket_calls == [1]
    logs = list((run / "logs").glob("test_log_*.txt"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert "mean-iou" in text and "----- original metric ------" in text

    (ck / "resume_bundle.pt").unlink()
    for p in ck.glob("*.pt"):
        p.unlink()
    assert texp.newest_checkpoint(run) == ck / "zzz.params"
    (ck / "zzz.params").unlink()
    with pytest.raises(FileNotFoundError, match="no model weights"):
        texp.newest_checkpoint(run)


def test_resume_needs_a_run_dir(dataset, tmp_path):
    with pytest.raises(ValueError, match="existing run dir"):
        rx.run(rx.SPECS["01_hair_deeplabv3_ffhq_pretrain_gan"],
               ["train", "--resume", str(tmp_path / "nowhere"),
                "--input-path", str(dataset)] + SMALL, exp_path=tmp_path)


def test_specs_are_the_experiments():
    a = rx.SPECS["00_hair_deeplabv3_ffhq_pretrain_no_gan"]
    b = rx.SPECS["01_hair_deeplabv3_ffhq_pretrain_gan"]
    assert (a.train_subdir, a.rotate_limit, a.lr, a.weight_decay,
            a.test_threshold) == ("train_real", 0, 0.01, 1e-4, 0.5)
    assert (b.train_subdir, b.rotate_limit, b.lr, b.weight_decay,
            b.test_threshold) == ("train_generated", 15, 0.005, 2e-4, 1e-15)
    for s in (a, b):
        assert (s.num_epochs, s.crop_size, s.base_size, s.train_epoch_len,
                s.scale_factor) == (20, 480, 512, 10000, 0.5)
    assert rx.EXPERIMENTS_DIR == Path(REPO) / "experiments" / \
        "rgb_segmentation"


@pytest.mark.parametrize("flags,match", [([], "pass --no-cuda")])
def test_runner_refuses_before_it_makes_a_run_dir(tmp_path, monkeypatch,
                                                  flags, match):
    """Without a card and without ``--no-cuda`` the runner raises before it
    makes a run dir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        rx.run(rx.SPECS["01_hair_deeplabv3_ffhq_pretrain_gan"],
               ["train", "--input-path", str(tmp_path)] + flags,
               exp_path=tmp_path)
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("flags", [
    ["--no-cuda", "--gpus", "0,1"], ["--no-cuda", "--ngpus", "2"],
    ["--no-cuda", "--kvstore", "dist_sync"]])
def test_no_cuda_card_lists_resolve_to_one_cpu_process(monkeypatch, flags):
    """With ``--no-cuda`` the card lists and a distributed kvstore resolve
    to one device, the CPU, in this one process (the JAX package forces
    kvstore ``local`` there): no process is spawned and no group joined."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = texp.get_train_arguments().parse_args(["train"] + flags)
    assert texp.resolve_world(args) == [torch.device("cpu")]
    assert not torch.distributed.is_initialized()


def test_command_line_refuses_without_a_card(tmp_path):
    """The module's entry point, as a user calls it, on this machine
    without a CUDA card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "gan_segmentation_tpu_torch.train."
           "rgb_experiments"]
    out = subprocess.run(cmd + ["01_hair_deeplabv3_ffhq_pretrain_gan",
                                "train", "--input-path", str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--no-cuda" in out.stderr
    out = subprocess.run(cmd + ["02_unknown"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "usage:" in out.stderr
    assert "01_hair_deeplabv3_ffhq_pretrain_gan" in out.stderr

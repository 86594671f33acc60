"""Experiment management (`deeplabv3plus/lib/utils/{cmd_args,exps_utils}.py`):
the counterpart of ``gan_segmentation_tpu/train/experiments.py``.

``init_exp`` parses the command line, resolves the world of the run
(``resolve_world``), creates ``<exp>/runs/train_<timestamp>/{logs,
checkpoints}`` with a copy of the run file (or reuses a run dir with
``--resume``), logs to ``logs/train_log.txt``, and in test mode picks the
newest checkpoint of the run dir: the port's ``*.pt`` first, then
``*.params``.

The world (the JAX package's device mesh, one process per card here):
- under a launcher (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) this process joins the group on
  ``cuda:LOCAL_RANK`` (NCCL), or on the CPU with ``--no-cuda`` (gloo);
  the primary makes the run dir and broadcasts its path;
- else ``--gpus a,b,...`` / ``--ngpus N`` / every card (``--kvstore
  local``: the first) give the cards; several make ``spawn_world`` start
  one training process per card, so the reference's command line keeps
  its meaning; ``--no-cuda`` is one CPU process (the reference forces
  ``--kvstore local`` there);
- no card without ``--no-cuda`` raises before any directory is made: there
  is no fallback, and a process of the world that fails fails the run.
Test mode runs in one process, on the first card.
"""

import argparse
import os
import shutil
import sys
from datetime import datetime
from pathlib import Path
from typing import Callable, List, Sequence

import torch

from ..core import distributed as dist_
from ..core.dtypes import cuda_device
from ..core.mesh import kvstore_devices
from ..utils.log import add_console_handler, add_file_handler, logger
from .deeplab_trainer import RESUME_BUNDLE


def get_common_arguments():
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["train", "test"])
    parser.add_argument("--workers", type=int, default=4, metavar="N",
                        help="decode worker processes (1: one thread)")
    parser.add_argument("--no-cuda", action="store_true", default=False,
                        help="run on the CPU (the default is the CUDA card)")
    parser.add_argument("--ngpus", type=int, default=None,
                        help="number of cards, one training process each "
                             "(default: every card)")
    parser.add_argument("--gpus", type=str, default="", required=False,
                        help="the cards' indices, e.g. '0,1': one training "
                             "process each")
    parser.add_argument("--kvstore", type=str, default="device",
                        help="the reference's flag: 'local' takes one card; "
                             "the others ('device', 'nccl', 'dist_*') every "
                             "card listed")
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--batch-size", type=int, default=8)
    return parser


def get_train_arguments():
    parser = get_common_arguments()
    parser.add_argument("--start-epoch", type=int, default=0)
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--test-batch-size", type=int, default=8)
    parser.add_argument("--no-exp", action="store_true", default=False)
    # not in the reference CLI: continue a preempted run in place, in its
    # runs/train_* dir, where the SIGTERM handler left the resume bundle
    parser.add_argument("--resume", type=str, default=None, metavar="RUN_DIR",
                        help="continue a preempted training run in this "
                             "existing runs/train_* directory")
    return parser


def get_test_arguments():
    parser = get_common_arguments()
    parser.add_argument("run_path", type=str)
    parser.add_argument("--vizualization", action="store_true", default=False)
    # not in the reference CLI: images per batched multi-scale evaluation
    # (`SegmentationTester.test` buckets same-shape images)
    parser.add_argument("--test-batch-size", type=int, default=2)
    return parser


def resolve_world(args) -> List[torch.device]:
    """The devices of the run, one process each: this process's device
    alone under a launcher (after joining its group) or for one device;
    several cards mean ``spawn_world``.  Test mode takes the first."""
    if dist_.launched():
        if args.no_cuda:
            device = torch.device("cpu")
        else:
            try:
                cuda_device()
            except RuntimeError as exc:
                raise RuntimeError(f"{exc}; pass --no-cuda to run on the "
                                   f"CPU") from None
            device = dist_.local_device()
        dist_.initialize(cuda=device.type == "cuda")
        return [device]
    devices = kvstore_devices(args.kvstore, args.gpus, args.ngpus,
                              args.no_cuda)
    return devices[:1] if args.mode == "test" else devices


def _spawned(index: int, devices: Sequence[str], port: int,
             target: Callable, target_args: tuple):
    """One process of ``spawn_world``: its place in the world as a
    launcher would set it, then ``target(*target_args)``."""
    device = torch.device(devices[index])
    os.environ.update(RANK=str(index), WORLD_SIZE=str(len(devices)),
                      LOCAL_RANK=str(device.index or 0),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        target(*target_args)
    finally:
        dist_.shutdown()


def spawn_world(devices: Sequence[torch.device], target: Callable,
                target_args: tuple = ()) -> None:
    """Run ``target(*target_args)`` in one new process per device (spawn),
    as ``torchrun`` would, and wait for all; any that fails raises here."""
    import torch.multiprocessing as mp
    mp.start_processes(_spawned, args=([str(d) for d in devices],
                                       dist_.free_port(), target,
                                       target_args),
                       nprocs=len(devices), join=True, start_method="spawn")


def newest_checkpoint(run_path: Path) -> Path:
    """The run dir's newest checkpoint by name (``last_checkpoint`` after
    ``NNN_checkpoint``): the port's ``*.pt`` first (not the resume
    bundle), else ``*.params``."""
    ours = [p for p in run_path.rglob("*.pt") if p.name != RESUME_BUNDLE]
    found = sorted(ours or run_path.rglob("*.params"), key=lambda p: p.stem)
    if not found:
        raise FileNotFoundError(f"no model weights (*.pt, *.params) under "
                                f"{run_path}")
    return found[-1]


def init_exp(exp_path, add_exp_args, argv=None, run_file=None):
    """-> the parsed ``args`` with ``device``, ``run_path``, ``logs_path``
    and, when training, ``checkpoints_path`` (test mode: ``weights``).
    Train runs go to ``exp_path/runs/train_<timestamp>``; ``run_file`` is
    copied there as ``run.py``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = (get_train_arguments() if "train" in argv
              else get_test_arguments())
    parser = add_exp_args(parser)
    args = parser.parse_args(argv)
    devices = resolve_world(args)  # before any directory is made
    if args.no_cuda:
        args.kvstore = "local"
    if len(devices) > 1:  # the caller spawns one process per device
        args.spawn_devices = devices
        return args
    device = devices[0]
    args.device = str(device)
    args.spawn_devices = None
    args.ngpus = dist_.process_count()
    stdout_log_path = None

    if args.mode == "train" and getattr(args, "resume", None):
        run_path = Path(args.resume)
        if not (run_path / "checkpoints").is_dir():
            raise ValueError(
                f"--resume expects an existing run dir, got {run_path}")
        args.logs_path = run_path / "logs"
        args.run_path = run_path
        args.checkpoints_path = run_path / "checkpoints"
        args.logs_path.mkdir(parents=True, exist_ok=True)
        stdout_log_path = args.logs_path / "train_log.txt"
    elif args.mode == "train":
        run_name = args.mode + datetime.today().strftime("_%Y-%m-%d_%H-%M-%S")
        # the primary's name, on every process
        run_path = Path(exp_path) / "runs" / dist_.broadcast_str(run_name)
        args.logs_path = run_path / "logs"
        args.run_path = run_path
        args.checkpoints_path = run_path / "checkpoints"
        if not args.no_exp and dist_.is_primary():
            if run_path.exists():
                raise FileExistsError(f"run dir {run_path} exists")
            run_path.mkdir(parents=True)
            if run_file is not None:
                shutil.copy(str(run_file), str(run_path / "run.py"))
            args.checkpoints_path.mkdir(parents=True, exist_ok=True)
            args.logs_path.mkdir(parents=True, exist_ok=True)
            stdout_log_path = args.logs_path / "train_log.txt"
        if not args.no_exp:  # the run dir exists before any process uses it
            dist_.barrier()
    else:
        run_path = Path(args.run_path)
        args.logs_path = run_path / "logs"
        current_date = datetime.today().strftime("%Y-%m-%d_%H-%M-%S")
        args.logs_path.mkdir(parents=True, exist_ok=True)
        stdout_log_path = args.logs_path / f"test_log_{current_date}.txt"
        if args.vizualization:
            viz = args.logs_path / f"viz_{current_date}"
            viz.mkdir(exist_ok=True)
            args.viz_path = viz
        args.weights = str(newest_checkpoint(run_path))

    add_console_handler()
    if stdout_log_path is not None and dist_.is_primary():
        add_file_handler(stdout_log_path)
    logger.info("Device: %s (process %d of %d)", device,
                dist_.process_index(), dist_.process_count())
    logger.info("%s", args)
    return args

"""Experiment management (`deeplabv3plus/lib/utils/{cmd_args,exps_utils}.py`):
the counterpart of ``gan_segmentation_tpu/train/experiments.py`` on one
device.

``init_exp`` parses the command line, resolves the device (the CUDA card, or
the CPU with ``--no-cuda``; it raises without a card and never falls back),
creates ``<exp>/runs/train_<timestamp>/{logs,checkpoints}`` with a copy of
the run file (or reuses a run dir with ``--resume``), logs to
``logs/train_log.txt``, and in test mode picks the newest checkpoint of the
run dir: the port's ``*.pt`` first, then ``*.params``.
"""

import argparse
import shutil
import sys
from datetime import datetime
from pathlib import Path

import torch

from ..core.dtypes import cuda_device
from ..utils.log import add_console_handler, add_file_handler, logger
from .deeplab_trainer import RESUME_BUNDLE

ONE_DEVICE = ("the port trains and tests on one device; multi-device runs "
              "are not ported yet (ROADMAP.md, Queue 1, item 7: scale-out)")


def get_common_arguments():
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["train", "test"])
    parser.add_argument("--workers", type=int, default=4, metavar="N",
                        help="Dataloader threads")
    parser.add_argument("--no-cuda", action="store_true", default=False,
                        help="run on the CPU (the default is the CUDA card)")
    parser.add_argument("--ngpus", type=int, default=None,
                        help="number of devices: 1 (the default)")
    parser.add_argument("--gpus", type=str, default="", required=False,
                        help="the CUDA device's index, e.g. '0'")
    parser.add_argument("--kvstore", type=str, default="device",
                        help="accepted for reference CLI compat: a "
                             "single-device kvstore ('device', 'local', "
                             "'nccl')")
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


def resolve_device(args) -> torch.device:
    """The one device of the run: the CPU with ``--no-cuda``, else the CUDA
    card (``--gpus`` picks its index).  More than one device is refused;
    no card without ``--no-cuda`` raises."""
    ids = [int(i) for i in args.gpus.split(",") if i.strip()]
    if len(ids) > 1:
        raise ValueError(f"--gpus {args.gpus}: {ONE_DEVICE}")
    if args.ngpus not in (None, 1):
        raise ValueError(f"--ngpus {args.ngpus}: {ONE_DEVICE}")
    if args.kvstore.startswith("dist") or args.kvstore == "horovod":
        raise ValueError(f"--kvstore {args.kvstore}: {ONE_DEVICE}")
    if args.no_cuda:
        return torch.device("cpu")
    try:
        device = cuda_device()
    except RuntimeError as exc:
        raise RuntimeError(f"{exc}; pass --no-cuda to run on the CPU"
                           ) from None
    if ids:
        if ids[0] >= torch.cuda.device_count():
            raise ValueError(f"--gpus {args.gpus}: this machine has "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        device = torch.device("cuda", ids[0])
    return device


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
    device = resolve_device(args)  # before any directory is made
    args.device = str(device)
    args.ngpus = 1
    if args.no_cuda:
        args.kvstore = "local"
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
        run_path = Path(exp_path) / "runs" / run_name
        args.logs_path = run_path / "logs"
        args.run_path = run_path
        args.checkpoints_path = run_path / "checkpoints"
        if not args.no_exp:
            if run_path.exists():
                raise FileExistsError(f"run dir {run_path} exists")
            run_path.mkdir(parents=True)
            if run_file is not None:
                shutil.copy(str(run_file), str(run_path / "run.py"))
            args.checkpoints_path.mkdir(parents=True, exist_ok=True)
            args.logs_path.mkdir(parents=True, exist_ok=True)
            stdout_log_path = args.logs_path / "train_log.txt"
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
    if stdout_log_path is not None:
        add_file_handler(stdout_log_path)
    logger.info("Device: %s", device)
    logger.info("%s", args)
    return args

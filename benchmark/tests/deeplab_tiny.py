"""The DeepLab cell (``deeplab-r50-sync4``) cut to a size the CPU holds
(resnet50 at every published width, crop 32, a global batch of 4, a pool of
4 crops a rank, an agreement every step), and a script that runs it in a
world of two gloo ranks as ``run.py`` runs a cell, with the look for a
chip skipped.  ``--fault`` plants a fault in the program of every rank
(the runner ``deeplab_planted`` in a root of its own):

- ``local-bn``: batch norm over each rank's own samples
  (``set_process_group`` given no group);
- ``no-allreduce``: the gradients left unaveraged
  (``core/distributed.py::allreduce_mean_`` does nothing).

    python deeplab_tiny.py [--fault local-bn] [--seconds 0.5]

It prints the result line last on standard output, as ``run.py`` does.
"""

import argparse
import copy
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "deeplab-r50-sync4"
RANKS = 2

PLANTED = '''"""deeplab_sync with a fault planted in the program (the traffic's
``fault``), undone when the run ends."""

import importlib.util
import os


def run(cell, **kw):
    from gan_segmentation_tpu_torch.core import distributed
    from gan_segmentation_tpu_torch.train import deeplab_trainer
    from gsbench import harness

    spec = importlib.util.spec_from_file_location(
        "deeplab_sync_real", os.path.join(harness.BENCH_DIR, "runners",
                                          "deeplab_sync.py"))
    real = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(real)
    saved = (deeplab_trainer.set_process_group, distributed.allreduce_mean_)
    fault = cell.traffic["fault"]
    if fault == "local-bn":
        deeplab_trainer.set_process_group = (
            lambda model, group: saved[0](model, None))
    elif fault == "no-allreduce":
        distributed.allreduce_mean_ = lambda tensors, grp: None
    try:
        return real.run(cell, **kw)
    finally:
        deeplab_trainer.set_process_group, distributed.allreduce_mean_ = saved
'''


def tiny_cell(fault=None):
    from gsbench import harness

    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"]["crop_size"] = 32
    sol = cell.config["solver"]
    sol["global_batch"] = 4
    sol["total_steps"] = sol["epochs"] * (sol["epoch_len"] // 4)
    cell.entry = dict(cell.entry, chips=RANKS)
    cell.traffic = dict(cell.traffic, pool=4, ignore_band_max=6,
                        agree_every=1, trace_lead=1, trace_settle=1,
                        trace_steps=2)
    if fault is not None:
        cell.traffic.update(runner="deeplab_planted", fault=fault)
    return cell


def planted_root():
    """A root whose ``benchmark/runners`` holds the planting runner."""
    root = tempfile.mkdtemp(prefix="deeplab_planted_")
    runners = os.path.join(root, "benchmark", "runners")
    os.makedirs(runners)
    with open(os.path.join(runners, "deeplab_planted.py"), "w") as fh:
        fh.write(PLANTED)
    return root


def main(argv=None):
    sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(
        HERE))]
    from gsbench import harness
    import run as bench_run

    p = argparse.ArgumentParser()
    p.add_argument("--fault", default=None,
                   choices=(None, "local-bn", "no-allreduce"))
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=2 ** 31 + 4321)
    a = p.parse_args(argv)
    cell = tiny_cell(a.fault)
    root = planted_root() if a.fault else harness.ROOT
    args = argparse.Namespace(seed=a.seed, seconds=a.seconds, trace=0,
                              control=None)
    harness.cache_dirs()
    try:
        outcome, found = bench_run.measure(cell, args, RANKS, "cpu",
                                           root=root)
        info = {"platform": "cpu", "count": RANKS,
                "memory_peak_bytes": int(outcome.memory_peak_bytes)}
        return bench_run.report(cell, args, outcome, found, info)
    finally:
        if a.fault:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())

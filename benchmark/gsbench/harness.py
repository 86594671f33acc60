"""The harness around one run of one cell: the cell's files found by name,
the caches kept inside the checkout, the check that no JAX module was
loaded, the per-layer metric readers, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files:

- ``configs/<config>.json``: the configuration's sizes, precision and
  source (the plain reference ``configs/<reference>.py`` beside it);
- ``traffic/<traffic>.json``: the traffic mix's parameters, and the
  ``runner`` (``runners/<runner>.py``) that generates it;
- ``workloads/<cell>.json``: the numbers its output check compares, each
  with its limit and the readings the limit was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``
  -> a number, or None where the run has nothing to read.

A later cell, configuration, traffic mix or metric is a new file and a new
entry of ``BENCHMARK.json``; no file here names one.

A cell whose ``chips`` is more than 1 runs as a world of one process per
card (``world.py``), each calling the runner's ``run`` as a one-card cell
does, on its own card, with the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
from which the program joins its own group.  Rank 0 is the measuring
process: the end-to-end values, the set-up, the traced stretch and the
breakdown are its own.  The ranks' outcomes merge (``world.merge``):
``failed`` summed, each compared number at its worst, the largest peak
memory; the forbidden modules of every rank count.  ``world.agree`` ends a
window on the same step on every rank.  A rank that ends with another code
than 0, or gives no outcome within ``world.GRACE_S`` seconds of rank 0's,
ends the run with exit code 4 and no result.
"""

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from os.path import dirname, join
from typing import Dict, List, Optional

BENCH_DIR = dirname(dirname(os.path.abspath(__file__)))
ROOT = dirname(BENCH_DIR)
# whole top-level module names that the measured process may not hold:
# the JAX stack and the JAX package (whose name the port's begins with)
FORBIDDEN = ("jax", "jaxlib", "flax", "gan_segmentation_tpu")


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    entry: dict        # the BENCHMARK.json workload entry
    config: dict
    traffic: dict
    checks: dict       # name -> {"limit": ..., ...}
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = read_json(join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    bdir = join(root, "benchmark")
    config = read_json(join(bdir, "configs", entry["config"] + ".json"))
    traffic = read_json(join(bdir, "traffic", entry["traffic"] + ".json"))
    checks = read_json(join(bdir, "workloads", name + ".json"))["checks"]
    return Cell(name, entry, config, traffic, checks,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def load_file(path, modname):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_runner(name, root=ROOT):
    return load_file(join(root, "benchmark", "runners", name + ".py"),
                     "gsbench_runner_" + name.replace("-", "_"))


def load_reference(config, root=ROOT):
    return load_file(join(root, "benchmark", "configs",
                          config["reference"] + ".py"),
                     "gsbench_ref_" + config["reference"])


def load_metric(name, root=ROOT):
    return load_file(join(root, "benchmark", "metrics", name + ".py"),
                     "gsbench_metric_" + name.replace(".", "_")
                     .replace("-", "_"))


def cache_dirs(root=ROOT):
    """Fixed cache directories inside the checkout for whatever the program
    builds at run time (its CUDA kernels build into its own ``_build``
    inside the checkout); set unless the caller set them."""
    base = join(root, "benchmark", "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = os.environ.get(var) or join(base, sub)
        os.environ[var] = path
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules():
    """The loaded modules whose whole top-level name is forbidden."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Phases:
    """Seconds of each set-up phase since the process start ``t0``, the
    device's work of a phase waited for at its end; printed on standard
    error (where set-up goes)."""

    def __init__(self, t0, device):
        self.last, self.done, self.device = t0, [], device

    def mark(self, name):
        import time

        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.done.append((name, round(now - self.last, 3)))
        self.last = now

    def report(self):
        print("phases_s " + json.dumps(dict(self.done)), file=sys.stderr)


@dataclass
class Record:
    """What a run hands the per-layer readers: the profiled ``stretch``
    (``trace.Stretch``, None without ``--trace 1``), the benchmark's host
    ``spans`` (seconds per call, by name) and ``counters``."""
    cell: Cell
    stretch: Optional[object] = None
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)


@dataclass
class Outcome:
    """A runner's run: end-to-end values by name, the work attempted and
    failed in the window, each compared number as (name, value), the peak
    device memory, and the record for the readers."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    compared: List[tuple]
    memory_peak_bytes: int
    record: Record
    setup_s: float = 0.0


def judge(cell, compared):
    """[(name, value, limit, ok)] for each compared number: ok where it is
    a finite number within its limit."""
    out = []
    for name, value in compared:
        limit = cell.checks[name]["limit"]
        ok = value is not None and value == value and value <= limit
        out.append((name, value, limit, ok))
    return out


def per_layer(cell, record, root=ROOT):
    """{metric: {"value", "unit"}} of the per-layer readers that found
    something to read."""
    out = {}
    for m in cell.per_layer:
        value = load_metric(m["name"], root).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, outcome, trace, device_info, root=ROOT,
                control=False):
    """The run's result as one dict (``checks`` last), and the judged
    numbers.  A ``control`` run reports only the metrics it measured."""
    judged = judge(cell, outcome.compared)
    correct = (outcome.failed == 0 and bool(judged)
               and all(ok for *_, ok in judged))
    if trace:
        metrics = per_layer(cell, outcome.record, root)
    else:
        values = dict(outcome.end_to_end, setup_s=outcome.setup_s)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                if control:
                    continue
                raise RuntimeError(f"the runner gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": device_info}
    st = outcome.record.stretch
    if trace and st is not None:
        line["breakdown"] = {"device_ops": st.top_ops(),
                             "idle_gaps": st.top_gaps()}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in judged}
    return line, judged

"""A cell of the benchmark cut to a size the CPU holds (the generator and
the decoder at ``max_res_log2`` 4, published channel widths, batch 2, a
collection of 4), and one run of it on the CPU with the harness's look for
a chip skipped."""

import copy
import time

import torch

from gsbench import harness

RES = 4


def tiny_cell(name, res=RES):
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    gan = cfg["gan"] if "gan" in cfg else cfg["pyramid"]["gan"]
    gan["max_res_log2"] = res
    cfg["decoder"]["features"] = [32] * (res - 1) + [2]
    cfg["decoder"]["in_channels"] = [512] * (res - 1)
    cell.config = cfg
    tr = dict(cell.traffic)
    if tr["runner"] == "generate":
        tr.update(batch=2, trace_lead=1, trace_settle=1, trace_batches=2,
                  trace_tail=1)
    else:
        tr.update(collection=4, trace_lead=1, trace_settle=1,
                  trace_epochs=1)
    cell.traffic = tr
    return cell


def run_tiny(name, seed=2 ** 31 + 12345, seconds=0.5, trace=False,
             control=None):
    """(result line, judged checks) of one run of the tiny cell."""
    cell = tiny_cell(name)
    runner = harness.load_runner(cell.traffic["runner"])
    outcome = runner.run(cell, seed=seed, seconds=seconds, trace=trace,
                         device=torch.device("cpu"),
                         t0=time.perf_counter(), control=control)
    info = {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
    return harness.result_line(cell, outcome, trace, info,
                               control=control is not None)

"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control <mode>]

From the root of a checkout of the repository, on a machine with as many
CUDA devices as the cell asks for (``BENCHMARK.json``).  The run makes its
weights and inputs from ``--seed``, warms up every shape the cell uses
(all of it counted in ``setup_s``), measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a profiled stretch of the window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit, also the last lines on standard error.

``--control <mode>`` runs a lower-precision control or a planted fault in
the program's place (the cell's traffic runner names the modes); it is for
setting the limits and is not part of a benchmark run.

Exits 2 without a result when CUDA is missing or has fewer devices than
the cell asks for, and 3 when a module of JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the benchmark's modules, then the checkout's root (the program)
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from gsbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    return p.parse_args(argv)


def device_info(torch, chips, trace, outcome):
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    st = outcome.record.stretch
    if trace and st is not None:
        info["busy_s"] = st.busy_seconds()
        info["window_s"] = st.seconds
    return info


def main(argv=None):
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.cache_dirs()
    # load from one process with few threads: the program's host work in
    # the window is launches and small copies
    torch.set_num_threads(1)
    runner = harness.load_runner(cell.traffic["runner"])
    outcome = runner.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device=torch.device("cuda"),
                         t0=T0, control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"the measured process loaded forbidden modules: {found}",
              file=sys.stderr)
        return 3
    line, judged = harness.result_line(
        cell, outcome, args.trace,
        device_info(torch, chips, args.trace, outcome),
        control=args.control is not None)
    st = outcome.record.stretch
    if args.trace and st is not None and st.units:
        print("device_ms_per_unit " + json.dumps(
            {k: v / st.units for k, v in st.ms_by_family().items()}),
            file=sys.stderr)
    for name, value, limit, ok in judged:
        print(f"check {name}: {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

A cell on more than one card runs as a world of one process per card
(``gsbench/world.py``): this process is rank 0, which measures (its host
clock, its set-up, its profiler, its end-to-end values and breakdown), and
it starts ranks 1..N-1 on ``cuda:1``..``cuda:N-1`` with the launcher's
environment the program reads; each runs the cell's runner untraced, and
the program joins its own group.  The result merges the ranks: ``failed``
summed, each compared number at its worst over the ranks, the largest
peak memory (``device.memory_peak_bytes``, the fullest card), the
forbidden modules of every rank.  A one-card cell starts no process.

Exits 2 without a result when CUDA is missing or has fewer devices than
the cell asks for, 3 when a module of JAX or the JAX package was loaded
(in any rank), and 4 when a rank other than 0 exits with another code
than 0, or gives no outcome within ``world.GRACE_S`` seconds of rank 0's:
every rank is killed and the rank's exit code and last lines are on
standard error.
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


def measure(cell, args, chips, device_type="cuda", root=harness.ROOT):
    """(the run's outcome, the forbidden modules its processes loaded)."""
    if chips == 1:
        import torch
        runner = harness.load_runner(cell.traffic["runner"], root)
        outcome = runner.run(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace),
                             device=torch.device(device_type), t0=T0,
                             control=args.control)
        return outcome, harness.forbidden_modules()
    from gsbench import world
    outcome, found = world.run(cell, chips, seed=args.seed,
                               seconds=args.seconds, trace=bool(args.trace),
                               control=args.control, t0=T0,
                               device_type=device_type, root=root)
    return outcome, sorted(set(found) | set(harness.forbidden_modules()))


def report(cell, args, outcome, found, device):
    """Print the result line (last on standard output) and the checks (last
    on standard error); -> the exit code."""
    if found:
        print(f"the measured processes loaded forbidden modules: {found}",
              file=sys.stderr)
        return 3
    line, judged = harness.result_line(cell, outcome, args.trace, device,
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
    # load from one process a card with few threads: the program's host
    # work in the window is launches and small copies
    torch.set_num_threads(1)
    outcome, found = measure(cell, args, chips)
    return report(cell, args, outcome, found,
                  device_info(torch, chips, args.trace, outcome))


if __name__ == "__main__":
    sys.exit(main())

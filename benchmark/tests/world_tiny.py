"""A toy traffic runner for the harness's world of one process per card, and
a script that runs it as ``run.py`` runs a cell, with the look for a chip
skipped.

Each rank joins the world through the program's own
``core.distributed.initialize`` (gloo on the CPU, NCCL on cards) and runs
a window of ``all_reduce`` steps, ended on the same step everywhere by
``world.agree``.  Step k sums ``rank + 1 + k`` over the ranks and reads
the sum back on the host (so a card waits in the collective); a step whose
sum is wrong counts as failed.  Each rank keeps a replica, the running
total of its sums, and compares it with the total the sums should give:
``replica_err``, limit 0.  A rank holds a ballast of ``rank + 1`` MiB on
its device, so the fullest device is the last rank's.

Planted faults (``--fault``, on rank ``--fault-rank`` at step
``--fault-step``): ``raise`` (an exception), ``kill`` (SIGKILL to itself),
``sleep`` (it never returns, after the window), ``forbidden`` (a module
under the JAX package's whole name), ``drop`` (it adds 0 in place of its
part, so every rank's sum is wrong at that step), ``drift`` (its replica
is off by one after the window).

    python world_tiny.py --ranks 4 [--device cuda] [--fault raise ...]
"""

import argparse
import os
import signal
import sys
import time

MIB = 2 ** 20
AGREE_S = 120


def run(cell, seed, seconds, trace, device, t0, control=None):
    import torch
    import torch.distributed as dist

    from gan_segmentation_tpu_torch.core import distributed
    from gsbench import harness, world

    tr = cell.traffic
    distributed.initialize(cuda=device.type == "cuda")
    grp = distributed.group()
    rank, size = distributed.process_index(), distributed.process_count()
    planted = tr["fault"] if rank == tr["fault_rank"] else None
    ballast = torch.ones((rank + 1) * MIB, dtype=torch.uint8, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    record = harness.Record(cell)
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    k = failed = 0
    replica = 0.0
    while True:
        if planted == "raise" and k == tr["fault_step"]:
            raise RuntimeError(f"planted fault on rank {rank} at step {k}")
        if planted == "kill" and k == tr["fault_step"]:
            os.kill(os.getpid(), signal.SIGKILL)
        mine = 0.0 if planted == "drop" and k == tr["fault_step"] else \
            float(rank + 1 + k)
        x = torch.full((tr["width"],), mine, dtype=torch.float64,
                       device=device)
        if grp is not None:
            dist.all_reduce(x, group=grp)
        got = float(x[0].item())
        failed += got != size * (size + 1) / 2 + size * k
        replica += got
        k += 1
        if world.agree(time.perf_counter() - start >= seconds, AGREE_S):
            break
    window = time.perf_counter() - start
    if planted == "sleep":
        time.sleep(10 ** 6)
    if planted == "forbidden":
        sys.modules["gan_segmentation_tpu.planted"] = sys
    if planted == "drift":
        replica += 1.0
    want = sum(size * (size + 1) / 2 + size * i for i in range(k))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else ballast.numel())
    del ballast
    distributed.shutdown()
    return harness.Outcome({"steps_per_s": k / window, "rank": float(rank)},
                           attempted=k, failed=failed,
                           compared=[("replica_err", abs(replica - want))],
                           memory_peak_bytes=peak, record=record,
                           setup_s=setup_s)


def toy_cell(ranks, fault=None, fault_rank=-1, fault_step=0):
    from gsbench import harness
    entry = {"name": "world-tiny", "config": "world-tiny",
             "traffic": "world-tiny", "chips": ranks}
    traffic = {"runner": "world_tiny", "width": 1024, "fault": fault,
               "fault_rank": fault_rank, "fault_step": fault_step}
    units = {"steps_per_s": "steps/s", "rank": "rank", "setup_s": "s"}
    return harness.Cell("world-tiny", entry, {}, traffic,
                        {"replica_err": {"limit": 0}},
                        [{"name": n, "unit": u} for n, u in units.items()],
                        [])


def main(argv=None):
    """Run the toy cell as ``run.py`` runs a cell (``measure``, then
    ``report``), the runner found under ``--root``; exits as ``run.py``
    would.  On its way out it says how many child processes are alive."""
    import multiprocessing

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), os.path.dirname(os.path.dirname(
        here))]
    from gsbench import harness, world
    import run as bench_run

    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cpu")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--grace", type=float, default=world.GRACE_S)
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-rank", type=int, default=-1)
    p.add_argument("--fault-step", type=int, default=0)
    a = p.parse_args(argv)
    world.GRACE_S = a.grace
    cell = toy_cell(a.ranks, a.fault, a.fault_rank, a.fault_step)
    args = argparse.Namespace(seed=2 ** 31 + 7, seconds=a.seconds, trace=0,
                              control=None)
    harness.cache_dirs()
    try:
        outcome, found = bench_run.measure(cell, args, a.ranks, a.device,
                                           root=a.root)
        info = {"platform": a.device, "count": a.ranks,
                "memory_peak_bytes": int(outcome.memory_peak_bytes)}
        return bench_run.report(cell, args, outcome, found, info)
    finally:
        print(f"alive children: {len(multiprocessing.active_children())}",
              file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())

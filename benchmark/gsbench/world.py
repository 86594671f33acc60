"""A world of one process per card, owned by the benchmark, for a cell whose
``chips`` is more than 1.

Rank 0 is the measuring process itself (``run.py``): its host clock, its
``t0``, its profiler with ``--trace 1``.  ``run()`` starts ranks 1..N-1 with
the ``spawn`` method, each with the launcher's environment that the
program reads (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` on ``127.0.0.1``), the checkout's caches and one thread,
and every rank calls the cell's runner as a one-chip run calls it, on
``cuda:<rank>`` (the CPU in the tests); only rank 0 traces.  The harness
makes no ``torch.distributed`` group and runs no collective: the program
joins its world through its own path, so a fault of its group is the
program's.  The harness's own channel is a host pipe between rank 0 and
each rank, which carries ``agree()`` and each rank's outcome.

The ranks' outcomes merge into one (``merge``): rank 0's end-to-end values,
record and set-up; ``failed`` summed; each compared number at its worst
over the ranks; the largest peak memory.  The forbidden modules are the
union over the ranks.

No rank is waited for without end.  A rank that exits with another code
than 0 (or dies) before rank 0's outcome ends the run at once: a watchdog
thread in rank 0 kills every rank, writes the rank's exit code and its
last lines on standard error, and exits 4 without a result (rank 0 may be
blocked in a collective, so the thread ends the process).  After rank 0's
outcome every rank has ``GRACE_S`` seconds to hand over its outcome and
exit 0; one that does not is killed, and the run exits 4 the same way.
Each rank's processes form a group of their own, killed whole, and a rank
whose rank 0 is gone kills its group.
"""

import collections
import dataclasses
import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import sys
import threading
import time
import traceback

from gsbench import harness

# seconds the ranks get after rank 0's outcome to hand over theirs and
# exit: NCCL's teardown of a communicator takes a few
GRACE_S = 60
# lines of a rank's standard error kept for the report of its end
TAIL_LINES = 40
EXIT_RANK_FAILED = 4

_link = None  # this process's end of the world's pipes, None alone


class PeerLost(RuntimeError):
    """A rank did not answer on the world's pipe."""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def agree(flag, timeout):
    """The OR of every rank's ``flag``: a runner ends its window on the same
    step on every rank with it.  A host barrier over the world's pipes, so
    a runner calls it at most once a chunk of steps, the same number of
    times on every rank.  Alone, ``flag`` itself.  Raises ``PeerLost``
    where a rank does not answer within ``timeout`` seconds."""
    if _link is None:
        return bool(flag)
    return _link.agree(bool(flag), timeout)


def _recv(conn, deadline, who):
    if not conn.poll(max(0.0, deadline - time.monotonic())):
        raise PeerLost(f"{who} sent nothing in time")
    try:
        return conn.recv()
    except EOFError:
        raise PeerLost(f"{who} closed its pipe") from None


class _Hub:
    """Rank 0's ends of the pipes, one a rank."""

    def __init__(self, conns):
        self.conns = conns

    def agree(self, flag, timeout):
        deadline = time.monotonic() + timeout
        for r, conn in enumerate(self.conns, 1):
            kind, theirs = _recv(conn, deadline, f"rank {r}")
            if kind != "agree":
                raise PeerLost(f"rank {r} sent its {kind} at an agreement")
            flag = flag or theirs
        for conn in self.conns:
            conn.send(flag)
        return flag


class _Spoke:
    """A rank's end of its pipe to rank 0."""

    def __init__(self, conn):
        self.conn = conn

    def agree(self, flag, timeout):
        self.conn.send(("agree", flag))
        return _recv(self.conn, time.monotonic() + timeout, "rank 0")


def _worst(values):
    """The worst of one number's readings: missing or NaN over any value,
    else the largest (``harness.judge`` passes a value up to its limit)."""
    bad = [v for v in values if v is None or v != v]
    return bad[0] if bad else max(values)


def merge(outcome, peers):
    """Rank 0's ``outcome`` merged with its ``peers``' (dicts with
    ``failed``, ``compared`` and ``memory_peak_bytes``)."""
    readings = collections.defaultdict(list)
    for name, value in outcome.compared:
        readings[name].append(value)
    for p in peers:
        for name, value in p["compared"]:
            readings[name].append(value)
    return dataclasses.replace(
        outcome,
        failed=outcome.failed + sum(p["failed"] for p in peers),
        compared=[(name, _worst(v)) for name, v in readings.items()],
        memory_peak_bytes=max([outcome.memory_peak_bytes]
                              + [p["memory_peak_bytes"] for p in peers]))


def _device(torch, device_type, rank):
    if device_type != "cuda":
        return torch.device(device_type)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    return device


def _kill_group(pgid):
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _watch_parent(lifeline):
    """Kill this rank's group once rank 0 is gone (its end of the lifeline
    closes)."""
    try:
        lifeline.recv()
    except EOFError:
        pass
    _kill_group(os.getpgid(0))


def _rank_main(rank, chips, port, cell, run_args, device_type, root, conn,
               out, lifeline):
    """Rank ``rank`` of the world: the cell's runner, then its outcome to
    rank 0 on ``conn``.  Its standard output and error go to ``out``."""
    t0 = time.perf_counter()
    os.setpgid(0, 0)
    os.dup2(out.fileno(), 1)
    os.dup2(out.fileno(), 2)
    out.close()
    threading.Thread(target=_watch_parent, args=(lifeline,),
                     daemon=True).start()
    for p in (harness.ROOT, harness.BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    harness.cache_dirs()
    import torch
    torch.set_num_threads(1)
    device = _device(torch, device_type, rank)
    global _link
    _link = _Spoke(conn)
    try:
        runner = harness.load_runner(cell.traffic["runner"], root)
        outcome = runner.run(cell, trace=False, device=device, t0=t0,
                             **run_args)
    except BaseException:
        # ends at once: a group left mid-collective may hang the teardown
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    conn.send(("outcome", {"failed": outcome.failed,
                           "compared": list(outcome.compared),
                           "memory_peak_bytes": outcome.memory_peak_bytes,
                           "forbidden": harness.forbidden_modules()}))


class _Rank:
    """Rank 0's handle on one rank: its process, its pipe, and a thread
    that copies its output to standard error, keeping the last lines."""

    def __init__(self, ctx, rank, args, lifeline):
        self.rank = rank
        self.conn, theirs = ctx.Pipe()
        out_r, out_w = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(
            target=_rank_main, name=f"gsbench-rank-{rank}",
            args=(rank, *args, theirs, out_w, lifeline))
        self.proc.start()
        theirs.close()
        out_w.close()
        self.tail = collections.deque(maxlen=TAIL_LINES)
        self.reader = threading.Thread(target=self._copy, args=(out_r,),
                                       daemon=True)
        self.reader.start()

    def _copy(self, out_r):
        with open(out_r.fileno(), "rb", closefd=False) as fh:
            for raw in fh:  # ends when every copy of the write end closed
                text = raw.decode(errors="replace").rstrip("\n")
                self.tail.append(text)
                sys.stderr.write(f"[rank {self.rank}] {text}\n")
        out_r.close()

    def kill(self):
        """Its process and whatever it started (its group)."""
        _kill_group(self.proc.pid)
        if self.proc.exitcode is None:
            self.proc.kill()
        self.proc.join(10)

    def report(self):
        """Its exit code and its last lines, on standard error."""
        self.reader.join(5)
        print(f"world: rank {self.rank} (pid {self.proc.pid}) exit code "
              f"{self.proc.exitcode}; its last lines:", file=sys.stderr)
        for line in list(self.tail):
            print(f"world:   {line}", file=sys.stderr)


class _Watchdog(threading.Thread):
    """Ends the run as soon as a rank exits with another code than 0 while
    rank 0 runs its window."""

    def __init__(self, ranks):
        super().__init__(daemon=True, name="gsbench-world-watchdog")
        self.ranks, self.lock, self.armed = ranks, threading.Lock(), True

    def run(self):
        live = {r.proc.sentinel: r for r in self.ranks}
        while live:
            ready = multiprocessing.connection.wait(list(live), timeout=0.5)
            with self.lock:
                if not self.armed:
                    return
                dead = [live.pop(s) for s in ready]
                failed = [r for r in dead if r.proc.exitcode != 0]
                if failed:
                    _end(self.ranks, failed, "a rank ended before rank "
                        "0's outcome")
                    sys.stdout.flush()
                    sys.stderr.flush()
                    os._exit(EXIT_RANK_FAILED)

    def disarm(self):
        with self.lock:
            self.armed = False


def _end(ranks, failed, why):
    """Kill every rank, then say ``why`` the run ends and report the
    ``failed`` ranks."""
    for r in ranks:
        r.kill()
    print(f"world: the run ends without a result: {why}", file=sys.stderr)
    for r in failed:
        r.report()


def _collect(ranks, deadline):
    """Each rank's outcome and its exit 0 by ``deadline``, or
    SystemExit(4) after the failed ranks' report."""
    outcomes, failed = [], []
    for r in ranks:
        try:
            kind, value = _recv(r.conn, deadline, f"rank {r.rank}")
        except PeerLost:
            kind = value = None
        if kind == "outcome":
            r.proc.join(max(0.0, deadline - time.monotonic()))
        if kind != "outcome" or r.proc.exitcode != 0:
            failed.append(r)
        outcomes.append(value)
    if failed:
        _end(ranks, failed, f"a rank gave no outcome or did not exit 0 "
            f"within {GRACE_S} s of rank 0's outcome")
        raise SystemExit(EXIT_RANK_FAILED)
    return outcomes


def run(cell, chips, *, seed, seconds, trace, control, t0,
        device_type="cuda", root=harness.ROOT):
    """The merged outcome of the cell's runner on ``chips`` ranks, and the
    forbidden modules the ranks loaded (rank 0's own are the caller's to
    read)."""
    import torch

    global _link
    port = free_port()
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(chips),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    run_args = dict(seed=seed, seconds=seconds, control=control)
    ctx = multiprocessing.get_context("spawn")
    lifeline, keep = ctx.Pipe(duplex=False)
    ranks = []
    try:
        for rank in range(1, chips):
            ranks.append(_Rank(ctx, rank, (chips, port, cell, run_args,
                                           device_type, root), lifeline))
        print("world: ranks " + " ".join(
            f"{r.rank}:{r.proc.pid}" for r in ranks), file=sys.stderr)
        watchdog = _Watchdog(ranks)
        watchdog.start()
        _link = _Hub([r.conn for r in ranks])
        device = _device(torch, device_type, 0)
        runner = harness.load_runner(cell.traffic["runner"], root)
        try:
            outcome = runner.run(cell, trace=trace, device=device, t0=t0,
                                 **run_args)
        except BaseException as exc:
            watchdog.disarm()
            # a rank that died stopped rank 0: its end is the cause
            time.sleep(2)
            failed = [r for r in ranks if r.proc.exitcode not in (None, 0)]
            if failed or isinstance(exc, PeerLost):
                _end(ranks, failed, f"rank 0 stopped ({exc!r})")
                raise SystemExit(EXIT_RANK_FAILED) from exc
            raise
        watchdog.disarm()
        peers = _collect(ranks, time.monotonic() + GRACE_S)
    finally:
        _link = None
        for r in ranks:
            r.kill()
        for r in ranks:
            r.reader.join(5)
        keep.close()
    found = sorted({m for p in peers for m in p["forbidden"]})
    return merge(outcome, peers), found

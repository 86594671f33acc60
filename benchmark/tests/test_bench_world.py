"""The harness's world of one process per card (``gsbench/world.py``), run
as ``run.py`` runs a cell, with the toy runner ``world_tiny.py``: four
ranks over gloo on the CPU, and over NCCL on four cards (``-m cuda``,
skipped with fewer):

    python -m pytest benchmark/tests/test_bench_world.py -m cuda
"""

import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

import world_tiny
from gsbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = 4


@pytest.fixture
def root(tmp_path):
    """A root whose ``benchmark/runners`` holds the toy runner."""
    runners = tmp_path / "benchmark" / "runners"
    runners.mkdir(parents=True)
    shutil.copy(os.path.join(HERE, "world_tiny.py"), runners)
    return str(tmp_path)


def run_toy(root, *args, timeout=300):
    """(the process's result, its seconds) of ``world_tiny.py``'s run."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
        "PYTHONPATH")}
    start = time.monotonic()
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "world_tiny.py"), "--root", root,
         "--ranks", str(RANKS), *args], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=harness.ROOT)
    return out, time.monotonic() - start


def result(out):
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def rank_pids(stderr):
    found = re.search(r"^world: ranks (.*)$", stderr, re.M)
    assert found, stderr[-4000:]
    pids = [int(p.split(":")[1]) for p in found.group(1).split()]
    assert len(pids) == RANKS - 1
    return pids


def alive(pid):
    """Whether ``pid`` runs (a zombie, ended and not yet reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def assert_no_rank_left(stderr):
    for pid in rank_pids(stderr):
        assert not alive(pid), pid


@pytest.mark.parametrize("fault,failed,replica_err", [
    (None, 0, 0.0),
    # rank 2 adds 0 in place of 2 + 1 + 1 at step 1: every rank's sum of
    # that step is wrong, by 4
    ("drop", RANKS, 4.0),
    # rank 1's replica drifts by one; the others' read 0
    ("drift", 0, 1.0)])
def test_world_merges_the_ranks(root, fault, failed, replica_err):
    args = ["--fault", fault, "--fault-rank", "2" if fault == "drop" else
            "1", "--fault-step", "1"] if fault else []
    out, _ = run_toy(root, *args)
    line = result(out)
    assert line["metrics"]["rank"]["value"] == 0.0   # rank 0's values
    assert line["metrics"]["steps_per_s"]["value"] > 0
    assert line["device"]["memory_peak_bytes"] == RANKS * world_tiny.MIB
    assert line["failed"] == failed
    assert line["checks"]["replica_err"]["value"] == replica_err
    assert line["correct"] is (fault is None)
    assert "alive children: 0" in out.stderr
    assert_no_rank_left(out.stderr)


@pytest.mark.parametrize("fault,code", [("raise", "exit code 1"),
                                        ("kill", "exit code -9")])
def test_a_rank_that_ends_ends_the_run(root, fault, code):
    """A rank that raises or is killed at step 3 of a window of 600 s: rank 0
    waits in the collective of step 3, and the watchdog ends the run."""
    out, seconds = run_toy(root, "--seconds", "600", "--fault", fault,
                           "--fault-rank", "2", "--fault-step", "3")
    assert out.returncode == 4, out.stderr[-4000:]
    assert seconds < 120
    assert not out.stdout.strip(), out.stdout[-2000:]
    assert f"rank 2 (pid {rank_pids(out.stderr)[1]}) {code}" in out.stderr
    if fault == "raise":
        tail = out.stderr[out.stderr.index("its last lines:"):]
        assert "planted fault on rank 2 at step 3" in tail
    assert_no_rank_left(out.stderr)


def test_a_rank_that_sleeps_is_killed_after_the_grace(root):
    out, seconds = run_toy(root, "--grace", "5", "--fault", "sleep",
                           "--fault-rank", "1")
    assert out.returncode == 4, out.stderr[-4000:]
    assert "within 5.0 s of rank 0's outcome" in out.stderr
    assert "rank 1 (pid" in out.stderr and not out.stdout.strip()
    assert "alive children: 0" in out.stderr
    assert seconds < 120
    assert_no_rank_left(out.stderr)


def test_a_rank_that_loads_a_forbidden_module_fails_the_run(root):
    out, _ = run_toy(root, "--fault", "forbidden", "--fault-rank", "3")
    assert out.returncode == 3, out.stderr[-4000:]
    assert "loaded forbidden modules: ['gan_segmentation_tpu']" in out.stderr
    assert not out.stdout.strip()


def test_merge_keeps_rank_0s_values_and_the_worst_reading():
    from gsbench import world
    rank0 = harness.Outcome({"x": 1.0}, attempted=5, failed=1,
                            compared=[("a", 0.1), ("b", 0.2), ("c", 0.0)],
                            memory_peak_bytes=10, record=harness.Record(None),
                            setup_s=3.0)
    peers = [{"failed": 2, "memory_peak_bytes": 30,
              "compared": [("a", 0.3), ("b", float("nan")), ("c", 0.0)]},
             {"failed": 0, "memory_peak_bytes": 20,
              "compared": [("a", None), ("b", 0.1), ("c", 0.5)]}]
    m = world.merge(rank0, peers)
    assert (m.end_to_end, m.attempted, m.setup_s) == ({"x": 1.0}, 5, 3.0)
    assert m.failed == 3 and m.memory_peak_bytes == 30
    got = dict(m.compared)
    assert got["a"] is None and got["b"] != got["b"] and got["c"] == 0.5


def test_a_one_chip_cell_spawns_nothing(root, monkeypatch):
    import argparse

    import torch  # noqa: F401  (imported before the patch)

    import run as bench_run

    def refuse(*_a, **_k):
        raise AssertionError("a one-chip cell started a process")

    monkeypatch.setattr(multiprocessing, "get_context", refuse)
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    args = argparse.Namespace(seed=2 ** 31 + 7, seconds=0.2, trace=0,
                              control=None)
    outcome, found = bench_run.measure(world_tiny.toy_cell(1), args, 1,
                                       "cpu", root=root)
    assert outcome.failed == 0 and outcome.compared == [("replica_err", 0)]
    assert outcome.memory_peak_bytes == world_tiny.MIB
    assert outcome.end_to_end["rank"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "raise", "kill"])
def test_cuda_four_cards(root, fault):
    """The toy world over NCCL, one rank a card; a rank that raises or is
    killed frees rank 0 from the collective it waits in."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA devices")
    args = ["--device", "cuda", "--seconds", "5"]
    if fault:
        args += ["--seconds", "600", "--fault", fault, "--fault-rank", "2",
                 "--fault-step", "200"]
    out, seconds = run_toy(root, *args, timeout=600)
    print(out.stderr[-3000:], out.stdout[-2000:],
          f"rc {out.returncode}, {seconds:.1f} s", sep="\n")
    if fault is None:
        line = result(out)
        assert line["correct"] is True and line["failed"] == 0
        assert line["device"]["memory_peak_bytes"] >= RANKS * world_tiny.MIB
    else:
        assert out.returncode == 4, out.stderr[-4000:]
        assert seconds < 300
    assert_no_rank_left(out.stderr)

"""Every configuration, cell, traffic mix and metric of ``BENCHMARK.json``
has its file, found by name, and the folder holds no file it does not
name; the file keeps the contract's shapes."""

import json
import os
import re

import pytest

from gsbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench_files(sub, ext):
    d = os.path.join(ROOT, "benchmark", sub)
    return sorted(f[:-len(ext)] for f in os.listdir(d) if f.endswith(ext))


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_load_by_name():
    assert sorted(c["name"] for c in BENCH["configs"]) == \
        [c for c in bench_files("configs", ".json")]
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert os.path.isfile(os.path.join(
            ROOT, "benchmark", "configs", cfg["reference"] + ".py"))


def test_cells_and_traffic_load_by_name():
    cells = sorted(w["name"] for w in BENCH["workloads"])
    assert cells == bench_files("workloads", ".json")
    assert sorted({w["traffic"] for w in BENCH["workloads"]}) == \
        bench_files("traffic", ".json")
    runners = bench_files("runners", ".py")
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.traffic["runner"] in runners
        assert w["chips"] == 1
        for name, spec in cell.checks.items():
            assert spec["limit"] > 0, name
        assert len(w["why"]) <= 200
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_metrics_load_by_name():
    assert sorted(m["name"] for m in BENCH["per_layer"]) == \
        bench_files("metrics", ".py")
    layers = {}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert {m["source"] for m in BENCH["end_to_end"]} <= {"host_clock",
                                                          "device_trace"}


@pytest.mark.parametrize("metric", [m for m in BENCH["end_to_end"]])
def test_bounds(metric):
    assert 0.01 <= metric["bound"] <= 0.25

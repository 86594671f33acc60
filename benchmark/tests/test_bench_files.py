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


def refusals(bench, config_file):
    """What the contract refuses in ``bench`` (a ``BENCHMARK.json`` dict) of
    its cells' chips and its configurations' cuts; ``config_file(c)`` -> the
    dict in configuration entry ``c``'s file.  A cell takes 1 or 4 chips,
    and at most a quarter of the cells, or one, take 4.  A configuration
    lists in ``reduced`` each key cut from its source, which its file's
    own ``reduced`` states with the ``published`` value and the
    ``deployment`` the cut stands for (the model-configs guide, 4)."""
    out = []
    cells = bench["workloads"]
    for w in cells:
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
    fours = sum(w["chips"] == 4 for w in cells)
    if fours > max(1, len(cells) // 4):
        out.append(f"{fours} of {len(cells)} cells take 4 chips")
    for c in bench["configs"]:
        cfg = config_file(c)
        cuts = cfg["reduced"]
        if len(c["reduced"]) > 16 or set(c["reduced"]) != set(cuts):
            out.append(f"{c['name']}: reduced {c['reduced']} against its "
                       f"file's {sorted(cuts)}")
        for key in c["reduced"]:
            cut = cuts.get(key) if isinstance(cuts, dict) else None
            if not (NAME.match(key) and key in cfg and isinstance(cut, dict)
                    and "published" in cut and cut.get("deployment")):
                out.append(f"{c['name']}: {key} without its value as run, "
                           f"its published value and its deployment")
    return out


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
        assert refusals({"workloads": [], "configs": [c]},
                        lambda _: cfg) == []
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


def synthetic(chips, reduced=(), cuts=None, held=None):
    """A BENCHMARK.json dict of one cell a number of ``chips``, and one
    configuration that lists ``reduced``, its file stating ``cuts`` and
    holding the keys ``held`` (by default those listed) as run."""
    bench = {"workloads": [{"name": f"cell{i}", "chips": n}
                           for i, n in enumerate(chips)],
             "configs": [{"name": "cfg", "reduced": list(reduced)}]}
    held = reduced if held is None else held
    return bench, {"cfg": {"reduced": [] if cuts is None else cuts,
                           **{k: 4 for k in held}}}


CUT = {"published": 50, "deployment": "four cards, one replica each"}


@pytest.mark.parametrize("bench,files,refused", [
    (*synthetic([1, 1, 4]), False),
    (*synthetic([1, 4, 4]), True),
    (*synthetic([1] * 6 + [4, 4]), False),
    (*synthetic([1] * 5 + [4, 4, 4]), True),
    (*synthetic([1, 2]), True),
    (*synthetic([1], ["num_layers"], {"num_layers": CUT}), False),
    # a cut its file does not state, or states without its published value
    # or its deployment
    (*synthetic([1], ["num_layers"], {}), True),
    (*synthetic([1], ["num_layers"], {"depth": CUT}), True),
    (*synthetic([1], ["num_layers"], {"num_layers": {"deployment": "x"}}),
     True),
    (*synthetic([1], ["num_layers"], {"num_layers": {"published": 50}}),
     True),
    # a cut the file states without the key's value as run
    (*synthetic([1], ["num_layers"], {"num_layers": CUT}, held=[]), True),
    # a cut the file states that BENCHMARK.json does not list
    (*synthetic([1], [], {"num_layers": CUT}), True),
    (BENCH, None, False)])
def test_contract_rule(bench, files, refused):
    def config_file(c):
        if files is None:
            return json.load(open(os.path.join(ROOT, c["file"])))
        return files[c["name"]]
    found = refusals(bench, config_file)
    assert bool(found) is refused, found

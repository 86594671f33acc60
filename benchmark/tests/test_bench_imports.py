"""The harness, its reference, its runners and its metric readers import no
module whose whole top-level name is ``jax``, ``jaxlib``, ``flax`` or
``gan_segmentation_tpu`` (the JAX package; the port's name begins with
it), neither in their sources nor in a process that runs a cell."""

import ast
import os
import subprocess
import sys

from gsbench import harness

BENCH = os.path.join(harness.ROOT, "benchmark")


def sources():
    for d, _, files in os.walk(BENCH):
        if os.sep + "tests" in d[len(BENCH):] or "_cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_forbidden_import_statement():
    found = []
    for path in sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            found += [(path, n) for n in names
                      if n.split(".")[0] in harness.FORBIDDEN]
    assert not found


def test_forbidden_modules_compares_whole_names():
    before = harness.forbidden_modules()
    probes = ["gan_segmentation_tpu_torch_probe", "jaxlib_probe.sub",
              "flax_probe"]
    added = [p for p in probes + ["gan_segmentation_tpu.probe"]
             if p not in sys.modules]
    for p in added:
        sys.modules[p] = sys
    try:
        after = harness.forbidden_modules()
    finally:
        for p in added:
            del sys.modules[p]
    assert after == sorted(set(before) | {"gan_segmentation_tpu"})


def test_a_run_loads_no_forbidden_module():
    """Both cells end to end on the CPU in a fresh process (the reference,
    the readers of a traced run and the program included)."""
    code = (
        "import sys; sys.path[:0] = %r\n"
        "import bench_tiny\n"
        "from gsbench import harness\n"
        "for cell in ('ffhq1024-gen-b8', 'ffhq1024-fit-b1'):\n"
        "    line, _ = bench_tiny.run_tiny(cell, trace=True)\n"
        "    assert line['checks'], line\n"
        "print('FOUND', harness.forbidden_modules())\n"
        % [os.path.dirname(os.path.abspath(__file__)), BENCH, harness.ROOT])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout, out.stdout[-2000:]

"""The controls, at each cell's own size on the card: the program's int8-full
path in place of its bf16 generate, and the reference in TF32 (the
precision below the fit's f32 with TF32 off) or with half of each image's
rows left out of the loss in place of the fit's train step; each has to
come out not correct under the cell's limits.  Without a card they skip.

    python -m pytest benchmark/tests/test_bench_controls.py -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from gsbench import harness

CASES = [("ffhq1024-gen-b8", "int8-full", 3100000011),
         ("ffhq1024-fit-b1", "tf32", 3100000013),
         ("ffhq1024-fit-b1", "half", 3100000017)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control,seed", CASES)
def test_control_is_not_correct(cell, control, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls run at the cells' "
                    "own sizes")
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", "3", "--trace", "0",
         "--control", control],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]

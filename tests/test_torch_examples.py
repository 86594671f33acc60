"""The port's closed-loop demo
(gan_segmentation_tpu_torch/examples/full_pipeline_demo.py) stays runnable
end to end on the CPU, at the tiny scale at which tests/test_examples.py
runs the JAX package's: fixture annotations at 32^2, decoder fit and
evaluation (mean IoU above 0.5, asserted by the demo), 8 + 8 generated
pairs, one DeepLabV3+ epoch of 8 draws and its validation."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_full_pipeline_demo(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m",
         "gan_segmentation_tpu_torch.examples.full_pipeline_demo", "--cpu",
         "--workdir", str(tmp_path), "--max-res-log2", "5",
         "--n-annotations", "6", "--n-generate", "8",
         "--decoder-epochs", "2", "--deeplab-epochs", "1",
         "--deeplab-epoch-len", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    gen = list((tmp_path / "dataset" / "train_generated").glob("img_*.jpg"))
    assert len(gen) == 8, (len(gen), r.stdout[-1500:])
    assert "== full pipeline OK" in r.stdout
    assert (tmp_path / "runs" / "checkpoints" / "last_checkpoint.pt").is_file()

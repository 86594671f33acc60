"""SegSolver — the decoder's construction, checkpoints and prediction
(the subset of ``gan_segmentation_tpu/train/solver.py`` that ``generate``
needs; ``fit`` and ``evaluate`` come later).

The port's checkpoint is ``torch.save`` of the decoder's ``state_dict`` as
``checkpoints/*.pt``.  A checkpoint directory that holds only the JAX
package's or mxnet's ``*.params`` raises: converting those is ROADMAP
Queue 1 #11, and ignoring them would silently serve a random decoder.
"""

import logging
import os
from os import makedirs
from os.path import isdir, isfile, join
from typing import List, Optional

import numpy as np
import torch

from ..core import dtypes
from ..core.config import SolverConfig
from ..models.decoder import decoder_from_config

log = logging.getLogger(__name__)

FOREIGN_CHECKPOINTS = (".params", ".msgpack")


class SegSolver:
    def __init__(self, max_res_log2: int, path_to_data: str,
                 checkpoints_dir: str, cfg: Optional[SolverConfig] = None,
                 seed: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.path_to_data = path_to_data
        self.checkpoints_dir = checkpoints_dir
        self.cfg = cfg or SolverConfig(max_res_log2=max_res_log2)
        self.seed = self.cfg.seed if seed is None else seed
        self.device = device if device is not None else dtypes.cuda_device()
        compute_dtype = dtypes.default_policy(self.cfg.dtype).compute_dtype
        self.model = decoder_from_config(self.cfg, compute_dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device).eval()
        self.params_file = None
        self.is_trained = self.load()

    # ------------------------------------------------------------ checkpoint
    def save(self, suffix: Optional[str] = None):
        if not isdir(self.checkpoints_dir):
            makedirs(self.checkpoints_dir)
        name = ("checkpoint_last.pt" if suffix is None
                else f"checkpoint_{suffix}.pt")
        dst = join(self.checkpoints_dir, name)
        # atomic: `load` must never see a torn checkpoint
        torch.save(self.model.state_dict(), dst + ".tmp")
        os.replace(dst + ".tmp", dst)
        self.params_file = name
        log.info("saved checkpoint: %s", name)

    def load(self) -> bool:
        if not isdir(self.checkpoints_dir):
            return False
        files = sorted(f for f in os.listdir(self.checkpoints_dir)
                       if isfile(join(self.checkpoints_dir, f)))
        ours = [f for f in files if f.endswith(".pt")]
        if not ours:
            foreign = [f for f in files if f.endswith(FOREIGN_CHECKPOINTS)]
            if foreign:
                raise RuntimeError(
                    f"{join(self.checkpoints_dir, foreign[0])} is a JAX-"
                    "package or mxnet checkpoint; the PyTorch port reads "
                    "only its own *.pt checkpoints (converting the others is "
                    "ROADMAP Queue 1 #11)")
            return False
        path = join(self.checkpoints_dir, ours[0])
        log.info("loading checkpoint: %s", ours[0])
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state)
        self.params_file = ours[0]
        return True

    # --------------------------------------------------------------- predict
    def predict_logits(self, features: List) -> torch.Tensor:
        """Eval-mode logits (N, H, W, num_classes) f32 for a feature pyramid
        of (H, W, C) or (N, H, W, C) arrays or tensors."""
        feats = []
        for f in features:
            f = torch.as_tensor(np.asarray(f, np.float32) if not
                                isinstance(f, torch.Tensor) else f)
            feats.append((f[None] if f.dim() == 3 else f).to(
                self.device, torch.float32))
        with torch.inference_mode():
            return self.model(feats)

"""What the benchmark takes from the program (``gan_segmentation_tpu_torch``,
the PyTorch / CUDA port): its kernel build, its configuration classes and
the objects under test.  Nothing here computes a result of its own."""

import json
import os
import sys
import time


def program_seed(seed):
    """The seed handed to the program: its generators take ``seed * 2**32
    + batch`` and ``RandomState(seed + epoch)``, so it is kept under
    2**31."""
    return int(seed) % 2 ** 31


def build_kernels(device):
    """Build (or load) the port's CUDA kernel library on a card and print
    an earlier line saying how long it took and whether it compiled; the
    time counts in set-up.  On a CPU device the kernels' plain versions
    run and nothing is built."""
    if device.type != "cuda":
        return 0.0
    from gan_segmentation_tpu_torch.kernels import _build

    t = time.perf_counter()
    fresh = not os.path.isfile(os.path.join(
        _build.BUILD_DIR, f"libgst_kernels-{_build._source_tag()}.so"))
    _build.library()
    took = time.perf_counter() - t
    print(json.dumps({"kernel_build_s": took, "compiled": fresh}))
    sys.stdout.flush()
    return took


def check_gan_config(gcfg, gan):
    """Raise unless the program's generator config holds the
    configuration's sizes."""
    pairs = {"max_res_log2": gcfg.max_res_log2, "fmap_base": gcfg.fmap_base,
             "fmap_decay": gcfg.fmap_decay, "fmap_max": gcfg.fmap_max,
             "base": gcfg.base_scale_x, "latent_size": gcfg.latent_size,
             "channels": gcfg.channels,
             "mapping_lr_mult": gcfg.mapping_lr_mult}
    bad = {k: (v, gan[k]) for k, v in pairs.items() if v != gan[k]}
    if bad or gcfg.base_scale_y != gan["base"]:
        raise RuntimeError(f"the program's generator config differs from "
                           f"the configuration: {bad}")


def check_decoder_config(scfg, dec):
    pairs = {"features": list(scfg.features),
             "in_channels": list(scfg.in_channels),
             "start_res": scfg.start_res, "use_bn": scfg.use_bn,
             "use_dropout": scfg.use_dropout}
    bad = {k: (v, dec[k]) for k, v in pairs.items() if v != dec[k]}
    if bad:
        raise RuntimeError(f"the program's decoder config differs from the "
                           f"configuration: {bad}")


def solver(torch, max_res_log2, dec, solver_cfg, seed, device, tmp,
           weights):
    """A ``SegSolver`` on ``device`` holding the benchmark's decoder
    ``weights`` (loaded strictly: a renamed or reshaped parameter raises).
    ``solver_cfg``: ``SolverConfig`` fields; no checkpoint directory
    exists, so nothing is read from disk."""
    from gan_segmentation_tpu_torch.core.config import SolverConfig
    from gan_segmentation_tpu_torch.train.solver import SegSolver

    scfg = SolverConfig(max_res_log2=max_res_log2, seed=seed,
                        **solver_cfg)
    check_decoder_config(scfg, dec)
    s = SegSolver(max_res_log2, os.path.join(tmp, "no-data"),
                  os.path.join(tmp, "no-checkpoints"), cfg=scfg, seed=seed,
                  device=device)
    with torch.no_grad():
        s.model.load_state_dict(weights)
    s.weights_version += 1
    return s

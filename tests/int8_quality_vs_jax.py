"""Int8 against float, in both packages on the same weights: the share of
mask pixels that ``int8`` and ``int8-full`` keep and the int8-full image's
PSNR, from the JAX package's scheme (``ops/quant.py``, its s2d decoder
tail) and the port's (``gan_segmentation_tpu_torch/ops/quant.py``), f32
on the CPU.  The weights are random, drawn with numpy as the tests draw
them (noise scales, biases and psi off their init), the JAX package's
worst case for int8; calibration on two batches of the fixed numpy stream,
evaluation on three others.  It shows how far int8 moves masks and images
on such weights, and that the port's int8 model moves them as far as the
JAX package's does.

    JAX_PLATFORMS=cpu python tests/int8_quality_vs_jax.py [--res 6]

(~2 min at the full ffhq width and res 6, ~4 min and ~4 GB at res 9;
``test_torch_quant_generator.py::test_tiny_int8_full_pipeline_matches_jax``
makes the same comparison narrow and small.)
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

from gan_segmentation_tpu.core.config import GanConfig as JGanConfig  # noqa: E402
from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig  # noqa: E402
from gan_segmentation_tpu.models.decoder import decoder_from_config as jdec  # noqa: E402
from gan_segmentation_tpu.models.stylegan import StyleGanGenerator as JGen  # noqa: E402
from gan_segmentation_tpu.ops import quant as jq  # noqa: E402
from gan_segmentation_tpu.ops import s2d_decoder as js2d  # noqa: E402

from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig  # noqa: E402
from gan_segmentation_tpu_torch.core.params_bridge import (  # noqa: E402
    decoder_state_dict, generator_quant_invs, generator_state_dict)
from gan_segmentation_tpu_torch.models.decoder import decoder_from_config  # noqa: E402
from gan_segmentation_tpu_torch.models.stylegan import StyleGanGenerator  # noqa: E402
from gan_segmentation_tpu_torch.ops import quant as tq  # noqa: E402

T = torch.from_numpy


def _params(model, latent, seed):
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, latent), jnp.float32))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, p):
        leaf = path[-1].key
        if leaf in ("scale_factors", "bias", "latent_avg"):
            return (0.1 * rng.randn(*p.shape)).astype(np.float32)
        if leaf == "truncation_psi":
            return (0.75 + 0.25 * np.tanh(rng.randn(*p.shape))).astype(
                np.float32)
        std = 100.0 if path[0].key == "mapping" else 1.0
        return (std * rng.randn(*p.shape)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                        [draw(p, s) for p, s in flat])


def _u8(x):
    return (np.clip((np.asarray(x) + 1) / 2, 0, 1) * 255).astype(np.uint8)


def _psnr(a, b):
    mse = ((_u8(a).astype(float) - _u8(b).astype(float)) ** 2).mean()
    return float("inf") if mse == 0 else float(10 * np.log10(255 ** 2 / mse))


def compare(res=6, fmap_max=512, latent=512, batch=2, seed=0):
    """{mode: {"jax": {...}, "port": {...}}} with the mean mask agreement
    and image PSNR of int8 against float over three batches."""
    from test_torch_quant import _decoder_vars
    from test_torch_quant_generator import _inject, _jax_int8

    gcfg = dict(max_res_log2=res, fmap_max=fmap_max, latent_size=latent,
                fmap_base=max(8192 * fmap_max // 512, fmap_max * 4),
                dtype="fp32")
    model = JGen(JGanConfig(**gcfg))
    params = _params(model, latent, seed)
    port = StyleGanGenerator(GanConfig(**gcfg)).eval()
    port.load_state_dict(generator_state_dict(params))
    chans = GanConfig(**gcfg).feature_channels
    scfg = dict(max_res_log2=res, in_channels=chans,
                features=[32] * (res - 2) + [16, 2])
    dmodel = jdec(JSolverConfig(**scfg))
    v = _decoder_vars(dmodel, JSolverConfig(**scfg), seed + 1)
    dec = decoder_from_config(SolverConfig(**scfg)).eval()
    dec.load_state_dict(decoder_state_dict(v["params"], v["batch_stats"]))

    def draw(s):
        r = np.random.RandomState(s)
        return (r.randn(batch, latent).astype(np.float32),
                {f"block_{k}.noise_{i}": r.randn(
                    batch, 2 ** k, 2 ** k, 1).astype(np.float32)
                 for k in range(2, res + 1) for i in (1, 2)})

    calib = [draw(100), draw(101)]
    stats = None
    for z, nz in calib:
        with _inject(nz):
            got = jq.calibrate_generator(model, params, [jnp.asarray(z)],
                                         [jax.random.PRNGKey(0)])
        stats = got if stats is None else jax.tree_util.tree_map(
            np.maximum, stats, got)
    quant = jq.generator_quant_scales(stats)
    dec_float = jax.jit(lambda vv, f: js2d.decoder_apply_s2d(
        dmodel, vv, f, fine_logits=True))
    dec_int8 = jax.jit(lambda qq, f: jq.apply_s2d_int8(
        dmodel, qq, f, 3, fine_logits=True))
    out = {}
    for mode in ("int8", "int8-full"):
        q = quant if mode == "int8-full" else None
        gstate = (tq.generator_int8_state(port, generator_quant_invs(quant))
                  if q is not None else None)
        with torch.no_grad():
            qtree = jax.device_get(jq.prepare_s2d_int8(
                dmodel, v, [_jax_int8(model, params, q, z, nz)[1]
                            for z, nz in calib], 3))
            dstate = tq.prepare_decoder_int8(
                dec, [port(T(z), {k: T(a) for k, a in nz.items()},
                           quant=gstate)[1] for z, nz in calib],
                torch.float32)
            rec = {"jax": [], "port": []}
            for s in range(3):
                z, nz = draw(200 + s)
                rf, ff, _ = _jax_int8(model, params, None, z, nz)
                rq, fq, _ = _jax_int8(model, params, q, z, nz)
                lf, lq = np.asarray(dec_float(v, ff)), np.asarray(
                    dec_int8(qtree, fq))
                rec["jax"].append(((lf.argmax(-1) == lq.argmax(-1)).mean(),
                                   _psnr(rf, rq)))
                tn = {k: T(a) for k, a in nz.items()}
                trf, tff = port(T(z), tn)
                trq, tfq = port(T(z), tn, quant=gstate)
                tlf = dec(tff).numpy()
                tlq = dec.forward_int8(tfq, dstate, torch.float32).numpy()
                rec["port"].append(((tlf.argmax(-1) == tlq.argmax(-1)).mean(),
                                    _psnr(trf.numpy(), trq.numpy())))
        out[mode] = {k: dict(mask_agreement=float(np.mean([a for a, _ in r])),
                             image_psnr_db=float(np.mean([p for _, p in r])))
                     for k, r in rec.items()}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=6)
    ap.add_argument("--fmap-max", type=int, default=512)
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps(compare(args.res, args.fmap_max)))

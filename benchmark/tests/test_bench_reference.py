"""The plain reference (``configs/stylegan_seg_ref.py``) against the frozen
copy of the repository's pure-numpy oracle (``ref_numpy_frozen.py``) at
``max_res_log2`` 5 with the published channel widths, noise scales zero
(the oracle's contract); against the program's own f32 forward on the CPU
with the noise on; and its train step against the program's on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import ref_numpy_frozen as ref_numpy
from gsbench import harness, weights

RES = 5
CFG = json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                  "stylegan-ffhq-1024.json")))
REF = harness.load_reference(CFG)


def small(res=RES):
    gan = dict(CFG["gan"], max_res_log2=res)
    dec = dict(CFG["decoder"], features=[32] * (res - 1) + [2],
               in_channels=[512] * (res - 1))
    return gan, dec


def mx_generator(p, gan):
    """The program-named weights in the reference repository's mxnet
    names and layouts (``chip_smoke.py::generator_mx_arrays``)."""
    t = {k: v.numpy() for k, v in p.items()}
    mx = {"constant_tensor": t["constant_tensor"].transpose(0, 3, 1, 2),
          "latent_avg": t["latent_avg"],
          "truncation_psi": t["truncation_psi"]}
    for i in range(8):
        mx[f"mp_dense_{i}_weight"] = t[f"mapping.dense_{i}.weight"]
        mx[f"mp_dense_{i}_bias"] = t[f"mapping.dense_{i}.bias"]
    for res in range(2, gan["max_res_log2"] + 1):
        s, blk = 2 ** res, f"block_{res}"
        if res >= 3:
            up = "deconv_1" if res >= 7 else "conv_1"
            mx[f"{s}_{up}_weight"] = t[f"{blk}.{up}.weight"]
        mx[f"{s}_conv_2_weight"] = t[f"{blk}.conv_2.weight"]
        for j in (1, 2):
            mx[f"{s}_noise_{j}_scale_factors"] = t[
                f"{blk}.noise_{j}.scale_factors"].reshape(1, -1, 1, 1)
            mx[f"{s}_bias_{j}_bias"] = t[f"{blk}.bias_{j}.bias"]
            mx[f"{s}_adain_{j}_dense_affine_weight"] = t[
                f"{blk}.adain_{j}.affine.weight"]
            mx[f"{s}_adain_{j}_dense_affine_bias"] = t[
                f"{blk}.adain_{j}.affine.bias"]
    top = gan["max_res_log2"]
    mx[f"{2 ** top}_conv_to_rgb_weight"] = t[f"to_rgb_{top}.weight"]
    mx[f"{2 ** top}_conv_to_rgb_bias"] = t[f"to_rgb_{top}.bias"]
    return mx


def mx_decoder(p, dec):
    """Creation-order names (``conv{k}``, ``batchnorm{k}``): every cvt
    block first, then the main blocks."""
    t = {k: v.numpy() for k, v in p.items()}
    n = len(dec["in_channels"])
    convs = [f"cvt_{i}_conv" for i in range(n)]
    bns = [f"cvt_{i}_bn" for i in range(n)]
    for i in range(n - 1):
        convs += [f"main_{i}.conv_0", f"main_{i}.conv_1"]
        bns += [f"main_{i}.bn_0", f"main_{i}.bn_1"]
        if f"main_{i}.shortcut.weight" in t:
            convs.append(f"main_{i}.shortcut")
    convs.append(f"main_{n - 1}_conv")
    mx = {}
    for k, name in enumerate(convs):
        mx[f"conv{k}_weight"] = t[f"{name}.weight"]
        mx[f"conv{k}_bias"] = t[f"{name}.bias"]
    for k, name in enumerate(bns):
        for ours, theirs in (("weight", "gamma"), ("bias", "beta"),
                             ("running_mean", "running_mean"),
                             ("running_var", "running_var")):
            mx[f"batchnorm{k}_{theirs}"] = t[f"{name}.{ours}"]
    return mx


class DecCfg:
    def __init__(self, dec):
        self.features = dec["features"]
        self.in_channels = dec["in_channels"]
        self.start_res = dec["start_res"]
        self.use_bn = dec["use_bn"]


def noise_for(gan, batch, g):
    return {f"block_{r}.noise_{j}": torch.randn(
        (batch, 2 ** r, 2 ** r, 1), generator=g)
        for r in range(2, gan["max_res_log2"] + 1) for j in (1, 2)}


def test_reference_matches_numpy_oracle():
    gan, dec = small()
    dev = torch.device("cpu")
    gw = weights.generator_weights(gan, 11, dev)
    for k in gw:
        if k.endswith("scale_factors"):
            gw[k] = torch.zeros_like(gw[k])
    dw = weights.decoder_weights(dec, 11, dev)
    g = torch.Generator().manual_seed(5)
    z = torch.randn((2, 512), generator=g)
    with torch.no_grad():
        rgb, feats = REF.generator_forward(gw, gan, z, noise_for(gan, 2, g))
        logits = REF.decoder_forward(dw, dec, feats)
    rgb_n, feats_n, _ = ref_numpy.generator_forward(mx_generator(gw, gan),
                                                    z.numpy(), RES)
    for ours, theirs in zip(feats, feats_n):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), rgb_n, rtol=1e-4, atol=1e-4)
    logits_n, _ = ref_numpy.decoder_forward(feats_n, mx_decoder(dw, dec),
                                            DecCfg(dec))
    np.testing.assert_allclose(logits.numpy(), logits_n, rtol=1e-4,
                               atol=1e-4)


def test_reference_matches_the_program_f32_with_noise():
    """A second witness for the noise term's place and scale: the
    program's own f32 generator and eval decoder on the CPU."""
    from gan_segmentation_tpu_torch.core.config import GanConfig, SolverConfig
    from gan_segmentation_tpu_torch.models.decoder import decoder_from_config
    from gan_segmentation_tpu_torch.models.stylegan import StyleGanGenerator

    gan, dec = small(4)
    dev = torch.device("cpu")
    gw = weights.generator_weights(gan, 12, dev)
    dw = weights.decoder_weights(dec, 12, dev)
    model = StyleGanGenerator(GanConfig(max_res_log2=4, dtype="fp32"))
    model.load_state_dict(gw)
    decoder = decoder_from_config(SolverConfig(max_res_log2=4)).eval()
    decoder.load_state_dict(dw)
    g = torch.Generator().manual_seed(6)
    z = torch.randn((2, 512), generator=g)
    noise = noise_for(gan, 2, g)
    with torch.no_grad():
        rgb, feats = REF.generator_forward(gw, gan, z, noise)
        logits = REF.decoder_forward(dw, dec, feats)
        rgb_p, feats_p = model(z, noise=noise)
        logits_p = decoder(feats_p, dtype=torch.float32)
    assert float(gw["block_3.noise_2.scale_factors"].abs().max()) > 0.05
    for ours, theirs in zip(feats, feats_p):
        torch.testing.assert_close(ours, theirs.permute(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rgb, rgb_p.permute(0, 3, 1, 2), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(logits, logits_p.permute(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4)


def test_reference_train_step_matches_the_program():
    """The fit cell run on the CPU at a tiny size: the reference's losses,
    Adam's first moment and the change over the first epoch and over an
    epoch of the window against the program's graphed epochs (eager on the
    CPU) on the same inputs."""
    import bench_tiny

    line, judged = bench_tiny.run_tiny("ffhq1024-fit-b1")
    gaps = {name: value for name, value, *_ in judged}
    for part in ("start", "window"):
        assert gaps[f"{part}_loss_gap"] < 1e-5
        assert gaps[f"{part}_moment_gap"] < 1e-4
        assert gaps[f"{part}_change_gap"] < 1e-4
    assert line["correct"] and line["attempted"] >= 4


def test_reference_class_mask_and_image():
    logits = torch.tensor([[[[0.0, 1.0]], [[0.0, 2.0]]]])   # (1, 2, 1, 2)
    assert REF.class_mask(logits).tolist() == [[[0, 1]]]    # ties: class 0
    rgb = torch.tensor([-1.0, 0.0, 0.999, 2.0]).reshape(1, 1, 1, 4)
    assert REF.to_uint8(rgb.permute(0, 3, 1, 2)).flatten().tolist() == \
        [0, 127, 254, 255]


@pytest.mark.parametrize("tf32", [False, True])
def test_precision_context_restores(tf32):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with REF.precision(tf32):
        assert torch.backends.cudnn.allow_tf32 == tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before

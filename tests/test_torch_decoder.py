"""The port's eval-mode decoder (gan_segmentation_tpu_torch/models/decoder.py)
against the JAX package's Decoder.apply on bridged params and batch_stats,
f32 on the CPU.  The BN statistics, scales and shifts are non-trivial, so
the BN fold is tested.  Tolerance rtol 1e-4, atol 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.models.decoder import Decoder as JDecoder

from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import decoder_state_dict
from gan_segmentation_tpu_torch.kernels.small_conv import conv3x3_small
from gan_segmentation_tpu_torch.models.decoder import (Decoder, Conv,
                                                       decoder_from_config)

torch.set_num_threads(2)  # the test workers share the host's cores

IN_CHANNELS = (64, 64, 64, 32, 16, 8)  # the narrow generator's pyramid


def _features(nclass):
    return (16, 16, 16, 16, 16, 8, nclass)


def _jax_decoder(features, rng, use_bn=True):
    """The JAX decoder and variables of its init's shapes, drawn with numpy
    (the flax init runs op by op and is slow here)."""
    model = JDecoder(features_cfg=features, in_channels=IN_CHANNELS,
                     use_bn=use_bn)
    feats = [jnp.zeros((1, 2 ** (i + 2), 2 ** (i + 2), c), jnp.float32)
             for i, c in enumerate(IN_CHANNELS)]
    shapes = jax.eval_shape(lambda k, f: model.init(k, f, False),
                            jax.random.PRNGKey(0), feats)

    def draw(path, p):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = math.prod(p.shape[:3])
            return rng.uniform(-1, 1, p.shape).astype(np.float32) * np.sqrt(
                2.34 / fan_in)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (0.2 * rng.randn(*p.shape)).astype(np.float32)

    variables = {}
    for col, tree in shapes.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        variables[col] = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [draw(path, p) for path, p in flat])
    return model, variables


def _pyramid(rng, n=2):
    return [rng.randn(n, 2 ** (i + 2), 2 ** (i + 2), c).astype(np.float32)
            for i, c in enumerate(IN_CHANNELS)]


@pytest.mark.parametrize("nclass,use_bn", [(2, True), (3, True), (2, False)])
def test_decoder_matches_jax(nclass, use_bn):
    rng = np.random.RandomState(nclass)
    model, variables = _jax_decoder(_features(nclass), rng, use_bn)
    feats = _pyramid(rng)
    want = model.apply(variables, feats, False)

    port = Decoder(_features(nclass), IN_CHANNELS, use_bn=use_bn).eval()
    port.load_state_dict(decoder_state_dict(variables["params"],
                                            variables.get("batch_stats", {})))
    launches = conv3x3_small.launches
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    assert conv3x3_small.launches == launches  # CPU: the plain version
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 128, 128, nclass)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fold_bn_matches_eval_batch_norm():
    """conv -> eval BN equals the conv with the folded kernel and bias."""
    dec = decoder_from_config(SolverConfig(max_res_log2=4)).eval()
    dec.reset_parameters(torch.Generator().manual_seed(0))
    bn, conv = dec.cvt_1_bn, dec.cvt_1_conv
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(t.shape, generator=g))
        bn.running_var.uniform_(0.5, 1.5, generator=g)
        x = torch.randn(2, 8, 8, 512, generator=g)
        ref = bn(torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1))
        w, b = dec.fold_bn()["cvt_1"]
        got = conv3x3_small(x, w, b)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=1e-4,
                               atol=1e-4)


def test_mx_xavier_init_and_defaults():
    dec = decoder_from_config(SolverConfig(max_res_log2=5))
    dec.reset_parameters(torch.Generator().manual_seed(0))
    for m in dec.modules():
        if isinstance(m, Conv):
            bound = math.sqrt(2.34 / math.prod(m.weight.shape[1:]))
            top = float(m.weight.detach().abs().max())
            assert 0.9 * bound < top <= bound
            assert not m.bias.any()
    assert bool((dec.cvt_0_bn.running_var == 1).all())


def test_train_mode_is_not_ported():
    """Train mode is ported now (tests/test_torch_train.py holds it to
    JAX); what stays refused is dropout without an explicit generator, and
    eval mode stays the folded path."""
    dec = decoder_from_config(SolverConfig(max_res_log2=3))
    feats = [torch.randn(1, 4, 4, 512), torch.randn(1, 8, 8, 512)]
    assert dec.training
    with pytest.raises(ValueError, match="Generator"):
        dec(feats)
    logits = dec(feats, generator=torch.Generator().manual_seed(0))
    assert tuple(logits.shape) == (1, 8, 8, 2) and logits.requires_grad
    with torch.no_grad():
        assert tuple(dec.eval()(feats).shape) == (1, 8, 8, 2)

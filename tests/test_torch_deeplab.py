"""The port's DeepLab stack (gan_segmentation_tpu_torch: ops/resize.py,
ops/losses.py, ops/norm.py::batch_norm, models/{resnet,resnext,deeplab}.py,
the train-mode forward and backward) against the JAX package on the same inputs and
the same parameters, carried across by core/params_bridge.py, and against
the numpy oracle tests/ref_numpy_deeplab.py.  f32 on the CPU.

Tolerances, stated where they are used:

- resizes and pooling 1e-5; losses 1e-5 relative (values and gradients);
- a module's or model's outputs ``rtol 1e-3`` plus ``1e-4`` of the
  tensor's largest magnitude (``_close``): both sides sum thousands of f32
  products in different orders through up to 57 convs, so a value near 0
  carries the rounding of partial sums as large as the tensor's largest;
- train-mode outputs and running statistics the same, with ``2e-3`` of
  the largest magnitude (batch statistics divide by a variance that itself
  carries the summation's rounding);
- gradients by their relative L2 error (``_close_l2``).  A block alone,
  train mode: under 1e-3 (measured ~1e-6).  A backbone or a whole model
  with batch norm in eval mode: under 1e-2.  A backbone or a whole model in
  train mode: under 0.15, because that gradient is ill-conditioned, not
  because the two sides disagree: the port's own f32 gradient of a random
  resnet50 DeepLabV3+ moves by 0.02-0.05 when the input is scaled by
  1 + 1e-7 (0.00003 next to the loss, 0.03-0.05 at the stem; ``chip_smoke.py``'s
  small reference measures and logs it), while the loss moves by 1e-6 and
  the eval-mode gradient by 1e-3 at most.  The JAX package's gradients
  sit up to 0.033 from the port's here.  A wrong layout or formula moves a gradient by its
  own size.

The JAX variables are built once per module: shapes from
``jax.eval_shape`` of ``init`` (no eager init), leaves filled from numpy
seeds, with running statistics and batch-norm scales off their defaults.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import ref_numpy_deeplab as ref

from gan_segmentation_tpu.models import deeplab as jdl
from gan_segmentation_tpu.models import resnet as jresnet
from gan_segmentation_tpu.models import resnext as jresnext
from gan_segmentation_tpu.ops import losses as jlosses
from gan_segmentation_tpu.ops import resize as jresize

from gan_segmentation_tpu_torch.core.params_bridge import (deeplab_state_dict,
                                                           state_dict_trees)
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.models import resnet as tresnet
from gan_segmentation_tpu_torch.models import resnext as tresnext
from gan_segmentation_tpu_torch.ops import losses as tlosses
from gan_segmentation_tpu_torch.ops import norm as tnorm
from gan_segmentation_tpu_torch.ops import resize as tresize

torch.set_num_threads(2)  # the test workers share the host's cores


def _close(got, want, scale=1e-4, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=1e-3, err_msg=err_msg,
        atol=scale * max(float(np.abs(want).max()), 1e-30))


def _close_l2(got, want, err_msg="", tol=1e-3, floor=1e-30):
    """A gradient: L2 error under ``tol`` of its norm (plus ``floor``)."""
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    err = np.linalg.norm(got - want) / (np.linalg.norm(want) + floor)
    assert err < tol, f"{err_msg}: relative L2 error {err:.3g}"


# ------------------------------------------------------- shared machinery
def jax_variables(model, *args, seed=0, **kwargs):
    """``model.init``'s tree with numpy-filled leaves: kernels N(0, 1 /
    fan_in), scales and variances U(0.5, 1.5), biases and means N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *args, **kwargs))
    rs = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / math.sqrt(math.prod(v.shape[:3]))
            return (std * rs.randn(*v.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (0.1 * rs.randn(*v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_port(module, variables):
    """The JAX variables into the port's module, strictly."""
    module.load_state_dict(deeplab_state_dict(
        variables["params"], variables.get("batch_stats", {})))
    return module


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_eval(jmodel, tmodel, variables, x, jkwargs=None, tkwargs=None):
    want = _tuple(jmodel.apply(variables, jnp.asarray(x), False,
                               **(jkwargs or {})))
    tmodel.eval()
    with torch.no_grad():
        got = _tuple(tmodel(torch.from_numpy(x), **(tkwargs or {})))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, err_msg=f"eval output {i}")
    return got


def check_train(jmodel, tmodel, variables, x, seed=0, scale=2e-3,
                grad_tol=1e-3, train=True):
    """Train-mode outputs, the gradients of ``sum(out * cot)`` w.r.t. every
    parameter and the input, and the updated running statistics; dropout is
    the identity on both sides.  With ``train=False`` the same outputs and
    gradients with batch norm in eval mode (no statistics move).  A gradient that is zero by construction (a
    shift that the next train-mode batch norm removes) is rounding noise on
    both sides: each is held to ``grad_tol`` of its own norm plus 1e-3 of
    the largest gradient's."""
    rs = np.random.RandomState(seed)
    with nn.intercept_methods(_no_dropout):
        shapes = jax.eval_shape(lambda: jmodel.apply(
            variables, jnp.asarray(x), train, mutable=["batch_stats"]))[0]
    cots = [rs.randn(*s.shape).astype(np.float32) for s in _tuple(shapes)]

    def loss_fn(params, xj):
        out, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xj, train, mutable=["batch_stats"])
        total = sum(jnp.sum(o * c) for o, c in zip(_tuple(out), cots))
        return total, (_tuple(out), upd.get("batch_stats"))

    with nn.intercept_methods(_no_dropout):
        (_, (want, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
                variables["params"], jnp.asarray(x))

    tmodel.train(train)
    tmodel.zero_grad()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _tuple(tmodel(xt))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cots)).backward()
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, scale, err_msg=f"train output {i}")
    want_grads = deeplab_state_dict(gp, {})
    named = dict(tmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    floor = 1e-3 * max(float(w.norm()) for w in want_grads.values())
    _close_l2(xt.grad, gx, "input gradient", grad_tol, floor)
    for k, w in want_grads.items():
        _close_l2(named[k].grad, w.numpy(), f"gradient of {k}", grad_tol,
                  floor)
    if not train:
        return
    want_stats = deeplab_state_dict({}, stats)
    state = tmodel.state_dict()
    for k, w in want_stats.items():
        if k.endswith("num_batches_tracked"):
            assert int(state[k]) == 1, k
        else:
            _close(state[k], w.numpy(), scale, k)
            assert not np.allclose(state[k].numpy(),
                                   deeplab_state_dict({}, variables[
                                       "batch_stats"])[k].numpy()), k


# ------------------------------------------------------- resize and pool
@pytest.mark.parametrize("size,out", [
    ((60, 60), (120, 120)), ((15, 15), (480, 480)), ((1, 1), (7, 7)),
    ((7, 7), (1, 1)), ((9, 9), (9, 9)), ((5, 8), (11, 8)),
    ((12, 7), (5, 3)), ((1, 6), (4, 6))],
    ids=["60-120", "15-480", "1-7", "7-1", "same", "h-only", "down",
         "h1-w-same"])
def test_bilinear_resize_matches_jax(rng, size, out):
    x = rng.randn(2, *size, 3).astype(np.float32)
    got = tresize.bilinear_resize(torch.from_numpy(x), *out)
    want = np.asarray(jresize.bilinear_resize(jnp.asarray(x), *out))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), ref.bilinear_align_corners(x, *out), atol=1e-5, rtol=0)


def test_bilinear_resize_keeps_dtype_and_identity(rng):
    x = torch.from_numpy(rng.randn(1, 4, 4, 2).astype(np.float32))
    assert tresize.bilinear_resize(x, 4, 4) is x
    y = tresize.bilinear_resize(x.bfloat16(), 8, 8)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jresize.bilinear_resize(
        jnp.asarray(x.numpy()).astype(jnp.bfloat16), 8, 8).astype(
            jnp.float32))
    # one bf16 rounding of the same f32 result
    np.testing.assert_allclose(y.float().numpy(), want, atol=2e-2, rtol=8e-3)


@pytest.mark.parametrize("keepdims", [True, False])
def test_global_avg_pool_matches_jax(rng, keepdims):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    got = tresize.global_avg_pool(torch.from_numpy(x), keepdims)
    want = np.asarray(jresize.global_avg_pool(jnp.asarray(x), keepdims))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ----------------------------------------------------------------- losses
def _labels(rs, shape, nclass):
    labels = rs.randint(-1, nclass, shape).astype(np.int32)
    labels[-1] = -1  # one sample with every pixel ignored
    return labels


def _softmax_case(rs):
    return rs.randn(3, 6, 5, 4).astype(np.float32) * 2.0, _labels(
        rs, (3, 6, 5), 4)


def _sigmoid_case(rs):
    return rs.randn(3, 6, 5).astype(np.float32) * 2.0, _labels(
        rs, (3, 6, 5), 2)


LOSSES = {
    "weighted_softmax_ce": (_softmax_case, lambda m, lg, lb, w: m.
                            weighted_softmax_ce(lg, lb, w)),
    "softmax_ce_with_ignore": (_softmax_case, lambda m, lg, lb, w: m.
                               softmax_ce_with_ignore(lg, lb)),
    "softmax_ce_valid_norm": (_softmax_case, lambda m, lg, lb, w: m.
                              softmax_ce_valid_norm(lg, lb)),
    "normalized_focal_loss_softmax": (
        _softmax_case, lambda m, lg, lb, w: m.normalized_focal_loss_softmax(
            lg, lb)),
    "normalized_focal_loss_softmax_sum": (
        _softmax_case, lambda m, lg, lb, w: m.normalized_focal_loss_softmax(
            lg, lb, gamma=1.5, size_average=False)),
    "area_normalized_focal_loss_softmax": (
        _softmax_case, lambda m, lg, lb, w: m.
        area_normalized_focal_loss_softmax(lg, lb, w)),
    "normalized_focal_loss_sigmoid": (
        _sigmoid_case, lambda m, lg, lb, w: m.normalized_focal_loss_sigmoid(
            lg, lb, scale=2.0)),
    "normalized_focal_loss_sigmoid_plain": (
        _sigmoid_case, lambda m, lg, lb, w: m.normalized_focal_loss_sigmoid(
            lg, lb, normalize=False, size_average=False)),
    "focal_loss_sigmoid": (_sigmoid_case, lambda m, lg, lb, w: m.
                           focal_loss_sigmoid(lg, lb)),
    "seg_loss_with_aux": (_softmax_case, lambda m, lg, lb, w: m.
                          seg_loss_with_aux(lg, 0.5 * lg + 1.0, lb,
                                            aux_weight=0.4)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_gradient_match_jax(rng, name):
    """Values (and the second return value where there is one) and the
    gradient w.r.t. the logits of a random weighting of the per-sample
    losses, with ignored pixels and an all-ignored sample: rtol 1e-5."""
    case, call = LOSSES[name]
    logits, labels = case(rng)
    weights = rng.uniform(0.2, 1.5, labels.shape).astype(np.float32)
    cot = rng.uniform(0.5, 1.5, 3).astype(np.float32)

    def jtotal(lg):
        out = call(jlosses, lg, jnp.asarray(labels), jnp.asarray(weights))
        first = out[0] if isinstance(out, tuple) else out
        return jnp.sum(first * (cot if first.ndim else cot[0])), out

    (_, want), want_grad = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = call(tlosses, lg, torch.from_numpy(labels),
               torch.from_numpy(weights))
    first = got[0] if isinstance(got, tuple) else got
    c = torch.from_numpy(cot)
    (first * (c if first.dim() else c[0])).sum().backward()
    assert isinstance(got, tuple) == isinstance(want, tuple)
    for g, w in zip(_tuple(got), _tuple(want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-7)
    want_grad = np.asarray(want_grad)
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(lg.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-6 * np.abs(want_grad).max())


def test_losses_take_int8_masks_and_bf16_logits(rng):
    logits, labels = _softmax_case(rng)
    want = tlosses.seg_loss_with_aux(torch.from_numpy(logits),
                                     torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    got = tlosses.seg_loss_with_aux(torch.from_numpy(logits),
                                    torch.from_numpy(logits),
                                    torch.from_numpy(labels.astype(np.int8)))
    assert torch.equal(got, want)
    half = tlosses.softmax_ce_valid_norm(torch.from_numpy(logits).bfloat16(),
                                         torch.from_numpy(labels))
    assert half.dtype == torch.float32


# ------------------------------------------------------------- batch norm
@pytest.mark.parametrize("shape", [(2, 5, 4, 6), (1, 4, 4, 3), (1, 1, 1, 5)],
                         ids=["batch2", "batch1", "one-value"])
def test_batch_norm_matches_flax_biased_running_var(rng, shape):
    """Train mode through ``F.batch_norm``: the output, and running
    statistics that fold in the BIASED variance (at (1, 4, 4, C) the
    unbiased one is 16/15 of it); a single value per channel takes the
    written-out formula.  1e-5."""
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    c = shape[-1]
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(
        np.float32), "bias": rng.randn(c).astype(np.float32)},
        "batch_stats": {"mean": rng.randn(c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    want, upd = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = tresnet.BatchNorm(c)
    state = deeplab_state_dict({"bn": variables["params"]},
                               {"bn": variables["batch_stats"]})
    bn.load_state_dict({k[len("bn."):]: t for k, t in state.items()})
    bn.train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, ours).numpy(),
            np.asarray(upd["batch_stats"][theirs]), atol=1e-5, rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    want_eval = nn.BatchNorm(use_running_average=True, momentum=0.9,
                             epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x))
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want_eval), atol=1e-5, rtol=1e-5)


def test_batch_norm_forms_agree(rng):
    """``batch_norm`` (fused) and ``batch_norm_train`` (written out) give
    the same output, gradients and running statistics: 1e-5."""
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    outs = []
    for form in (tnorm.batch_norm_train,
                 lambda t, bn: tnorm.batch_norm(t, bn, True)):
        bn = tresnet.BatchNorm(4)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
            bn.running_var.fill_(0.7)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = form(xt, bn)
        (y * y).sum().backward()
        outs.append([y.detach(), xt.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean.clone(), bn.running_var.clone()])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("downsample", [True, False], ids=["ds", "plain"])
def test_bottleneck_matches_jax(rng, downsample):
    in_ch, strides = (12, 2) if downsample else (32, 1)
    x = rng.randn(2, 9, 9, in_ch).astype(np.float32)
    jm = jresnet.BottleneckV1b(8, strides, 2, downsample=downsample)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tresnet.BottleneckV1b(in_ch, 8, strides, 2,
                                         downsample=downsample), v)
    check_eval(jm, tm, v, x)
    check_train(jm, tm, v, x)


@pytest.mark.parametrize("dilated", [True, False], ids=["dilated", "strided"])
def test_resnet_v1s_matches_jax(rng, dilated):
    x = rng.randn(2, 33, 33, 3).astype(np.float32)
    jm = jresnet.ResNetV1s(layers=(1, 1, 1, 1), dilated=dilated)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tresnet.ResNetV1s(layers=(1, 1, 1, 1), dilated=dilated), v)
    c1, c3, c4 = check_eval(jm, tm, v, x)
    assert tuple(c4.shape) == ((2, 5, 5, 2048) if dilated
                               else (2, 2, 2, 2048))
    check_train(jm, tm, v, x, grad_tol=0.15)


def test_resnet_first_block_dilation_rule():
    """Block 0 of the dilation-2 stage runs dilation 1 and block 0 of the
    dilation-4 stage dilation 2; both have a stride-1 downsample."""
    m = tresnet.resnet50_v1s()
    got = {name: (getattr(m, name).conv2.dilation,
                  getattr(m, name).conv2.stride,
                  getattr(m, name).downsample_conv is not None)
           for name in ("layer1_block0", "layer1_block1", "layer2_block0",
                        "layer3_block0", "layer3_block1", "layer4_block0",
                        "layer4_block2")}
    assert got == {"layer1_block0": (1, 1, True),
                   "layer1_block1": (1, 1, False),
                   "layer2_block0": (1, 2, True),
                   "layer3_block0": (1, 1, True),
                   "layer3_block1": (2, 1, False),
                   "layer4_block0": (2, 1, True),
                   "layer4_block2": (4, 1, False)}
    assert m.layer3_block0.downsample_conv.stride == 1
    assert [len([n for n, _ in m.named_children() if n.startswith(
        f"layer{i}_")]) for i in (1, 2, 3, 4)] == [3, 4, 6, 3]


def test_constructors_pass_the_published_depths(monkeypatch):
    monkeypatch.setattr(tresnet, "ResNetV1s", lambda **kw: kw)
    monkeypatch.setattr(tresnext, "ResNextDilated", lambda **kw: kw)
    assert tresnet.resnet50_v1s() == dict(layers=(3, 4, 6, 3), dilated=True)
    assert tresnet.resnet101_v1s(False) == dict(layers=(3, 4, 23, 3),
                                                dilated=False)
    assert tresnet.resnet152_v1s() == dict(layers=(3, 8, 36, 3),
                                           dilated=True)
    base = dict(bottleneck_width=4, dilated=True)
    assert tresnext.resnext50_32x4d() == dict(
        layers=(3, 4, 6, 3), cardinality=32, use_se=False, **base)
    assert tresnext.resnext101_32x4d() == dict(
        layers=(3, 4, 23, 3), cardinality=32, use_se=False, **base)
    assert tresnext.resnext101_64x4d() == dict(
        layers=(3, 4, 23, 3), cardinality=64, use_se=False, **base)
    assert tresnext.se_resnext50_32x4d() == dict(
        layers=(3, 4, 6, 3), cardinality=32, use_se=True, **base)
    assert tresnext.se_resnext101_32x4d() == dict(
        layers=(3, 4, 23, 3), cardinality=32, use_se=True, **base)


def test_resnext_matches_jax_and_the_oracle(rng):
    x = rng.randn(2, 33, 33, 3).astype(np.float32)
    kw = dict(layers=(2, 2, 2, 2), cardinality=8, use_se=True)
    jm = jresnext.ResNextDilated(**kw)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tresnext.ResNextDilated(**kw), v)
    got = check_eval(jm, tm, v, x)
    want = ref.resnext_dilated_forward(x, v["params"], v["batch_stats"], **kw)
    for g, w in zip(got, want):
        _close(g, w)
    check_train(jm, tm, v, x, grad_tol=0.15)
    assert tm.layer3_block0.conv2.dilation == 1
    assert tm.layer4_block0.conv2.dilation == 2
    assert tm.layer4_block1.conv2.dilation == 4
    assert all(getattr(tm, f"layer{i}_block0").downsample_conv is not None
               for i in (1, 2, 3, 4))
    assert tm.layer1_block0.se_conv1.bias is not None


@pytest.mark.parametrize("last_gamma", [False, True])
def test_resnext_last_gamma_quirk(last_gamma):
    """The inverted condition: bn3's scale starts at ZERO when
    ``last_gamma`` is False, as the JAX package's init has it."""
    x = jnp.zeros((1, 8, 8, 64))
    jm = jresnext.ResNextBlock(16, cardinality=4, last_gamma=last_gamma)
    want = jm.init(jax.random.PRNGKey(0), x, False)["params"]
    tm = tresnext.ResNextBlock(64, 16, cardinality=4, last_gamma=last_gamma)
    tresnet.init_parameters(tm, torch.Generator().manual_seed(0))
    for bn in ("bn1", "bn2", "bn3"):
        np.testing.assert_array_equal(getattr(tm, bn).weight.detach().numpy(),
                                      np.asarray(want[bn]["scale"]))
    assert float(tm.bn3.weight.detach().abs().max()) == \
        (1.0 if last_gamma else 0.0)
    assert float(tm.conv1.weight.detach().std()) > 0


def test_resnext50_widths():
    m = tresnext.se_resnext50_32x4d()
    assert m.layers == (3, 4, 6, 3) and m.layer1_block0.conv2.groups == 32
    assert tuple(m.layer1_block0.conv2.weight.shape) == (128, 4, 3, 3)
    assert tuple(m.layer1_block0.se_conv1.weight.shape) == (16, 256, 1, 1)
    assert tuple(m.stem_conv.weight.shape) == (64, 3, 7, 7)


@pytest.mark.parametrize("depth_activation", [True, False])
def test_separable_conv_matches_jax(rng, depth_activation):
    x = rng.randn(2, 9, 8, 6).astype(np.float32)
    jm = jdl.SeparableConv(10, dilation=2, depth_activation=depth_activation)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tdl.SeparableConv(6, 10, dilation=2,
                                     depth_activation=depth_activation), v)
    got, = check_eval(jm, tm, v, x)
    _close(got, ref.separable_conv(x, v["params"], v["batch_stats"],
                                   dilation=2,
                                   depth_activation=depth_activation))
    check_train(jm, tm, v, x)
    assert tm.depthwise.padding == (2, 2) == jdl._same_padding(3, 2)


@pytest.mark.parametrize("k,d", [(3, 1), (3, 2), (3, 12), (2, 1), (4, 3)])
def test_same_padding(k, d):
    assert tdl._same_padding(k, d) == jdl._same_padding(k, d) == \
        ref.same_pad(k, d)


def test_asymmetric_padding_is_applied_as_written(rng):
    """A (begin, end) pair that differs pads begin before and end after."""
    from gan_segmentation_tpu_torch.ops.conv import conv2d
    x = rng.randn(1, 6, 6, 2).astype(np.float32)
    w = rng.randn(2, 2, 2, 3).astype(np.float32)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=(0, 1))
    _close(got, ref.conv2d(x, w, pad=(0, 1)))


@pytest.mark.parametrize("batch", [2, 1], ids=["batch2", "batch1"])
def test_aspp_matches_jax(rng, batch):
    """Batch 1 gives the pooled branch's batch norm one value per channel
    in train mode (the written-out formula)."""
    x = rng.randn(batch, 7, 6, 16).astype(np.float32)
    jm = jdl.ASPP(atrous_rates=(2, 4, 6), out_channels=8)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tdl.ASPP(16, (2, 4, 6), 8, use_dropout=False), v)
    got, = check_eval(jm, tm, v, x)
    _close(got, ref.aspp(x, v["params"], v["batch_stats"], rates=(2, 4, 6)))
    check_train(jm, tm, v, x)
    full = tdl.ASPP(2048)
    assert [full.b1_conv.dilation, full.b2_conv.dilation,
            full.b3_conv.dilation] == [12, 24, 36]
    assert full.b3_conv.padding == 36 and full.project_conv.weight.shape[1] \
        == 5 * 256


def test_fcn_head_and_skip_project_match_jax(rng):
    x = rng.randn(2, 6, 7, 16).astype(np.float32)
    jm = jdl.FCNHead(3)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tdl.FCNHead(16, 3, use_dropout=False), v)
    got, = check_eval(jm, tm, v, x)
    _close(got, ref.fcn_head(x, v["params"], v["batch_stats"]))
    check_train(jm, tm, v, x)
    assert tm.conv0.bias is None and tm.conv1.bias is not None

    jm = jdl.SkipProject(5)
    v = jax_variables(jm, jnp.asarray(x), False)
    tm = load_port(tdl.SkipProject(16, 5), v)
    check_eval(jm, tm, v, x)
    check_train(jm, tm, v, x)


# ------------------------------------------------------- the whole models
@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(7).randn(1, 64, 64, 3).astype(np.float32)


@pytest.fixture(scope="module")
def v3plus(image):
    jm = jdl.DeepLabV3Plus(nclass=3, backbone="resnet50", aux=True)
    v = jax_variables(jm, jnp.asarray(image), False, seed=1)
    return jm, v, load_port(tdl.DeepLabV3Plus(3), v)


def test_deeplab_v3plus_matches_jax_and_the_oracle(v3plus, image):
    """resnet50 at 1x64x64, eval: 1e-3 (``_close``)."""
    jm, v, tm = v3plus
    out, aux = check_eval(jm, tm, v, image)
    assert tuple(out.shape) == tuple(aux.shape) == (1, 64, 64, 3)
    want = ref.deeplab_v3plus_forward(image, v["params"], v["batch_stats"])
    _close(out, want[0])
    _close(aux, want[1])
    # out_hw, and the biases are where the JAX package has them
    small = check_eval(jm, tm, v, image, dict(out_hw=(40, 24)),
                       dict(out_hw=(40, 24)))
    assert tuple(small[0].shape) == (1, 40, 24, 3)
    assert [n for n, _ in tm.named_parameters() if n.endswith(".bias")
            and "bn" not in n] == ["head_classifier.bias",
                                   "auxlayer.conv1.bias"]


def test_deeplab_v3plus_with_depth_and_without_aux(image, rng):
    depth = rng.rand(1, 64, 64, 1).astype(np.float32)
    jm = jdl.DeepLabV3Plus(nclass=2, backbone="resnet50_lsun", aux=False)
    v = jax_variables(jm, jnp.asarray(image), False, seed=2,
                      depth=jnp.asarray(depth))
    assert v["params"]["backbone"]["stem_conv0"]["kernel"].shape[2] == 4
    tm = load_port(tdl.DeepLabV3Plus(2, "resnet50_lsun", aux=False,
                                     in_channels=4), v)
    got = check_eval(jm, tm, v, image, dict(depth=jnp.asarray(depth)),
                     dict(depth=torch.from_numpy(depth)))
    assert len(got) == 1 and not hasattr(tm, "auxlayer")


def test_deeplab_v3_matches_jax_and_the_oracle(image):
    jm = jdl.DeepLabV3(nclass=3, backbone="resnet50", aux=True)
    v = jax_variables(jm, jnp.asarray(image), False, seed=3)
    tm = load_port(tdl.DeepLabV3(3), v)
    out, aux = check_eval(jm, tm, v, image)
    _c1, c3, c4 = ref.resnet_v1s_forward(image, v["params"]["backbone"],
                                         v["batch_stats"]["backbone"])
    want = ref.deeplab_v3_head(c3, c4, v["params"], v["batch_stats"],
                               (64, 64))
    _close(out, want[0])
    _close(aux, want[1])


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match="unknown backbone: vgg"):
        tdl.DeepLabV3Plus(2, backbone="vgg")
    assert tdl._BACKBONE_LAYERS == jdl._BACKBONE_LAYERS
    assert tdl.HEAD_LR_MULT == jdl.HEAD_LR_MULT == 10.0


@pytest.fixture()
def tiny_backbones(monkeypatch):
    """A (1, 1, 1, 1) backbone under the real heads, in both packages."""
    monkeypatch.setitem(jdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
    monkeypatch.setitem(tdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))


@pytest.mark.parametrize("kind", ["v3plus", "v3"])
def test_deeplab_train_mode_matches_jax(tiny_backbones, rng, kind):
    """Train-mode forward, every gradient and every running statistic of
    the whole model (full-width heads on a (1, 1, 1, 1) backbone, batch 2
    at 48^2), dropout off on both sides; and every gradient with batch norm
    in eval mode, where it is well-conditioned."""
    x = rng.randn(2, 48, 48, 3).astype(np.float32)
    jcls, tcls = ((jdl.DeepLabV3Plus, tdl.DeepLabV3Plus) if kind == "v3plus"
                  else (jdl.DeepLabV3, tdl.DeepLabV3))
    jm = jcls(nclass=2, backbone="tiny")
    v = jax_variables(jm, jnp.asarray(x), False, seed=4)
    tm = load_port(tcls(2, "tiny", use_dropout=False), v)
    check_train(jm, tm, v, x, grad_tol=1e-2, train=False)
    check_train(jm, tm, v, x, grad_tol=0.15)


def test_port_f32_gradients_match_its_f64_run(tiny_backbones, rng):
    """The port's train-mode gradients in f32 against the same model and
    input with f64 convs and batch norms (the resizes and the pool stay
    f32): relative L2 error under 1e-3 for every parameter at this size."""
    import copy
    x = rng.randn(2, 48, 48, 3).astype(np.float32)
    cots = [rng.randn(2, 48, 48, 2) for _ in range(2)]
    jm = jdl.DeepLabV3Plus(nclass=2, backbone="tiny")
    v = jax_variables(jm, jnp.asarray(x), False, seed=4)
    tm = load_port(tdl.DeepLabV3Plus(2, "tiny", use_dropout=False), v)
    grads = []
    for model, dtype in ((tm, torch.float32),
                         (copy.deepcopy(tm).double(), torch.float64)):
        model.train()
        out = model(torch.from_numpy(x).to(dtype))
        sum((o * torch.from_numpy(c).to(dtype)).sum()
            for o, c in zip(out, cots)).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    floor = 1e-3 * max(float(g.norm()) for g in grads[1].values())
    for k, g in grads[0].items():
        assert g.dtype == torch.float32
        _close_l2(g, grads[1][k].numpy(), k, 1e-3, floor)


def test_train_mode_dropout_needs_and_follows_the_generator(rng):
    tm = tdl.FCNHead(8, 2)
    tresnet.init_parameters(tm, torch.Generator().manual_seed(1))
    x = torch.from_numpy(rng.randn(2, 6, 6, 8).astype(np.float32))
    tm.train()
    with pytest.raises(ValueError, match="torch.Generator"):
        tm(x)
    a = tm(x, torch.Generator().manual_seed(3))
    b = tm(x, torch.Generator().manual_seed(3))
    c = tm(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    tm.eval()
    assert torch.equal(tm(x), tm(x, torch.Generator().manual_seed(3)))


def test_own_init_follows_the_jax_defaults():
    """lecun_normal kernels (variance 1 / fan_in, truncated at 2 sigma),
    zero biases, batch norm at scale 1, shift 0, mean 0, variance 1; the
    same generator seed gives the same model."""
    a = tdl.DeepLabV3Plus(2, generator=torch.Generator().manual_seed(5))
    b = tdl.DeepLabV3Plus(2, generator=torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name, groups_fan in (("backbone.layer4_block2.conv2.weight", 9 * 512),
                             ("aspp.b3_conv.weight", 9 * 2048),
                             ("head_sep0.depthwise.weight", 9)):
        w = sa[name]
        assert abs(float(w.var()) * groups_fan - 1.0) < 0.1, name
        assert float(w.abs().max()) <= 2.0 / 0.8796 / math.sqrt(groups_fan) \
            * 1.0001
    assert float(sa["head_classifier.bias"].abs().max()) == 0.0
    bn = a.backbone.layer2_block1.bn2
    assert bn.momentum == 0.1 and bn.eps == 1e-5
    assert torch.equal(bn.weight, torch.ones(128)) and torch.equal(
        bn.running_var, torch.ones(128))
    assert a.backbone.stem_conv0.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_bf16_activations_keep_f32_parameters(v3plus, image):
    """The compute dtype is the input's: bf16 logits within bf16's rounding
    of the f32 ones (5% of the largest logit), parameters and statistics
    untouched in f32."""
    _, _, tm = v3plus
    tm.eval()
    with torch.no_grad():
        want = tm(torch.from_numpy(image))[0]
        got = tm(torch.from_numpy(image).bfloat16())[0]
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.state_dict().values()
               if p.is_floating_point())
    assert float((got.float() - want).abs().max()) < 0.05 * float(
        want.abs().max())


def test_state_dict_trees_inverts_the_bridge(v3plus):
    _, v, tm = v3plus
    params, stats = state_dict_trees(tm.state_dict())
    flat_got = dict(jax.tree_util.tree_leaves_with_path((params, stats)))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        (v["params"], v["batch_stats"])))
    assert {str(k) for k in flat_got} == {str(k) for k in flat_want}
    for k, w in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], w, err_msg=str(k))

"""The port's decoder training and evaluation (gan_segmentation_tpu_torch:
kernels/conv3x3_grad.py, ops/losses.py, models/decoder.py train mode,
train/solver.py, apps/main.py train|evaluate) against the JAX package, f32
on the CPU, where every kernel wrapper takes its plain version.

Parity runs at res 32 on a narrow channel table with dropout off (PyTorch's
and JAX's random streams differ) and on parameters drawn with numpy and
carried across with ``decoder_state_dict``.  Tolerances, with reasons:

- the conv and its gradients, the loss: rtol 1e-4 / atol 1e-5 (f32 sums of
  up to 9*512 products, or of every pixel, in different orders);
- the train-mode decoder and one step's gradients: rtol 1e-4 / atol 1e-5
  (four scales of conv + BN, each re-normalising the rounding);
- the pre-BN conv biases: their true gradient is 0 (BN subtracts the batch
  mean), so each side's value is rounding noise; they are compared with
  atol 1e-6 only, and Adam, which turns such noise into about +-lr
  updates, is not compared on them (tests/test_solver.py:199-203 has the
  same caveat);
- learning-rate schedules: rtol 1e-5 (optax computes in f32, its cosine
  to ~1e-6 relative);
- fit trajectories: rtol 1e-4 on each step's loss (JAX's log prints six
  decimals: atol 2e-6).
"""

import functools
import logging
import re
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.core.mesh import make_mesh
from gan_segmentation_tpu.models.decoder import Decoder as JDecoder
from gan_segmentation_tpu.ops import losses as jlosses
from gan_segmentation_tpu.train.solver import SegSolver as JSegSolver

from gan_segmentation_tpu_torch.apps import main as app
from gan_segmentation_tpu_torch.core import dtypes
from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import decoder_state_dict
from gan_segmentation_tpu_torch.data.collection import (
    CollectionDataset, save_annotation_sample)
from gan_segmentation_tpu_torch.kernels import conv3x3_grad
from gan_segmentation_tpu_torch.kernels.conv3x3_grad import Conv3x3
from gan_segmentation_tpu_torch.kernels.small_conv import conv3x3_small_plain
from gan_segmentation_tpu_torch.models import decoder as tdec
from gan_segmentation_tpu_torch.ops import losses as tlosses
from gan_segmentation_tpu_torch.train import solver as tsolver
from gan_segmentation_tpu_torch.train.generator import (FusedPipeline,
                                                        ImageGenerator)
from gan_segmentation_tpu_torch.train.solver import SegSolver

torch.set_num_threads(2)  # the test workers share the host's cores

CPU = torch.device("cpu")
IN_CHANNELS = [32, 32, 16, 8]          # a narrow res-32 pyramid
FEATURES = [16, 16, 16, 8, 2]
TOL = dict(rtol=1e-4, atol=1e-5)


def _tcfg(**kw):
    return SolverConfig(max_res_log2=5, features=list(FEATURES),
                        in_channels=list(IN_CHANNELS), **kw)


def _jcfg(**kw):
    return JSolverConfig(max_res_log2=5, features=list(FEATURES),
                         in_channels=list(IN_CHANNELS), **kw)


def _pyramid(rs, n=1, channels=IN_CHANNELS):
    return [rs.randn(n, 2 ** (i + 2), 2 ** (i + 2), c).astype(np.float32)
            for i, c in enumerate(channels)]


def _mask(rs, n=1, res=32):
    m = rs.randint(0, 2, (n, res, res)).astype(np.int32)
    m[:, :2] = -1
    return m


def _jax_variables(model, rs):
    """Variables of the JAX decoder's init shapes, drawn with numpy (the
    flax init runs op by op and is slow here): non-trivial BN scales,
    shifts and running statistics, so every BN detail is exercised."""
    feats = [jnp.zeros(f.shape, jnp.float32) for f in _pyramid(rs)]
    shapes = jax.eval_shape(lambda k, f: model.init(k, f, False),
                            jax.random.PRNGKey(0), feats)

    def draw(path, p):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = np.prod(p.shape[:3])
            return rs.uniform(-1, 1, p.shape).astype(np.float32) * np.sqrt(
                2.34 / fan_in)
        if leaf in ("scale", "var"):
            return rs.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (0.2 * rs.randn(*p.shape)).astype(np.float32)

    out = {}
    for col, tree in shapes.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        out[col] = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [draw(path, p) for path, p in flat])
    return out


def _jax_and_port_decoders(seed=0):
    rs = np.random.RandomState(seed)
    jmodel = JDecoder(features_cfg=tuple(FEATURES),
                      in_channels=tuple(IN_CHANNELS), use_dropout=False)
    variables = _jax_variables(jmodel, rs)
    port = tdec.decoder_from_config(_tcfg(use_dropout=False)).train()
    port.load_state_dict(decoder_state_dict(variables["params"],
                                            variables["batch_stats"]))
    return jmodel, variables, port, rs


def _pre_bn_bias(name):
    """Conv biases that feed a BatchNorm (true gradient 0)."""
    return name.endswith(".bias") and (
        re.fullmatch(r"cvt_\d+_conv\.bias", name)
        or re.fullmatch(r"main_\d+\.conv_[01]\.bias", name))


# ------------------------------------------------------------------ conv


def _jax_conv(x, w, b):
    y = jax.lax.conv_general_dilated(
        x, w, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    return y + b


# batch-1 layers inside kernel 3's contract, one at its limit (2 x 64), and
# two that take kernel 2 (Cin 512; B*Cin = 144)
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 8, 8, 16, 16), (2, 6, 5, 64, 8), (1, 4, 4, 512, 32),
    (3, 5, 7, 48, 40), (1, 8, 8, 32, 2)])
def test_conv3x3_grads_match_jax(n, h, w, cin, cout):
    rs = np.random.RandomState(cin)
    x = rs.randn(n, h, w, cin).astype(np.float32)
    wt = (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    dy = rs.randn(n, h, w, cout).astype(np.float32)
    y_j, vjp = jax.vjp(_jax_conv, x, wt, b)
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wt, b)]
    y = Conv3x3.apply(*leaves)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    for got, wnt in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(wnt), **TOL)


def test_conv3x3_input_gradient_only_when_needed(monkeypatch):
    """No dX when x needs none (the cvt convs read the feature pyramid)."""
    calls = []
    x = torch.randn(1, 4, 4, 8)
    w = torch.randn(3, 3, 8, 4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    orig = conv3x3_grad.conv3x3
    monkeypatch.setattr(conv3x3_grad, "conv3x3",
                        lambda *a: calls.append(a) or orig(*a))
    Conv3x3.apply(x, w, b).sum().backward()
    assert len(calls) == 1  # the forward
    Conv3x3.apply(x.requires_grad_(), w, b).sum().backward()
    assert len(calls) == 3
    assert tuple(calls[2][1].shape) == (3, 3, 4, 8)  # Cout -> Cin


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 3, 4, 2, 3), (2, 4, 3, 3, 2)])
def test_conv3x3_gradcheck_plain_f64(n, h, w, cin, cout, monkeypatch):
    """The backward formulas in float64, with the conv dispatch (which
    takes f32 / bf16 only) replaced by the plain version."""
    monkeypatch.setattr(conv3x3_grad, "conv3x3", conv3x3_small_plain)
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g, dtype=torch.float64,
                        requires_grad=True)
            for s in ((n, h, w, cin), (3, 3, cin, cout), (cout,))]
    assert torch.autograd.gradcheck(Conv3x3.apply, args)


def test_train_path_dispatch_at_full_ffhq_width(monkeypatch):
    """The decoder at the full ffhq width (SolverConfig(max_res_log2=10))
    at batch 1: per step kernel 3 runs 21 forward convs (cvt_5..8, every
    main_i conv_0 / conv_1, main_8_conv) and the 17 input gradients of the
    convs after cvt_i; kernel 2 runs the 5 forward convs with Cin 512 / 256
    (cvt_0..4).  Routing depends on (B, Cin, Cout) only, so the pyramid
    here is a quarter of the real resolution (1^2 .. 256^2)."""
    seen = {"bil": [], "small": []}
    for name, tag in (("conv3x3_bil", "bil"), ("conv3x3_small", "small")):
        orig = getattr(conv3x3_grad, name)
        monkeypatch.setattr(
            conv3x3_grad, name,
            lambda x, w, b=None, _o=orig, _t=tag: seen[_t].append(
                (x.shape[0], x.shape[3], w.shape[3])) or _o(x, w, b))
    cfg = SolverConfig(max_res_log2=10)
    dec = tdec.decoder_from_config(cfg).train()
    dec.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feats = [torch.randn(1, 2 ** i, 2 ** i, c, generator=g)
             for i, c in enumerate(cfg.in_channels)]
    logits = dec(feats, generator=torch.Generator().manual_seed(2))
    assert (len(seen["bil"]), len(seen["small"])) == (21, 5)
    assert sorted(c for _, c, _ in seen["small"]) == [256, 512, 512, 512, 512]
    logits.float().square().mean().backward()
    assert (len(seen["bil"]), len(seen["small"])) == (21 + 17, 5)
    assert all(n * max(ci, co) <= 128 for n, ci, co in seen["bil"])


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("nclass", [2, 4])
def test_weighted_softmax_ce_matches_jax(nclass):
    rs = np.random.RandomState(nclass)
    logits = (3 * rs.randn(2, 5, 6, nclass)).astype(np.float32)
    labels = rs.randint(-1, nclass, (2, 5, 6)).astype(np.int32)
    w = (labels > -1).astype(np.float32)
    want = jlosses.weighted_softmax_ce(logits, labels, w)
    lt = torch.from_numpy(logits).requires_grad_()
    got = tlosses.weighted_softmax_ce(lt, torch.from_numpy(labels),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    got.mean().backward()
    gj = jax.grad(lambda z: jnp.mean(jlosses.weighted_softmax_ce(
        z, labels, w)))(logits)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(
        tlosses.softmax_ce_with_ignore(
            torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jlosses.softmax_ce_with_ignore(logits, labels)),
        rtol=1e-6, atol=1e-7)
    # ignored pixels count in the mean (normalised by all pixels)
    assert float(got.detach()[0]) < float(
        torch.log_softmax(lt.detach()[0], -1).neg().max())


# ------------------------------------------------------------- batch norm


def test_batch_norm_train_matches_flax_biased_running_var():
    """flax updates the running variance with the BIASED batch variance;
    torch's BatchNorm2d train mode with the unbiased one (16/15 of it at
    batch 1 and 4x4).  The port follows flax."""
    x = np.random.RandomState(0).randn(1, 4, 4, 3).astype(np.float32) * 2
    bn_j = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                         epsilon=1e-5)
    variables = bn_j.init(jax.random.PRNGKey(0), x)
    y_j, upd = bn_j.apply(variables, x, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1)
    y = tdec.batch_norm_train(torch.from_numpy(x), bn)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    var_j = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), var_j, rtol=1e-6)
    biased = x.reshape(-1, 3).var(0)
    np.testing.assert_allclose(var_j, 0.9 + 0.1 * biased, rtol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(torch_bn.running_var.numpy(), var_j, rtol=1e-3)


def test_dropout_draws_from_the_generator():
    x = torch.ones(1, 64, 64, 8)
    a = tdec.dropout(x, torch.Generator().manual_seed(0))
    b = tdec.dropout(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.02
    dec = tdec.decoder_from_config(_tcfg()).train()
    with pytest.raises(ValueError, match="Generator"):
        dec([torch.from_numpy(f) for f in _pyramid(np.random.RandomState(0))])


# ---------------------------------------------------- decoder, one step


def test_decoder_train_mode_matches_jax():
    jmodel, variables, port, rs = _jax_and_port_decoders()
    feats = _pyramid(rs, n=2)
    want, upd = jmodel.apply(variables, feats, True,
                             mutable=["batch_stats"])
    got = port([torch.from_numpy(f) for f in feats])
    assert tuple(got.shape) == (2, 32, 32, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    new_stats = decoder_state_dict({}, jax.device_get(upd["batch_stats"]))
    state = port.state_dict()
    for key, v in new_stats.items():
        if key.endswith("num_batches_tracked"):
            assert int(state[key]) == 1, key
            continue
        np.testing.assert_allclose(state[key].numpy(), v.numpy(), **TOL,
                                   err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    """jit(value_and_grad) of the JAX train step's loss, compiled once."""
    jmodel = JDecoder(features_cfg=tuple(FEATURES),
                      in_channels=tuple(IN_CHANNELS), use_dropout=False)

    def loss_fn(params, batch_stats, feats, mask):
        logits, upd = jmodel.apply({"params": params,
                                    "batch_stats": batch_stats},
                                   feats, True, mutable=["batch_stats"])
        w = (mask > -1).astype(jnp.float32)
        loss = jnp.mean(jlosses.weighted_softmax_ce(logits, mask, w))
        return loss, upd["batch_stats"]
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_train_step_loss_and_grads_match_jax():
    jmodel, variables, port, rs = _jax_and_port_decoders(1)
    feats, mask = _pyramid(rs), _mask(rs)
    (loss_j, _), grads_j = _jax_value_and_grad()(
        variables["params"], variables["batch_stats"], feats, mask)
    solver = SegSolver(5, "", "/nonexistent", cfg=_tcfg(use_dropout=False),
                       device=CPU)
    solver.model.load_state_dict(port.state_dict())
    solver.model.train()
    opt, _ = solver._make_optimizer(1)
    before = {k: v.clone() for k, v in solver.model.named_parameters()}
    # capture the gradients before the update
    grads = {}
    orig_step = opt.step
    opt.step = lambda: grads.update(
        {k: p.grad.clone() for k, p in solver.model.named_parameters()}) \
        or orig_step()
    loss, acc = solver._train_step(opt, [torch.from_numpy(f) for f in feats],
                                   torch.from_numpy(mask).long(), None)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert 0.0 <= float(acc) <= 1.0
    want = decoder_state_dict(jax.device_get(grads_j), {})
    assert set(want) == set(grads)
    for key, g in grads.items():
        if _pre_bn_bias(key):
            np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6,
                                       err_msg=key)
            np.testing.assert_allclose(want[key].numpy(), 0.0, atol=1e-6)
            continue
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), **TOL,
                                   err_msg=key)
        assert not torch.equal(before[key],
                               dict(solver.model.named_parameters())[key])


def test_three_adam_steps_match_optax():
    jmodel, variables, port, rs = _jax_and_port_decoders(2)
    batches = [(_pyramid(rs), _mask(rs)) for _ in range(3)]
    tx = optax.adam(1e-4)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    for feats, mask in batches:
        (_, stats), grads = _jax_value_and_grad()(params, stats, feats,
                                                   mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    solver = SegSolver(5, "", "/nonexistent", cfg=_tcfg(use_dropout=False),
                       device=CPU)
    solver.model.load_state_dict(port.state_dict())
    solver.model.train()
    opt, lr = solver._make_optimizer(1)
    for step, (feats, mask) in enumerate(batches):
        for group in opt.param_groups:
            group["lr"] = lr(step)
        solver._train_step(opt, [torch.from_numpy(f) for f in feats],
                           torch.from_numpy(mask).long(), None)
    want = decoder_state_dict(jax.device_get(params),
                              jax.device_get(stats))
    state = solver.model.state_dict()
    compared = 0
    for key, v in want.items():
        if _pre_bn_bias(key) or key.endswith("num_batches_tracked"):
            continue
        # a running mean takes in its conv's pre-BN bias (0.1 per step),
        # which Adam moved by up to +-lr per step on rounding noise
        atol = 3 * 0.1 * 2e-4 if key.endswith("running_mean") else 1e-6
        np.testing.assert_allclose(state[key].numpy(), v.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=key)
        compared += 1
    assert compared > 20


@pytest.mark.parametrize("scheduler,epochs,ipe", [
    (None, 3, 4), ("cos", 4, 5), ("cos", 2, 1), ("steps", 4, 5)])
def test_lr_schedules_match_optax(scheduler, epochs, ipe):
    cfg, jcfg = _tcfg(scheduler=scheduler), _jcfg(scheduler=scheduler)
    for c in (cfg, jcfg):
        c.train_epochs = epochs
        c.epochs_steps = [1, 2.5]
    ours = SegSolver._make_lr(SimpleNamespace(cfg=cfg), ipe)
    theirs = JSegSolver._make_lr(SimpleNamespace(cfg=jcfg), ipe)
    for step in range(epochs * ipe + 3):
        want = theirs if scheduler is None else float(theirs(step))
        np.testing.assert_allclose(ours(step), want, rtol=1e-5, err_msg=step)


def test_sgd_with_weight_decay_matches_optax():
    cfg = _tcfg(use_dropout=False, optimizer="sgd", momentum=0.9, wd=1e-3)
    solver = SegSolver(5, "", "/nonexistent", cfg=cfg, device=CPU)
    opt, _ = solver._make_optimizer(1)
    params = {k: p.detach().numpy().copy()
              for k, p in solver.model.named_parameters()}
    tx = optax.chain(optax.add_decayed_weights(1e-3),
                     optax.sgd(1e-4, momentum=0.9))
    state = tx.init(params)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        grads = {k: torch.randn(p.shape, generator=g)
                 for k, p in solver.model.named_parameters()}
        for k, p in solver.model.named_parameters():
            p.grad = grads[k].clone()
        opt.step()
        upd, state = tx.update({k: v.numpy() for k, v in grads.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
    for k, p in solver.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


# ----------------------------------------------------------------- fit


@pytest.fixture(scope="module")
def narrow_dir(tmp_path_factory):
    """Six annotated samples of the narrow res-32 pyramid, drawn with
    numpy; the mask is the sign of channel 0 of the last scale."""
    d = tmp_path_factory.mktemp("narrow")
    rs = np.random.RandomState(0)
    for i in range(6):
        feats = [f[0] for f in _pyramid(rs)]
        trimap = (feats[-1][..., 0] > 0).astype(np.int32)
        trimap[:2] = -1
        img = rs.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        save_annotation_sample(str(d), i, img, trimap, feats)
    return d


def _step_losses_from_log(records):
    return [float(m.group(1)) for r in records
            if (m := re.search(r"total-loss=([0-9.]+)", r.getMessage()))
            and "Batch[" in r.getMessage()]


def test_fit_two_epochs_matches_jax(narrow_dir, tmp_path, caplog):
    jcfg = _jcfg(use_dropout=False)
    jcfg.train_epochs, jcfg.train_display_iters = 2, 1
    js = JSegSolver(5, str(narrow_dir), str(tmp_path / "jax"),
                    mesh=make_mesh(jax.devices()[:1]), keep_weights=True,
                    cfg=jcfg)
    init = decoder_state_dict(jax.device_get(js.params),
                              jax.device_get(js.batch_stats))
    with caplog.at_level(logging.INFO,
                         logger="gan_segmentation_tpu.train.solver"):
        js.fit()
    want = _step_losses_from_log(caplog.records)
    cfg = _tcfg(use_dropout=False)
    cfg.train_epochs = 2
    ts = SegSolver(5, str(narrow_dir), str(tmp_path / "port"), cfg=cfg,
                   device=CPU)
    ts.model.load_state_dict(init)
    ts.fit()
    got = [loss for epoch in ts.history for loss in epoch]
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-6)
    assert ts.cache_active


def test_cached_and_uploaded_batches_train_alike(narrow_dir, tmp_path):
    histories = []
    for cache in (True, False):
        cfg = _tcfg(use_dropout=True, device_cache=cache)
        cfg.train_epochs = 2
        s = SegSolver(5, str(narrow_dir), str(tmp_path / str(cache)),
                      cfg=cfg, device=CPU)
        s.fit()
        assert s.cache_active == cache
        histories.append(s.history)
    np.testing.assert_allclose(histories[0], histories[1], rtol=1e-6)
    cfg = _tcfg(device_cache_gb=1e-9)
    s = SegSolver(5, str(narrow_dir), str(tmp_path / "x"), cfg=cfg,
                  device=CPU)
    assert s._try_device_cache(s.init_data()[0]) is None


@pytest.fixture(scope="module")
def generator_dir(tmp_path_factory):
    """Six samples of the port's seeded res-32 generator (512 channels at
    every scale), masked by the sign of channel 0 of the 32^2 feature with
    the top two rows ignored, as tests/util_fixtures.py makes the JAX
    package's."""
    d = tmp_path_factory.mktemp("gen")
    gen = ImageGenerator(gan="bedrooms", batch_size=6, dtype="fp32",
                         max_res_log2=5, gan_dir=str(d / "none"), seed=0,
                         device=CPU)
    imgs, feats, _ = gen.sample_batch()
    for i in range(6):
        fs = [f[i].numpy() for f in feats]
        trimap = (fs[-1][..., 0] > 0).astype(np.int32)
        trimap[:2] = -1
        save_annotation_sample(str(d), i, imgs[i].numpy(), trimap, fs)
    return d


@pytest.fixture(scope="module")
def trained(generator_dir, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfg = SolverConfig(max_res_log2=5)
    cfg.train_epochs = 20
    solver = SegSolver(5, str(generator_dir), str(ckpt), cfg=cfg,
                       keep_weights=True, device=CPU)
    assert not solver.is_trained
    ends = []
    solver.fit(epoch_end_callback=lambda: ends.append(
        solver.model.training))
    assert ends == [False] * 20  # the callback sees the eval-mode model
    return solver, ckpt


def test_fit_learns_the_rule(trained, generator_dir):
    solver, _ = trained
    assert solver.is_trained and not solver.model.training
    assert np.mean(solver.history[-1]) < np.mean(solver.history[0])
    result = dict(solver.evaluate(str(generator_dir)))
    assert result["accuracy"] > 0.9, result
    assert result["mean-iou"] > 0.8, result
    assert result["total-loss"] < 0.2, result


def test_predict_shape_and_auto_resume(trained, generator_dir):
    solver, ckpt = trained
    _, _, feats = CollectionDataset(str(generator_dir), load_to_memory=False)[0]
    pred = solver.predict(feats)
    assert pred.shape == (1, 32, 32, 1) and pred.dtype == np.int64
    assert set(np.unique(pred)) <= {0, 1}
    again = SegSolver(5, str(generator_dir), str(ckpt), device=CPU,
                      cfg=SolverConfig(max_res_log2=5))
    assert again.is_trained and again.params_file == "checkpoint_last.pt"
    np.testing.assert_array_equal(again.predict(feats), pred)


def test_evaluate_dumps_images(trained, generator_dir, tmp_path):
    solver, _ = trained
    out = tmp_path / "eval_out"
    result = solver.evaluate(str(generator_dir), output_dir=str(out))
    assert [n for n, _ in result] == ["accuracy", "mean-iou", "total-loss"]
    files = sorted(p.name for p in out.iterdir())
    for i in range(6):
        for name in (f"img_{i:06d}.jpg", f"mask_{i:06d}.png",
                     f"gt_mask_{i:06d}.png", f"metrics_{i:06d}.txt"):
            assert name in files
    assert "accuracy" in (out / "metrics_000000.txt").read_text()


def test_cli_train_then_evaluate(generator_dir, tmp_path, monkeypatch,
                                 capsys):
    monkeypatch.setattr(dtypes, "cuda_device", lambda: CPU)
    base = tmp_path / "exp"
    for sub, idx in (("data", (0, 1)), ("eval", (2, 3))):
        (base / sub).mkdir(parents=True)
        for i in idx:
            for stem, ext in (("feat", "pickle"), ("img", "jpg"),
                              ("mask", "png")):
                shutil.copy(generator_dir / f"{stem}_{i:06d}.{ext}",
                            base / sub / f"{stem}_{i:06d}.{ext}")
    config = tmp_path / "config.yml"
    config.write_text(f"BASE_DIR: {base}\nGAN: bedrooms\nMAX_RES_LOG2: 5\n")
    with pytest.raises(SystemExit):  # nothing trained yet
        app.main(["evaluate", "--config", str(config)])
    app.main(["train", "--config", str(config)])
    assert (base / "checkpoints" / "checkpoint_last.pt").is_file()
    capsys.readouterr()
    app.main(["evaluate", "--config", str(config)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    values = dict(kv.split(": ") for kv in line.split(", "))
    assert list(values) == ["accuracy", "mean-iou", "total-loss"]
    assert all(np.isfinite(float(v)) for v in values.values())


def test_pipeline_refolds_after_the_solver_changed(generator_dir, tmp_path):
    """A pipeline built before ``fit`` / ``reinit`` / ``load`` emits the
    masks of the solver's weights of now, as a fresh pipeline does: the
    same z and noise through both.  (Folding once and keeping it served the
    old decoder.)"""
    cfg = SolverConfig(max_res_log2=5)
    cfg.train_epochs = 3
    solver = SegSolver(5, str(generator_dir), str(tmp_path / "ckpt"), cfg=cfg,
                       device=CPU)
    gen = ImageGenerator(gan="bedrooms", batch_size=2, dtype="fp32",
                         max_res_log2=5, gan_dir=str(tmp_path / "none"),
                         device=CPU)
    pipe = FusedPipeline(gen, solver, inference_dtype=torch.float32)
    z = torch.from_numpy(np.random.RandomState(0).randn(2, 512)
                         .astype(np.float32))

    def masks(pipeline):
        return pipeline._fused(z, torch.Generator().manual_seed(1))[1]

    def fresh():
        return FusedPipeline(gen, solver, inference_dtype=torch.float32)

    before = masks(pipe)
    assert pipe._prepared() is pipe._prepared()   # kept while nothing changed
    solver.fit()
    after = masks(pipe)
    assert torch.equal(after, masks(fresh()))
    assert not torch.equal(after, before)
    solver.reinit()
    assert torch.equal(masks(pipe), before)
    assert solver.load()                           # fit's checkpoint_last.pt
    assert torch.equal(masks(pipe), after)


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError("no room"),
                                   OSError("unreadable")])
def test_fit_goes_on_when_the_device_cache_fails(narrow_dir, tmp_path,
                                                 monkeypatch, caplog, error):
    """A failed upload of the collection is logged and ``fit`` trains on
    with per-step uploads, to the same losses."""
    def fit(patched):
        cfg = _tcfg(use_dropout=False)
        cfg.train_epochs = 1
        s = SegSolver(5, str(narrow_dir), str(tmp_path / str(patched)),
                      cfg=cfg, device=CPU)
        s.fit()
        return s

    want = fit(False)

    def refuse(self, items, masks):
        raise error

    monkeypatch.setattr(SegSolver, "_upload_collection", refuse)
    with caplog.at_level(logging.WARNING, logger=tsolver.__name__):
        got = fit(True)
    assert want.cache_active and not got.cache_active
    assert "device cache disabled" in caplog.text
    np.testing.assert_allclose(got.history, want.history, rtol=1e-6)


@pytest.mark.parametrize("error", [OSError("unreadable"),
                                   MemoryError("no room")])
def test_fit_goes_on_when_the_host_cache_probe_fails(narrow_dir, tmp_path,
                                                     monkeypatch, caplog,
                                                     error):
    """``init_data`` sizes the host cache from one sample; when that read
    fails, or the host has no room for it, it logs and leaves the collection
    on disk."""
    cfg = _tcfg()
    s = SegSolver(5, str(narrow_dir), str(tmp_path / "ckpt"), cfg=cfg,
                  device=CPU)

    def unreadable(self, name):
        raise error

    monkeypatch.setattr(CollectionDataset, "load_sample", unreadable)
    with caplog.at_level(logging.WARNING, logger=tsolver.__name__):
        ds, iters = s.init_data()
    assert "host cache disabled" in caplog.text
    assert ds._samples is None and iters == 6


def test_print_params_lists_every_parameter(caplog):
    model = tdec.decoder_from_config(_tcfg())
    with caplog.at_level(logging.INFO, logger=tsolver.__name__):
        SegSolver.print_params(model, "decoder")
    lines = [r.getMessage() for r in caplog.records]
    names = [n for n, _ in model.named_parameters()]
    assert lines[0].split() == ["decoder", "params", "weight", "shape",
                                "dtype"]
    assert [ln.split()[0] for ln in lines[1:-1]] == names
    total = sum(p.numel() for p in model.parameters())
    assert lines[-1].split() == ["total", str(total)]

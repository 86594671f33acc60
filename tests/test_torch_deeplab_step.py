"""The step-level core of the port's DeepLab trainer
(gan_segmentation_tpu_torch/train/deeplab_trainer.py) against the JAX
package's: the optimizer against optax over five steps (1e-6), the
on-device normalisation against the host transform, the dtype flag, and two
whole train steps and an eval step against the same steps written with the
JAX package's model, criterion and optimizer.  f32 on the CPU; helpers and
tolerances from tests/test_torch_deeplab.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from test_torch_deeplab import (_close, _no_dropout, jax_variables,
                                load_port, tiny_backbones)  # noqa: F401

from gan_segmentation_tpu.data.segmentation import imagenet_transform
from gan_segmentation_tpu.models import deeplab as jdl
from gan_segmentation_tpu.ops import losses as jlosses
from gan_segmentation_tpu.train import deeplab_trainer as jtrainer

from gan_segmentation_tpu_torch.core.params_bridge import deeplab_state_dict
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.train import deeplab_trainer as ttrainer

torch.set_num_threads(2)  # the test workers share the host's cores


def test_head_param_groups_split_like_the_jax_labels(tiny_backbones):
    jm = jdl.DeepLabV3Plus(nclass=2, backbone="tiny")
    v = jax_variables(jm, jnp.zeros((1, 32, 32, 3)), False)
    tm = tdl.DeepLabV3Plus(2, "tiny")
    base, head = tdl.head_param_groups(tm)
    labels = jdl.head_param_labels(v["params"])
    n_base = sum(1 for x in jax.tree_util.tree_leaves(labels) if x == "base")
    n_head = sum(1 for x in jax.tree_util.tree_leaves(labels) if x == "head")
    assert (len(base), len(head)) == (n_base, n_head)
    names = {id(p): n for n, p in tm.named_parameters()}
    assert all(names[id(p)].startswith("backbone.") for p in base)
    assert {names[id(p)].split(".")[0] for p in head} == {
        "skip_project", "aspp", "head_sep0", "head_sep1", "head_classifier",
        "auxlayer"}


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("wd", [2e-4, 0.0])
def test_optimizer_matches_optax_over_five_steps(rng, wd, graphed):
    """SGD + momentum + weight decay on EVERY parameter + the poly rate at
    the step count before the update, head at 10x: five steps on a fixed
    gradient sequence, 1e-6.  ``graphed``: the rates live in tensors that
    the scheduler fills (``make_optimizer(graphed=True)``)."""
    jm = jdl.SkipProject(4)
    x = jnp.zeros((1, 3, 3, 6))
    params = {"backbone": jax_variables(jm, x, False, seed=1)["params"],
              "aspp": jax_variables(jm, x, False, seed=2)["params"]}
    tx = jtrainer.make_optimizer(params, 0.005, 7, wd, 0.9)
    opt_state = tx.init(params)

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = tdl.SkipProject(6, 4)
            self.aspp = tdl.SkipProject(6, 4)

    tm = Two()
    tm.load_state_dict({k: v for k, v in deeplab_state_dict(
        params, {}).items()}, strict=False)
    optimizer, scheduler = ttrainer.make_optimizer(tm, 0.005, 7, wd, 0.9,
                                                   graphed=graphed)
    named = dict(tm.named_parameters())
    for step in range(5):
        lrs = [float(g["lr"]) for g in optimizer.param_groups]
        want_lr = float(jtrainer.poly_schedule(0.005, 7)(step))
        np.testing.assert_allclose(lrs, [want_lr, 10 * want_lr], rtol=1e-6)
        np.testing.assert_allclose(
            ttrainer.poly_schedule(0.005, 7)(step), want_lr, rtol=1e-6)
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), params)
        for k, g in deeplab_state_dict(grads, {}).items():
            named[k].grad = g.clone()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        optimizer.step()
        scheduler.step()
        for k, w in deeplab_state_dict(params, {}).items():
            np.testing.assert_allclose(named[k].detach().numpy(), w.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
    assert ttrainer.poly_schedule(0.005, 7)(9) == 0.0  # clipped past the end


def test_device_normalize_matches_the_host_transform(rng):
    img = rng.randint(0, 256, (2, 5, 6, 3)).astype(np.uint8)
    got = ttrainer._device_normalize(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), imagenet_transform(img),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jtrainer._device_normalize(jnp.asarray(img))),
        atol=1e-6, rtol=1e-6)
    f = torch.from_numpy(imagenet_transform(img))
    assert ttrainer._device_normalize(f) is f


@pytest.mark.parametrize("flag,want", [
    (None, torch.float32), ("float32", torch.float32), ("f32", torch.float32),
    ("float16", torch.bfloat16), ("fp16", torch.bfloat16),
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
    ("float64", torch.float64), (torch.float16, torch.float16)])
def test_resolve_dtype(flag, want):
    assert ttrainer._resolve_dtype(flag) is want
    if not isinstance(flag, torch.dtype):  # the same flag in the JAX package
        names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                 torch.float64: "float64"}
        assert jnp.dtype(jtrainer._resolve_dtype(flag)).name == names[want]


def test_resolve_dtype_refuses_unknown_names():
    with pytest.raises(TypeError, match="unknown dtype"):
        ttrainer._resolve_dtype("float99")


def test_train_and_eval_steps_match_the_jax_steps(tiny_backbones, rng):
    """The slice as a whole: two train steps (uint8 images normalised on
    the device, int8 masks with ignored pixels, aux weight 0.5, SGD 0.9,
    weight decay 2e-4, poly rate, head at 10x; dropout off on both sides)
    and an eval step against the same steps written with the JAX package's
    model, criterion and optimizer.  First step: loss 1e-5 relative, logits
    within ``_close``'s 2e-3.  The second step starts from weights that
    differ by the rate times the two sides' gradient difference (see the
    module docstring): loss 1e-3 relative, logits 2e-2 of the largest;
    every parameter and statistic after the steps within 2e-3."""
    images = rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    masks = rng.randint(-1, 2, (2, 48, 48)).astype(np.int8)
    jm = jdl.DeepLabV3Plus(nclass=2, backbone="tiny")
    v = jax_variables(jm, jnp.zeros((1, 48, 48, 3)), False, seed=6)
    tm = load_port(tdl.DeepLabV3Plus(2, "tiny", use_dropout=False), v)
    params, stats = v["params"], v["batch_stats"]
    tx = jtrainer.make_optimizer(params, 0.005, 10, 2e-4, 0.9)
    opt_state = tx.init(params)
    optimizer, scheduler = ttrainer.make_optimizer(tm, 0.005, 10, 2e-4, 0.9)

    def loss_fn(p, bs):
        x = jtrainer._device_normalize(jnp.asarray(images))
        outputs, upd = jm.apply({"params": p, "batch_stats": bs}, x, True,
                                mutable=["batch_stats"])
        loss = jnp.mean(jlosses.seg_loss_with_aux(
            outputs[0], outputs[1], jnp.asarray(masks).astype(jnp.int32),
            aux_weight=0.5))
        return loss, (outputs[0], upd["batch_stats"])

    step_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for step in range(2):
        with nn.intercept_methods(_no_dropout):
            (want_loss, (want_pred, stats)), grads = step_fn(params, stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        loss, pred = ttrainer.train_step(
            tm, optimizer, scheduler, torch.from_numpy(images),
            torch.from_numpy(masks), aux_weight=0.5)
        assert loss.dtype == pred.dtype == torch.float32
        np.testing.assert_allclose(float(loss), float(want_loss),
                                   rtol=(1e-5, 1e-3)[step])
        _close(pred, want_pred, (2e-3, 2e-2)[step], f"step {step} logits")
    state = tm.state_dict()
    for k, w in deeplab_state_dict(params, stats).items():
        if not k.endswith("num_batches_tracked"):
            _close(state[k], w.numpy(), 2e-3, k)
    assert tm.training
    got = ttrainer.eval_step(tm, torch.from_numpy(images))
    assert not tm.training and got.dtype == torch.float32
    want = jm.apply({"params": params, "batch_stats": stats},
                    jtrainer._device_normalize(jnp.asarray(images)), False)[0]
    _close(got, want, 2e-3, "eval logits")
    half = ttrainer.eval_step(tm, torch.from_numpy(images),
                              dtype=torch.bfloat16)
    assert half.dtype == torch.float32 and bool(torch.isfinite(half).all())



"""The port's DeepLab checkpoint readers (gan_segmentation_tpu_torch:
core/backbone_convert.py, core/deeplab_convert.py and their loaders)
against the JAX package's on the same synthetic files, f32 on the CPU.

- The copied converters must give exactly the original's trees, errors
  included, on tests/test_backbone_convert.py's and
  tests/test_deeplab_convert.py's synthetic files, both naming schemes.
- A file loaded by both packages must give the same eval forward, within
  tests/test_torch_deeplab.py's ``_close`` (rtol 1e-3 plus 1e-4 of the
  tensor's largest magnitude).
- A missing or misshapen entry raises; nothing stays at its init silently.

No gluoncv backbone file and no reference-trained DeepLabV3+ checkpoint is
in the repository: every file here is synthetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_backbone_convert import (synth_gluoncv_resnet50,
                                   synth_gluoncv_resnet50_dotted)
from test_deeplab_convert import synth_reference_deeplab
from test_mx_params import write_mx_file
from test_torch_convert import _assert_states_equal, _assert_trees_equal
from test_torch_deeplab import _close, jax_variables

import chip_smoke
from gan_segmentation_tpu.core import backbone_convert as jbc
from gan_segmentation_tpu.core import deeplab_convert as jdc
from gan_segmentation_tpu.models import deeplab as jdl
from gan_segmentation_tpu.models import resnet as jresnet
from gan_segmentation_tpu.train import deeplab_trainer as jtrainer

from gan_segmentation_tpu_torch.core import backbone_convert as tbc
from gan_segmentation_tpu_torch.core import deeplab_convert as tdc
from gan_segmentation_tpu_torch.core.params_bridge import (deeplab_state_dict,
                                                           state_dict_trees)
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.models import resnet as tresnet

torch.set_num_threads(2)  # the test workers share the host's cores


def _randomize_bn(named, seed=1):
    """The synthesizers leave gamma 1, beta 0, var 1 (or draw a normal
    variance): move them to values a forward can tell apart."""
    rs = np.random.RandomState(seed)
    for k in named:
        if k.endswith(("gamma", "running_var")):
            named[k] = rs.uniform(0.5, 1.5, named[k].shape).astype(np.float32)
        elif k.endswith(("beta", "running_mean")):
            named[k] = (0.1 * rs.randn(*named[k].shape)).astype(np.float32)
        elif k.endswith("weight") and named[k].ndim == 4:
            fan_in = np.prod(named[k].shape[1:])
            named[k] = (rs.randn(*named[k].shape) / np.sqrt(fan_in)).astype(
                np.float32)
    return named


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def port_v3plus():
    """One full-size model for the module (its init takes seconds); every
    test loads its own state into it first."""
    return tdl.DeepLabV3Plus(2)


# ---------------------------------------------------------------- backbone
@pytest.mark.parametrize("dotted", [False, True], ids=["legacy", "dotted"])
def test_backbone_convert_matches_original_and_jax_forward(
        tmp_path, image, port_v3plus, dotted):
    synth = synth_gluoncv_resnet50_dotted if dotted else synth_gluoncv_resnet50
    named = _randomize_bn(synth(), seed=1 + dotted)
    assert any("." in k for k in named) == dotted
    params, stats = jbc.convert_resnet_v1s_params(named)
    got_params, got_stats = tbc.convert_resnet_v1s_params(named)
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_stats, stats)

    path = str(tmp_path / "resnet50_v1s.params")
    write_mx_file(path, list(named.values()), list(named))
    state = tbc.load_backbone_state_dict(path)
    _assert_states_equal(state, deeplab_state_dict(params, stats))
    model = port_v3plus
    before = model.backbone.layer3_block5.conv2.weight.clone()
    model.backbone.load_state_dict(state)     # strict
    assert not torch.equal(before, model.backbone.layer3_block5.conv2.weight)
    # OIHW in the file is OIHW in the port, untouched
    src = ("layer3.5.conv2.weight" if dotted
           else "resnetv1s_layers3_bottleneckv1b5_conv1_weight")
    np.testing.assert_array_equal(
        model.backbone.layer3_block5.conv2.weight.detach().numpy(),
        named[src])
    model.eval()
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(image))
    want = jresnet.ResNetV1s().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(image), False)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("dotted,missing", [
    (False, "resnetv1s_layers3_bottleneckv1b2_conv1_weight"),
    (False, "resnetv1s_down4_batchnorm0_running_var"),
    (True, "layer2.0.downsample.0.weight"), (True, "bn1.gamma")])
def test_backbone_convert_strict_reports_misses(tmp_path, port_v3plus,
                                                dotted, missing):
    synth = synth_gluoncv_resnet50_dotted if dotted else synth_gluoncv_resnet50
    named = synth()
    del named[missing]
    with pytest.raises(KeyError) as want:
        jbc.convert_resnet_v1s_params(named, strict=True)
    with pytest.raises(KeyError) as got:
        tbc.convert_resnet_v1s_params(named, strict=True)
    assert str(got.value) == str(want.value) and missing in str(got.value)
    loose = tbc.convert_resnet_v1s_params(named, strict=False)
    for a, b in zip(loose, jbc.convert_resnet_v1s_params(named,
                                                         strict=False)):
        _assert_trees_equal(a, b)
    # and what strict=False leaves out is refused by the model's own load
    path = str(tmp_path / "short.params")
    write_mx_file(path, list(named.values()), list(named))
    with pytest.raises(KeyError):
        tbc.load_backbone_state_dict(path)
    state = tbc.load_backbone_state_dict(path, strict=False)
    with pytest.raises(RuntimeError, match="Missing key"):
        port_v3plus.backbone.load_state_dict(state)


def test_backbone_of_another_depth_is_refused(tmp_path, port_v3plus):
    named = synth_gluoncv_resnet50()
    path = str(tmp_path / "resnet50_v1s.params")
    write_mx_file(path, list(named.values()), list(named))
    with pytest.raises(KeyError, match="layers3_bottleneckv1b6"):
        tbc.load_backbone_state_dict(path, layers=(3, 4, 23, 3))
    named["resnetv1s_conv0_weight"] = named["resnetv1s_conv0_weight"][:, :2]
    write_mx_file(path, list(named.values()), list(named))
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_v3plus.backbone.load_state_dict(
            tbc.load_backbone_state_dict(path))


# ----------------------------------------------------------------- deeplab
@pytest.fixture(scope="module")
def reference_file(image):
    """A reference-named DeepLabV3+ file's arrays, from the JAX model's
    shapes."""
    jm = jdl.DeepLabV3Plus(nclass=2, aux=True)
    v = jax_variables(jm, jnp.asarray(image), False)
    return jm, _randomize_bn(synth_reference_deeplab(v["params"],
                                                     v["batch_stats"]))


def test_deeplab_convert_matches_original_and_jax_forward(
        tmp_path, image, reference_file, port_v3plus):
    jm, named = reference_file
    assert tdc.is_deeplab_reference_file(named)
    assert jdc.is_deeplab_reference_file(named)
    assert not tdc.is_deeplab_reference_file(synth_gluoncv_resnet50_dotted())
    params, stats = jdc.convert_deeplabv3plus_params(named)
    got_params, got_stats = tdc.convert_deeplabv3plus_params(named)
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_stats, stats)

    path = str(tmp_path / "last_checkpoint.params")
    write_mx_file(path, list(named.values()), list(named))
    state = tdc.load_deeplab_state_dict(path)
    _assert_states_equal(state, deeplab_state_dict(params, stats))
    model = port_v3plus.eval()
    model.load_state_dict(state)               # strict
    # the depthwise kernel (C, 1, kh, kw) arrives untouched
    np.testing.assert_array_equal(
        model.head_sep0.depthwise.weight.detach().numpy(),
        named["head.block.0.depthwise_conv.weight"])
    with torch.no_grad():
        got = model(torch.from_numpy(image))
    jparams, jstats = jtrainer.load_checkpoint(
        path, *[jax_variables(jm, jnp.asarray(image), False)[k]
                for k in ("params", "batch_stats")])
    want = jm.apply({"params": jparams, "batch_stats": jstats},
                    jnp.asarray(image), False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)


def test_deeplab_without_aux_converts(reference_file):
    _, named = reference_file
    named = {k: v for k, v in named.items() if not k.startswith("auxlayer")}
    with pytest.raises(KeyError, match="auxlayer.block.0.weight"):
        tdc.convert_deeplabv3plus_params(named)
    got = tdc.convert_deeplabv3plus_params(named, aux=False)
    for a, b in zip(got, jdc.convert_deeplabv3plus_params(named, aux=False)):
        _assert_trees_equal(a, b)
    tdl.DeepLabV3Plus(2, aux=False).load_state_dict(deeplab_state_dict(*got))


@pytest.mark.parametrize("missing", [
    "aspp.project.0.weight", "head.block.1.bn2.running_mean",
    "layer4.0.downsample.1.beta", "head.block.2.bias"])
def test_deeplab_convert_strict_reports_misses(tmp_path, reference_file,
                                               port_v3plus, missing):
    _, named = reference_file
    named = dict(named)
    del named[missing]
    with pytest.raises(KeyError) as want:
        jdc.convert_deeplabv3plus_params(named, strict=True)
    with pytest.raises(KeyError) as got:
        tdc.convert_deeplabv3plus_params(named, strict=True)
    assert str(got.value) == str(want.value) and missing in str(got.value)
    for a, b in zip(tdc.convert_deeplabv3plus_params(named, strict=False),
                    jdc.convert_deeplabv3plus_params(named, strict=False)):
        _assert_trees_equal(a, b)
    if missing.startswith("aspp"):  # once is enough for a 160 MB file
        path = str(tmp_path / "short.params")
        write_mx_file(path, list(named.values()), list(named))
        with pytest.raises(KeyError, match=missing):
            tdc.load_deeplab_state_dict(path)
        state = tdc.load_deeplab_state_dict(path, strict=False)
    else:
        state = deeplab_state_dict(*tdc.convert_deeplabv3plus_params(
            named, strict=False))
    with pytest.raises(RuntimeError, match="Missing key"):
        port_v3plus.load_state_dict(state)


def test_deeplab_loader_refuses_other_files(tmp_path, rng):
    named = synth_gluoncv_resnet50_dotted()
    path = str(tmp_path / "backbone.params")
    write_mx_file(path, list(named.values()), list(named))
    with pytest.raises(ValueError) as got:
        tdc.load_deeplab_state_dict(path)
    with pytest.raises(ValueError) as want:
        jtrainer.load_checkpoint(path, {}, {})
    assert str(got.value) == str(want.value)
    from gan_segmentation_tpu.core.checkpoint import save_msgpack
    other = str(tmp_path / "generator.params")
    save_msgpack(other, {"mapping": {"w": rng.randn(3).astype(np.float32)}})
    with pytest.raises(ValueError, match="no 'params' tree"):
        tdc.load_deeplab_state_dict(other)


def test_loads_the_jax_packages_deeplab_checkpoint(tmp_path, image):
    """``*.params`` as the JAX trainer's ``save_checkpoint_file`` writes it
    (msgpack of params and batch_stats) loads to the same forward."""
    jm = jdl.DeepLabV3(nclass=3, aux=True)
    v = jax_variables(jm, jnp.asarray(image), False, seed=8)
    path = str(tmp_path / "epoch_0003.params")
    jtrainer.save_checkpoint_file(path, v["params"], v["batch_stats"])
    state = tdc.load_deeplab_state_dict(path)
    _assert_states_equal(state, deeplab_state_dict(v["params"],
                                                   v["batch_stats"]))
    model = tdl.DeepLabV3(3).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(image))
    want = jm.apply(v, jnp.asarray(image), False)
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(RuntimeError, match="Unexpected key|Missing key"):
        tdl.DeepLabV3Plus(3, "resnet50").load_state_dict(state)


# --------------------------------------- the card script's synthetic files
def test_chip_smoke_writes_what_the_readers_read(tmp_path, port_v3plus):
    """chip_smoke.py's inverse name maps and writer (its phase 8 on the
    card): a DeepLabV3+ in the reference's dotted names and its backbone in
    gluoncv's legacy names load back to the source's state, through the
    JAX package's converters as well."""
    src = port_v3plus
    tresnet.init_parameters(src, torch.Generator().manual_seed(3))
    chip_smoke.perturb(torch, src, 4)
    state = src.state_dict()
    assert not torch.equal(state["aspp.pool_bn.running_var"], torch.ones(256))
    assert float(state["auxlayer.conv1.bias"].abs().min()) > 0
    named = chip_smoke.deeplab_mx_arrays(state)
    assert tdc.is_deeplab_reference_file(named)
    path = str(tmp_path / "last_checkpoint.params")
    chip_smoke.write_mx_file(path, named)
    _assert_states_equal(tdc.load_deeplab_state_dict(path), state)
    want_trees = state_dict_trees(state)
    for a, b in zip(jdc.load_reference_deeplab(path), want_trees):
        _assert_trees_equal(a, b)

    bb_state = {k[len("backbone."):]: v for k, v in state.items()
                if k.startswith("backbone.")}
    named = chip_smoke.backbone_mx_arrays(bb_state)
    assert not any("." in k for k in named)
    assert "resnetv1s_dense0_weight" in named
    bb_path = str(tmp_path / "resnet50_v1s.params")
    chip_smoke.write_mx_file(bb_path, named)
    _assert_states_equal(tbc.load_backbone_state_dict(bb_path), bb_state)
    for a, b in zip(jbc.load_pretrained_backbone(bb_path),
                    (want_trees[0]["backbone"], want_trees[1]["backbone"])):
        _assert_trees_equal(a, b)


def test_chip_smoke_batch_is_seeded_and_labelled():
    images, masks = chip_smoke.deeplab_batch(torch, 2, 64, seed=9,
                                             device="cpu")
    again, _ = chip_smoke.deeplab_batch(torch, 2, 64, seed=9, device="cpu")
    assert images.dtype == torch.uint8 and tuple(images.shape) == (2, 64, 64,
                                                                   3)
    assert masks.dtype == torch.int8 and tuple(masks.shape) == (2, 64, 64)
    assert torch.equal(images, again)
    assert set(masks.unique().tolist()) == {-1, 0, 1}
    assert 0.02 < float((masks == -1).float().mean()) < 0.12

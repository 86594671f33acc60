"""gluoncv ``resnet50_v1s`` ImageNet checkpoint -> the port's ``ResNetV1s``
``state_dict``.

The reference's DeepLab models load gluoncv-zoo pretrained backbones
(`deeplabv3plus.py:92-100`). ``convert_resnet_v1s_params`` is a copy of
``gan_segmentation_tpu/core/backbone_convert.py`` (importing that module
pulls in jax through its package): it maps a gluoncv mxnet ``.params``
file (parsed by `core.mx_params`) onto the JAX package's ``(params,
batch_stats)`` trees of ``ResNetV1s``;
``tests/test_torch_deeplab_convert.py`` pins the copy to the original.
``load_backbone_state_dict`` passes the trees through
``core/params_bridge.py::deeplab_state_dict`` for
``model.backbone.load_state_dict``.

Name map (derived from gluoncv 0.5 ``resnetv1b.py`` structure with
``name_prefix='resnetv1s_'``; gluon auto-numbers layers per name scope):

  stem:   resnetv1s_conv{0,1,2}_weight, resnetv1s_batchnorm{0,1,2}_*
  stages: resnetv1s_layers{i}_bottleneckv1b{b}_conv{0,1,2}_weight,
          ..._batchnorm{0,1,2}_*              (i in 1..4, b per stage depth)
  downsamples: resnetv1s_down{i}_conv0_weight, resnetv1s_down{i}_batchnorm0_*
  (classifier resnetv1s_dense0_* is skipped)

VALIDATION CAVEAT: no real gluoncv weight file is available in this
environment; the map is exercised against synthetic files generated with
the same naming algorithm (tests/test_backbone_convert.py). On first
contact with a real file, run with ``strict=True`` and fix any reported
misses; `tools/inspect_checkpoint.py` lists a file's actual names.
"""

from typing import Dict, Sequence, Tuple

import numpy as np

from .params_bridge import deeplab_state_dict

_BN_MAP = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def _conv_w(arr):  # OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))


def convert_resnet_v1s_params(mx: Dict[str, np.ndarray],
                              layers: Sequence[int] = (3, 4, 6, 3),
                              prefix: str = "resnetv1s_",
                              strict: bool = True) -> Tuple[Dict, Dict]:
    """-> the JAX package's (params, batch_stats) of ``ResNetV1s``.

    Handles both checkpoint naming schemes, dispatched on ``any('.' in
    name)`` like mxnet's ``Block.load_parameters``: attribute-path (dotted)
    names from ``save_parameters`` — ``conv1.{0,3,6}.weight``,
    ``layer{i}.{b}.conv{c}.weight``, ``layer{i}.0.downsample.{0,1}.*`` —
    or the legacy name_scope parameter names documented above.
    """
    if any("." in k for k in mx):
        return _convert_resnet_v1s_dotted(mx, layers, strict)
    params: Dict = {}
    batch_stats: Dict = {}
    missing = []

    def take(name):
        if name in mx:
            return mx[name]
        missing.append(name)
        return None

    def put_conv(our, src):
        arr = take(src)
        if arr is not None:
            params.setdefault(our, {})["kernel"] = _conv_w(arr)

    def put_bn(our, src_base):
        for suffix, (kind, field) in _BN_MAP.items():
            arr = take(f"{src_base}_{suffix}")
            if arr is None:
                continue
            dst = params if kind == "params" else batch_stats
            dst.setdefault(our, {})[field] = np.asarray(arr, np.float32)

    for k in range(3):
        put_conv(f"stem_conv{k}", f"{prefix}conv{k}_weight")
        put_bn(f"stem_bn{k}", f"{prefix}batchnorm{k}")

    for i, depth in enumerate(layers, start=1):
        for b in range(depth):
            blk = f"layer{i}_block{b}"
            src = f"{prefix}layers{i}_bottleneckv1b{b}"
            for c in range(3):
                put_conv(f"{blk}.conv{c + 1}", f"{src}_conv{c}_weight")
                put_bn(f"{blk}.bn{c + 1}", f"{src}_batchnorm{c}")
        put_conv(f"layer{i}_block0.downsample_conv", f"{prefix}down{i}_conv0_weight")
        put_bn(f"layer{i}_block0.downsample_bn", f"{prefix}down{i}_batchnorm0")

    if strict and missing:
        raise KeyError(
            f"{len(missing)} expected gluoncv parameters not found, e.g. "
            f"{missing[:5]} — inspect the file with tools/inspect_checkpoint.py "
            "and adjust the name map")

    return _nest(params), _nest(batch_stats)


def _convert_resnet_v1s_dotted(mx: Dict[str, np.ndarray],
                               layers: Sequence[int] = (3, 4, 6, 3),
                               strict: bool = True) -> Tuple[Dict, Dict]:
    """Attribute-path names (gluoncv ``resnetv1b`` structure: deep stem
    ``conv1`` = Sequential[conv,bn,relu,conv,bn,relu,conv] + separate
    ``bn1``; bottlenecks attrs conv1/bn1/conv2/bn2/conv3/bn3/downsample).
    The classifier (``fc.*``) is skipped."""
    params: Dict = {}
    batch_stats: Dict = {}
    missing = []

    def take(name):
        if name in mx:
            return mx[name]
        missing.append(name)
        return None

    def put_conv(our, src):
        arr = take(f"{src}.weight")
        if arr is not None:
            params.setdefault(our, {})["kernel"] = _conv_w(arr)

    def put_bn(our, src):
        for suffix, (kind, field) in _BN_MAP.items():
            arr = take(f"{src}.{suffix}")
            if arr is None:
                continue
            dst = params if kind == "params" else batch_stats
            dst.setdefault(our, {})[field] = np.asarray(arr, np.float32)

    for k, idx in enumerate((0, 3, 6)):
        put_conv(f"stem_conv{k}", f"conv1.{idx}")
    put_bn("stem_bn0", "conv1.1")
    put_bn("stem_bn1", "conv1.4")
    put_bn("stem_bn2", "bn1")

    for i, depth in enumerate(layers, start=1):
        for b in range(depth):
            blk = f"layer{i}_block{b}"
            for c in (1, 2, 3):
                put_conv(f"{blk}.conv{c}", f"layer{i}.{b}.conv{c}")
                put_bn(f"{blk}.bn{c}", f"layer{i}.{b}.bn{c}")
        put_conv(f"layer{i}_block0.downsample_conv",
                 f"layer{i}.0.downsample.0")
        put_bn(f"layer{i}_block0.downsample_bn", f"layer{i}.0.downsample.1")

    if strict and missing:
        raise KeyError(
            f"{len(missing)} expected gluoncv parameters not found, e.g. "
            f"{missing[:5]} — inspect the file with tools/inspect_checkpoint.py "
            "and adjust the name map")
    return _nest(params), _nest(batch_stats)


def _nest(flat: Dict) -> Dict:
    """'layer1_block0.conv1' dotted keys -> nested dicts."""
    out: Dict = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def load_backbone_state_dict(path: str, layers: Sequence[int] = (3, 4, 6, 3),
                             strict: bool = True) -> Dict:
    """A gluoncv backbone file (either naming scheme) -> the ``state_dict``
    of `models/resnet.py::ResNetV1s` with ``layers``."""
    from .mx_params import load_mx_ndarray_file

    return deeplab_state_dict(*convert_resnet_v1s_params(
        load_mx_ndarray_file(path), layers=layers, strict=strict))

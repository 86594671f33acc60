"""Reference (mxnet) DeepLabV3+ checkpoint -> the port's ``state_dict``.

``convert_deeplabv3plus_params`` is a copy of
``gan_segmentation_tpu/core/deeplab_convert.py`` (importing that module
pulls in jax through its package) and produces the JAX package's
``(params, batch_stats)`` trees; ``tests/test_torch_deeplab_convert.py``
pins the copy to the original.  ``load_deeplab_state_dict`` reads a file of
either kind the JAX package's trainer reads: a reference mxnet file through
the converter, or the msgpack ``{"params", "batch_stats"}`` the JAX package
itself saves; both through ``core/params_bridge.py::deeplab_state_dict``.

The reference saves trained runs with ``net.save_parameters``
(`lib/utils/utils.py:5-16`, called per epoch at
`lib/core/segmentation.py:153`). In mxnet 1.5 ``save_parameters`` stores
names from ``Block._collect_params_with_prefix`` — dotted ATTRIBUTE paths
(child blocks keyed by attribute name, sequential children by index), NOT
the gluon name_scope parameter names. The attribute tree of the reference
``DeepLabV3Plus`` (`deeplabv3plus.py:143-226` + ``SegBaseModel``
`:72-140` + gluoncv ``resnetv1b``):

  backbone (flattened onto the model):
    conv1.{0,3,6}.weight                   deep-stem convs
    conv1.{1,4}.{gamma,beta,running_*}     stem BNs 0,1
    bn1.*                                  stem BN 2 (separate attribute)
    layer{1..4}.{b}.conv{1,2,3}.weight, .bn{1,2,3}.*
    layer{i}.0.downsample.{0.weight, 1.*}
  skip_project.skip_project.{0.weight, 1.*}          (`:228-240`)
  aspp.concurent.{0..3}.{0.weight, 1.*}              (`:300-335`)
  aspp.concurent.4.gap.{1.weight, 2.*}               (_AsppPooling)
  aspp.project.{0.weight, 1.*}
  head.block.{0,1}.{depthwise_conv.weight, bn1.*,    (`:243-260`,
                    pointwise_conv.weight, bn2.*}     SeparableConv
  head.block.2.{weight, bias}                         `:338-369`)
  auxlayer.block.{0.weight, 1.*, 4.weight, 4.bias}   (gluoncv _FCNHead)

VALIDATION CAVEAT: like the other converters, exercised against synthetic
files fabricated from this same table (no real mxnet run is mounted);
``strict=True`` pinpoints misses on first real contact —
`tools/inspect_checkpoint.py` lists a file's actual names.
"""

from typing import Dict, Sequence, Tuple

import numpy as np

from .params_bridge import deeplab_state_dict

_BN_MAP = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def _conv_w(arr):  # OIHW -> HWIO (depthwise (C,1,kh,kw) -> (kh,kw,1,C))
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))


def _node(tree: Dict, dotted: str) -> Dict:
    node = tree
    for p in dotted.split("."):
        node = node.setdefault(p, {})
    return node


def convert_deeplabv3plus_params(mx: Dict[str, np.ndarray],
                                 layers: Sequence[int] = (3, 4, 6, 3),
                                 aux: bool = True,
                                 strict: bool = True) -> Tuple[Dict, Dict]:
    """-> the JAX package's (params, batch_stats) of ``DeepLabV3Plus``."""
    params: Dict = {}
    batch_stats: Dict = {}
    missing = []

    def take(name):
        if name in mx:
            return mx[name]
        missing.append(name)
        return None

    def put_conv(our, src, bias=False):
        w = take(f"{src}.weight")
        node = _node(params, our)
        if w is not None:
            node["kernel"] = _conv_w(w)
        if bias:
            b = take(f"{src}.bias")
            if b is not None:
                node["bias"] = np.asarray(b, np.float32)

    def put_bn(our, src):
        for suffix, (kind, field) in _BN_MAP.items():
            arr = take(f"{src}.{suffix}")
            if arr is None:
                continue
            tree = params if kind == "params" else batch_stats
            _node(tree, our)[field] = np.asarray(arr, np.float32)

    # ---- backbone (deep stem + bottleneck stages) -> our "backbone" subtree
    for k, idx in enumerate((0, 3, 6)):
        put_conv(f"backbone.stem_conv{k}", f"conv1.{idx}")
    put_bn("backbone.stem_bn0", "conv1.1")
    put_bn("backbone.stem_bn1", "conv1.4")
    put_bn("backbone.stem_bn2", "bn1")
    for i, depth in enumerate(layers, start=1):
        for b in range(depth):
            ours = f"backbone.layer{i}_block{b}"
            src = f"layer{i}.{b}"
            for c in (1, 2, 3):
                put_conv(f"{ours}.conv{c}", f"{src}.conv{c}")
                put_bn(f"{ours}.bn{c}", f"{src}.bn{c}")
        put_conv(f"backbone.layer{i}_block0.downsample_conv",
                 f"layer{i}.0.downsample.0")
        put_bn(f"backbone.layer{i}_block0.downsample_bn",
               f"layer{i}.0.downsample.1")

    # ---- decoder skip projection
    put_conv("skip_project.conv", "skip_project.skip_project.0")
    put_bn("skip_project.bn", "skip_project.skip_project.1")

    # ---- ASPP: 1x1 + three atrous branches + pooling branch + projection
    for bi in range(4):
        put_conv(f"aspp.b{bi}_conv", f"aspp.concurent.{bi}.0")
        put_bn(f"aspp.b{bi}_bn", f"aspp.concurent.{bi}.1")
    put_conv("aspp.pool_conv", "aspp.concurent.4.gap.1")
    put_bn("aspp.pool_bn", "aspp.concurent.4.gap.2")
    put_conv("aspp.project_conv", "aspp.project.0")
    put_bn("aspp.project_bn", "aspp.project.1")

    # ---- head: two separable convs + 1x1 classifier
    for s in range(2):
        put_conv(f"head_sep{s}.depthwise", f"head.block.{s}.depthwise_conv")
        put_bn(f"head_sep{s}.depthwise_bn", f"head.block.{s}.bn1")
        put_conv(f"head_sep{s}.pointwise", f"head.block.{s}.pointwise_conv")
        put_bn(f"head_sep{s}.pointwise_bn", f"head.block.{s}.bn2")
    put_conv("head_classifier", "head.block.2", bias=True)

    # ---- aux FCN head on c3
    if aux:
        put_conv("auxlayer.conv0", "auxlayer.block.0")
        put_bn("auxlayer.bn0", "auxlayer.block.1")
        put_conv("auxlayer.conv1", "auxlayer.block.4", bias=True)

    if strict and missing:
        raise KeyError(
            f"{len(missing)} expected reference DeepLabV3+ parameters not "
            f"found, e.g. {missing[:5]} — inspect the file with "
            "tools/inspect_checkpoint.py and adjust the name map")
    return params, batch_stats


def is_deeplab_reference_file(names) -> bool:
    """Heuristic: a reference-trained DeepLabV3+ save_parameters file."""
    names = set(names)
    return any(n.startswith("aspp.concurent.") for n in names) and \
        any(n.startswith("head.block.") for n in names)


def load_deeplab_state_dict(path: str, layers: Sequence[int] = (3, 4, 6, 3),
                            aux: bool = True, strict: bool = True) -> Dict:
    """A DeepLab checkpoint file -> the ``state_dict`` of
    `models/deeplab.py`'s model.  An mxnet NDArray file must be a reference
    DeepLabV3+ ``save_parameters`` file (else ``ValueError``) and goes
    through the converter; anything else is read as the JAX package's
    msgpack checkpoint.  Load the result with ``load_state_dict``'s default
    ``strict=True``: a missing or misshapen entry raises there."""
    from .checkpoint import load_checkpoint
    from .mx_params import is_mx_params_file

    tree = load_checkpoint(path)
    if is_mx_params_file(path):
        if not is_deeplab_reference_file(tree):
            raise ValueError(
                f"{path} is an mxnet NDArray file but not a reference "
                "DeepLabV3+ checkpoint; convert it explicitly")
        params, batch_stats = convert_deeplabv3plus_params(
            tree, layers=layers, aux=aux, strict=strict)
    else:
        if not (isinstance(tree, dict) and "params" in tree):
            raise ValueError(f"{path} holds no 'params' tree: not a "
                             "checkpoint of the DeepLab trainer")
        params, batch_stats = tree["params"], tree.get("batch_stats", {})
    return deeplab_state_dict(params, batch_stats)

"""Reference (mxnet) Decoder checkpoint -> the port's decoder ``state_dict``.

``convert_decoder_params`` is a copy of
``gan_segmentation_tpu/core/decoder_convert.py`` (importing that module
pulls in jax through its package) and produces the JAX package's
``(params, batch_stats)`` trees; ``tests/test_torch_convert.py`` pins the
copy to the original.  ``load_decoder_state_dict`` passes the trees through
``core/params_bridge.py::decoder_state_dict``.

Two naming schemes are handled, dispatched on ``any('.' in name)`` exactly
like mxnet's own ``Block.load_parameters``:

1. **Attribute-path (dotted) names** — what ``net.save_parameters``
   actually writes in mxnet 1.5 (``_collect_params_with_prefix``), i.e.
   the format of every checkpoint the reference itself produces
   (`seg_solver.py:331-337`). See ``_convert_decoder_params_dotted``.

2. **Legacy creation-order parameter names**: `networks_seg.py` creates
   every layer *outside* ``name_scope()``, so gluon assigns process-global
   names ``conv0_weight, batchnorm0_gamma, ...`` — the scheme used by
   ``collect_params().save()``-style files. Creation order
   (`networks_seg.py:64-94`):

  1. cvt blocks, i = start_res..n-1:  Conv2D, [BatchNorm], LeakyReLU,
     [Dropout]                        -> conv{k}, batchnorm{k}
  2. main blocks, i = start_res..n-2: UpSample (no params) +
     DecoderResBlock(conv, [bn], lrelu, conv, [bn], lrelu, [1x1 shortcut])
     (`networks_seg.py:7-46`; shortcut exists iff in_c != conv_size, i.e.
     for every i > start_res since in_c doubles after the concat)
  3. final main block, i = n-1: Conv2D -> num_classes

VALIDATION CAVEAT: like `backbone_convert`, validated against synthetic
files named by the same algorithm (no reference checkpoint is mounted
here); ``strict=True`` pinpoints misses on first real contact.
"""

from typing import Dict, Tuple

import numpy as np

from .params_bridge import decoder_state_dict

_BN_MAP = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def _conv_w(arr):  # OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))


def convert_decoder_params(mx: Dict[str, np.ndarray], cfg,
                           strict: bool = True) -> Tuple[Dict, Dict]:
    """``cfg``: a `core.config.SolverConfig`. -> (params, batch_stats).

    Dispatches on the file's naming scheme exactly like mxnet's own
    ``Block.load_parameters``: names containing '.' are attribute-path
    names written by ``save_parameters`` — the format the reference's
    ``SegSolver.save`` actually produces (`seg_solver.py:331-337`) —
    otherwise the legacy creation-order parameter names are assumed.
    """
    if any("." in k for k in mx):
        return _convert_decoder_params_dotted(mx, cfg, strict)
    params: Dict = {}
    batch_stats: Dict = {}
    missing = []
    conv_idx = 0
    bn_idx = 0

    def take(name):
        if name in mx:
            return mx[name]
        missing.append(name)
        return None

    def put_conv(path, with_bias=True):
        nonlocal conv_idx
        w = take(f"conv{conv_idx}_weight")
        node = _node(params, path)
        if w is not None:
            node["kernel"] = _conv_w(w)
        if with_bias:
            b = take(f"conv{conv_idx}_bias")
            if b is not None:
                node["bias"] = np.asarray(b, np.float32)
        conv_idx += 1

    def put_bn(path):
        nonlocal bn_idx
        for suffix, (kind, field) in _BN_MAP.items():
            arr = take(f"batchnorm{bn_idx}_{suffix}")
            if arr is None:
                continue
            tree = params if kind == "params" else batch_stats
            _node(tree, path)[field] = np.asarray(arr, np.float32)
        bn_idx += 1

    n = len(cfg.in_channels)
    for i in range(cfg.start_res, n):
        put_conv((f"cvt_{i}_conv",))
        if cfg.use_bn:
            put_bn((f"cvt_{i}_bn",))
    for i in range(cfg.start_res, n - 1):
        blk = f"main_{i}"
        put_conv((blk, "conv_0"))
        if cfg.use_bn:
            put_bn((blk, "bn_0"))
        put_conv((blk, "conv_1"))
        if cfg.use_bn:
            put_bn((blk, "bn_1"))
        in_c = cfg.features[i] if i == cfg.start_res else 2 * cfg.features[i]
        if cfg.features[i + 1] != in_c:
            put_conv((blk, "shortcut"))
    put_conv((f"main_{n - 1}_conv",))

    if strict and missing:
        raise KeyError(
            f"{len(missing)} expected decoder parameters not found, e.g. "
            f"{missing[:5]} — inspect with tools/inspect_checkpoint.py")
    return params, batch_stats


def _node(tree: Dict, path) -> Dict:
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    return node


def _convert_decoder_params_dotted(mx: Dict[str, np.ndarray], cfg,
                                   strict: bool = True) -> Tuple[Dict, Dict]:
    """Attribute-path names from ``save_parameters`` (mxnet 1.5
    ``_collect_params_with_prefix``): sequential children keyed by index,
    blocks by attribute name (`networks_seg.py:49-94`):

      cvt_block_{i}.0.{weight,bias}, cvt_block_{i}.1.{gamma,...}   [if bn]
      main_block_{i}.1.base_layers.{0,3}.{weight,bias}   (0=UpSample)
      main_block_{i}.1.base_layers.{1,4}.{gamma,...}                [if bn]
      main_block_{i}.1.shortcut.0.{weight,bias}   (iff in_c != conv_size)
      main_block_{n-1}.0.{weight,bias}            (final plain conv)
    """
    params: Dict = {}
    batch_stats: Dict = {}
    missing = []

    def take(name):
        if name in mx:
            return mx[name]
        missing.append(name)
        return None

    def put_conv(path, src):
        w = take(f"{src}.weight")
        node = _node(params, path)
        if w is not None:
            node["kernel"] = _conv_w(w)
        b = take(f"{src}.bias")
        if b is not None:
            node["bias"] = np.asarray(b, np.float32)

    def put_bn(path, src):
        for suffix, (kind, field) in _BN_MAP.items():
            arr = take(f"{src}.{suffix}")
            if arr is None:
                continue
            tree = params if kind == "params" else batch_stats
            _node(tree, path)[field] = np.asarray(arr, np.float32)

    n = len(cfg.in_channels)
    for i in range(cfg.start_res, n):
        put_conv((f"cvt_{i}_conv",), f"cvt_block_{i}.0")
        if cfg.use_bn:
            put_bn((f"cvt_{i}_bn",), f"cvt_block_{i}.1")
    # base_layers indices shift when bn is off: conv,bn,lrelu,conv,bn,lrelu
    # vs conv,lrelu,conv,lrelu
    c0, b0, c1, b1 = (0, 1, 3, 4) if cfg.use_bn else (0, None, 2, None)
    for i in range(cfg.start_res, n - 1):
        blk = f"main_{i}"
        src = f"main_block_{i}.1.base_layers"
        put_conv((blk, "conv_0"), f"{src}.{c0}")
        if cfg.use_bn:
            put_bn((blk, "bn_0"), f"{src}.{b0}")
        put_conv((blk, "conv_1"), f"{src}.{c1}")
        if cfg.use_bn:
            put_bn((blk, "bn_1"), f"{src}.{b1}")
        in_c = cfg.features[i] if i == cfg.start_res else 2 * cfg.features[i]
        if cfg.features[i + 1] != in_c:
            put_conv((blk, "shortcut"), f"main_block_{i}.1.shortcut.0")
    put_conv((f"main_{n - 1}_conv",), f"main_block_{n - 1}.0")

    if strict and missing:
        raise KeyError(
            f"{len(missing)} expected decoder parameters not found, e.g. "
            f"{missing[:5]} — inspect with tools/inspect_checkpoint.py")
    return params, batch_stats


def load_decoder_state_dict(mx: Dict[str, np.ndarray], cfg,
                            strict: bool = True) -> Dict:
    """An mxnet decoder checkpoint's arrays (either naming scheme) -> the
    ``state_dict`` of ``models/decoder.py`` for ``cfg``."""
    return decoder_state_dict(*convert_decoder_params(mx, cfg, strict))

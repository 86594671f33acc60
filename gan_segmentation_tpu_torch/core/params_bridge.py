"""JAX-package parameter trees -> the port's ``state_dict``s.

Input is the JAX package's tree as nested mappings of numpy arrays
(``jax.device_get(params)``, and the decoder's ``batch_stats``); nothing of
jax is imported.  The map is layout only: both packages keep the wscale
multipliers at run time (`gan_segmentation_tpu/models/layers.py:79-90,
119-127,182-186`), so no value is rescaled.

- conv HWIO -> OIHW;
- transposed conv: the JAX package stores the flipped, conv-equivalent
  kernel (`gan_segmentation_tpu/ops/conv.py:286-290`), so PyTorch's
  ``F.conv_transpose2d`` weight is ``torch_w[ci,co,ky,kx] =
  jax_w[k-1-ky, k-1-kx, ci, co]``;
- dense (in, out) -> (out, in);
- the JAX package's BatchNorm ``scale``/``bias`` and batch stats
  ``mean``/``var`` -> ``weight``/``bias``/``running_mean``/``running_var``
  (``tree_state_dict``, for the decoder and the DeepLab models, whose
  submodules carry the JAX package's names; ``state_dict_trees`` is its inverse);
- int8 state: the JAX generator's ``quant`` collection
  (``generator_quant_invs``) and the JAX decoder's ``prepare_s2d_int8``
  tree (``decoder_int8_state``) -> the port's ``ops/quant.py`` states, so
  both packages can serve the same quantized model.
"""

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def conv_weight(hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(hwio, np.float32).transpose(3, 2, 0, 1)))


def deconv_weight(hwio_flipped) -> torch.Tensor:
    w = np.asarray(hwio_flipped, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 0, 1)))


def dense_weight(in_out) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(in_out, np.float32).T))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def generator_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``StyleGanGenerator`` params -> ``models.stylegan`` state_dict.
    Module paths map one to one (``block_3/adain_1/affine/weight`` ->
    ``block_3.adain_1.affine.weight``)."""
    out = {}
    for key, v in _flatten(params).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and v.ndim == 4:
            out[key] = (deconv_weight(v) if ".deconv_" in f".{key}"
                        else conv_weight(v))
        elif leaf == "weight" and v.ndim == 2:
            out[key] = dense_weight(v)
        else:
            out[key] = torch.from_numpy(np.array(v, np.float32))
    return out


_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def tree_state_dict(params: Mapping,
                    batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A conv / batch-norm model's JAX trees -> the ``state_dict`` of the
    port's module with the same submodule names.  Conv ``kernel`` (HWIO,
    grouped and depthwise too: ``(kh, kw, Cin/groups, Cout)`` ->
    ``(Cout, Cin/groups, kh, kw)``) and BatchNorm ``scale`` both become
    ``weight``; ``bias`` keeps its name; the batch statistics ``mean`` /
    ``var`` become ``running_mean`` / ``running_var``, and every batch norm
    gets its ``num_batches_tracked``."""
    out = {}
    for key, v in _flatten(params).items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "kernel":
            out[f"{module}.weight"] = conv_weight(v)
        elif leaf == "scale":
            out[f"{module}.weight"] = torch.from_numpy(np.array(v, np.float32))
        else:
            out[key] = torch.from_numpy(np.array(v, np.float32))
    for key, v in _flatten(batch_stats).items():
        module, leaf = key.rsplit(".", 1)
        out[f"{module}.{_STAT_LEAVES[leaf]}"] = torch.from_numpy(
            np.array(v, np.float32))
        out[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return out


def decoder_state_dict(params: Mapping,
                       batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Decoder`` params + batch_stats -> ``models.decoder``
    state_dict."""
    return tree_state_dict(params, batch_stats)


def deeplab_state_dict(params: Mapping,
                       batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DeepLabV3Plus`` / ``DeepLabV3`` / ``ResNetV1s`` /
    ``ResNextDilated`` params + batch_stats -> the state_dict of the
    port's model of the same name (`models/deeplab.py`, `resnet.py`,
    `resnext.py`)."""
    return tree_state_dict(params, batch_stats)


def _put(tree: Dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def state_dict_trees(state: Mapping) -> Tuple[Dict, Dict]:
    """The inverse of ``tree_state_dict``: a ``state_dict`` of conv and
    batch-norm modules -> numpy ``(params, batch_stats)`` trees.  A 4-d
    ``weight`` is a conv kernel (-> HWIO ``kernel``), a 1-d ``weight`` a
    batch norm's ``scale``."""
    params, batch_stats = {}, {}
    for key, t in state.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        v = t.detach().float().cpu().numpy()
        if leaf == "weight" and v.ndim == 4:
            _put(params, f"{module}.kernel",
                 np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
        elif leaf == "weight":
            _put(params, f"{module}.scale", v)
        elif leaf in ("running_mean", "running_var"):
            _put(batch_stats, f"{module}.{leaf[len('running_'):]}", v)
        else:
            _put(params, key, v)
    return params, batch_stats


def generator_quant_invs(quant: Mapping) -> Dict[str, float]:
    """The JAX generator's ``quant`` collection (``{"block_3": {"conv_1":
    {"inv_in": ...}}, ...}``) -> ``{"block_3.conv_1": inv_in}``, the scales
    ``ops/quant.py::generator_int8_state`` takes (the weights quantize from
    the port's own parameters, as the JAX package's do at trace time)."""
    return {k.rsplit(".", 1)[0]: float(np.float32(v))
            for k, v in _flatten(quant).items()}


# Fine-kernel row ky -> (block row dy, input parity a') of the s2d 3x3
# kernel, for output parity 0 (``gan_segmentation_tpu/ops/s2d_decoder.py::
# _ROW_S2D[0]``): its entries there are the fine kernel's, each once.
_ROW_S2D0 = ((0, 0, 1), (1, 1, 0), (2, 1, 1))


def _fine_from_s2d3x3(k):
    """(3, 3, 4 Ci, 4 Co) s2d kernel (``conv3x3_kernel_s2d``) -> the fine
    (3, 3, Ci, Co) kernel it re-places."""
    ci, co = k.shape[2] // 4, k.shape[3] // 4
    out = np.zeros((3, 3, ci, co), k.dtype)
    for ky, dy, ap in _ROW_S2D0:
        for kx, dx, bp in _ROW_S2D0:
            out[ky, kx] = k[dy, dx, ap * 2 + bp::4, 0::4]
    return out


def decoder_int8_state(qtree: Mapping, dec, n_block_stages: int = 3):
    """The JAX decoder's ``prepare_s2d_int8`` tree (numpy) -> the port's
    ``QuantState`` for ``Decoder.forward_int8`` on ``dec``'s sites, on the
    CPU.  Every kernel but a block stage's conv_0 holds the fine kernel's
    integers in an s2d arrangement, and the fine ones are taken back (output
    parity 0's channels, ``0::4``, of the per-channel vectors); a block
    stage's conv_0 stays the (3, 3, Ci, 4 Co) kernel in its ``c * 4 +
    parity`` order, with its per-(channel, parity) scales."""
    from ..ops.quant import (QConv, QuantState, _layout1x1, _layout3x3,
                             _plan, check_shortcut_scales)
    stages = qtree["stages"]
    last = len(dec.in_channels) - 1
    _, sres, first_block = _plan(last + 1, dec.start_res, n_block_stages)

    def site(st, kkey, bkey, w, sl=slice(None)):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        w = t(np.asarray(w, np.int8))
        return QConv(_layout1x1(w) if w.shape[0] == 1 else _layout3x3(w),
                     t(np.asarray(st[kkey + "_deq"], np.float32)[sl]),
                     t(np.asarray(st[bkey], np.float32)[sl]),
                     torch.tensor([float(np.float32(st[kkey + "_inv"]))]))

    out = {}
    for i in range(sres, last + 1):
        st = {k: np.asarray(v) for k, v in stages[str(i)].items()}
        block = i >= first_block
        p0 = slice(0, None, 4)
        if i == last:  # cvt_k: strided_parity_kernel, parity 0 at (0, 0)
            out[f"cvt_{i}"] = site(st, "cvt_k", "cvt_b",
                                   st["cvt_k"][0:3, 0:3, :, 0::4], p0)
            out[f"main_{i}_conv"] = site(st, "kf", "bf",
                                         _fine_from_s2d3x3(st["kf"]), p0)
            continue
        out[f"cvt_{i}"] = site(st, "cvt_k", "cvt_b", st["cvt_k"])
        out[f"main_{i}.conv_0"] = site(st, "k0", "b0", st["k0"])
        if block:
            out[f"main_{i}.conv_1"] = site(st, "k1", "b1",
                                           _fine_from_s2d3x3(st["k1"]), p0)
        else:
            out[f"main_{i}.conv_1"] = site(st, "k1", "b1", st["k1"])
        if "ksc" in st:
            ksc = st["ksc"][..., 0::4] if block else st["ksc"]
            out[f"main_{i}.shortcut"] = site(st, "ksc", "bsc", ksc,
                                             p0 if block else slice(None))
    check_shortcut_scales({k: v.inv for k, v in out.items()})
    return QuantState(out, first_block)

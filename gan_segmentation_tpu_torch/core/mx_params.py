"""mxnet ``.params`` checkpoint reader and StyleGAN name/layout converter.

The reader (``load_mx_ndarray_file``, ``is_mx_params_file``) and
``convert_stylegan_params`` are a copy of
``gan_segmentation_tpu/core/mx_params.py`` (importing that module pulls in
jax through its package); ``tests/test_torch_convert.py`` pins the copy to
the original on the same files.  ``load_generator_params`` differs: it
returns the port's ``state_dict``, not the JAX package's tree.

The reference ships generator weights as mxnet NDArray-list files
(``stylegan-{ffhq,cars,bedrooms}.params``, loaded at `image_generator.py:21-22`)
and saves decoder checkpoints the same way (`seg_solver.py:331-337`).
This module parses that binary format in pure numpy (no mxnet dependency):

File layout (mxnet ``NDArray::Save`` / ``mx.nd.save``):
  uint64  kMXAPINDArrayListMagic = 0x112
  uint64  reserved = 0
  uint64  ndarray count
  per array:
    uint32  magic: 0xF993fac9 (V2) / 0xF993faca (V3); legacy files start
            directly with the shape (no magic)
    int32   storage type (V2/V3 only; 0 == dense — the only kind we accept)
    TShape  uint32 ndim + dims (int64 in modern files, uint32 in legacy —
            auto-detected by validating the context/type fields that follow)
    int32   dev_type, int32 dev_id  (context)
    int32   type_flag  (0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64)
  uint64  name count, then per name: uint64 length + bytes ('arg:'/'aux:'
          prefixes stripped like gluon ``load_parameters``)

The StyleGAN converter then re-lays-out each tensor into the JAX package's
tree (OIHW conv -> HWIO, deconv flip+transpose, NCHW broadcasts ->
channel-last) using the reference's parameter naming scheme
(`networks_stylegan.py` block prefixes), and ``core/params_bridge.py`` maps
that tree onto the port's modules: one statement of each layout rule.
"""

import struct
from typing import Dict, Tuple

import numpy as np

from .params_bridge import generator_state_dict

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA

_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n: int) -> bytes:
        if n < 0:
            raise ValueError(f"negative read ({n}): corrupt file")
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError(f"truncated file: wanted {n} bytes at offset "
                             f"{self.pos}, have {len(out)}")
        self.pos += n
        return out

    def peek(self, fmt: str, offset: int = 0):
        return struct.unpack_from("<" + fmt, self.buf, self.pos + offset)[0]


def _valid_tail(r: _Reader, offset: int) -> bool:
    """Is (dev_type, dev_id, type_flag) plausible at ``offset`` ahead?"""
    try:
        dev_type = struct.unpack_from("<i", r.buf, r.pos + offset)[0]
        dev_id = struct.unpack_from("<i", r.buf, r.pos + offset + 4)[0]
        type_flag = struct.unpack_from("<i", r.buf, r.pos + offset + 8)[0]
    except struct.error:
        return False
    return 1 <= dev_type <= 16 and 0 <= dev_id <= 512 and 0 <= type_flag <= 12


def _read_shape(r: _Reader) -> Tuple[int, ...]:
    ndim = r.read("I")
    if ndim > 32:
        raise ValueError(f"implausible ndim {ndim}: corrupt file")
    # disambiguate int64 vs uint32 dims by validating what follows
    if _valid_tail(r, 8 * ndim):
        dims = r.read("q" * ndim) if ndim else ()
    elif _valid_tail(r, 4 * ndim):
        dims = r.read("I" * ndim) if ndim else ()
    else:
        raise ValueError("cannot determine TShape dim width")
    if ndim == 1:
        dims = (dims,)
    dims = tuple(int(d) for d in dims)
    if any(d < 0 for d in dims):
        raise ValueError(f"negative dim in shape {dims}: corrupt file")
    return dims


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.peek("I")
    if magic in (_V2_MAGIC, _V3_MAGIC):
        r.read("I")
        stype = r.read("i")
        if stype != 0:
            raise ValueError("only dense storage supported "
                             f"(got stype={stype}; row_sparse/csr arrays "
                             "are not checkpoint weights)")
    elif magic == _V1_MAGIC:
        r.read("I")
    shape = _read_shape(r)
    _dev_type = r.read("i")
    _dev_id = r.read("i")
    type_flag = r.read("i")
    if type_flag not in _DTYPES:
        raise ValueError(f"unsupported mxnet type_flag {type_flag} "
                         f"(known: {sorted(_DTYPES)})")
    dtype = _DTYPES[type_flag]
    count = int(np.prod(shape)) if shape else 1
    data = np.frombuffer(r.read_bytes(count * np.dtype(dtype).itemsize),
                         dtype=dtype)
    return data.reshape(shape).copy()


def load_mx_ndarray_file(path: str) -> Dict[str, np.ndarray]:
    """Parse an mxnet ``mx.nd.save`` / ``save_parameters`` file."""
    with open(path, "rb") as fp:
        r = _Reader(fp.read())
    try:
        # header reads sit INSIDE the guard too: a write torn right after
        # the 8-byte magic must surface as the same ValueError contract
        magic = r.read("Q")
        if magic != _LIST_MAGIC:
            raise ValueError(f"not an mxnet NDArray file (magic {magic:#x})")
        reserved = r.read("Q")
        if reserved != 0:
            raise ValueError(f"bad reserved field {reserved:#x}: corrupt file")
        count = r.read("Q")
        arrays = [_read_ndarray(r) for _ in range(count)]
        name_count = r.read("Q")
        names = []
        for _ in range(name_count):
            ln = r.read("Q")
            names.append(r.read_bytes(ln).decode("utf-8"))
    except struct.error as exc:  # ran off the end mid-record
        raise ValueError(f"truncated mxnet file {path!r}: {exc}") from None
    if len(names) != len(arrays):
        raise ValueError(f"{len(names)} names for {len(arrays)} arrays: "
                         "corrupt file")
    out = {}
    for name, arr in zip(names, arrays):
        if name.startswith(("arg:", "aux:")):
            name = name[4:]
        out[name] = arr
    return out


def is_mx_params_file(path: str) -> bool:
    try:
        with open(path, "rb") as fp:
            head = fp.read(8)
        return len(head) == 8 and struct.unpack("<Q", head)[0] == _LIST_MAGIC
    except OSError:
        return False


# --------------------------------------------------------------------------
# StyleGAN generator name/layout conversion
# --------------------------------------------------------------------------

def _conv_w(arr):   # OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))


def _deconv_w(arr):  # mxnet deconv (I, O, kh, kw) -> flipped HW, (kh,kw,I,O)
    return np.ascontiguousarray(
        np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def _squeeze_c(arr):  # (1, C, 1, 1) -> (C,)
    return np.ascontiguousarray(arr.reshape(-1))


def convert_stylegan_params(mx: Dict[str, np.ndarray], cfg) -> Dict:
    """mxnet reference checkpoint -> the JAX package's generator tree
    (nested dicts of numpy arrays).

    Unknown/auxiliary entries ('std' wscale constants, InstanceNorm
    gamma/beta) are skipped, mirroring ``load_parameters(ignore_extra=True)``
    (`image_generator.py:22`).
    """
    params: Dict = {}

    def put(path, value):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value, np.float32)

    put(("constant_tensor",), np.transpose(mx["constant_tensor"], (0, 2, 3, 1)))
    put(("latent_avg",), mx["latent_avg"])
    put(("truncation_psi",), mx["truncation_psi"])

    for i in range(8):
        put(("mapping", f"dense_{i}", "weight"),
            mx[f"mp_dense_{i}_weight"].T)
        put(("mapping", f"dense_{i}", "bias"), mx[f"mp_dense_{i}_bias"])

    for res in range(2, cfg.max_res_log2 + 1):
        scale = 2 ** res
        blk = f"block_{res}"
        if res >= 3:
            if res >= 7:
                put((blk, "deconv_1", "weight"),
                    _deconv_w(mx[f"{scale}_deconv_1_weight"]))
            else:
                put((blk, "conv_1", "weight"),
                    _conv_w(mx[f"{scale}_conv_1_weight"]))
        put((blk, "conv_2", "weight"), _conv_w(mx[f"{scale}_conv_2_weight"]))
        for j in (1, 2):
            put((blk, f"noise_{j}", "scale_factors"),
                _squeeze_c(mx[f"{scale}_noise_{j}_scale_factors"]))
            put((blk, f"bias_{j}", "bias"),
                _squeeze_c(mx[f"{scale}_bias_{j}_bias"]))
            put((blk, f"adain_{j}", "affine", "weight"),
                mx[f"{scale}_adain_{j}_dense_affine_weight"].T)
            put((blk, f"adain_{j}", "affine", "bias"),
                mx[f"{scale}_adain_{j}_dense_affine_bias"])

    top = 2 ** cfg.max_res_log2
    put((f"to_rgb_{cfg.max_res_log2}", "weight"),
        _conv_w(mx[f"{top}_conv_to_rgb_weight"]))
    put((f"to_rgb_{cfg.max_res_log2}", "bias"), mx[f"{top}_conv_to_rgb_bias"])
    return params


def load_generator_params(path: str, cfg) -> Dict:
    """Generator weights from an mxnet ``.params`` file or one of the JAX
    package's msgpack pytree checkpoints -> the port's generator
    ``state_dict`` (``models/stylegan.py``)."""
    if is_mx_params_file(path):
        tree = convert_stylegan_params(load_mx_ndarray_file(path), cfg)
    else:
        from .checkpoint import load_msgpack  # imports this module
        tree = load_msgpack(path)
        if not isinstance(tree, dict):
            raise ValueError(f"{path!r} holds no parameter tree: not a "
                             "generator checkpoint")
    return generator_state_dict(tree)

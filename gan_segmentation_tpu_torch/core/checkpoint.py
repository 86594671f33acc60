"""Reading foreign checkpoints: the JAX package's msgpack ``*.params`` and
mxnet's binary ``*.params`` (counterpart of
``gan_segmentation_tpu/core/checkpoint.py``, read side only: the port
writes its own ``*.pt``).

The JAX package saves a tree of numpy arrays with its serialization
library's ``msgpack_serialize``: ``SegSolver.save`` writes ``{"params",
"batch_stats"}`` (`gan_segmentation_tpu/train/solver.py:625-639`), a
generator checkpoint is the bare parameter tree.  That library and the
``msgpack`` package are not requirements of the port, so the decoder for
the subset of msgpack those files use is written out here:

- nil, booleans, integers, floats, str, bin, arrays, maps;
- ext type 1, an ndarray: its payload is itself msgpack, the array
  ``[shape, dtype name, row-major bytes]``;
- ext type 3, a numpy scalar (the same payload, of shape ``()``);
- ext type 2, a native complex ``[real, imag]``.

Any other ext type raises, and so does the chunked form the library uses
for arrays over 2**30 bytes (a map holding ``__msgpack_chunked_array__``):
no checkpoint of this project comes near that size.  A truncated or
malformed file raises ``ValueError``.
"""

import struct
from os.path import isdir
from typing import Any

import numpy as np

from .mx_params import is_mx_params_file, load_mx_ndarray_file

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED_KEY = "__msgpack_chunked_array__"

# first byte -> struct format of a fixed-size scalar
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# first byte -> struct format of the length that follows
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Unpacker:
    """One pass over a msgpack buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError(f"truncated msgpack data: wanted {n} bytes at "
                             f"offset {self.pos}, have {len(out)}")
        self.pos += n
        return out

    def _num(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def unpack(self) -> Any:
        b = self._num(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self._num(_SCALARS[b])
        if b in _BIN:
            return bytes(self._take(self._num(_BIN[b])))
        if b in _STR:
            return self._str(self._num(_STR[b]))
        if b in _ARRAY:
            return self._array(self._num(_ARRAY[b]))
        if b in _MAP:
            return self._map(self._num(_MAP[b]))
        if b in _EXT:
            n = self._num(_EXT[b])
            return self._ext(self._num(">b"), n)
        if b in _FIXEXT:
            return self._ext(self._num(">b"), _FIXEXT[b])
        raise ValueError(f"invalid msgpack type byte {b:#x} at offset "
                         f"{self.pos - 1}")

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        if _CHUNKED_KEY in out:
            raise ValueError(
                "the checkpoint stores an array over 2**30 bytes in chunks "
                f"({_CHUNKED_KEY}); the port does not read that form")
        return out

    def _ext(self, code: int, n: int) -> Any:
        data = bytes(self._take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code} ({n} bytes): not "
                         "a checkpoint of the JAX package")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    payload = unpackb(data)
    if not (isinstance(payload, list) and len(payload) == 3):
        raise ValueError("malformed ndarray payload in msgpack checkpoint")
    shape, dtype_name, buffer = payload
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"array dtype {dtype_name!r} has no numpy "
                         "counterpart; save the checkpoint in float32"
                         ) from None
    if int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != len(buffer):
        raise ValueError(f"ndarray payload of shape {tuple(shape)} {dtype} "
                         f"holds {len(buffer)} bytes")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    u = _Unpacker(data)
    out = u.unpack()
    if u.pos != len(data):
        raise ValueError(f"{len(data) - u.pos} trailing bytes after the "
                         "msgpack object")
    return out


def load_msgpack(path: str) -> Any:
    """A msgpack checkpoint of the JAX package -> nested dicts of numpy
    arrays."""
    with open(path, "rb") as fp:
        data = fp.read()
    try:
        return unpackb(data)
    except ValueError as exc:
        raise ValueError(f"{path!r}: {exc}") from None


def load_checkpoint(path: str) -> Any:
    """Auto-detect: mxnet binary (-> {name: array}) or msgpack file
    (-> tree).  A directory is an orbax checkpoint, which the port does not
    read."""
    if isdir(path):
        raise NotImplementedError(
            f"{path!r} is a directory (an orbax checkpoint); the PyTorch "
            "port reads single-file *.pt, msgpack and mxnet checkpoints")
    if is_mx_params_file(path):
        return load_mx_ndarray_file(path)
    return load_msgpack(path)

"""Native host-side image IO (C++, built on demand, loaded via ctypes).

The port's own copy of ``gan_segmentation_tpu/native/__init__.py``: the port
imports nothing of the JAX package.  ``imgio.cc`` is that package's source,
byte for byte, and the Python side keeps its public names and behaviour;
``tests/test_torch_native.py`` pins both to the original.

- encode: a threaded JPEG/PNG pair writer (``PairWriter``) that encodes off
  the Python thread, GIL-free, with the device's bit-packed binary-mask
  format unpacked inside the encoder (``apps/main.py --writer native``);
- decode: a pair reader (``read_pair``) that fuses a scale factor into the
  JPEG decode itself (libjpeg DCT-domain scaling, denom in {1,2,4,8}),
  emits RGB directly and releases the GIL.

The library is compiled with ``g++`` at first use into
``gan_segmentation_tpu_torch/_build/`` under a name keyed by the source's
hash.  If the toolchain or libjpeg / libpng are missing,
:func:`load_library` returns ``None`` and ``generate --writer auto`` takes
the cv2 loop (``apps/main.py::run_generate``).
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from os.path import dirname, isfile, join

import numpy as np

log = logging.getLogger(__name__)

_SRC = join(dirname(__file__), "imgio.cc")
_BUILD_DIR = join(dirname(dirname(os.path.abspath(__file__))), "_build")
_LIB = None
_LIB_TRIED = False


def _source_tag() -> str:
    with open(_SRC, "rb") as fh:
        return hashlib.sha1(fh.read()).hexdigest()[:12]


def build_library(verbose: bool = False) -> str:
    """Compile ``imgio.cc`` into a cached shared library; returns its path.

    The cache key is the source hash, so edits rebuild automatically and
    stale builds are never loaded.  Raises on compiler failure.
    """
    out = join(_BUILD_DIR, f"libgsio-{_source_tag()}.so")
    if isfile(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # atomic: build to a temp name, rename into place (safe under races)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", _SRC,
           "-o", tmp, "-ljpeg", "-lpng", "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, out)
    except BaseException:
        if isfile(tmp):
            os.unlink(tmp)
        raise
    return out


def load_library():
    """Return the ctypes CDLL, building it if needed; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(build_library())
    except (OSError, subprocess.CalledProcessError, FileNotFoundError) as exc:
        log.info("native imgio unavailable (%s); using cv2 fallback", exc)
        return None
    lib.gsio_abi_version.restype = ctypes.c_int
    if lib.gsio_abi_version() != 2:  # pragma: no cover
        log.warning("native imgio ABI mismatch; using cv2 fallback")
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gsio_writer_create.restype = ctypes.c_void_p
    lib.gsio_writer_create.argtypes = [ctypes.c_int] * 3
    lib.gsio_writer_submit.restype = ctypes.c_int
    lib.gsio_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        u8p, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.gsio_writer_finish.restype = ctypes.c_int
    lib.gsio_writer_finish.argtypes = [ctypes.c_void_p]
    lib.gsio_write_jpeg.restype = ctypes.c_int
    lib.gsio_write_jpeg.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.gsio_write_png_gray.restype = ctypes.c_int
    lib.gsio_write_png_gray.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    lib.gsio_read_pair.restype = ctypes.c_void_p
    lib.gsio_read_pair.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.gsio_record_dims.restype = ctypes.c_int
    lib.gsio_record_dims.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.gsio_record_copy.restype = ctypes.c_int
    lib.gsio_record_copy.argtypes = [ctypes.c_void_p, u8p, u8p]
    lib.gsio_record_free.restype = None
    lib.gsio_record_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return load_library() is not None


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_u8c(arr, name: str) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"{name} must be uint8, got {arr.dtype}")
    return arr


class PairWriter:
    """Asynchronous (image.jpg, mask.png) pair writer.

    ``submit`` copies the buffers into the native queue and returns; a pool
    of C++ threads encodes and writes GIL-free.  The queue is bounded, so
    submission applies backpressure instead of growing host memory.  Use as
    a context manager; ``finish()``/``__exit__`` block until all files hit
    disk and raise if any write failed.

    JPEG input is RGB HxWx3 (encoded directly — no BGR flip copy as the cv2
    path needs); masks are HxW uint8 class ids, or bit-packed H x W/8 bytes
    (MSB first, ``np.unpackbits`` order) with ``mask_packed=True`` and
    ``mask_width`` giving the width in pixels.
    """

    def __init__(self, threads: int = 0, queue_cap: int = 0,
                 jpeg_quality: int = 95):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native imgio library unavailable")
        if threads <= 0:
            threads = max(1, (os.cpu_count() or 1) - 1)
        if queue_cap <= 0:
            queue_cap = 2 * threads + 2
        self._lib = lib
        self._handle = lib.gsio_writer_create(threads, queue_cap, jpeg_quality)
        if not self._handle:
            raise RuntimeError("gsio_writer_create failed")
        self.submitted = 0

    def submit(self, img_path=None, mask_path=None, img=None, mask=None,
               mask_packed: bool = False, mask_width: int = 0):
        if self._handle is None:
            raise RuntimeError("writer already finished")
        ip = mp = None
        iptr = mptr = None
        ih = iw = mh = mw = 0
        if img_path is not None:
            img = _as_u8c(img, "img")
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"img must be HxWx3, got {img.shape}")
            ih, iw = img.shape[:2]
            iptr, ip = _u8ptr(img), os.fsencode(img_path)
        if mask_path is not None:
            mask = _as_u8c(mask, "mask")
            if mask.ndim != 2:
                raise ValueError(f"mask must be 2-D, got {mask.shape}")
            mh = mask.shape[0]
            mw = mask_width if mask_packed else mask.shape[1]
            if mask_packed and mask.shape[1] * 8 != mw:
                raise ValueError("packed mask width mismatch: "
                                 f"{mask.shape[1]}*8 != {mw}")
            mptr, mp = _u8ptr(mask), os.fsencode(mask_path)
        rc = self._lib.gsio_writer_submit(self._handle, ip, mp, iptr, ih, iw,
                                          mptr, mh, mw, int(mask_packed))
        if rc != 0:
            raise RuntimeError(f"gsio_writer_submit failed (rc={rc})")
        self.submitted += 1

    def finish(self):
        if self._handle is None:
            return
        errors = self._lib.gsio_writer_finish(self._handle)
        self._handle = None
        if errors:
            raise RuntimeError(f"{errors} native write(s) failed")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.finish()
        elif self._handle is not None:  # drain, but don't mask the error
            try:
                self._lib.gsio_writer_finish(self._handle)
            finally:
                self._handle = None
        return False


def read_pair(img_path=None, mask_path=None, scale_denom: int = 1):
    """Decode an (image.jpg, mask.png) pair via the native reader.

    Returns ``(img, mask)`` — img as RGB HxWx3 uint8 (or None when
    ``img_path`` is None), mask as HxW uint8 (or None).  ``scale_denom`` in
    {1, 2, 4, 8} fuses downscaling into the JPEG decode itself (libjpeg
    DCT-domain scaling) and nearest-subsamples the mask on the same
    src = dst*d grid as ``cv2.INTER_NEAREST``.  At denom 1 the image decode
    is bit-identical to ``cv2.imread`` (both ride libjpeg).

    Raises ``RuntimeError`` on decode failure.  The underlying call releases
    the GIL, so a thread pool of readers scales across host cores.
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native imgio library unavailable")
    rec = lib.gsio_read_pair(
        os.fsencode(img_path) if img_path else None,
        os.fsencode(mask_path) if mask_path else None, int(scale_denom))
    if not rec:
        raise RuntimeError(
            f"native decode failed: {img_path!r} / {mask_path!r}")
    try:
        dims = (ctypes.c_int * 4)()
        if lib.gsio_record_dims(rec, dims):
            raise RuntimeError("gsio_record_dims failed")
        ih, iw, mh, mw = dims[0], dims[1], dims[2], dims[3]
        img = np.empty((ih, iw, 3), np.uint8) if img_path else None
        mask = np.empty((mh, mw), np.uint8) if mask_path else None
        rc = lib.gsio_record_copy(
            rec, _u8ptr(img) if img is not None else None,
            _u8ptr(mask) if mask is not None else None)
        if rc:
            raise RuntimeError("gsio_record_copy failed")
    finally:
        lib.gsio_record_free(rec)
    return img, mask


def write_jpeg(path, img, quality: int = 95):
    """Synchronous RGB JPEG write via the native encoder."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native imgio library unavailable")
    img = _as_u8c(img, "img")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"img must be HxWx3, got {img.shape}")
    rc = lib.gsio_write_jpeg(os.fsencode(path), _u8ptr(img), img.shape[0],
                             img.shape[1], quality)
    if rc != 0:
        raise RuntimeError(f"gsio_write_jpeg failed (rc={rc})")


def write_png_gray(path, mask, packed: bool = False, width: int = 0):
    """Synchronous 8-bit grayscale PNG write via the native encoder."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native imgio library unavailable")
    mask = _as_u8c(mask, "mask")
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got {mask.shape}")
    w = width if packed else mask.shape[1]
    if packed and mask.shape[1] * 8 != w:
        raise ValueError("packed mask width mismatch")
    rc = lib.gsio_write_png_gray(os.fsencode(path), _u8ptr(mask),
                                 mask.shape[0], w, int(packed))
    if rc != 0:
        raise RuntimeError(f"gsio_write_png_gray failed (rc={rc})")

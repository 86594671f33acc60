"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ``ctypes``.  Pointers travel as
``c_void_p`` and the stream is PyTorch's current stream.  The library is
built at first use, never at import, into ``gan_segmentation_tpu_torch/_build/``
under a name keyed by a hash of the sources, so an edit rebuilds and a stale
build is never loaded.  A failed build raises.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from os.path import dirname, isfile, join

import torch

_PKG = dirname(dirname(os.path.abspath(__file__)))
CSRC = join(_PKG, "csrc")
BUILD_DIR = join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIB = None


def _sources():
    return sorted(glob.glob(join(CSRC, "*.cu")) + glob.glob(join(CSRC, "*.cuh")))


def _source_tag() -> str:
    h = hashlib.sha1()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and isfile(join(cand, "bin", "nvcc")):
            return join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return found


def build_library() -> str:
    """Compile the kernels (once per source hash); returns the .so path.
    ptxas's register and shared-memory report lands beside it."""
    out = join(BUILD_DIR, f"libgst_kernels-{_source_tag()}.so")
    if isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    srcs = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (rc=%d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
        with open(out + ".ptxas.txt", "w") as fh:
            fh.write(proc.stderr)
        os.replace(tmp, out)
    finally:
        if isfile(tmp):
            os.unlink(tmp)
    return out


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check(t, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape, dtype and
    device: the kernels index raw pointers and take nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC / HWIO)")


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def library():
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_library())
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gst_conv3x3_num_tiles.restype = i
    lib.gst_conv3x3_num_tiles.argtypes = [i, i]
    lib.gst_conv3x3_in_stats.restype = i
    lib.gst_conv3x3_in_stats.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                         i, i, i, i, i, i, f, vp]
    lib.gst_conv3x3_small.restype = i
    lib.gst_conv3x3_small.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, f,
                                      vp]
    _LIB = lib
    return lib

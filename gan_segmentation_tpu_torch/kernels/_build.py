"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into ONE shared library with a plain
C interface, loaded with ``ctypes``.  Pointers travel as
``c_void_p`` and the stream is PyTorch's current stream.  The library is
built at first use, never at import, into ``gan_segmentation_tpu_torch/_build/``
under a name keyed by a hash of the sources, so an edit rebuilds and a stale
build is never loaded.  A failed build raises.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from os.path import dirname, isfile, join

import torch

from . import tc_plan

_PKG = dirname(dirname(os.path.abspath(__file__)))
CSRC = join(_PKG, "csrc")
BUILD_DIR = join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

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
    One ``nvcc -c`` per source runs in parallel, then one link.  ptxas's
    register and shared-memory report lands beside the library."""
    out = join(BUILD_DIR, f"libgst_kernels-{_source_tag()}.so")
    if isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    srcs = [p for p in _sources() if p.endswith(".cu")]
    try:
        nvcc = _nvcc()
        jobs = []
        for src in srcs:
            obj = join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-c", src,
                   "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report, failed = [], []
        for cmd, _obj, proc in jobs:
            _, err = proc.communicate()
            report.append(err)
            if proc.returncode != 0:
                failed.append("nvcc failed (rc=%d):\n%s\n%s" % (
                    proc.returncode, " ".join(cmd), err[-8000:]))
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = join(work, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *(obj for _cmd, obj, _proc in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (rc=%d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
        with open(out + ".ptxas.txt", "w") as fh:
            fh.write("".join(report))
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def check_conv3x3(x, w, b):
    """Validate the arguments of a 3x3 conv kernel (x NHWC f32/bf16, w HWIO
    in x's dtype, b (Cout,) f32 or None, one device, contiguous); returns
    (n, h, w, cin, cout)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, wd, cin = x.shape
    if w.dim() != 4:
        raise ValueError(f"w must be HWIO, got shape {tuple(w.shape)}")
    cout = w.shape[3]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    dev = x.device
    check(x, "x", (n, h, wd, cin), x.dtype, dev)
    check(w, "w", (3, 3, cin, cout), x.dtype, dev)
    if b is not None:
        check(b, "b", (cout,), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, h, wd, cin, cout


def check_conv3x3_s8(x, w, deq, b):
    """Validate the arguments of an s8 3x3 conv (x NHWC s8, w s8 (3, 3,
    Cout, Cin), i.e. [tap][Cout][Cin], deq and b (Cout,) f32, b may be
    None, one device, contiguous); returns (n, h, w, cin, cout)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be NHWC and w (3, 3, Cout, Cin), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[2]
    dev = x.device
    check(x, "x", (n, h, wd, cin), torch.int8, dev)
    check(w, "w", (3, 3, cout, cin), torch.int8, dev)
    check(deq, "deq", (cout,), torch.float32, dev)
    if b is not None:
        check(b, "b", (cout,), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, h, wd, cin, cout


@functools.lru_cache(maxsize=None)
def _tc_plan_c(dtype, n, h, w, cin, cout, noise, aligned=True, rows=False):
    if dtype == torch.float32:
        # the full-image f32 calls of kernels 1 and 2 by the f32 rule; the
        # row bands keep the mma.sync 3xTF32 body
        p = (tc_plan.plan_f32(n, h, w, cin, cout, stats=noise) if rows else
             tc_plan.plan_f32_body(n, h, w, cin, cout, aligned, noise=noise))
    elif dtype == torch.int8:
        p = tc_plan.plan_s8(n, h, w, cin, cout, noise, aligned)
    else:
        p = tc_plan.plan_bf16(n, h, w, cin, cout, noise, aligned)
    args = p.args()
    return p, (ctypes.c_int * len(args))(*args)


def tc_launch_args(x, n, h, w, cin, cout, noise=False, tensors=(),
                   rows=False):
    """For a call of kernel 1 (``noise``) or 2 (``rows``: a row band):
    (plan, plan as a C int array, split-K workspace or None).  bf16 takes
    ``tc_plan.plan_bf16`` and s8 ``tc_plan.plan_s8``: the Hopper body's
    ``PlanSM90`` (int[11], conv3x3_sm90.cuh; ``plan.sm90`` names its entry
    points ``gst_*_sm90``) where TMA's rules let it, given whether x and
    ``tensors`` start on 16 bytes, else the mma.sync body's ``Plan``
    (int[9], conv3x3_tc.cuh); f32 kernels 1 and 2
    ``tc_plan.plan_f32_body`` (the Hopper body's 3xTF32 form, ``PlanSM90``
    with ``tf32``, entries ``gst_conv3x3_in_stats_f32_sm90`` by
    ``plan_tf32_in_stats`` and ``gst_conv3x3_small_f32_sm90`` by
    ``plan_tf32``; else ``plan_f32``, int[11], conv3x3_tf32.cuh), the row
    bands ``tc_plan.plan_f32``.  The plan is cached per shape: the host's
    time per launch is what bounds the small layers.  The workspace holds
    a streamed tf32 plan's K-major tap layout, then the split-K partials
    (``plan.ws_elems``; s32 in the s8 bodies)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    p, plan_c = _tc_plan_c(x.dtype, n, h, w, cin, cout, noise, aligned,
                           rows)
    ws = None
    if p.ws_elems(n, h, w, cout):
        ws = torch.empty(p.ws_elems(n, h, w, cout),
                         dtype=torch.int32 if x.dtype == torch.int8
                         else torch.float32, device=x.device)
    return p, plan_c, ws


def entry_name(name, plan):
    """The C entry of ``name`` (``gst_conv3x3_in_stats``, ...) on the body
    ``plan`` names: the mma.sync bodies' ``name``, the Hopper body's
    ``name_sm90``, its f32 form's ``name_f32_sm90`` (kernels 1 and 2:
    entries 9 and 8); all take the same arguments."""
    if not plan.sm90:
        return name
    return name + ("_f32_sm90" if plan.tf32 else "_sm90")


@functools.lru_cache(maxsize=None)
def tf32_plan_c(n, h, w, cin, cout):
    """For an f32 call of kernel 3 on the mma.sync body: its 3xTF32 plan
    (no split) as a C int[11], cached per shape (the host's time per launch
    bounds the small layers)."""
    args = tc_plan.plan_f32(n, h, w, cin, cout, splits=1).args()
    return (ctypes.c_int * len(args))(*args)


@functools.lru_cache(maxsize=None)
def _bil_plan_c(n, h, w, cin, cout, aligned):
    p = tc_plan.plan_f32_body(n, h, w, cin, cout, aligned, kernel3=True)
    return p, (tf32_plan_c(n, h, w, cin, cout) if not p.sm90 else
               (ctypes.c_int * 11)(*p.args()))


def bil_launch_args(x, n, h, w, cin, cout, tensors=()):
    """For an f32 call of kernel 3: (plan, plan as a C int[11], split-K
    workspace or None) by ``tc_plan.plan_f32_body(kernel3=True)``: the
    Hopper body's 3xTF32 form (entry ``gst_conv3x3_bil_sm90``) where
    ``plan_tf32`` takes the shape, given whether x and ``tensors`` start on
    16 bytes, else the mma.sync body without a split (``tf32_plan_c``,
    entry ``gst_conv3x3_bil``); cached per shape."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    p, plan_c = _bil_plan_c(n, h, w, cin, cout, aligned)
    ws = None
    if p.splits > 1:
        ws = torch.empty(p.ws_elems(n, h, w, cout), dtype=torch.float32,
                         device=x.device)
    return p, plan_c, ws


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
    lib.gst_conv3x3_in_stats.restype = i
    lib.gst_conv3x3_in_stats.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                         i, i, i, i, i, i, f, vp, vp]
    lib.gst_conv3x3_small.restype = i
    lib.gst_conv3x3_small.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                                      f, vp, vp]
    lib.gst_conv3x3_in_stats_rows.restype = i
    lib.gst_conv3x3_in_stats_rows.argtypes = \
        lib.gst_conv3x3_in_stats.argtypes
    lib.gst_conv3x3_small_rows.restype = i
    lib.gst_conv3x3_small_rows.argtypes = lib.gst_conv3x3_small.argtypes
    # the Hopper body's entries take the same arguments (its f32 forms of
    # kernels 1 and 2 too)
    for name in ("gst_conv3x3_in_stats", "gst_conv3x3_in_stats_rows",
                 "gst_conv3x3_small", "gst_conv3x3_small_rows",
                 "gst_conv3x3_small_f32", "gst_conv3x3_in_stats_f32"):
        fn = getattr(lib, name + "_sm90")
        fn.restype = i
        fn.argtypes = getattr(lib, name.replace("_f32", "")).argtypes
    lib.gst_conv3x3_in_stats_s8.restype = i
    lib.gst_conv3x3_in_stats_s8.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                            vp, i, i, i, i, i, i, f, vp, vp]
    lib.gst_conv3x3_small_s8.restype = i
    lib.gst_conv3x3_small_s8.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i,
                                         i, i, i, f, vp, vp]
    for name in ("gst_conv3x3_in_stats_s8", "gst_conv3x3_small_s8"):
        fn = getattr(lib, name + "_sm90")
        fn.restype = i
        fn.argtypes = getattr(lib, name).argtypes
    lib.gst_quantize_s8.restype = i
    lib.gst_quantize_s8.argtypes = [vp, vp, vp, ctypes.c_longlong, i, vp]
    lib.gst_conv3x3_bil.restype = i
    lib.gst_conv3x3_bil.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, f,
                                    vp, vp]
    # kernel 3 on the Hopper body: kernel 2's arguments (a workspace)
    lib.gst_conv3x3_bil_sm90.restype = i
    lib.gst_conv3x3_bil_sm90.argtypes = lib.gst_conv3x3_small.argtypes
    _LIB = lib
    return lib

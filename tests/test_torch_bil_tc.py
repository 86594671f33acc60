"""Kernel 3's f32 body on the tensor cores (``csrc/conv3x3_tf32.cuh``;
kernels 1 and 2 run it too: ``tests/test_torch_f32_tc.py``), checked where a CPU can check it: its launch plan (``tc_plan.plan_f32``)
at every call of a train step and at the contract's edges, the index maps
and shared-memory layout that plan feeds, and the 3xTF32 numerics,
emulated bit for bit on the operands.  The kernel itself runs on the card
(``tests/test_torch_kernels.py::test_cuda_bil_matches_plain`` and
``chip_smoke.py``)."""

import ctypes
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.kernels import _build, tc_plan
from gan_segmentation_tpu_torch.kernels.bil_conv import EDGE_SHAPES, fits


def _train_step_calls():
    """(n, h, w, cin, cout) of kernel 3's 38 calls in a train step at ffhq
    1024^2, batch 1 (chip_smoke.py::bil_shapes, counted from the decoder):
    the forward convs inside the contract, and the input gradients (Cin and
    Cout swapped) of every conv after the cvt_i."""
    scfg = SolverConfig(max_res_log2=10)
    f, cin = scfg.features, scfg.in_channels
    last = len(cin) - 1
    convs = []
    for i in range(last + 1):
        r = 2 ** (i + 2)
        convs.append((r, cin[i], f[i], False))
        c_in = f[i] * (2 if i > 0 else 1)
        if i < last:
            convs += [(2 * r, c_in, f[i + 1], True),
                      (2 * r, f[i + 1], f[i + 1], True)]
        else:
            convs.append((r, c_in, f[i + 1], True))
    out = []
    for r, ci, co, dx in convs:
        if fits(1, ci, co):
            out.append((1, r, r, ci, co))
        if dx:
            out.append((1, r, r, co, ci))
    return out


TRAIN_CALLS = _train_step_calls()
EDGE_CALLS = list(EDGE_SHAPES)


def test_the_train_step_makes_38_calls():
    assert len(TRAIN_CALLS) == 38
    flop = sum(2 * 9 * ci * co * n * h * w for n, h, w, ci, co in TRAIN_CALLS)
    assert round(flop / 1e9, 1) == 102.7


def _walk(p, n, h, w):
    """Each output (image, row, column, Cout block, split) under the
    kernel's item and pixel maps: items run Cout block fastest, then spatial
    tile, then split, then image group; tile pixel q is (image, row, column)
    of g x th x tw."""
    hits = {}
    tiles = p.tiles_x * p.tiles_y
    for it in range(p.blocks):
        rest, cb = divmod(it, p.cout_blocks)
        z, tile = divmod(rest, tiles)
        grp, split = divmod(z, p.splits)
        ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
        for q in range(p.bm):
            gi, rem = divmod(q, p.th * p.tw)
            nn, oy, ox = grp * p.g + gi, ty0 + rem // p.tw, tx0 + rem % p.tw
            if nn < n and oy < h and ox < w:
                key = (nn, oy, ox, cb, split)
                hits[key] = hits.get(key, 0) + 1
    return hits


@pytest.mark.parametrize("shape", TRAIN_CALLS + EDGE_CALLS,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_f32_fits_and_covers_every_output_once(shape):
    n, h, w, cin, cout = shape
    p = tc_plan.plan_f32(n, h, w, cin, cout, splits=1)  # kernel 3: no split
    assert p.splits == 1 and p.cps == p.chunks and not p.stats, p
    assert p.smem_bytes <= tc_plan.MAX_SMEM, p
    assert p.bn % 8 == 0 and p.bn >= min(cout, 64) and p.bn <= 64, p
    assert p.tw * p.th * p.g == p.bm == 16 * p.mi * p.wm, p
    assert p.ck in (8, 16) and (p.chunks - 1) * p.ck < cin <= p.chunks * p.ck
    assert p.stages in (2, 3) and (p.stages == 2 or p.chunks > 2)
    assert not p.resident or p.cout_blocks == 1
    assert p.blocks < 2 ** 31
    assert len(p.args()) == 11 and p.mi in (2, 4)
    assert p.mi == 2 or (p.bn <= 16 and p.wm == 4)
    assert p.bn <= 16 or p.mi == 2
    if n * h * w <= 1 << 16:  # the index map, where it is cheap to walk
        hits = _walk(p, n, h, w)
        assert len(hits) == n * h * w * p.cout_blocks
        assert set(hits.values()) == {1}


def test_plan_f32_keeps_the_big_layers_resident_and_two_blocks_per_sm():
    """At 1024^2 (85% of the step's FLOP with 512^2) the taps stay resident
    and the shared memory leaves room for the blocks per SM that the launch
    bounds ask for."""
    for (n, h, w, cin, cout) in TRAIN_CALLS:
        if h < 1024:
            continue
        p = tc_plan.plan_f32(n, h, w, cin, cout, splits=1)
        assert p.bm == 256 and p.resident, p
        assert p.smem_bytes * p.min_blocks <= tc_plan.SM_SMEM - 1024 * (
            p.min_blocks), p


HEADER = Path(tc_plan.__file__).parents[1] / "csrc" / "conv3x3_tf32.cuh"
# the (BN, WM, MI) that conv3x3_tf32.cuh::run instantiates
TILES_F32 = [(8, 4, 2), (8, 4, 4), (16, 4, 2), (16, 4, 4), (32, 4, 2),
             (32, 8, 2), (64, 4, 2), (64, 8, 2)]


def _py(expr):
    """One C expression of the header as Python: ``a ? b : c`` (innermost
    parenthesised ones first, then one at the top), ``||``, ``&&``, integer
    ``/`` and the ``L.`` fields of the layout."""
    expr = " ".join(expr.split())
    expr = (expr.replace("||", " or ").replace("&&", " and ")
            .replace("/", "//").replace("L.", "L_"))
    inner = re.compile(r"\(([^()?:]+)\?([^():]+):([^()]+)\)")
    while inner.search(expr):
        expr = inner.sub(r"((\2) if (\1) else (\3))", expr)
    top = re.fullmatch(r"([^?:]+)\?([^:]+):(.+)", expr)
    return f"(({top[2]}) if ({top[1]}) else ({top[3]}))" if top else expr


def _header_rules(text):
    """pad_px, pad_n, layout's shared-memory bytes and Cfg::MIN_BLOCKS, as
    conv3x3_tf32.cuh states them."""
    def fn(name):
        m = re.search(rf"constexpr int {name}\(int (\w+)\) \{{\s*return "
                      rf"(.*?);", text, re.S)
        return eval(f"lambda {m[1]}: {_py(m[2])}")

    pads = {"pad_px": fn("pad_px"), "pad_n": fn("pad_n")}
    body = re.search(r"inline Layout layout\((.*?)\) \{(.*?)return L;", text,
                     re.S)
    params = re.findall(r"int (\w+)", body[1])
    fields = re.findall(r"L\.(\w+) = (.*?);", body[2], re.S)

    def smem(**kw):
        env = dict(pads, **kw)
        for name, expr in fields:
            env["L_" + name] = eval(_py(expr), env)
        return env["L_smem"]

    blocks = _py(re.search(r"MIN_BLOCKS =\s*(.*?);", text, re.S)[1])
    return (pads["pad_px"], pads["pad_n"], params, smem,
            lambda bn, wm, mi: eval(blocks, dict(BN=bn, WM=wm, MI=mi)))


@pytest.mark.parametrize("tile", TILES_F32, ids=lambda t: "bn%d_wm%d_mi%d" % t)
def test_plan_f32_mirrors_the_header(tile):
    """The planner's blocks per SM, padding and shared-memory bytes are the
    header's launch bounds and layout, at every plan the path and the edges
    make with this tile and at each ring and residency it may pick."""
    pad_px, pad_n, params, smem, min_blocks = _header_rules(
        HEADER.read_text())
    assert params == ["bn", "ck", "g", "th", "tw", "stages", "resident",
                      "chunks", "wm", "mi", "stats"]
    bn, wm, mi = tile
    for ck in (8, 16):
        assert tc_plan.pad_px(ck) == pad_px(ck)
    assert tc_plan.pad_n(bn) == pad_n(bn)
    plans = [p for p in (tc_plan.plan_f32(*s, stats=stats)
                         for s in TRAIN_CALLS + EDGE_CALLS
                         for stats in (False, True))
             if (p.bn, p.wm, p.mi) == tile]
    bm = 16 * mi * wm
    for ck, tw, stages, resident, chunks, stats in itertools.product(
            (8, 16), (4, 8, 16), (2, 3), (False, True), (1, 4),
            (False, True)):
        # one image per tile, or four images of 16 pixels (a warp spans
        # images: one statistics slot per m16 fragment)
        for th, g in ((bm // tw, 1), (16 // tw, bm // 16)):
            plans.append(tc_plan.PlanF32(
                bn=bn, wm=wm, ck=ck, tw=tw, th=th, g=g, stages=stages,
                resident=resident, chunks=chunks, tiles_x=1, tiles_y=1,
                groups=1, cout_blocks=1, mi=mi, stats=stats))
    for p in plans:
        assert p.min_blocks == min_blocks(bn, wm, mi), p
        assert p.smem_bytes == smem(
            bn=p.bn, ck=p.ck, g=p.g, th=p.th, tw=p.tw, stages=p.stages,
            resident=int(p.resident), chunks=p.chunks, wm=p.wm, mi=p.mi,
            stats=int(p.stats)), p


def test_wrapper_passes_the_plan_as_int9():
    """The plan travels as a C int array: int[11] since the split-K fields
    joined it (conv3x3_tf32.cuh::run reads plan[0..10]), kernel 3's with
    one split."""
    read = {int(i) for i in re.findall(r"plan\[(\d+)\]", HEADER.read_text())}
    assert read == set(range(11))
    for shape in TRAIN_CALLS[:4] + EDGE_CALLS[:3]:
        c = _build.tf32_plan_c(*shape)
        assert isinstance(c, ctypes.Array) and len(c) == 11
        assert tuple(c) == tc_plan.plan_f32(*shape, splits=1).args()
        assert tuple(c)[9:] == (1, tc_plan.plan_f32(*shape).chunks)
    assert _build.tf32_plan_c(*TRAIN_CALLS[0]) is _build.tf32_plan_c(
        *TRAIN_CALLS[0])


def _a_rows(p, lane, warp, i):
    """Halo pixel (image, row, column) of this lane's ldmatrix row in m16
    fragment i at tap (0, 0), and its channel offset (conv3x3_tf32.cuh)."""
    r = lane % 8 + 8 * ((lane // 8) % 2)
    q = warp * 16 * p.mi + i * 16 + r
    gi, rem = divmod(q, p.th * p.tw)
    return gi, rem // p.tw, rem % p.tw, 4 * (lane // 16)


@pytest.mark.parametrize("shape", TRAIN_CALLS[-12:] + EDGE_CALLS[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_shared_memory_reads_stay_inside_and_hit_distinct_banks(shape):
    """Every ldmatrix row and B load reads inside its stage's halo or taps;
    the 8 rows of each ldmatrix matrix fall in 8 different 16-byte bank
    groups at every tap where they are 8 pixels of one tile row, and the 32
    lanes' B loads in 32 different banks."""
    p = tc_plan.plan_f32(*shape, splits=1)
    ps, bnp = tc_plan.pad_px(p.ck), tc_plan.pad_n(p.bn)
    hp, wp = p.th + 2, p.tw + 2
    halo = p.g * hp * wp * ps
    for warp in range(p.wm):
        for i in range(p.mi):
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                for kk in range(p.ck // 8):
                    units = []
                    for lane in range(32):
                        gi, ty, tx, c = _a_rows(p, lane, warp, i)
                        off = (((gi * hp + ty + ky) * wp + tx + kx) * ps
                               + c + kk * 8)
                        assert off + 4 <= halo and c + kk * 8 + 4 <= p.ck
                        units.append(off // 4)
                    if p.tw >= 8:
                        for m in range(4):
                            rows = units[8 * m:8 * m + 8]
                            assert len({u % 8 for u in rows}) == 8, (tap, m)
    taps = 9 * p.ck * bnp
    for k0 in range(0, 9 * p.ck, 8):
        for jj in range(p.bn // 8):
            for row in (0, 4):
                words = [(k0 + lane % 4 + row) * bnp + jj * 8 + lane // 4
                         for lane in range(32)]
                assert max(words) < taps
                assert len({wd % 32 for wd in words}) == 32


# ---------------------------------------------------------------- numerics

def _tf32_trunc(v):
    """f32 -> tf32 as the kernel's split does it: clear the low 13 mantissa
    bits (conv3x3_tf32.cuh::split)."""
    bits = torch.from_numpy(np.ascontiguousarray(v, np.float32)).view(
        torch.int32)
    return (bits & -8192).view(torch.float32).numpy()


def _split(v):
    hi = _tf32_trunc(v)
    lo = _tf32_trunc((v - hi).astype(np.float32))  # v - hi is exact in f32
    return hi, lo


def _mma_sum(pairs, k):
    """sum over k of the products, one m16n8k8 step (8 of k) at a time: each
    step adds its terms, exact in f64 (11-bit by 11-bit operands), to the
    f32 accumulator with one rounding, in the kernel's order."""
    acc = np.zeros((pairs[0][0].shape[0], pairs[0][1].shape[1]), np.float32)
    for k0 in range(0, k, 8):
        for a, b in pairs:
            step = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(
                np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def test_split_gives_tf32_operands_within_2_to_minus_20():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-20, 20, 1 << 16))
         ).astype(np.float32)
    hi, lo = _split(v)
    for t in (hi, lo):
        assert not (t.view(np.int32) & 8191).any()  # valid tf32
    rel = np.abs(v.astype(np.float64) - hi - lo) / np.abs(v)
    assert rel.max() < 2.0 ** -20


def test_3xtf32_keeps_f32_tolerance_where_1xtf32_does_not():
    """At the path's worst K, 9 * 64 = 576, with x ~ N(0, 1) and
    w ~ N(0, 1) / sqrt(K) as chip_smoke.py draws them: the 3xTF32 sum
    (lo*hi + hi*lo, then hi*hi) stays within chip_smoke.py's f32 tolerance
    (atol 1e-4, rtol 1e-4) of the f64 sum at every output, as an f32 FMA
    chain does; one TF32 pass (hi*hi alone) misses it at most outputs."""
    k, m, n = 576, 16384, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    ref = x.astype(np.float64) @ w.astype(np.float64)
    tol = 1e-4 + 1e-4 * np.abs(ref)
    xh, xl = _split(x)
    wh, wl = _split(w)
    three = _mma_sum([(xl, wh), (xh, wl), (xh, wh)], k)
    one = _mma_sum([(xh, wh)], k)
    f32 = (x @ w).astype(np.float32)
    err3, err1 = np.abs(three - ref), np.abs(one - ref)
    assert (err3 <= tol).all(), err3.max()
    assert err3.max() < 1e-5
    assert err3.max() < 4 * np.abs(f32 - ref).max() + 1e-6
    assert (err1 > tol).mean() > 0.25, (err1 > tol).mean()
    assert err1.max() > 1e-3

"""The s8 form of the Hopper body of kernels 1 and 2 (entries 4 and 5 of
``csrc/conv3x3_sm90.cuh``: TMA boxes of s8 into the mbarrier ring, wgmma
m64nBNk32 into s32, the epilogue from registers), checked where a CPU can
check it: the rule that picks an s8 call's body (``tc_plan.plan_s8``) at
every int8 and int8-full shape and at the edges, TMA's and wgmma's rules
on its plans, and an emulation of the body on the operands (the halo box
and its byte swizzle, the ldmatrix rows of each tap, the K-major tap slice
through wgmma's descriptor, the exact s32 sums, split-K, the epilogue
rounded step by step, the statistics' order) held bit for bit to the exact
integer conv and the plain epilogue.  The kernel itself runs on the card
(``tests/test_torch_quant_pipeline.py::test_cuda_s8_bodies_are_exact``,
``chip_smoke.py``'s int8 phase)."""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from gan_segmentation_tpu_torch.core.config import SolverConfig, gan_config
from gan_segmentation_tpu_torch.kernels import tc_plan
from gan_segmentation_tpu_torch.kernels.conv_in_stats import (
    s8_in_stats_epilogue_plain)
from gan_segmentation_tpu_torch.kernels.small_conv import (conv3x3_s8_acc,
                                                           s8_epilogue_plain)
from gan_segmentation_tpu_torch.ops import quant as tq

GANS = ("ffhq", "cars", "bedrooms")


def int8_cases():
    """(gan, quant, kernel 1?, (n, h, w, cin, cout)) of every s8 3x3 call
    of a generate batch of 8 under int8 and int8-full."""
    out = set()
    for gan, quant in itertools.product(GANS, ("int8", "int8-full")):
        gcfg = gan_config(gan)
        got = tq.conv3x3_s8_shapes(
            gcfg, SolverConfig(max_res_log2=gcfg.max_res_log2), 8, quant)
        out |= {(gan, quant, k == "conv_in_stats_s8", s)
                for k, v in got.items() for s in v}
    return sorted(out)


INT8_CASES = int8_cases()

# the s8 edge cases chip_smoke.py runs on the card on both bodies
EDGES = sorted(chip_smoke.S8_EDGES)


def check_plan(p, n, h, w, cin, cout, noise):
    """The s8 plan's own rules, TMA's and wgmma's."""
    assert p.sm90 and p.s8 and p.eb == 1, p
    assert p.smem_bytes <= tc_plan.MAX_SMEM, p
    assert p.smem_bytes <= tc_plan.SM_SMEM // p.min_blocks - 1024 or \
        p.stages == 2, p
    # the byte-bound layers (Cin <= 64) run 32-channel tiles, two an SM
    assert p.bn in (16, 32, 64, 128), p
    assert p.bn >= min(cout, 32 if cin <= 64 else 128), p
    # a stage of 32 or 64 bytes a pixel: wgmma k32 steps of 32 bytes; or
    # Cin 16 in 16-byte pixels, a step over two taps, the pairs resident
    assert p.ck in (16, 32, 64), p
    assert p.pairs == (p.ck == 16) and (not p.pairs or (
        cin == 16 and p.resident and p.chunks == 1)), p
    # a tile conv3x3_sm90.cuh builds
    assert (p.bn, p.mi, p.ck) in tc_plan.S8_SM90_TILES[noise], p
    assert p.tw * p.th * p.g == p.bm == 128 * p.mi, p
    assert (p.th * p.tw) % 16 == 0  # a 16-row fragment lies in one image
    assert (p.splits - 1) * p.cps < p.chunks <= p.splits * p.cps, p
    assert p.chunks == -(-cin // p.ck)
    assert 2 <= p.stages <= tc_plan.SM90_MAX_STAGES
    assert p.blocks < 2 ** 31
    # TMA: boxes <= 256 a dimension; x's and w's inner rows of ck bytes,
    # the swizzle's span (32 B or 64 B; 16-byte pixels unswizzled); y's of
    # bna bf16
    boxes = p.boxes()
    assert boxes["w"] == (p.ck, p.bn, 9)
    elem = {"x": 1, "w": 1, "noise": 4, "y": 2}
    for name, box in boxes.items():
        if name == "w" and p.resident:  # no tensor map: the kernel's loads
            continue
        assert all(1 <= d <= tc_plan.TMA_BOX_MAX for d in box), (name, box)
        inner = box[0] * elem[name]
        assert inner % 16 == 0, (name, box)
        if name != "noise":
            assert inner in ((16,) if p.pairs and name == "x" else
                             (32, 64, 128)), (name, box)
    # global strides multiples of 16 bytes: x's and w's rows of Cin bytes;
    # y's where it leaves by TMA; the noise's where kernel 1 loads it
    assert cin % 16 == 0
    if p.tma_y:
        assert (cout * 2) % 16 == 0 and p.splits == 1
    if noise and p.splits == 1:
        assert (w * 4) % 16 == 0
    if p.resident:
        assert p.cout_blocks == 1 and p.splits == 1
        assert p.chunks * p.tap_bytes <= tc_plan.SM90_RESIDENT_MAX


@pytest.mark.parametrize("case", INT8_CASES,
                         ids=["-".join(map(str, (*c[:3], *c[3])))
                              for c in INT8_CASES])
def test_plan_s8_takes_every_int8_shape(case):
    """Every s8 call of int8 and int8-full at ffhq, cars and bedrooms runs
    the Hopper body, and its plan keeps every rule."""
    _, _, noise, (n, h, w, cin, cout) = case
    p = tc_plan.plan_s8(n, h, w, cin, cout, noise)
    check_plan(p, n, h, w, cin, cout, noise)


def test_plan_s8_takes_all_43_shapes_of_an_ffhq_batch():
    shapes = tq.conv3x3_s8_shapes(gan_config("ffhq"),
                                  SolverConfig(max_res_log2=10), 8)
    calls = [(s, k == "conv_in_stats_s8") for k, v in shapes.items()
             for s in v]
    assert len(calls) == 43
    assert all(tc_plan.plan_s8(*s, noise).sm90 for s, noise in calls)


@pytest.mark.parametrize("shape", EDGES,
                         ids=["-".join(map(str, s)) for s in EDGES])
@pytest.mark.parametrize("noise", [False, True])
def test_plan_s8_at_the_edges(shape, noise):
    """The edge shapes go to the body the rule names: the Hopper body where
    TMA's rules take them, else the mma.sync s8 body, for the reason
    ``tma_refuses`` gives; an unaligned view always keeps the mma.sync
    body."""
    n, h, w, cin, cout = shape
    p = tc_plan.plan_s8(n, h, w, cin, cout, noise)
    refused = tc_plan.tma_refuses(cin, w, noise, s8=True)
    assert p.sm90 == (refused is None), (shape, refused)
    if p.sm90:
        check_plan(p, n, h, w, cin, cout, noise)
    else:
        assert p.s8 and p.smem_bytes <= tc_plan.MAX_SMEM
    assert not tc_plan.plan_s8(n, h, w, cin, cout, noise,
                               aligned=False).sm90


def test_s8_refusals_name_their_rule():
    assert "16" in tc_plan.tma_refuses(40, 8, False, s8=True)
    assert tc_plan.tma_refuses(40, 8, False) is None  # bf16 takes Cin 40
    assert "W % 4" in tc_plan.tma_refuses(32, 6, True, s8=True)
    assert tc_plan.tma_refuses(32, 6, False, s8=True) is None
    # s8's taps are K-major: Cout % 8 does not matter (bf16 refuses Cout 20
    # past the resident taps' budget)
    assert tc_plan.plan_sm90(8, 64, 64, 512, 20, s8=True).sm90
    assert tc_plan.plan_sm90(8, 64, 64, 512, 20) is None


@pytest.mark.parametrize("noise", [False, True])
def test_plan_s8_returns_only_the_built_tiles(noise):
    """Over a grid of shapes the rule returns exactly the (bn, mi, ck) that
    conv3x3_sm90.cuh's s8_tile builds for entries 4 and 5
    (``tc_plan.S8_SM90_TILES``): none it lacks, none it builds in vain."""
    seen = set()
    for n, res, cin, cout in itertools.product(
            (1, 2, 8), (4, 8, 16, 32, 64, 128, 256, 512),
            (16, 32, 48, 64, 128, 256, 512), (2, 16, 24, 32, 64, 96, 128,
                                              256, 512, 2048)):
        p = tc_plan.plan_s8(n, res, res, cin, cout, noise)
        if p.sm90:
            seen.add((p.bn, p.mi, p.ck))
    assert seen == tc_plan.S8_SM90_TILES[noise]


# ------------------------------------------------- the body, emulated
# Shared memory as a flat byte array; TMA's swizzle and the kernel's index
# maps in numpy; the s8 products in int64 (exact, as the card's s32).

def swizzle(off, mask):
    """conv3x3_sm90.cuh's swizzle(): 16-byte chunk bits [4, 7) xor address
    bits [7, 10); TMA's 32 B / 64 B modes for mask 1 / 3 (vectorised)."""
    return off ^ (((off >> 7) & mask) << 4)


def row_mask(row_bytes):
    """The swizzle of rows of ``row_bytes`` (16-byte rows: none)."""
    return {128: 7, 64: 3, 32: 1, 16: 0}[row_bytes]


class Smem:
    def __init__(self, nbytes):
        self.b = np.full(nbytes, -999, np.int64)  # never written: poison

    def tma_box(self, base, t, start, box, row_bytes):
        """A TMA load of the s8 tensor ``t`` (dims outermost first;
        ``start`` and ``box`` innermost first) to ``base``: zero fill
        outside, dense rows of the inner dimension, each 16-byte unit
        placed under the swizzle of ``row_bytes``."""
        full = np.zeros(tuple(reversed(box)), np.int64)
        src, dst = [], []
        for d, (s, b) in enumerate(zip(reversed(start), reversed(box))):
            lo, hi = max(s, 0), min(s + b, t.shape[d])
            src.append(slice(lo, max(lo, hi)))
            dst.append(slice(lo - s, lo - s + max(0, hi - lo)))
        full[tuple(dst)] = t[tuple(src)]
        units = full.reshape(-1, 16)
        addr = base + swizzle(np.arange(len(units)) * 16,
                              row_mask(row_bytes))
        self.b[addr[:, None] + np.arange(16)] = units

    def read(self, addr):
        vals = self.b[addr]
        assert (vals != -999).all(), "read of a byte no load wrote"
        return vals


def emulate(x, w, noise, nscale, bias, deq, act, p):
    """The s8 Hopper body on the operands (x (N, H, W, Cin) and w (3, 3,
    Cout, Cin) s8 as int64): -> (the s32 sums (N, H, W, Cout), v in f32
    after the epilogue, kernel 1's partials (N, tiles, 2, Cout) or None)."""
    n, h, wd, cin = x.shape
    cout = w.shape[2]
    ck, bn, bm, mi = p.ck, p.bn, p.bm, p.mi
    xsw = row_mask(ck)   # the halo's rows: ck bytes
    krow = 32 if p.pairs else ck  # a tap row of B: ck bytes, or a pair's
    ksw = row_mask(krow)
    wt = w.reshape(9, cout, cin)
    hp, wp, per = p.th + 2, p.tw + 2, p.th * p.tw
    stats = noise is not None
    sums = np.zeros((p.splits, n, h, wd, cout), np.int64)
    v_out = np.full((n, h, wd, cout), np.nan, np.float32)
    partial = np.full((n, p.tiles, 2, cout), np.nan, np.float32) \
        if stats else None
    lanes = np.arange(32)
    lrow = lanes % 8 + 8 * ((lanes // 8) % 2)
    hits = np.zeros((n, h, wd, cout), int)
    tb = -(-p.halo_bytes // 1024) * 1024   # the stage's tap slice
    for item in range(p.blocks):
        rest, cb = divmod(item, p.cout_blocks)
        co0 = cb * bn
        z, tile = divmod(rest, p.tiles)
        ty, tx = divmod(tile, p.tiles_x)
        ty0, tx0 = ty * p.th, tx * p.tw
        split, n0 = z % p.splits, (z // p.splits) * p.g
        c0 = split * p.cps
        nc = min(p.chunks - c0, p.cps)
        acc = np.zeros((bm, bn), np.int64)
        for c in range(c0, c0 + nc):
            sm = Smem(tb + p.tap_bytes + 4096)
            sm.tma_box(0, x, (c * ck, tx0 - 1, ty0 - 1, n0),
                       (ck, wp, hp, p.g), ck)
            if p.pairs:  # the kernel's stores: [5][bn][32], tap 9 zero
                j, o, hf = (a.ravel() for a in np.meshgrid(
                    np.arange(5), np.arange(bn), np.arange(2),
                    indexing="ij"))
                pad = np.zeros((10, max(bn, cout), 16), np.int64)
                pad[:9, :cout] = wt
                off = (j * bn + o) * 32 + hf * 16
                sm.b[tb + swizzle(off, ksw)[:, None] + np.arange(16)] = \
                    pad[2 * j + hf, o]
            elif p.resident:  # the kernel's own 16-byte stores
                tap, o, u = (a.ravel() for a in np.meshgrid(
                    np.arange(9), np.arange(bn), np.arange(ck // 16),
                    indexing="ij"))
                cc = c * ck + u * 16
                pad = np.zeros((9, max(bn, cout), cin + 16), np.int64)
                pad[:, :cout, :cin] = wt
                vals = pad[tap[:, None], o[:, None],
                           np.minimum(cc, cin)[:, None] + np.arange(16)]
                off = (tap * bn + o) * ck + u * 16
                sm.b[tb + swizzle(off, xsw)[:, None] + np.arange(16)] = vals
            else:  # one box (ck, bn, 9): [9][bn][ck]
                sm.tma_box(tb, wt, (c * ck, co0, 0), (ck, bn, 9), ck)
            for wg, wq, i in itertools.product(range(2), range(4), range(mi)):
                m = (wg * mi + i) * 64 + wq * 16 + lrow
                gi, rem = np.divmod(m, per)
                ty_, tx_ = np.divmod(rem, p.tw)
                aoff = ((gi * hp + ty_) * wp + tx_) * ck + 16 * (lanes // 16)
                if p.pairs:  # lanes 16-31: the pair's second tap
                    aoff = aoff - 16 * (lanes // 16)
                rows = (wg * mi + i) * 64 + wq * 16 + np.arange(16)
                steps = itertools.product(range(5), (0,)) if p.pairs else \
                    itertools.product(range(9), range(ck // 32))
                for tap, kk in steps:
                    tl = np.full(32, tap)
                    if p.pairs:  # pair ``tap``: taps 2 tap and 2 tap + 1
                        tl = np.minimum(2 * tap + lanes // 16, 8)
                    toff = (tl // 3) * wp * ck + (tl % 3) * ck + kk * 32
                    # ldmatrix.x4: lane ln's 16-byte row is the fragment's
                    # row lrow[ln], k bytes 16 * (ln // 16) ...
                    a_frag = np.zeros((16, 32), np.int64)
                    addr = swizzle(aoff + toff, xsw)
                    a_frag[lrow[:, None], 16 * (lanes // 16)[:, None]
                           + np.arange(16)] = sm.read(addr[:, None]
                                                      + np.arange(16))
                    # B [32 x bn] through the K-major descriptor: start =
                    # the tap's (pair's) slice + 32 kk bytes, channel o's
                    # row at (o // 8) * SBO + (o % 8) * krow, SBO = 8 rows;
                    # the swizzle on the address
                    start = tb + tap * bn * krow + kk * 32
                    o = np.arange(bn)
                    k = np.arange(32)
                    byte = (start + (o // 8)[None] * 8 * krow
                            + (o % 8)[None] * krow + k[:, None])
                    b_frag = sm.read(tb + swizzle(byte - tb, ksw))
                    acc[rows] += a_frag @ b_frag
        m = np.arange(bm)
        gi, rem = np.divmod(m, per)
        ry, rx = np.divmod(rem, p.tw)
        nn, oy, ox = n0 + gi, ty0 + ry, tx0 + rx
        ok = (nn < n) & (oy < h) & (ox < wd)
        cols = co0 + np.arange(bn)
        cok = cols < cout
        for q in np.nonzero(ok)[0]:
            hits[nn[q], oy[q], ox[q], cols[cok]] += 1
            sums[split, nn[q], oy[q], ox[q], cols[cok]] = acc[q, cok]
        if p.splits > 1:
            continue
        nz = np.zeros(bm, np.float32)
        if stats:
            nz[ok] = noise[nn[ok], oy[ok], ox[ok]]
        cc = np.minimum(cols, cout - 1)
        v = epilogue(acc, deq[cc], nz[:, None],
                     nscale[cc] if stats else None,
                     None if bias is None else bias[cc], act)
        for q in np.nonzero(ok)[0]:
            v_out[nn[q], oy[q], ox[q], cols[cok]] = v[q, cok]
        if stats:
            slot = stat_slots(v, ok, mi, one=p.g == 1)
            fpi = 8 if p.g == 1 else per // 16  # slots per image
            for g_ in range(p.g):
                if n0 + g_ >= n:
                    continue
                tot = np.zeros((bn, 2), np.float32)
                for f in range(g_ * fpi, (g_ + 1) * fpi):
                    tot = tot + slot[f]  # slot order, f32
                partial[n0 + g_, tile, :, cols[cok]] = tot[cok]
    assert (hits == p.splits).all(), "every output element once per split"
    total = sums.sum(axis=0)  # the finish kernel: s32 adds, exact
    if p.splits > 1:
        v_out = epilogue(total, deq, noise[..., None] if stats else None,
                         nscale if stats else None, bias, act)
        partial = None  # the finish kernel's own segment order
    return total, v_out, partial


def epilogue(acc, deq, nz, nscale, bias, act):
    """The s8 epilogue in f32, every step rounded on its own (numpy's f32
    ops round to nearest, as __fmul_rn / __fadd_rn; no fused multiply-add):
    float(acc) * deq [+ noise * nscale] [+ bias], the activation."""
    f32 = np.float32
    v = acc.astype(f32) * deq.astype(f32)
    if nscale is not None:
        v = v + nz.astype(f32) * nscale.astype(f32)
    if bias is not None:
        v = v + bias.astype(f32)
    if act == "relu":
        v = np.maximum(v, f32(0))
    elif act == "leaky":
        v = np.where(v >= 0, v, f32(0.2) * v)
    return v.astype(f32)


def stat_slots(v, ok, mi, one):
    """The statistics' slots in the kernel's order and in f32 (as
    tests/test_torch_sm90_plan.py::stat_slots: a lane's rows r and r + 8,
    three xor-shuffles; a slot per warp where the block holds one image,
    else per 16-row fragment)."""
    v32 = np.where(ok[:, None], v, 0).astype(np.float32)
    rows = v32.reshape(2, mi, 4, 16, v.shape[1])
    out = []
    for wg, wq in itertools.product(range(2), range(4)):
        for i in (range(1) if one else range(mi)):
            t1 = np.zeros((8, v.shape[1]), np.float32)
            t2 = np.zeros((8, v.shape[1]), np.float32)
            for k in (range(mi) if one else (i,)):
                fr = rows[wg, k, wq]
                t1 = t1 + (fr[:8] + fr[8:])
                t2 = t2 + (fr[:8] * fr[:8] + fr[8:] * fr[8:])
            for d in (1, 2, 4):
                idx = np.arange(8) ^ d
                t1, t2 = t1 + t1[idx], t2 + t2[idx]
            out.append(((wg * mi + i) * 4 + wq if not one else wg * 4 + wq,
                        np.stack([t1[0], t2[0]], axis=-1)))
    return np.stack([s_ for _, s_ in sorted(out, key=lambda t: t[0])])


# (n, h, w, cin, cout, kernel 1?, act): each tile class of the rule, by
# the plan it gets (asserted below): ragged tiles with resident taps at CK
# 64 and 32; a tile of images (g > 1) with images past N and Cout 24
# (masked channels, stores from registers); split-K with the 128-channel
# tap box by TMA; Cout 2 (n16 on zero taps, y from registers); BN 64 (the
# wide tile's per-tap rows); BN 128 unsplit with two Cout blocks, the
# second ragged; 256-pixel blocks (mi 2); Cout 64 at Cin 64 in two
# 32-channel blocks; kernel 1's 32-channel tiles; Cin 16 in tap pairs
# (kernel 1 ragged, kernel 2 at Cout 32 and at Cout 2)
EMULATED = [(2, 12, 20, 64, 16, True, "leaky"),
            (3, 8, 8, 32, 24, False, "relu"),
            (8, 4, 4, 256, 128, True, "leaky"),
            (2, 16, 16, 32, 2, False, "none"),
            (1, 16, 16, 128, 64, True, "leaky"),
            (1, 16, 16, 128, 200, False, "leaky"),
            (1, 128, 256, 32, 16, False, "leaky"),
            (2, 8, 16, 128, 32, False, "none"),
            (2, 16, 16, 64, 64, False, "leaky"),
            (1, 16, 32, 32, 32, True, "leaky"),
            (2, 12, 20, 16, 16, True, "leaky"),
            (1, 16, 32, 16, 32, False, "relu"),
            (2, 16, 16, 16, 2, False, "none")]


def s8_operands(rng, n, h, w, cin, cout, k1):
    x = rng.integers(-127, 128, (n, h, w, cin))
    wq = rng.integers(-127, 128, (3, 3, cout, cin))
    deq = ((rng.random(cout) + 0.5) / (127.0 * (9 * cin) ** 0.5)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    noise = rng.standard_normal((n, h, w)).astype(np.float32) if k1 else None
    nscale = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, wq, deq, bias, noise, nscale


def exact_conv(x, wq):
    """The exact integer conv in float64 (every partial sum an integer far
    below 2^53), as int64."""
    y = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
                 torch.from_numpy(wq).permute(2, 3, 0, 1).double(),
                 padding=1)
    return y.permute(0, 2, 3, 1).numpy().astype(np.int64)


@pytest.mark.parametrize("case", EMULATED,
                         ids=["-".join(map(str, c)) for c in EMULATED])
def test_emulated_s8_body_matches_plain(case):
    n, h, w, cin, cout, k1, act = case
    rng = np.random.default_rng(sum(case[:5]))
    x, wq, deq, bias, noise, nscale = s8_operands(rng, n, h, w, cin, cout,
                                                  k1)
    p = tc_plan.plan_s8(n, h, w, cin, cout, k1)
    assert p.sm90 and p.s8
    total, v, partial = emulate(x, wq, noise, nscale, bias, deq, act, p)
    # the s32 sums: the exact integer conv, and its f32 as conv3x3_s8_acc's
    assert np.array_equal(total, exact_conv(x, wq))
    tx = torch.from_numpy(x).to(torch.int8)
    tw = torch.from_numpy(wq).to(torch.int8)
    acc = conv3x3_s8_acc(tx, tw)
    assert np.array_equal(total.astype(np.float32), acc.numpy())
    # y: the plain epilogue's, bit for bit, in f32 and in bf16
    td, tb = torch.from_numpy(deq), torch.from_numpy(bias)
    for out in (torch.float32, torch.bfloat16):
        if k1:
            want, mean, var = s8_in_stats_epilogue_plain(
                acc, td, torch.from_numpy(noise), torch.from_numpy(nscale),
                tb, out_dtype=out)
        else:
            want = s8_epilogue_plain(acc, td, tb, relu=act == "relu",
                                     leaky=0.2 if act == "leaky" else None,
                                     out_dtype=out)
        got = torch.from_numpy(v).to(out)
        assert torch.equal(got, want), (out, float(
            (got.float() - want.float()).abs().max()))
    if k1 and partial is not None:
        sums = partial.astype(np.float64).sum(axis=1)  # the tile axis
        got_mean = sums[:, 0] / (h * w)
        got_var = sums[:, 1] / (h * w) - got_mean ** 2
        tol = chip_smoke.STAT_TOL["bf16"]
        np.testing.assert_allclose(got_mean, mean.double().numpy(), **tol)
        np.testing.assert_allclose(got_var, var.double().numpy(), **tol)
        # the same operands give the same slots: the order is fixed
        again = emulate(x, wq, noise, nscale, bias, deq, act, p)[2]
        assert np.array_equal(partial, again)


def test_emulated_cases_cover_the_tile_classes():
    plans = [tc_plan.plan_s8(*c[:5], c[5]) for c in EMULATED]
    assert all(p.sm90 for p in plans)
    assert {p.bn for p in plans} == {16, 32, 64, 128}
    assert {p.ck for p in plans} == {16, 32, 64}
    assert any(p.pairs for p in plans)
    assert {p.mi for p in plans} == {1, 2}
    assert any(p.splits > 1 for p in plans)
    assert any(p.resident for p in plans) and any(
        not p.resident for p in plans)
    assert any(p.g > 1 for p in plans) and any(p.cout_blocks > 1
                                               for p in plans)
    assert any(not p.tma_y for p in plans) and any(p.tma_y for p in plans)


@pytest.mark.parametrize("ck", [16, 32, 64])
@pytest.mark.parametrize("tw", [16, 8, 4])
def test_s8_ldmatrix_rows_fall_in_distinct_bank_groups(ck, tw):
    """A pixel of ck s8 channels is ck bytes, a bf16 pixel of ck / 2: the
    8 row addresses of every ldmatrix of every tap and k32 step fall in 8
    distinct 16-byte bank groups where a tile row holds 8 or 16 pixels;
    with 4-pixel rows (4^2 images) a group takes at most 2 rows.  16-byte
    pixels (unswizzled, a step over two taps: lanes 16-31 at the second)
    keep 8 neighbouring pixels in 128 contiguous bytes."""
    ps = ck
    mask = row_mask(ps)
    lanes = np.arange(32)
    lrow = lanes % 8 + 8 * ((lanes // 8) % 2)
    for mi in (1, 2):
        bm = 128 * mi
        th = min(bm // tw, 4 if tw == 4 else bm // tw)
        wp = tw + 2
        for wg, wq, i in itertools.product(range(2), range(4), range(mi)):
            m = (wg * mi + i) * 64 + wq * 16 + lrow
            gi, rem = np.divmod(m, th * tw)
            ty, tx = np.divmod(rem, tw)
            aoff = ((gi * (th + 2) + ty) * wp + tx) * ps
            steps = itertools.product(range(5), (0,)) if ck == 16 else \
                itertools.product(range(9), range(ck // 32))
            for tap, kk in steps:
                if ck == 16:
                    tl = np.minimum(2 * tap + lanes // 16, 8)
                    toff = (tl // 3) * wp * ps + (tl % 3) * ps
                else:
                    toff = ((tap // 3) * wp * ps + (tap % 3) * ps + kk * 32
                            + 16 * (lanes // 16))
                addr = swizzle(aoff + toff, mask)
                for j in range(4):  # the x4's matrices: lanes 8j..8j+7
                    banks = (addr[8 * j:8 * j + 8] // 16) % 8
                    worst = np.bincount(banks, minlength=8).max()
                    assert worst <= (2 if tw == 4 else 1), (
                        ck, tw, tap, kk, j, banks)


def test_s8_tap_rows_fall_in_distinct_bank_groups():
    """wgmma reads B's 8-row core matrices of 16 bytes: under the taps'
    swizzle (32 B rows at ck 32, 64 B at ck 64) the 8 rows of one core
    matrix lie in 8 distinct bank groups."""
    for ck in (32, 64):
        for tap, o8, kk, half in itertools.product(range(9), range(16),
                                                   range(ck // 32), (0, 1)):
            byte = (tap * 128 + o8 * 8 + np.arange(8)) * ck + kk * 32 + \
                16 * half
            banks = (swizzle(byte, row_mask(ck)) // 16) % 8
            assert len(set(banks.tolist())) == 8, (ck, banks)


@pytest.mark.parametrize("name,kernel,body", [
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<128, 2, "
     "32, 4>(gst::sm90::(anonymous namespace)::Args)", "conv_in_stats_s8",
     "sm90"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, 32, "
     "5>(gst::sm90::(anonymous namespace)::Args)", "small_conv_s8", "sm90"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<64, 8, 64, 5>("
     "gst::tc::(anonymous namespace)::Args)", "small_conv_s8", "mma_sync"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<64, 4, 64, 4>("
     "gst::tc::(anonymous namespace)::Args)", "conv_in_stats_s8",
     "mma_sync"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_finish_kernel<true>("
     "gst::tc::(anonymous namespace)::Args, int, int)", None, None)])
def test_traces_tell_the_s8_bodies_apart(name, kernel, body):
    """chip_smoke.py counts each traced s8 launch by kernel and body, so
    its int8 phase shows every s8 launch on the Hopper body."""
    assert chip_smoke.kernel_of(name) == kernel
    assert chip_smoke.body_of(name) == body

"""The f32 (3xTF32) form of the Hopper body of kernels 3 and 2 (entries 3
and 8 of ``csrc/conv3x3_sm90.cuh``: TMA boxes of the f32 halo into the
mbarrier ring, the block's taps split into resident K-major tf32 hi and lo,
three wgmma m64nBNk8 tf32 a k8 step, split-K with a fixed-order finish,
y from registers), checked where a CPU can check it: the rule that picks
an f32 call's body (``tc_plan.plan_f32_body`` over ``plan_tf32``) at every
kernel-3 call of a train step and every kernel-2 f32 call of the decoder
at ffhq, cars and bedrooms and at the edges, the plans' own rules, and an
emulation of the body on the operands (the halo box under its 64-byte
swizzle, the ldmatrix rows of each tap and k8 step, the (hi, lo) taps
through wgmma's K-major descriptor) held bit for bit to the 3xTF32 split
of ``conv3x3_tf32.cuh``, and within ``TOL["f32"]`` of the plain version
with the tensor cores' truncating accumulator.  The kernel itself runs on
the card (``tests/test_torch_kernels.py::test_cuda_bil_matches_plain``,
``chip_smoke.py``'s phase 3); ``torch.ops.gst.conv3x3_bil`` and its fake
run here."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from gan_segmentation_tpu_torch.core.config import SolverConfig, gan_config
from gan_segmentation_tpu_torch.kernels import _build, tc_plan
from gan_segmentation_tpu_torch.kernels.bil_conv import (EDGE_SHAPES,
                                                         conv3x3_bil,
                                                         conv3x3_bil_plain)

GANS = ("ffhq", "cars", "bedrooms")
TOL = chip_smoke.TOL["f32"]


def _scfg(gan):
    return SolverConfig(max_res_log2=gan_config(gan).max_res_log2)


def train_calls():
    """(gan, label, (n, h, w, cin, cout)) of every kernel-3 call of a train
    step (batch 1: the forward convs inside the contract, the input
    gradients), as chip_smoke.bil_shapes counts them."""
    return [(gan, label, tuple(s[:5])) for gan in GANS
            for label, *s in chip_smoke.bil_shapes(_scfg(gan))]


def kernel2_calls():
    """(gan, name, (n, h, w, cin, cout)) of kernel 2's f32 calls: every
    decoder conv of evaluate and predict (batch 1; train's cvt_i forward
    are among them) and of the f32 generate path (batch 8)."""
    return sorted({(gan, name, tuple(s[:5])) for gan in GANS
                   for b in (1, 8)
                   for name, *s in chip_smoke.kernel2_shapes(_scfg(gan), b)})


TRAIN_CALLS = train_calls()
KERNEL2_CALLS = kernel2_calls()
# the f32 edge cases chip_smoke.py runs on the card on both bodies
EDGES = sorted(set(EDGE_SHAPES) | set(chip_smoke.TC_EDGES)
               | set(chip_smoke.F32_EDGES))


def _ids(cases):
    return ["-".join(map(str, (c[0], c[1].replace(" ", "_"), *c[2])))
            for c in cases]


def check_plan(p, n, h, w, cin, cout, path=True):
    """The tf32 plan's own rules, TMA's and wgmma's; ``path``: the blocks
    an SM that the launch bounds ask for share one."""
    assert p.sm90 and p.tf32 and p.eb == 4 and not p.s8, p
    assert p.ck == 16 and p.resident and not p.tma_y and not p.noise, p
    assert (p.bn, p.mi, p.ck) in tc_plan.TF32_SM90_TILES, p
    assert 8 <= p.bn <= min(64, max(8, 1 << (cout - 1).bit_length())), p
    # one split's taps, hi and lo, resident (more where a narrow block
    # runs one to an SM on a grid that fills the card); chains of <= 8
    # chunks
    one = p.cps * p.tap_bytes > tc_plan.SM90_RESIDENT_MAX
    assert not one or (p.bn <= 32 and p.blocks >= tc_plan.NUM_SMS and
                       p.cps * p.tap_bytes
                       <= tc_plan.TF32_RESIDENT_ONE_BLOCK), p
    assert p.tap_bytes == 9 * 2 * p.bn * 16 * 4
    assert p.cps <= tc_plan.MAX_CPS_F32, p
    assert (p.splits - 1) * p.cps < p.chunks <= p.splits * p.cps, p
    assert p.chunks == -(-cin // 16) <= tc_plan.MAX_CPS_F32
    assert p.smem_bytes <= tc_plan.MAX_SMEM, p
    if path and not one:
        assert p.smem_bytes <= tc_plan.SM_SMEM // p.min_blocks - 1024, p
    assert p.tw * p.th * p.g == p.bm == 128 * p.mi, p
    assert (p.th * p.tw) % 16 == 0
    assert 2 <= p.stages <= tc_plan.SM90_MAX_STAGES
    assert p.blocks < 2 ** 31
    # TMA: x's box (16 f32 = 64 bytes, the 64-byte swizzle's rows), <= 256
    # a dimension; x's rows of Cin f32 a multiple of 16 bytes
    box = p.boxes()["x"]
    assert box == (16, p.tw + 2, p.th + 2, p.g)
    assert all(1 <= d <= tc_plan.TMA_BOX_MAX for d in box), box
    assert (cin * 4) % 16 == 0
    assert len(p.args()) == 11


def covered(p, n, h, w):
    """{(image, row, column, Cout block, split): times} over the kernel's
    item and pixel maps (conv3x3_sm90.cuh::item)."""
    hits = {}
    for it in range(p.blocks):
        rest, cb = divmod(it, p.cout_blocks)
        z, tile = divmod(rest, p.tiles)
        ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
        split, grp = z % p.splits, z // p.splits
        for q in range(p.bm):
            gi, rem = divmod(q, p.th * p.tw)
            nn, oy, ox = grp * p.g + gi, ty0 + rem // p.tw, tx0 + rem % p.tw
            if nn < n and oy < h and ox < w:
                key = (nn, oy, ox, cb, split)
                hits[key] = hits.get(key, 0) + 1
    return hits


@pytest.mark.parametrize("case", TRAIN_CALLS, ids=_ids(TRAIN_CALLS))
def test_kernel3_train_calls_take_the_hopper_body(case):
    """Every kernel-3 call of a train step at ffhq, cars and bedrooms runs
    the tf32 Hopper body but the last conv's input gradient (Cin 2: x's
    rows of 8 bytes, which TMA refuses), which keeps the mma.sync 3xTF32
    body without a split; each plan keeps every rule."""
    gan, label, (n, h, w, cin, cout) = case
    p = tc_plan.plan_f32_body(n, h, w, cin, cout, kernel3=True)
    refused = label.endswith("_conv dX")
    assert p.sm90 == (not refused), (label, p)
    if refused:
        assert cin == 2 and "Cin % 4" in tc_plan.tma_refuses(
            cin, w, False, tf32=True)
        assert p == tc_plan.plan_f32(n, h, w, cin, cout, splits=1)
        return
    check_plan(p, n, h, w, cin, cout)
    if n * h * w <= 1 << 14:
        hits = covered(p, n, h, w)
        assert len(hits) == n * h * w * p.cout_blocks * p.splits
        assert set(hits.values()) == {1}


@pytest.mark.parametrize("case", KERNEL2_CALLS, ids=_ids(KERNEL2_CALLS))
def test_kernel2_f32_calls_take_the_hopper_body_up_to_cin_128(case):
    """Kernel 2's f32 calls run the tf32 Hopper body wherever Cin <= 128
    (one chain of at most 8 chunks); cvt_0..4 (Cin 512 and 256 at 4^2-64^2)
    keep the mma.sync 3xTF32 body and its split rule."""
    gan, name, (n, h, w, cin, cout) = case
    p = tc_plan.plan_f32_body(n, h, w, cin, cout)
    assert p.sm90 == (cin <= 128), (name, p)
    assert p.sm90 == (name not in {f"cvt_{i}" for i in range(5)}), name
    if p.sm90:
        check_plan(p, n, h, w, cin, cout)
    else:
        assert p == tc_plan.plan_f32(n, h, w, cin, cout)


def test_the_rule_names_the_calls_of_ffhq():
    """At ffhq 1024^2: 37 of a train step's 38 kernel-3 calls run the tf32
    Hopper body (not main_8_conv's input gradient), and 21 of an evaluate
    sample's 26 kernel-2 calls (all but cvt_0..4), among them the 13 at
    128^2 and above."""
    k3 = [(label, s) for gan, label, s in TRAIN_CALLS if gan == "ffhq"]
    assert len(k3) == 38
    off = [label for label, s in k3
           if not tc_plan.plan_f32_body(*s, kernel3=True).sm90]
    assert off == ["main_8_conv dX"]
    k2 = [(name, tuple(s[:5])) for name, *s in
          chip_smoke.kernel2_shapes(_scfg("ffhq"), 1)]
    assert len(k2) == 26
    off = [name for name, s in k2 if not tc_plan.plan_f32_body(*s).sm90]
    assert off == [f"cvt_{i}" for i in range(5)]
    big = [name for name, s in k2 if s[1] >= 128]
    assert len(big) == 13 and not set(big) & set(off)


@pytest.mark.parametrize("shape", EDGES, ids=["-".join(map(str, s))
                                              for s in EDGES])
def test_plan_tf32_at_the_edges(shape):
    """The f32 edge shapes go to the body the rule names: the Hopper body
    where TMA's rules take them and Cin <= 128, else the mma.sync 3xTF32
    body (kernel 3 without a split); an unaligned view always keeps the
    mma.sync body."""
    n, h, w, cin, cout = shape
    takes = tc_plan.tma_refuses(cin, w, False, tf32=True) is None and (
        cin <= 16 * tc_plan.MAX_CPS_F32)
    for k3 in (True, False):
        p = tc_plan.plan_f32_body(n, h, w, cin, cout, kernel3=k3)
        assert p.sm90 == takes, (shape, p)
        if takes:
            check_plan(p, n, h, w, cin, cout, path=False)
            if n * h * w <= 1 << 13:
                hits = covered(p, n, h, w)
                assert len(hits) == n * h * w * p.cout_blocks * p.splits
                assert set(hits.values()) == {1}
        else:
            assert isinstance(p, tc_plan.PlanF32)
            assert p.splits == 1 or not k3
        assert not tc_plan.plan_f32_body(n, h, w, cin, cout, aligned=False,
                                         kernel3=k3).sm90


def test_tf32_refusals_name_their_rule():
    assert "Cin % 4" in tc_plan.tma_refuses(2, 1024, False, tf32=True)
    assert tc_plan.tma_refuses(12, 17, False, tf32=True) is None
    assert "aligned" in tc_plan.tma_refuses(16, 8, False, aligned=False,
                                            tf32=True)
    assert tc_plan.plan_tf32(1, 64, 64, 256, 32) is None  # a chain of 16
    assert tc_plan.plan_tf32(1, 64, 64, 128, 32).sm90


def test_plan_tf32_returns_only_the_built_tiles():
    """Over a grid of shapes the rule returns exactly the (bn, mi, ck) that
    conv3x3_sm90.cuh's tf32_tile builds for entries 3 and 8
    (``tc_plan.TF32_SM90_TILES``): none it lacks, none it builds in vain."""
    seen = set()
    for n, res, cin, cout in itertools.product(
            (1, 2, 8), (4, 8, 16, 64, 256, 1024), (4, 16, 32, 64, 128),
            (2, 5, 16, 32, 64, 128)):
        p = tc_plan.plan_tf32(n, res, res, cin, cout)
        if p is not None:
            check_plan(p, n, res, res, cin, cout, path=False)
            seen.add((p.bn, p.mi, p.ck))
    assert seen == tc_plan.TF32_SM90_TILES


def test_the_rule_narrows_the_blocks_to_fill_the_card_and_never_splits():
    """Hi and lo of 64 -> 32 are 147 KB, over the resident budget of two
    blocks an SM: from 256^2 up (items enough to fill the card) BN 32
    keeps them all, one block an SM; at 128^2 two 16-channel blocks of
    73.7 KB each.  The 8^2-64^2 layers, whose wide blocks leave most SMs
    idle, run 8-channel blocks (more of them, each a quarter of the MMAs)
    and no split-K; cvt_5 (Cin 128) two blocks of 16 channels, one an SM;
    32 -> 64 two blocks of 32 (the wide tile is not offered more taps)."""
    for res in (256, 512):
        p = tc_plan.plan_tf32(1, res, res, 64, 32)
        assert (p.bn, p.cout_blocks, p.splits, p.cps) == (32, 1, 1, 4)
        assert p.smem_bytes > tc_plan.SM_SMEM // 2 - 1024
    p = tc_plan.plan_tf32(1, 128, 128, 64, 32)
    assert (p.bn, p.cout_blocks, p.splits) == (16, 2, 1)
    for res, cin, cout in itertools.product((8, 16, 32, 64), (32, 64),
                                            (32, 64)):
        p = tc_plan.plan_tf32(1, res, res, cin, cout)
        assert (p.bn, p.mi, p.splits) == (8, 1, 1), (res, cin, cout, p)
    p = tc_plan.plan_tf32(1, 128, 128, 32, 32)
    assert (p.bn, p.mi, p.cout_blocks) == (16, 1, 2)
    p = tc_plan.plan_tf32(1, 128, 128, 128, 32)
    assert (p.bn, p.cout_blocks, p.splits, p.cps) == (16, 2, 1, 8)
    p = tc_plan.plan_tf32(1, 512, 512, 32, 64)
    assert (p.bn, p.cout_blocks, p.splits) == (32, 2, 1)
    assert all(tc_plan.plan_f32_body(*s, kernel3=True).splits == 1
               for _, _, s in TRAIN_CALLS)


# ------------------------------------------------- the body, emulated
# Shared memory as flat arrays of 32-bit words (f32 bit patterns); TMA's
# swizzle and the kernel's index maps in numpy.

def swizzle(off, mask=3):
    """conv3x3_sm90.cuh's swizzle(): 16-byte chunk bits [4, 7) xor address
    bits [7, 10) (64-byte rows: mask 3)."""
    return off ^ (((off >> 7) & mask) << 4)


def tf32_trunc(v):
    """conv3x3_tf32.cuh's split: clear the low 13 mantissa bits."""
    return (np.ascontiguousarray(v, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def split(v):
    hi = tf32_trunc(v)
    return hi, tf32_trunc((np.asarray(v, np.float32) - hi).astype(
        np.float32))


def toward_zero(v):
    """f64 -> f32 rounded toward zero, as the tensor cores round their f32
    accumulator (tests/test_torch_f32_tc.py)."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def mma(acc, a, b, trunc):
    """One wgmma: acc + a @ b, the products exact (tf32 operands), one
    rounding of the f32 accumulator, toward zero or to nearest."""
    s64 = acc.astype(np.float64) + a.astype(np.float64) @ b.astype(
        np.float64)
    return toward_zero(s64) if trunc else s64.astype(np.float32)


POISON = np.uint32(0xFFC0DEAD)  # a NaN no load writes


class Words:
    """Shared memory of 32-bit words, poisoned until written."""

    def __init__(self, nbytes):
        self.w = np.full(nbytes // 4, POISON, np.uint32)

    def tma_box(self, t, start, box):
        """A TMA load of the f32 tensor ``t`` (dims outermost first;
        ``start`` and ``box`` innermost first) to offset 0: zero fill
        outside, 16-byte units under the 64-byte swizzle."""
        full = np.zeros(tuple(reversed(box)), np.uint32)
        src, dst = [], []
        for d, (s, b) in enumerate(zip(reversed(start), reversed(box))):
            lo, hi = max(s, 0), min(s + b, t.shape[d])
            src.append(slice(lo, max(lo, hi)))
            dst.append(slice(lo - s, lo - s + max(0, hi - lo)))
        full[tuple(dst)] = t.view(np.uint32)[tuple(src)]
        units = full.reshape(-1, 4)
        addr = swizzle(np.arange(len(units)) * 16) // 4
        self.w[addr[:, None] + np.arange(4)] = units

    def read(self, byte):
        vals = self.w[byte // 4]
        assert (vals != POISON).all(), "read of a word no store wrote"
        return vals


def split_taps(w, co0, c0, nc, bn, taps):
    """conv3x3_sm90.cuh::split_taps: w (9, Cin, Cout) f32 for channels co0
    .. co0 + bn - 1 and chunks c0 .. c0 + nc - 1, as [chunk][9][hi, lo][bn]
    [16] tf32 under the 64-byte swizzle."""
    cin, cout = w.shape[1:]
    lo_off = bn * 64
    sm = Words(nc * taps)
    chunk, tap, ci, o = (a.ravel() for a in np.meshgrid(
        np.arange(nc), np.arange(9), np.arange(16), np.arange(bn),
        indexing="ij"))
    c, co = (c0 + chunk) * 16 + ci, co0 + o
    ok = (c < cin) & (co < cout)
    v = np.zeros(len(c), np.float32)
    v[ok] = w[tap[ok], c[ok], co[ok]]
    hi, lo = split(v)
    off = chunk * taps + swizzle((tap * 2 * bn + o) * 64 + ci * 4)
    sm.w[off // 4] = hi.view(np.uint32)
    sm.w[(off + lo_off) // 4] = lo.view(np.uint32)
    return sm


def emulate(x, w, bias, act, p, trunc=True, max_items=None):
    """The tf32 Hopper body on the operands (x (N, H, W, Cin), w (3, 3,
    Cin, Cout) f32): -> (y over the emulated items, NaN elsewhere; which
    outputs were emulated).  Every A and B word the MMAs read is held bit
    for bit to x and to split(w) at the position the GEMM view gives it;
    each k8 step adds A_hi [B_hi | B_lo] to the accumulators' two halves,
    then A_lo B_hi to the first, with one rounding each, toward zero
    (``trunc``) or to nearest; the halves are added to nearest, the splits
    in order; then bias and the activation."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    bn, bm, mi = p.bn, p.bm, p.mi
    ps, hp, wp, per = 64, p.th + 2, p.tw + 2, p.th * p.tw
    wt = w.reshape(9, cin, cout)
    wh, wl = split(wt)
    parts = np.full((p.splits, n, h, wd, cout), np.nan, np.float32)
    lanes = np.arange(32)
    lrow = lanes % 8 + 8 * ((lanes // 8) % 2)
    # the ldmatrix.x4 rows: lane l gives row lrow[l], k words 4 (l // 16) ..
    frow = (lanes // 8 % 2) * 8 + lanes % 8
    fk = (lanes // 16) * 4
    xpad = np.zeros((n + p.g, h + 2 + p.th, wd + 2 + p.tw, cin + 16),
                    np.float32)
    xpad[:n, 1:h + 1, 1:wd + 1, :cin] = x
    items = p.blocks if max_items is None else min(p.blocks, max_items)
    for item in range(items):
        rest, cb = divmod(item, p.cout_blocks)
        co0 = cb * bn
        z, tile = divmod(rest, p.tiles)
        ty, tx = divmod(tile, p.tiles_x)
        ty0, tx0 = ty * p.th, tx * p.tw
        sp, n0 = z % p.splits, (z // p.splits) * p.g
        c0 = sp * p.cps
        nc = min(p.chunks - c0, p.cps)
        res = split_taps(wt, co0, c0, nc, bn, p.tap_bytes)
        acc = np.zeros((bm, 2 * bn), np.float32)
        m = np.arange(bm)
        gi, rem = np.divmod(m, per)
        ry, rx = np.divmod(rem, p.tw)
        for c in range(nc):
            st = Words(p.halo_bytes)
            st.tma_box(x, ((c0 + c) * 16, tx0 - 1, ty0 - 1, n0),
                       (16, wp, hp, p.g))
            for t, kk in itertools.product(range(9), range(2)):
                a = np.zeros((bm, 8), np.uint32)
                for wg, wq, i in itertools.product(range(2), range(4),
                                                   range(mi)):
                    m0 = (wg * mi + i) * 64 + wq * 16
                    mm = m0 + lrow
                    g_, r_ = np.divmod(mm, per)
                    y_, x_ = np.divmod(r_, p.tw)
                    aoff = ((g_ * hp + y_) * wp + x_) * ps + 16 * (lanes // 16)
                    byte = swizzle(aoff + (t // 3) * wp * ps + (t % 3) * ps
                                   + kk * 32)
                    if bn == 64:  # the wide tiles' per-tap rows, asw
                        asw = swizzle(aoff + ((t // 3) * wp + t % 3) * ps)
                        assert (asw ^ (kk * 32) == byte).all()
                    words = st.read(byte[:, None] + 4 * np.arange(4))
                    a[m0 + frow[:, None], fk[:, None] + np.arange(4)] = words
                # A: x at the tap-shifted pixel, channels kk*8 .. of the chunk
                ch = (c0 + c) * 16 + kk * 8 + np.arange(8)
                want = xpad[(n0 + gi)[:, None], (ty0 + ry + t // 3)[:, None],
                            (tx0 + rx + t % 3)[:, None], ch[None]]
                assert np.array_equal(a, want.view(np.uint32)), (item, c, t)
                # B through the K-major descriptor: start = the tap's rows
                # + 32 kk bytes, row r (hi o < bn, lo bn + o) at (r // 8)
                # SBO + (r % 8) 64, SBO = 8 rows of 64 bytes
                r, k = np.arange(2 * bn), np.arange(8)
                byte = c * p.tap_bytes + swizzle(
                    t * 2 * bn * ps + kk * 32 + (r // 8)[None] * 8 * ps
                    + (r % 8)[None] * ps + 4 * k[:, None])
                b2 = res.read(byte).view(np.float32)
                cc = np.minimum(ch, cin - 1)
                o = np.arange(bn)
                col = np.minimum(co0 + o, cout - 1)
                inside = (ch < cin)[:, None] & (co0 + o < cout)[None]
                for got, ref in ((b2[:, :bn], wh), (b2[:, bn:], wl)):
                    want = np.where(inside, ref[t][cc[:, None], col[None]],
                                    np.float32(0))
                    assert np.array_equal(got.view(np.uint32),
                                          want.view(np.uint32)), (item, t)
                # A_hi is the f32 itself, of which the MMA reads the tf32
                # bits (trunc); lo = a - trunc(a), read truncated too
                ah, al = split(a.view(np.float32))
                acc = mma(acc, ah, b2, trunc)
                acc[:, :bn] = mma(acc[:, :bn], al, b2[:, :bn], trunc)
        acc = (acc[:, :bn] + acc[:, bn:]).astype(np.float32)
        nn, oy, ox = n0 + gi, ty0 + ry, tx0 + rx
        ok = (nn < n) & (oy < h) & (ox < wd)
        cols = co0 + np.arange(bn)
        cok = cols < cout
        for q in np.nonzero(ok)[0]:
            parts[sp, nn[q], oy[q], ox[q], cols[cok]] = acc[q, cok]
    total = parts[0]
    for s in range(1, p.splits):  # the finish kernel: in order, f32
        total = (total + parts[s]).astype(np.float32)
    y = total if bias is None else (total + bias).astype(np.float32)
    if act == "relu":
        y = np.maximum(y, np.float32(0))
    elif act == "leaky":
        y = np.where(y >= 0, y, np.float32(0.2) * y).astype(np.float32)
    return y, ~np.isnan(total)


def ref_conv(x, w, bias, act):
    """The plain version in f64."""
    y = F.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                 torch.from_numpy(w).double().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).numpy()
    if bias is not None:
        y = y + bias
    if act == "relu":
        y = np.maximum(y, 0)
    elif act == "leaky":
        y = np.where(y >= 0, y, 0.2 * y)
    return y


# (n, h, w, cin, cout, act, items, splits): each class of the rule, by the
# plan it gets (asserted below): 8-channel blocks (16^2 64 -> 32, and the
# same forced into two Cin splits, the finish kernel's order, as
# phase_tf32_sweep runs it on the card; Cin 128 in 16-channel blocks and
# four splits), two Cout blocks of 32 (32 -> 64 at 128^2), a tile of two
# 8^2 images with the second past N, Cout 2 on n8, the wide BN 64 tile's
# per-tap rows (the first items of 1024^2 16 -> 64), Cin 12 and Cout 5 (a
# short chunk, masked channels) over a
# ragged 10 x 17 at batch 4, 256-pixel blocks (the first items of a 1024^2
# 16 -> 16 layer), BN 16 in two blocks (64 -> 32 at 128^2, the first items),
# BN 32 with 147 KB of taps, one block an SM (64 -> 32 at 256^2)
EMULATED = [(1, 16, 16, 64, 32, "leaky", None, 1),
            (1, 16, 16, 64, 32, "leaky", None, 2),
            (1, 16, 16, 128, 32, "none", None, 4),
            (1, 128, 128, 32, 64, "none", 4, 1),
            (1, 8, 8, 32, 32, "leaky", None, 1),
            (1, 32, 32, 32, 2, "none", None, 1),
            (1, 1024, 1024, 16, 64, "relu", 2, 1),
            (4, 10, 17, 12, 5, "leaky", None, 1),
            (1, 1024, 1024, 16, 16, "leaky", 2, 1),
            (1, 128, 128, 64, 32, "leaky", 4, 1),
            (1, 256, 256, 64, 32, "leaky", 2, 1)]


def emulated_plan(case):
    """The rule's plan of an EMULATED case, in ``splits`` Cin splits."""
    n, h, w, cin, cout, _, _, splits = case
    p = tc_plan.plan_tf32(n, h, w, cin, cout)
    cps = -(-p.chunks // splits)
    return dataclasses.replace(p, splits=-(-p.chunks // cps), cps=cps)


def operands(rng, n, h, w, cin, cout):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("case", EMULATED,
                         ids=["-".join(map(str, (*c[:6], c[7])))
                              for c in EMULATED])
def test_emulated_tf32_body_reads_the_split_and_keeps_f32(case):
    """The body's addressing gives the MMAs x and the 3xTF32 split of w
    bit for bit (asserted inside ``emulate``), and its sums, with the
    tensor cores' truncating accumulator or with one rounding to nearest,
    stay within TOL["f32"] of the plain version in f64 at every emulated
    output."""
    n, h, w, cin, cout, act, items, _ = case
    rng = np.random.default_rng(sum(case[:5]))
    x, wt, bias = operands(rng, n, h, w, cin, cout)
    p = emulated_plan(case)
    assert p is not None and p.tf32
    ref = ref_conv(x, wt, bias, act)
    for trunc in (True, False):
        y, done = emulate(x, wt, bias, act, p, trunc, items)
        assert done.any() and (items is not None or done.all())
        err = np.abs(y[done] - ref[done])
        assert (err <= TOL["atol"] + TOL["rtol"] * np.abs(ref[done])).all(), (
            trunc, err.max())


def test_emulated_cases_cover_the_tile_classes():
    plans = [emulated_plan(c) for c in EMULATED]
    assert {p.bn for p in plans} == {8, 16, 32, 64}
    assert {p.mi for p in plans} == {1, 2}
    assert any(p.splits > 1 for p in plans)
    assert any(p.cout_blocks > 1 for p in plans)
    assert any(p.g > 1 for p in plans)
    assert any(p.chunks * 16 > c[3] for p, c in zip(plans, EMULATED))


def _chain_sum(x, w, p, trunc):
    """The body's sum as plan ``p`` cuts Cin (x (m, 9, cin), w (9, cin,
    n)): split by split, inside one chunk by chunk, tap by tap, 8 channels
    a step: A_hi B_hi and A_hi B_lo into two f32 accumulators, then A_lo
    B_hi into the first (each rounded toward zero or to nearest), the two
    added at the end; the splits added in order in f32 by the finish
    kernel."""
    m, n = x.shape[0], w.shape[2]
    total = np.zeros((m, n), np.float32)
    for s in range(p.splits):
        hh = np.zeros((m, n), np.float32)
        hl = np.zeros((m, n), np.float32)
        for c in range(s * p.cps, min(p.chunks, (s + 1) * p.cps)):
            for t, kk in itertools.product(range(9), range(2)):
                ch = slice(c * 16 + kk * 8, c * 16 + kk * 8 + 8)
                (ah, al), (bh, bl) = split(x[:, t, ch]), split(w[t, ch])
                hh, hl = mma(hh, ah, bh, trunc), mma(hl, ah, bl, trunc)
                hh = mma(hh, al, bh, trunc)
        total = (total + (hh + hl).astype(np.float32)).astype(np.float32)
    return total


@pytest.mark.parametrize("shape,splits", [((1, 128, 128, 128, 32), 1),
                                          ((1, 16, 16, 64, 32), 2),
                                          ((1, 16, 16, 128, 32), 4)])
def test_truncating_chains_keep_f32_tolerance(shape, splits):
    """The longest chain the rule makes (cvt_5, Cin 128: 8 chunks, 72 k8
    steps, 216 truncating adds) and the split-K sums the body also takes
    (16^2 at Cin 64 and 128 forced into 2 and 4 splits) stay within
    TOL["f32"] of the f64 sum at every output, with x ~ N(0, 1) and w ~
    N(0, 1) / sqrt(K) as chip_smoke.py draws them, truncating or rounding
    to nearest; the truncating chain stays under half of the tolerance."""
    n, h, w, cin, cout = shape
    p = emulated_plan((*shape, "none", None, splits))
    rng = np.random.default_rng(cin)
    m = 2048
    x = rng.standard_normal((m, 9, cin)).astype(np.float32)
    wt = (rng.standard_normal((9, cin, 8)) / np.sqrt(9 * cin)).astype(
        np.float32)
    ref = np.einsum("mtc,tcn->mn", x.astype(np.float64),
                    wt.astype(np.float64))
    tol = TOL["atol"] + TOL["rtol"] * np.abs(ref)
    for trunc in (True, False):
        used = np.abs(_chain_sum(x, wt, p, trunc) - ref) / tol
        assert used.max() < (0.5 if trunc else 0.25), (trunc, used.max())
    if cin == 128 and h == 128:
        assert (p.splits, p.cps) == (1, tc_plan.MAX_CPS_F32)
    else:
        assert p.splits == splits


# --------------------------------------------- the op and the launch args

def test_bil_op_and_its_fake_give_the_plain_values_and_shape():
    """``torch.ops.gst.conv3x3_bil`` on the CPU is the plain version; its
    fake gives y's shape and dtype without running it; the wrapper goes
    through the op."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(5)
    x, wt, bias = (torch.from_numpy(a) for a in operands(rng, 2, 9, 7, 8, 5))
    for act, leaky in (("none", 0.0), ("relu", 0.0), ("leaky", 0.2)):
        got = torch.ops.gst.conv3x3_bil(x, wt, bias, act, leaky)
        want = conv3x3_bil_plain(x, wt, bias, relu=act == "relu",
                                 leaky=leaky if act == "leaky" else None)
        assert torch.equal(got, want)
    assert torch.equal(conv3x3_bil(x, wt, leaky=0.2),
                       conv3x3_bil_plain(x, wt, leaky=0.2))
    with FakeTensorMode() as mode:
        fx, fw = mode.from_tensor(x), mode.from_tensor(wt)
        y = torch.ops.gst.conv3x3_bil(fx, fw, None, "none", 0.0)
        assert y.shape == (2, 9, 7, 5) and y.dtype == torch.float32
        yb = torch.ops.gst.conv3x3_bil(fx.bfloat16(), fw.bfloat16(), None,
                                       "relu", 0.0)
        assert yb.dtype == torch.bfloat16


def test_kernel3_launch_args_name_the_body_and_its_workspace():
    """``_build.bil_launch_args`` hands kernel 3's C entries the rule's
    plan as int[11]: the Hopper body's (entry gst_conv3x3_bil_sm90, with a
    workspace where it splits) or, where the rule refuses, the mma.sync
    body's ``tf32_plan_c`` (no split, no workspace); cached per shape."""
    for shape in [(1, 16, 16, 64, 32), (1, 1024, 1024, 16, 16),
                  (1, 1024, 1024, 2, 32), (1, 8, 8, 32, 32)]:
        n, h, w, cin, cout = shape
        x = torch.zeros(shape[:4])
        p, c, ws = _build.bil_launch_args(x, n, h, w, cin, cout)
        assert len(c) == 11 and tuple(c) == p.args()
        assert p == tc_plan.plan_f32_body(*shape, kernel3=True)
        assert p.sm90 == (cin % 4 == 0)
        if not p.sm90:
            assert c is _build.tf32_plan_c(*shape) and p.splits == 1
        assert (ws is None) == (p.splits == 1)
        if ws is not None:
            assert ws.dtype == torch.float32
            assert ws.numel() == p.splits * n * h * w * cout
        assert _build.bil_launch_args(x, n, h, w, cin, cout)[1] is c
    view = torch.zeros(16 * 16 * 64 + 1)[1:].view(1, 16, 16, 64)
    assert not _build.bil_launch_args(view, 1, 16, 16, 64, 32)[0].sm90


def test_kernel2_f32_launch_args_take_the_rule_but_not_for_bands():
    """Kernel 2's full-image f32 calls get ``plan_f32_body``'s plan; its
    row bands and kernel 1 keep ``plan_f32``."""
    x = torch.zeros((1, 64, 64, 32))
    p, c, ws = _build.tc_launch_args(x, 1, 64, 64, 32, 32)
    assert p.sm90 and p.tf32 and tuple(c) == p.args() and ws is None
    p, _, _ = _build.tc_launch_args(x, 1, 62, 64, 32, 32, rows=True)
    assert isinstance(p, tc_plan.PlanF32)
    p, _, _ = _build.tc_launch_args(x, 1, 64, 64, 32, 32, noise=True)
    assert isinstance(p, tc_plan.PlanF32) and p.stats


@pytest.mark.parametrize("name,kernel,body", [
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<32, 1, "
     "16, 3>(gst::sm90::(anonymous namespace)::Args)", "bil_conv",
     "sm90_tf32"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, "
     "16, 8>(gst::sm90::(anonymous namespace)::Args)", "small_conv",
     "sm90_tf32"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, "
     "16, 2>(gst::sm90::(anonymous namespace)::Args)", "small_conv",
     "sm90"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<16, 4, 4, "
     "16, 3>(gst::tf32::(anonymous namespace)::Args)", "bil_conv",
     "3xtf32"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<32, 4, 2, "
     "16, 2>(gst::tf32::(anonymous namespace)::Args)", "small_conv",
     "3xtf32"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_finish_kernel<false>("
     "gst::tc::(anonymous namespace)::Args, int, int)", None, None)])
def test_traces_tell_the_f32_bodies_apart(name, kernel, body):
    """chip_smoke.py counts each traced launch by kernel and body, so the
    train step's trace shows kernel 3 on the tf32 Hopper body."""
    assert chip_smoke.kernel_of(name) == kernel
    assert chip_smoke.body_of(name) == body

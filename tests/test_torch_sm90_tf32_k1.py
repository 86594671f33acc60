"""Kernel 1's f32 (3xTF32) form of the Hopper body (entry 9 of
``csrc/conv3x3_sm90.cuh``, C entry ``gst_conv3x3_in_stats_f32_sm90`` in
``csrc/conv_in_stats_f32.cu``), checked where a CPU can check it: the rule
that picks a kernel-1 f32 call's body (``tc_plan.plan_f32_body(noise=True)``
over ``plan_tf32_in_stats``) at every kernel-1 call of the f32 generator at
ffhq, cars and bedrooms, batch 8 and 3, with the plans' own rules and their
item maps; an emulation of the body in numpy (the K-major tap layout of
``tf32_taps_kernel``, its TMA boxes under the 64-byte swizzle, the ldmatrix
rows of the halo, truncating 3xTF32 chains, the split-K finish to nearest,
the noise, bias and leaky epilogue, the statistics slots in their order)
held to ``conv3x3_noise_bias_lrelu_instats_plain`` within ``TOL["f32"]`` and
``STAT_TOL["f32"]``, and once to the Pallas kernel run in interpret mode;
the launch args and the traces.  The kernel itself runs on the card
(``chip_smoke.py``'s phase 3, ``tests/test_torch_kernels.py``'s ``cuda``
tests)."""

import dataclasses
import functools
import itertools
import re
import sys
from os.path import dirname, join

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_sm90_tf32 as t32
from gan_segmentation_tpu_torch.core.config import gan_config
from gan_segmentation_tpu_torch.kernels import _build, tc_plan
from gan_segmentation_tpu_torch.kernels.conv_in_stats import \
    conv3x3_noise_bias_lrelu_instats_plain

GANS = ("ffhq", "cars", "bedrooms")
TOL = chip_smoke.TOL["f32"]
STAT_TOL = chip_smoke.STAT_TOL["f32"]
FINISH_BN, FINISH_THREADS = 8, 256  # conv3x3_tc.cuh's split-K finish
CSRC = join(dirname(__file__), "..", "gan_segmentation_tpu_torch", "csrc")


def k1_calls():
    """(gan, batch, (n, h, w, cin, cout)) of every kernel-1 call of the f32
    generator: conv_2 of each synthesis block."""
    return [(gan, b, s) for gan in GANS for b in (8, 3)
            for s in chip_smoke.kernel1_shapes(gan_config(gan), b)]


K1_CALLS = k1_calls()


def check_plan_k1(p, n, h, w, cin, cout, rule=True):
    """Entry 9's plan keeps its own rules, TMA's and wgmma's; ``rule``: the
    rule's own choices too (taps resident only where one wave holds every
    item, within TF32_RESIDENT_ONE_BLOCK)."""
    assert p.sm90 and p.tf32 and p.noise and p.eb == 4 and not p.s8, p
    assert p.ck == 16 and not p.tma_y, p
    assert (p.bn, p.mi, p.ck) in tc_plan.TF32_K1_SM90_TILES, p
    assert p.chunks == -(-cin // 16)
    assert p.cps <= tc_plan.MAX_CPS_F32, p  # the chains' cap
    assert (p.splits - 1) * p.cps < p.chunks <= p.splits * p.cps, p
    assert p.tap_bytes == 9 * 2 * p.bn * 16 * 4
    assert p.streamed == (not p.resident)
    if rule:
        assert p.resident == (
            p.blocks <= tc_plan.NUM_SMS
            and p.cps * p.tap_bytes <= tc_plan.TF32_RESIDENT_ONE_BLOCK), p
    assert p.smem_bytes <= tc_plan.MAX_SMEM, p
    assert p.tw * p.th * p.g == p.bm == 128 * p.mi, p
    # >= 16 pixels of an image in a tile: a 16-row fragment in one image
    assert (p.th * p.tw) % 16 == 0
    assert 2 <= p.stages <= tc_plan.SM90_MAX_STAGES
    assert p.blocks < 2 ** 31
    # TMA: x's box of 64-byte pixels, the taps' (16, bn, 2, 9) of 64-byte
    # rows, the noise's (tw, th, g) of f32 rows (tw * 4 bytes, a multiple
    # of 16); every dimension 1..256; x's rows (Cin f32) and the noise's
    # (W f32) multiples of 16 bytes
    boxes = p.boxes()
    assert boxes["x"] == (16, p.tw + 2, p.th + 2, p.g)
    assert boxes["w"] == (16, p.bn, 2, 9)
    assert boxes["noise"] == (p.tw, p.th, p.g) and (p.tw * 4) % 16 == 0
    for box in (boxes["x"], boxes["w"], boxes["noise"]):
        assert all(1 <= d <= tc_plan.TMA_BOX_MAX for d in box), box
    assert (cin * 4) % 16 == 0 and (w * 4) % 16 == 0
    assert len(p.args()) == 11 and p.args()[9] == int(p.resident)
    assert p.ws_elems(n, h, w, cout) == (
        p.layout_elems(cout)
        + (p.splits * n * h * w * cout if p.splits > 1 else 0))
    assert p.layout_elems(cout) == (p.chunks * 9 * 2 * cout * 16
                                    if p.streamed else 0)


def item_counts(p, n, h, w):
    """{(image, row, column, Cout block, split): times} over the kernel's
    item and pixel maps (conv3x3_sm90.cuh::item), in numpy."""
    it = np.arange(p.blocks)
    rest, cb = np.divmod(it, p.cout_blocks)
    z, tile = np.divmod(rest, p.tiles)
    ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
    split, grp = z % p.splits, z // p.splits
    q = np.arange(p.bm)
    gi, rem = np.divmod(q, p.th * p.tw)
    nn = grp[:, None] * p.g + gi[None]
    oy = ty0[:, None] + (rem // p.tw)[None]
    ox = tx0[:, None] + (rem % p.tw)[None]
    ok = (nn < n) & (oy < h) & (ox < w)
    key = np.stack([nn, oy, ox, np.broadcast_to(cb[:, None], ok.shape),
                    np.broadcast_to(split[:, None], ok.shape)], -1)[ok]
    uniq, counts = np.unique(key, axis=0, return_counts=True)
    return uniq, counts


@pytest.mark.parametrize("case", K1_CALLS, ids=["-".join(map(str, (
    c[0], c[1], *c[2]))) for c in K1_CALLS])
def test_kernel1_f32_calls_take_the_hopper_body(case):
    """Every kernel-1 call of the f32 generator at ffhq, cars and bedrooms
    (batch 8, and 3) runs the tf32 Hopper body: TMA's rules take each
    shape, the plan keeps every rule, no chain passes 8 chunks, the tile is
    one the body builds, and the item map covers every (pixel, Cout block,
    split) exactly once."""
    _, _, (n, h, w, cin, cout) = case
    p = tc_plan.plan_f32_body(n, h, w, cin, cout, noise=True)
    assert p == tc_plan.plan_tf32_in_stats(n, h, w, cin, cout)
    check_plan_k1(p, n, h, w, cin, cout)
    # the tiles cover the images (and no tile lies wholly past them)
    assert (p.tiles_x - 1) * p.tw < w <= p.tiles_x * p.tw
    assert (p.tiles_y - 1) * p.th < h <= p.tiles_y * p.th
    assert (p.groups - 1) * p.g < n <= p.groups * p.g
    assert (p.cout_blocks - 1) * p.bn < cout <= p.cout_blocks * p.bn
    if n * h * w * p.cout_blocks * p.splits <= 1 << 20:
        uniq, counts = item_counts(p, n, h, w)
        assert len(uniq) == n * h * w * p.cout_blocks * p.splits
        assert (counts == 1).all()


def test_the_rule_names_the_plans_of_ffhq():
    """At ffhq 1024^2, batch 8: the 512-channel layers run 64-channel
    blocks with their taps streamed and 4 Cin splits at 8^2-32^2 (the chain
    cap: Cin 512 is 32 chunks), but 4^2 runs 8 splits of 32-channel blocks
    with resident taps (one wave: no layout pass); 2 splits at 64^2 256 ->
    256; 128^2-1024^2 in one chain, 256-pixel blocks, streamed."""
    got = {}
    for s in chip_smoke.kernel1_shapes(gan_config("ffhq")):
        p = tc_plan.plan_f32_body(*s, noise=True)
        got[s[1]] = (p.bn, p.mi, p.splits, p.cps, p.resident)
    assert got == {4: (32, 1, 8, 4, True), 8: (64, 1, 4, 8, False),
                   16: (64, 1, 4, 8, False), 32: (64, 2, 4, 8, False),
                   64: (64, 2, 2, 8, False), 128: (64, 2, 1, 8, False),
                   256: (64, 2, 1, 4, False), 512: (32, 2, 1, 2, False),
                   1024: (16, 2, 1, 1, False)}, got


def test_kernel1_refusals_keep_the_mma_sync_body():
    """What TMA refuses keeps the mma.sync 3xTF32 body with its statistics
    (``plan_f32(stats=True)``): Cin % 4, a ragged noise row (W % 4), an
    unaligned view; no plan of the rule passes the chain cap."""
    assert "Cin % 4" in tc_plan.tma_refuses(3, 16, True, tf32=True)
    assert "W % 4" in tc_plan.tma_refuses(16, 6, True, tf32=True)
    assert tc_plan.tma_refuses(16, 6, False, tf32=True) is None
    assert "aligned" in tc_plan.tma_refuses(16, 8, True, aligned=False,
                                            tf32=True)
    for shape, aligned in (((2, 9, 7, 3, 16), True), ((2, 5, 6, 40, 24), True),
                           ((8, 16, 16, 512, 512), False)):
        p = tc_plan.plan_f32_body(*shape, aligned=aligned, noise=True)
        assert isinstance(p, tc_plan.PlanF32) and p.stats, (shape, p)
        assert p == tc_plan.plan_f32(*shape, stats=True)
    for cin in (16, 64, 256, 512, 1024):
        p = tc_plan.plan_tf32_in_stats(1, 4, 4, cin, 64)
        assert p.cps <= tc_plan.MAX_CPS_F32
        assert p.splits >= -(-cin // (16 * tc_plan.MAX_CPS_F32))
    assert tc_plan.tf32_in_stats_plan(1, 4, 4, 512, 64, 64, 1,
                                      splits=2) is None


def test_plans_for_kernels_2_and_3_do_not_move():
    """Kernel 1's rule is its own: ``plan_f32_body`` without ``noise``
    still gives ``plan_tf32``'s plans (or ``plan_f32``'s), which never
    stream their taps."""
    for shape in [(1, 16, 16, 64, 32), (1, 1024, 1024, 16, 16),
                  (1, 4, 4, 512, 32), (8, 32, 32, 512, 512)]:
        for k3 in (True, False):
            p = tc_plan.plan_f32_body(*shape, kernel3=k3)
            want = tc_plan.plan_tf32(*shape) or tc_plan.plan_f32(
                *shape, splits=1 if k3 else None)
            assert p == want
            assert not getattr(p, "streamed", False)
            if p.sm90:
                assert p.layout_elems(shape[4]) == 0 and not p.noise


@pytest.mark.parametrize("shape", sorted(set(chip_smoke.TC_EDGES)
                                         | set(chip_smoke.F32_EDGES)),
                         ids=lambda s: "-".join(map(str, s)))
def test_kernel1_edges_take_the_rule(shape):
    """chip_smoke.py's f32 edge shapes of kernel 1 go to the body the rule
    names, each Hopper plan within its rules and its item map whole."""
    n, h, w, cin, cout = shape
    p = tc_plan.plan_f32_body(*shape, noise=True)
    takes = tc_plan.tma_refuses(cin, w, True, tf32=True) is None
    assert p.sm90 == takes, (shape, p)
    if takes:
        check_plan_k1(p, *shape)
        uniq, counts = item_counts(p, n, h, w)
        assert len(uniq) == n * h * w * p.cout_blocks * p.splits
        assert (counts == 1).all()
    else:
        assert p == tc_plan.plan_f32(*shape, stats=True)


def test_the_rule_returns_only_the_built_tiles():
    """Over a grid of shapes the rule and every variant the card's sweep
    times (``chip_smoke.tf32_k1_variants``) use only the (bn, mi, ck)
    that conv3x3_sm90.cuh's tf32_tile builds for entry 9
    (``tc_plan.TF32_K1_SM90_TILES``), and the sweep reaches all of them."""
    seen, swept = set(), set()
    for n, res, cin, cout in itertools.product(
            (1, 3, 8), (4, 8, 16, 64, 256, 1024), (16, 32, 64, 128, 512),
            (2, 16, 32, 64, 512)):
        p = tc_plan.plan_tf32_in_stats(n, res, res, cin, cout)
        if p is None:
            continue
        check_plan_k1(p, n, res, res, cin, cout)
        seen.add((p.bn, p.mi, p.ck))
        if res in (8, 64):
            for q in chip_smoke.tf32_k1_variants(p, (n, res, res, cin,
                                                     cout)):
                check_plan_k1(q, n, res, res, cin, cout, rule=False)
                swept.add((q.bn, q.mi, q.ck))
    assert seen <= tc_plan.TF32_K1_SM90_TILES
    assert swept | seen == tc_plan.TF32_K1_SM90_TILES


def test_tiles_mirror_the_header():
    """conv3x3_sm90.cuh's tf32_tile builds for kernel 9 what
    ``TF32_K1_SM90_TILES`` lists, and kernel 9 is a tf32 entry with
    statistics."""
    text = open(join(CSRC, "conv3x3_sm90.cuh")).read()
    m = re.search(r"return kernel == 9\s*\?\s*bn >= (\d+) && bn <= (\d+) && "
                  r"\(mi == 1 \|\| mi == 2\)", text)
    assert m, "tf32_tile's kernel-9 rule"
    lo, hi = int(m.group(1)), int(m.group(2))
    built = {(bn, mi, 16) for bn in (8, 16, 32, 64) if lo <= bn <= hi
             for mi in (1, 2)}
    assert built == tc_plan.TF32_K1_SM90_TILES
    assert re.search(r"is_tf32\(int k\) \{\s*return k == 3 \|\| k == 8 \|\| "
                     r"k == 9;", text)
    assert re.search(r"has_stats\(int k\) \{\s*return k == 1 \|\| k == 4 \|\| "
                     r"k == 6 \|\| k == 9;", text)


# ------------------------------------------------- the body, emulated

def k_major_taps(w):
    """csrc/conv_in_stats_f32.cu::tf32_taps_kernel: w (3, 3, Cin, Cout) f32
    -> wk (chunks * 9, 2, Cout, 16) f32: [chunk][tap][hi, lo][Cout][16],
    hi the f32 itself, lo = v - (v & 0xFFFFE000) (exact, not truncated), 0
    past Cin."""
    cin, cout = w.shape[2:]
    chunks = -(-cin // 16)
    wt = np.zeros((9, chunks * 16, cout), np.float32)
    wt[:, :cin] = w.reshape(9, cin, cout)
    v = wt.reshape(9, chunks, 16, cout).transpose(1, 0, 3, 2)
    lo = (v - t32.tf32_trunc(v)).astype(np.float32)
    return np.ascontiguousarray(np.stack([v, lo], 2).reshape(
        chunks * 9, 2, cout, 16))


MASK = np.uint32(0xFFFFE000)  # the bits of a tf32 operand the MMA reads


def test_layout_kernel_gives_the_split_the_mma_reads():
    """The layout kernel's hi and lo, in the 19 bits the MMA reads, are
    tf32_split's hi and lo (``csrc/sm90_util.cuh``) bit for bit; hi is the
    f32 itself, and its tf32 bits plus lo give it exactly; channels past
    Cin are zeros."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 3, 40, 24)) * np.float32(3.0)).astype(
        np.float32)
    w.reshape(-1)[:5] = [0.0, -0.0, 1e-30, -2.5e-39, 3.4e38]
    wk = k_major_taps(w)
    cin, cout = 40, 24
    assert wk.shape == (3 * 9, 2, cout, 16) and wk.dtype == np.float32
    wt = w.reshape(9, cin, cout)
    hi_want, lo_want = t32.split(wt)
    for chunk, tap in itertools.product(range(3), range(9)):
        ch = slice(chunk * 16, min(cin, chunk * 16 + 16))
        k = ch.stop - ch.start
        row = chunk * 9 + tap
        for part, want in ((0, hi_want), (1, lo_want)):
            got = wk[row, part][:, :k].T.view(np.uint32) & MASK
            assert np.array_equal(got, want[tap, ch].view(np.uint32))
        assert (wk[row, :, :, k:] == 0).all()
        assert np.array_equal(wk[row, 0][:, :k].T.view(np.uint32),
                              wt[tap, ch].view(np.uint32))
        exact = (t32.tf32_trunc(wk[row, 0][:, :k]).astype(np.float64)
                 + wk[row, 1][:, :k])
        assert np.array_equal(exact.T, wt[tap, ch])


def body_stats(v, ok, p, bn):
    """The body's statistics of one item (conv3x3_sm90.cuh's slots): v
    (bm, bn) the epilogue's f32 values, ok (bm,) the valid pixels ->
    (g, 2, bn) sums of v and v^2 per image of the tile.  Each thread adds
    its two rows of a 16-row fragment (its m64 tiles' in turn where the
    block holds one image), three xor-shuffles add the fragment's 8 row
    pairs (a tree over lr), one slot per (fragment, channel); an image's
    slots are added in fragment order."""
    mi, per = p.mi, p.th * p.tw
    one = p.g == 1
    v = np.where(ok[:, None], v, np.float32(0)).astype(np.float32)
    slots = {}
    for wg, wq in itertools.product(range(2), range(4)):
        for i in range(mi):
            if one and i > 0:
                break
            s1 = np.zeros((8, bn), np.float32)
            s2 = np.zeros((8, bn), np.float32)
            for k in (range(mi) if one else (i,)):
                m0 = (wg * mi + k) * 64 + wq * 16
                v0, v1 = v[m0:m0 + 8], v[m0 + 8:m0 + 16]
                s1 = (s1 + (v0 + v1)).astype(np.float32)
                s2 = (s2 + (v0 * v0 + v1 * v1)).astype(np.float32)
            for sh in (1, 2, 4):  # xor 4, 8, 16 over lanes: lr ^ 1, 2, 4
                idx = np.arange(8) ^ sh
                s1 = (s1 + s1[idx]).astype(np.float32)
                s2 = (s2 + s2[idx]).astype(np.float32)
            f = wg * 4 + wq if one else (wg * mi + i) * 4 + wq
            slots[f] = (s1[0], s2[0])
    fpi = 8 if one else per // 16
    out = np.zeros((p.g, 2, bn), np.float32)
    for gi in range(p.g):
        for f in range(gi * fpi, (gi + 1) * fpi):
            out[gi, 0] = (out[gi, 0] + slots[f][0]).astype(np.float32)
            out[gi, 1] = (out[gi, 1] + slots[f][1]).astype(np.float32)
    return out


def epilogue(acc, nz, nscale, bias, leaky):
    """v = acc + noise * nscale + bias, then the leaky relu, in f32."""
    v = (acc + (nz * nscale).astype(np.float32)).astype(np.float32)
    v = (v + bias).astype(np.float32)
    return np.where(v >= 0, v, np.float32(leaky) * v).astype(np.float32)


def finish(parts, noise, nscale, bias, p, leaky):
    """conv3x3_tc.cuh's split-K finish: the splits added in order, to
    nearest, the epilogue, y, and per (tile, image) the statistics: each of
    S segments of the tile's pixels summed in order, the segments in
    order (S = FINISH_THREADS / (g * FINISH_BN))."""
    _, n, h, wd, cout = parts.shape
    s = np.zeros(parts.shape[1:], np.float32)
    for part in parts:
        s = (s + part).astype(np.float32)
    y = epilogue(s, noise[..., None], nscale, bias, leaky)
    per = p.th * p.tw
    e = p.g * FINISH_BN
    segs = 1 if e >= FINISH_THREADS else FINISH_THREADS // e
    seg_len = -(-per // segs)
    partial = np.zeros((n, p.tiles, 2, cout), np.float32)
    for tile in range(p.tiles):
        ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
        for nn in range(n):
            tot = np.zeros((2, cout), np.float32)
            for seg in range(segs):
                acc = np.zeros((2, cout), np.float32)
                for q in range(seg * seg_len, min(per, (seg + 1) * seg_len)):
                    oy, ox = ty0 + q // p.tw, tx0 + q % p.tw
                    if oy >= h or ox >= wd:
                        continue
                    v = y[nn, oy, ox]
                    acc[0] = (acc[0] + v).astype(np.float32)
                    acc[1] = (acc[1] + v * v).astype(np.float32)
                tot = (tot + acc).astype(np.float32)
            partial[nn, tile] = tot
    return y, partial


def emulate_k1(x, w, noise, nscale, bias, p, leaky=0.2, trunc=True):
    """Entry 9 under plan ``p`` on the operands: -> (y, partial (n, tiles,
    2, Cout)).  Every A and B word the MMAs read is held to x and to
    tf32_split(w) in the bits the MMA reads, at the position the GEMM view
    gives it: B from the TMA box of the K-major layout (streamed) or the
    blocks' split (resident), both [9][hi, lo][bn][16] under the 64-byte
    swizzle; each k8 step adds A_hi [B_hi | B_lo] to the accumulators' two
    halves, then A_lo B_hi to the first, each rounded toward zero
    (``trunc``) or to nearest; the halves added to nearest; then the body's
    epilogue and slots, or the workspace and the finish kernel."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    bn, bm, mi = p.bn, p.bm, p.mi
    ps, hp, wp, per = 64, p.th + 2, p.tw + 2, p.th * p.tw
    wt = w.reshape(9, cin, cout)
    wh, wl = t32.split(wt)
    wk = k_major_taps(w) if p.streamed else None
    parts = np.zeros((p.splits, n, h, wd, cout), np.float32)
    y = np.full((n, h, wd, cout), np.nan, np.float32)
    partial = np.full((n, p.tiles, 2, cout), np.nan, np.float32)
    lanes = np.arange(32)
    frow = (lanes // 8 % 2) * 8 + lanes % 8
    fk = (lanes // 16) * 4
    xpad = np.zeros((n + p.g, h + 2 + p.th, wd + 2 + p.tw, cin + 16),
                    np.float32)
    xpad[:n, 1:h + 1, 1:wd + 1, :cin] = x
    m = np.arange(bm)
    gi, rem = np.divmod(m, per)
    ry, rx = np.divmod(rem, p.tw)
    for item in range(p.blocks):
        rest, cb = divmod(item, p.cout_blocks)
        co0 = cb * bn
        z, tile = divmod(rest, p.tiles)
        ty, tx = divmod(tile, p.tiles_x)
        ty0, tx0 = ty * p.th, tx * p.tw
        sp, n0 = z % p.splits, (z // p.splits) * p.g
        c0 = sp * p.cps
        nc = min(p.chunks - c0, p.cps)
        if p.resident:
            res = t32.split_taps(wt, co0, c0, nc, bn, p.tap_bytes)
        acc = np.zeros((bm, 2 * bn), np.float32)
        for c in range(nc):
            st = t32.Words(p.halo_bytes)
            st.tma_box(x, ((c0 + c) * 16, tx0 - 1, ty0 - 1, n0),
                       (16, wp, hp, p.g))
            if p.streamed:  # the stage's tap box, from the layout
                taps, tb = t32.Words(p.tap_bytes), 0
                taps.tma_box(wk, (0, co0, 0, (c0 + c) * 9), (16, bn, 2, 9))
            else:
                taps, tb = res, c * p.tap_bytes
            for t, kk in itertools.product(range(9), range(2)):
                a = np.zeros((bm, 8), np.uint32)
                for wg, wq, i in itertools.product(range(2), range(4),
                                                   range(mi)):
                    m0 = (wg * mi + i) * 64 + wq * 16
                    g_, r_ = np.divmod(m0 + frow, per)
                    y_, x_ = np.divmod(r_, p.tw)
                    aoff = ((g_ * hp + y_) * wp + x_) * ps + 16 * (lanes // 16)
                    byte = t32.swizzle(aoff + (t // 3) * wp * ps
                                       + (t % 3) * ps + kk * 32)
                    words = st.read(byte[:, None] + 4 * np.arange(4))
                    a[m0 + frow[:, None], fk[:, None] + np.arange(4)] = words
                ch = (c0 + c) * 16 + kk * 8 + np.arange(8)
                want = xpad[(n0 + gi)[:, None], (ty0 + ry + t // 3)[:, None],
                            (tx0 + rx + t % 3)[:, None], ch[None]]
                assert np.array_equal(a, want.view(np.uint32)), (item, c, t)
                # B through the K-major descriptor (SBO = 8 rows of 64
                # bytes; a k step 32 bytes into the row)
                r, k = np.arange(2 * bn), np.arange(8)
                byte = tb + t32.swizzle(
                    t * 2 * bn * ps + kk * 32 + (r // 8)[None] * 8 * ps
                    + (r % 8)[None] * ps + 4 * k[:, None])
                b2 = taps.read(byte)
                cc = np.minimum(ch, cin - 1)
                col = np.minimum(co0 + np.arange(bn), cout - 1)
                inside = (ch < cin)[:, None] & (co0 + np.arange(bn)
                                                < cout)[None]
                for got, ref in ((b2[:, :bn], wh), (b2[:, bn:], wl)):
                    want = np.where(inside, ref[t][cc[:, None], col[None]],
                                    np.float32(0))
                    assert np.array_equal(got & MASK, want.view(np.uint32)), (
                        item, t)
                bt = (b2 & MASK).view(np.float32)  # what the MMA reads
                ah, al = t32.split(a.view(np.float32))
                acc = t32.mma(acc, ah, bt, trunc)
                acc[:, :bn] = t32.mma(acc[:, :bn], al, bt[:, :bn], trunc)
        acc = (acc[:, :bn] + acc[:, bn:]).astype(np.float32)
        nn, oy, ox = n0 + gi, ty0 + ry, tx0 + rx
        ok = (nn < n) & (oy < h) & (ox < wd)
        cols = co0 + np.arange(bn)
        cok = cols < cout
        if p.splits > 1:
            for q in np.nonzero(ok)[0]:
                parts[sp, nn[q], oy[q], ox[q], cols[cok]] = acc[q, cok]
            continue
        nz = np.where(ok, noise[np.minimum(nn, n - 1), np.minimum(oy, h - 1),
                                np.minimum(ox, wd - 1)], np.float32(0))
        colc = np.minimum(cols, cout - 1)
        v = epilogue(acc, nz[:, None].astype(np.float32),
                     np.where(cok, nscale[colc], 0).astype(np.float32),
                     np.where(cok, bias[colc], 0).astype(np.float32), leaky)
        for q in np.nonzero(ok)[0]:
            y[nn[q], oy[q], ox[q], cols[cok]] = v[q, cok]
        sums = body_stats(v, ok, p, bn)
        for g_ in range(p.g):
            if n0 + g_ < n:
                partial[n0 + g_, tile, :, cols[cok]] = sums[g_][:, cok].T
    if p.splits > 1:
        y, partial = finish(parts, noise, nscale, bias, p, leaky)
    return y, partial


def k1_plan(case):
    """The plan of an EMULATED_K1 case: the rule's, or the tile, splits and
    taps it names."""
    shape, bn, mi, splits, resident = case
    if bn is None:
        return tc_plan.plan_tf32_in_stats(*shape)
    return tc_plan.tf32_in_stats_plan(*shape, bn, mi, splits=splits,
                                      resident=resident)


# (shape, bn, mi, splits, resident), bn None for the rule's plan: split-K
# with streamed taps over a tile of two 8^2 images (the finish kernel's
# statistics); one 16^2 image in two tiles in one chain, streamed (the
# body's slots, one slot a warp); three 4^2 images in a tile of eight, one
# chain, resident (a slot per fragment, images past N); a ragged 12 x 20
# with Cout 16 on the rule's resident plan; 256-pixel blocks of 64 channels
# streamed (a warp's two m64 tiles into one slot); a 4^2 image of Cin 512
# in 16 splits of resident 32-channel taps; Cin 40 -> 24 (a short chunk,
# masked channels) split in two
EMULATED_K1 = [((2, 8, 8, 256, 64), None, None, None, None),
               ((1, 16, 16, 64, 32), 32, 1, 1, False),
               ((3, 4, 4, 32, 32), 32, 1, 1, True),
               ((2, 12, 20, 32, 16), None, None, None, None),
               ((1, 32, 32, 64, 64), 64, 2, 1, False),
               ((1, 4, 4, 512, 32), None, None, None, None),
               ((2, 8, 8, 40, 24), 32, 1, 2, False)]


def k1_operands(rng, n, h, w, cin, cout):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    noise = rng.standard_normal((n, h, w)).astype(np.float32)
    nscale = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, wt, noise, nscale, bias


def mean_var(partial, h, w):
    """The wrapper's second pass (kernels/ops.py): the tile axis summed,
    then mean and var (not clamped), in f32."""
    sums = torch.from_numpy(partial).sum(dim=1)
    mean = sums[:, 0] / (h * w)
    return mean, sums[:, 1] / (h * w) - mean * mean


def within(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool((np.abs(got - want)
                 <= tol["atol"] + tol["rtol"] * np.abs(want)).all())


@pytest.mark.parametrize("case", EMULATED_K1,
                         ids=["-".join(map(str, (*c[0], c[3] or "rule",
                                                 "res" if c[4] else "str")))
                              for c in EMULATED_K1])
def test_emulated_k1_body_keeps_the_contract(case):
    """The body's addressing gives the MMAs x and the 3xTF32 split of w in
    the bits they read (asserted inside ``emulate_k1``), and with truncating
    chains, the finish to nearest and the slots in their order its y, mean
    and var stay within ``TOL["f32"]`` and ``STAT_TOL["f32"]`` of the plain
    version in f64."""
    shape = case[0]
    n, h, w, cin, cout = shape
    p = k1_plan(case)
    assert p is not None and p.noise and p.tf32
    check_plan_k1(p, *shape, rule=case[1] is None)
    rng = np.random.default_rng(sum(shape))
    x, wt, noise, nscale, bias = k1_operands(rng, *shape)
    y, partial = emulate_k1(x, wt, noise, nscale, bias, p)
    assert not np.isnan(y).any() and not np.isnan(partial).any()
    yr, mr, vr = conv3x3_noise_bias_lrelu_instats_plain(
        *(torch.from_numpy(a).double() for a in (x, wt, noise, nscale,
                                                 bias)))
    assert within(y, yr.numpy(), TOL), np.abs(y - yr.numpy()).max()
    mean, var = mean_var(partial, h, w)
    assert within(mean.numpy(), mr.numpy(), STAT_TOL)
    assert within(var.numpy(), vr.numpy(), STAT_TOL)
    # each tile's partial: the f64 sums of its pixels of y
    ref = yr.numpy()
    for tile in range(p.tiles):
        ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
        blk = ref[:, ty0:ty0 + p.th, tx0:tx0 + p.tw]
        want = np.stack([blk.sum((1, 2)), (blk * blk).sum((1, 2))], 1)
        assert within(partial[:, tile], want, STAT_TOL), tile


def test_emulated_cases_cover_the_body_classes():
    plans = [k1_plan(c) for c in EMULATED_K1]
    assert {p.bn for p in plans} == {16, 32, 64}
    assert {p.mi for p in plans} == {1, 2}
    assert any(p.splits > 1 and p.streamed for p in plans)
    assert any(p.splits > 1 and p.resident for p in plans)
    assert any(p.splits == 1 and p.streamed for p in plans)
    assert any(p.splits == 1 and p.resident for p in plans)
    assert any(p.splits == 1 and p.g > 1 for p in plans)     # slot a fragment
    assert any(p.splits == 1 and p.g == 1 and p.mi == 2 for p in plans)
    assert any(p.tiles_x * p.tw > c[0][2] for p, c in zip(plans, EMULATED_K1))
    assert any(p.chunks * 16 > c[0][3] for p, c in zip(plans, EMULATED_K1))


def test_emulated_repeats_are_bit_identical_and_orders_fixed():
    """The emulation is deterministic and its statistics depend on the
    plan's fixed orders only: the same call twice is bit-identical, and the
    body's slots and the finish kernel's segments, two routes to one
    partial per (image, tile), agree within STAT_TOL on the same y."""
    shape = (2, 8, 8, 64, 32)
    rng = np.random.default_rng(3)
    ops = k1_operands(rng, *shape)
    one = tc_plan.tf32_in_stats_plan(*shape, 32, 1, splits=1, resident=True)
    two = tc_plan.tf32_in_stats_plan(*shape, 32, 1, splits=2, resident=True)
    y1, p1 = emulate_k1(*ops, one)
    y1b, p1b = emulate_k1(*ops, one)
    assert np.array_equal(y1, y1b) and np.array_equal(p1, p1b)
    y2, p2 = emulate_k1(*ops, two)
    assert within(y2, y1, TOL) and within(p2, p1, STAT_TOL)


@pytest.mark.parametrize("trunc", [True, False])
def test_kernel1_chains_keep_f32_tolerance(trunc):
    """Kernel 1's longest chains (8 chunks of Cin 512, 4 splits: 32^2 at
    batch 8) added by the finish kernel to nearest stay within TOL["f32"]
    of the f64 sum, truncating (the card) or rounding to nearest, with x ~
    N(0, 1) and w ~ N(0, 1) / sqrt(K) as chip_smoke.py draws them."""
    p = tc_plan.plan_tf32_in_stats(8, 32, 32, 512, 512)
    assert (p.splits, p.cps) == (4, 8)
    rng = np.random.default_rng(512)
    m = 512
    x = rng.standard_normal((m, 9, 512)).astype(np.float32)
    wt = (rng.standard_normal((9, 512, 8)) / np.sqrt(9 * 512)).astype(
        np.float32)
    ref = np.einsum("mtc,tcn->mn", x.astype(np.float64),
                    wt.astype(np.float64))
    tol = TOL["atol"] + TOL["rtol"] * np.abs(ref)
    used = np.abs(t32._chain_sum(x, wt, p, trunc) - ref) / tol
    assert used.max() < (0.5 if trunc else 0.25), used.max()


@pytest.fixture
def pallas_in_stats(monkeypatch):
    """experiments/pallas_archive/conv_in_stats.py through the Pallas
    interpreter, as tests/test_pallas_conv.py runs it."""
    sys.path.insert(0, join(dirname(__file__), "..", "experiments",
                            "pallas_archive"))
    import conv_in_stats as m
    orig = m.pl.pallas_call
    monkeypatch.setattr(m.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    return m.conv3x3_noise_bias_lrelu_instats.__wrapped__


def test_emulated_k1_body_matches_the_pallas_kernel(pallas_in_stats):
    """One small case of the emulated body (two 16^2 images, Cin 32 -> 16,
    resident taps in one chain) against the TPU kernel itself, run in
    interpret mode: y within TOL["f32"], mean and var within
    STAT_TOL["f32"]."""
    import jax.numpy as jnp

    shape = (2, 16, 16, 32, 16)
    rng = np.random.default_rng(11)
    ops = k1_operands(rng, *shape)
    p = tc_plan.plan_tf32_in_stats(*shape)
    assert p.splits == 1 and p.resident
    y, partial = emulate_k1(*ops, p)
    mean, var = mean_var(partial, shape[1], shape[2])
    py, pm, pv = pallas_in_stats(*(jnp.asarray(a) for a in ops), tile_h=8)
    assert within(y, np.asarray(py), TOL)
    assert within(mean.numpy(), np.asarray(pm), STAT_TOL)
    assert within(var.numpy(), np.asarray(pv), STAT_TOL)


# --------------------------------------------- the launch args and traces

def test_launch_args_name_the_entry_its_workspace_and_layout():
    """``_build.tc_launch_args`` hands an f32 call of kernel 1 the rule's
    plan as int[11] with one workspace: the K-major layout where the taps
    stream, then the split-K partials; the C entry is
    ``gst_conv3x3_in_stats_f32_sm90``; an unaligned view keeps the mma.sync
    3xTF32 body's entry and its plan; the plan is cached per shape."""
    for shape in [(8, 4, 4, 512, 512), (8, 128, 128, 128, 128),
                  (8, 1024, 1024, 16, 16), (2, 8, 8, 40, 24)]:
        n, h, w, cin, cout = shape
        x = torch.zeros(shape[:4])
        p, c, ws = _build.tc_launch_args(x, n, h, w, cin, cout, noise=True)
        assert p == tc_plan.plan_tf32_in_stats(*shape)
        assert len(c) == 11 and tuple(c) == p.args()
        assert _build.entry_name("gst_conv3x3_in_stats", p) == \
            "gst_conv3x3_in_stats_f32_sm90"
        layout = p.layout_elems(cout)
        split = p.splits * n * h * w * cout if p.splits > 1 else 0
        assert layout == (p.chunks * 9 * 2 * cout * 16 if p.streamed else 0)
        if layout + split:
            assert ws.dtype == torch.float32 and ws.numel() == layout + split
        else:
            assert ws is None
        assert _build.tc_launch_args(x, n, h, w, cin, cout,
                                     noise=True)[1] is c
    p, _, ws = _build.tc_launch_args(torch.zeros((8, 8, 8, 512)), 8, 8, 8,
                                     512, 512, noise=True)
    assert p.streamed and p.splits == 4
    assert ws.numel() == 32 * 9 * 2 * 512 * 16 + 4 * 8 * 64 * 512
    view = torch.zeros(16 * 16 * 64 + 1)[1:].view(1, 16, 16, 64)
    p, c, _ = _build.tc_launch_args(view, 1, 16, 16, 64, 32, noise=True)
    assert isinstance(p, tc_plan.PlanF32) and p.stats
    assert _build.entry_name("gst_conv3x3_in_stats", p) == \
        "gst_conv3x3_in_stats"
    # kernel 2's f32 entry and the bf16 ones as before
    p, _, _ = _build.tc_launch_args(torch.zeros((1, 64, 64, 32)), 1, 64, 64,
                                    32, 32)
    assert _build.entry_name("gst_conv3x3_small", p) == \
        "gst_conv3x3_small_f32_sm90"
    p, _, _ = _build.tc_launch_args(torch.zeros((1, 64, 64, 32),
                                                dtype=torch.bfloat16),
                                    1, 64, 64, 32, 32, noise=True)
    assert _build.entry_name("gst_conv3x3_in_stats", p) == \
        "gst_conv3x3_in_stats_sm90"


@pytest.mark.parametrize("name,kernel,body", [
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<64, 2, "
     "16, 9>(gst::sm90::(anonymous namespace)::Args)", "conv_in_stats",
     "sm90_tf32"),
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, "
     "16, 1>(gst::sm90::(anonymous namespace)::Args)", "conv_in_stats",
     "sm90"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<64, 8, 2, "
     "16, 1>(gst::tf32::(anonymous namespace)::Args)", "conv_in_stats",
     "3xtf32"),
    ("void gst::(anonymous namespace)::tf32_taps_kernel(float const*, "
     "float*, int, int)", None, None),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_finish_kernel<false>("
     "gst::tc::(anonymous namespace)::Args, int, int)", None, None)])
def test_traces_tell_kernel1s_bodies_apart(name, kernel, body):
    """chip_smoke.py counts each traced launch by kernel and body: kernel
    1's f32 calls on the tf32 Hopper body (entry 9) apart from its bf16
    Hopper body and its mma.sync 3xTF32 body; the layout and finish kernels
    count for no kernel."""
    assert chip_smoke.kernel_of(name) == kernel
    assert chip_smoke.body_of(name) == body


def test_mma_sync_context_swaps_kernel1s_rule():
    """``chip_smoke.mma_sync_tf32_body`` sends kernel 1's f32 calls to the
    mma.sync 3xTF32 body too, and restores the rule after."""
    x = torch.zeros((8, 32, 32, 512))
    args = (x, 8, 32, 32, 512, 512)
    assert _build.tc_launch_args(*args, noise=True)[0].sm90
    with chip_smoke.mma_sync_tf32_body():
        p = _build.tc_launch_args(*args, noise=True)[0]
        assert isinstance(p, tc_plan.PlanF32) and p.stats
    assert _build.tc_launch_args(*args, noise=True)[0].sm90


def test_sweep_variants_change_one_thing_each():
    """``chip_smoke.tf32_k1_variants`` sets beside the rule's plan the
    other tap route, other splits within the cap, the other BN and MI:
    every variant differs from the rule and fits."""
    shape = (8, 16, 16, 512, 512)
    rule = tc_plan.plan_tf32_in_stats(*shape)
    vs = chip_smoke.tf32_k1_variants(rule, shape)
    assert vs and rule not in vs and len(set(vs)) == len(vs)
    assert any(q.splits != rule.splits for q in vs)
    assert any(q.bn != rule.bn for q in vs)
    assert any(q.mi != rule.mi for q in vs)
    assert all(q.cps <= tc_plan.MAX_CPS_F32 for q in vs)
    small = (8, 1024, 1024, 16, 16)
    vs = chip_smoke.tf32_k1_variants(tc_plan.plan_tf32_in_stats(*small),
                                     small)
    assert any(q.streamed for q in vs)
    assert dataclasses.replace(vs[0]) == vs[0]

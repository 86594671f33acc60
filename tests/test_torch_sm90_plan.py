"""The bf16 Hopper body of kernels 1 and 2 (``csrc/conv3x3_sm90.cuh``),
checked where a CPU can check it: its launch plan (``tc_plan.plan_sm90``)
and the rule that picks the body (``tc_plan.plan_bf16``) at every path and
band shape, TMA's box and stride rules and wgmma's N; and an emulation of
the body's index maps on the operands (the item walk, the halo boxes with
their zero fill, the swizzled ldmatrix rows of each tap, the tap slice
through wgmma's descriptor, the epilogue and the fixed order of the
statistics) held to the plain versions.  The kernel itself runs on the
card (``tests/test_torch_kernels.py::test_cuda_kernels_match_plain``,
``chip_smoke.py``)."""

import itertools

import numpy as np
import pytest
import torch

from gan_segmentation_tpu_torch.core.config import SolverConfig, gan_config
from gan_segmentation_tpu_torch.core.spatial import BandPlan
from gan_segmentation_tpu_torch.kernels import tc_plan
from gan_segmentation_tpu_torch.kernels.conv_in_stats import (
    conv3x3_noise_bias_lrelu_instats_plain,
    conv3x3_noise_bias_lrelu_instats_rows_plain)
from gan_segmentation_tpu_torch.kernels.small_conv import (
    conv3x3_small_plain, conv3x3_small_rows_plain)

GANS = ("ffhq", "cars", "bedrooms")


def path_shapes(gan, batch):
    """(n, h, w, cin, cout, kernel 1?) of every kernel-1 and kernel-2 call
    of ``gan``'s generate path."""
    gcfg = gan_config(gan)
    scfg = SolverConfig(max_res_log2=gcfg.max_res_log2)
    out = [(batch, 2 ** r, 2 ** r, gcfg.num_features(r),
            gcfg.num_features(r), True)
           for r in range(2, gcfg.max_res_log2 + 1)]
    f, cin = scfg.features, scfg.in_channels
    for i in range(len(cin)):
        r = 2 ** (i + 2)
        out.append((batch, r, r, cin[i], f[i], False))
        c_in = f[i] * (2 if i > 0 else 1)
        if i < len(cin) - 1:
            out += [(batch, 2 * r, 2 * r, c_in, f[i + 1], False),
                    (batch, 2 * r, 2 * r, f[i + 1], f[i + 1], False)]
        else:
            out.append((batch, r, r, c_in, f[i + 1], False))
    return out


def band_shapes(batch, n):
    """Every band of every ffhq path call over ``n`` bands."""
    bands = BandPlan.of(gan_config("ffhq"), n)
    out = set()
    for (b, h, w, cin, cout, k1) in path_shapes("ffhq", batch):
        for start, stop in bands.bounds(h) or ():
            out.add((b, stop - start, w, cin, cout, k1))
    return sorted(out)


# chip_smoke.py's TC_EDGES and test_torch_kernels.py's TC_EDGE_SHAPES
EDGES = sorted({(8, 4, 4, 512, 512), (8, 4, 4, 512, 32), (3, 12, 20, 32, 16),
                (2, 12, 20, 64, 64), (4, 64, 64, 32, 2), (2, 9, 7, 3, 16),
                (1, 64, 64, 64, 16), (1, 16, 16, 512, 512),
                (1, 4, 4, 512, 32), (8, 64, 72, 64, 64), (1, 13, 21, 512, 32),
                (3, 4, 4, 64, 64), (2, 5, 6, 40, 24), (1, 32, 32, 500, 32),
                (2, 33, 40, 32, 2)})

PATH_CASES = sorted({(gan, *s) for gan in GANS for b in (8, 2)
                     for s in path_shapes(gan, b)})
BAND_CASES = sorted({(n, *s) for n in (2, 4) for b in (8, 4)
                     for s in band_shapes(b, n)})


def check_plan(p, n, h, w, cin, cout, noise):
    """The plan's own rules and TMA's and wgmma's."""
    assert p.smem_bytes <= tc_plan.MAX_SMEM, p
    assert p.bn in (16, 32, 64, 128) and p.bn >= min(cout, 128), p
    # wgmma m64nNk16: N a multiple of 8 up to 256; a B atom of <= 64
    assert p.bn % 8 == 0 and p.bn <= 256 and p.bn % p.bna == 0
    assert p.tw * p.th * p.g == p.bm == 128 * p.mi, p
    assert (p.th * p.tw) % 16 == 0  # a 16-row fragment lies in one image
    assert (p.splits - 1) * p.cps < p.chunks <= p.splits * p.cps, p
    assert p.chunks == -(-cin // p.ck)
    assert 2 <= p.stages <= tc_plan.SM90_MAX_STAGES
    assert p.blocks < 2 ** 31
    assert p.tiles == p.tiles_x * -(-h // p.th)
    # TMA: boxes <= 256 along every dimension; a box's inner row a multiple
    # of 16 bytes and within its swizzle span (32, 64 or 128 bytes)
    elem = {"x": 2, "w": 2, "noise": 4, "y": 2}
    for name, box in p.boxes().items():
        assert all(1 <= d <= tc_plan.TMA_BOX_MAX for d in box), (name, box)
        inner = box[0] * elem[name]
        assert inner % 16 == 0, (name, box)
        if name != "noise":
            assert inner in (32, 64, 128), (name, box)
    # global strides multiples of 16 bytes: x's rows always; w's and y's
    # where they go through TMA; the noise's where kernel 1 loads it
    assert (cin * 2) % 16 == 0
    if not p.resident:
        assert (cout * 2) % 16 == 0
    if p.tma_y:
        assert (cout * 2) % 16 == 0 and p.splits == 1
    if noise and p.splits == 1:
        assert (w * 4) % 16 == 0
    if p.resident:
        assert p.cout_blocks == 1 and p.splits == 1
        assert p.chunks * p.tap_bytes <= tc_plan.SM90_RESIDENT_MAX
    # the ring keeps ~24 KB a block in flight unless shared memory forbids
    if p.stages < tc_plan.SM90_MAX_STAGES:
        assert ((p.stages - 1) * p.stage_load_bytes
                < tc_plan.SM90_INFLIGHT + p.stage_load_bytes)


@pytest.mark.parametrize("case", PATH_CASES,
                         ids=["-".join(map(str, c)) for c in PATH_CASES])
def test_sm90_plan_takes_every_path_shape(case):
    """ffhq, cars and bedrooms at the generate batch 8 and the annotation
    run's 2: the rule picks the Hopper body and its plan keeps every rule."""
    _, n, h, w, cin, cout, noise = case
    p = tc_plan.plan_bf16(n, h, w, cin, cout, noise)
    assert p.sm90, case
    check_plan(p, n, h, w, cin, cout, noise)


@pytest.mark.parametrize("case", BAND_CASES,
                         ids=["-".join(map(str, c)) for c in BAND_CASES])
def test_sm90_plan_takes_every_band_shape(case):
    """Every band of the ffhq path at N = 2 and 4 (a batch of 8, and 4 on
    a 2 x 2 grid's rows), planned for the band's output rows."""
    _, n, h, w, cin, cout, noise = case
    p = tc_plan.plan_bf16(n, h, w, cin, cout, noise)
    assert p.sm90, case
    check_plan(p, n, h, w, cin, cout, noise)


@pytest.mark.parametrize("shape", EDGES,
                         ids=["-".join(map(str, s)) for s in EDGES])
@pytest.mark.parametrize("noise", [False, True])
def test_sm90_plan_at_the_edges(shape, noise):
    """The tensor-core edge shapes: the Hopper body where TMA's rules take
    them, else the mma.sync body, for a reason the rule names."""
    n, h, w, cin, cout = shape
    p = tc_plan.plan_bf16(n, h, w, cin, cout, noise)
    refused = tc_plan.tma_refuses(cin, w, noise)
    assert p.sm90 == (refused is None), (shape, refused)
    if p.sm90:
        check_plan(p, n, h, w, cin, cout, noise)
    else:
        assert p.smem_bytes <= tc_plan.MAX_SMEM
    # an unaligned view always keeps the mma.sync body
    assert not tc_plan.plan_bf16(n, h, w, cin, cout, noise,
                                 aligned=False).sm90


def test_the_rule_picks_the_wide_tiles():
    """Cout >= 128 runs wgmma n128 (two atoms), 32^2 x 512 in 256-pixel
    blocks (one wave of 128 items), the Cin-512 layers at 4^2-16^2 split K,
    and the narrow 1024^2 layers keep >= 24 KB a block in flight."""
    p = tc_plan.plan_sm90(8, 32, 32, 512, 512, True)
    assert (p.bn, p.mi, p.splits, p.blocks) == (128, 2, 1, 128)
    for res in (4, 8, 16):
        assert tc_plan.plan_sm90(8, res, res, 512, 512, True).splits > 1
    p = tc_plan.plan_sm90(8, 1024, 1024, 16, 16, True)
    assert p.resident and p.tma_y and p.bn == 16
    assert (p.stages - 1) * p.stage_load_bytes >= tc_plan.SM90_INFLIGHT
    p = tc_plan.plan_sm90(8, 1024, 1024, 32, 2)
    assert p.resident and not p.tma_y and p.bn == 16


# ------------------------------------------------- the body, emulated
# Shared memory as 16-byte units of 8 values; TMA's swizzle and the
# kernel's index maps in numpy, the products in float64 (bf16 x bf16 is
# exact in f32, so the card's sums differ from these by f32 rounding only).

def swizzle(off, mask):
    """conv3x3_sm90.cuh's swizzle(): 16-byte chunk bits [4, 7) xor address
    bits [7, 10), TMA's 32 B / 64 B / 128 B modes for mask 1 / 3 / 7."""
    return off ^ (((off >> 7) & mask) << 4)


def row_mask(row_bytes):
    return {128: 7, 64: 3, 32: 1}[row_bytes]


class Smem:
    def __init__(self, nbytes):
        self.units = np.full((nbytes // 16, 8), np.nan)

    def tma_box(self, base, t, start, box, row_bytes):
        """A TMA load of ``t`` (dims outermost first; ``start`` and ``box``
        innermost first) to ``base``: zero fill outside, dense rows of the
        inner dimension, swizzled by ``row_bytes``."""
        full = np.zeros(tuple(reversed(box)))
        src, dst = [], []
        for d, (s, b) in enumerate(zip(reversed(start), reversed(box))):
            lo, hi = max(s, 0), min(s + b, t.shape[d])
            src.append(slice(lo, max(lo, hi)))
            dst.append(slice(lo - s, lo - s + max(0, hi - lo)))
        full[tuple(dst)] = t[tuple(src)]
        flat = full.reshape(-1, 8)  # 16-byte units of 8 bf16
        for u, vals in enumerate(flat):
            self.units[(base + swizzle(u * 16, row_mask(row_bytes))) // 16] = \
                vals

    def unit(self, addr):
        assert addr % 16 == 0
        return self.units[addr // 16]


def emulate(x, w, noise, nscale, bias, act, p, rows):
    """The Hopper body on float64 copies of the operands: -> (v before the
    bf16 rounding (N, H, W, Cout), kernel 1's partials (N, tiles, 2, Cout)
    or None)."""
    n, h_in, wd, cin = x.shape
    h = h_in - 2 if rows else h_in
    cout = w.shape[3]
    ck, bn, bna, bm, mi = p.ck, p.bn, p.bna, p.bm, p.mi
    rb, ps = bna * 2, ck * 2
    xsw = row_mask(ps)
    atom = 9 * ck * rb
    wt = w.reshape(9, cin, cout)
    hp, wp, per = p.th + 2, p.tw + 2, p.th * p.tw
    stats = noise is not None
    acc_ws = np.zeros((p.splits, n, h, wd, cout))
    v_out = np.full((n, h, wd, cout), np.nan)
    partial = np.full((n, p.tiles, 2, cout), np.nan) if stats else None
    # this lane's ldmatrix row (conv3x3_sm90.cuh: aoff), per (wg, wq, i)
    lanes = np.arange(32)
    lrow = lanes % 8 + 8 * ((lanes // 8) % 2)
    items = p.blocks
    hits = np.zeros((n, h, wd, cout), int)
    for item in range(items):
        rest, cb = divmod(item, p.cout_blocks)
        co0 = cb * bn
        z, tile = divmod(rest, p.tiles)
        ty, tx = divmod(tile, p.tiles_x)
        ty0, tx0 = ty * p.th, tx * p.tw
        split, n0 = z % p.splits, (z // p.splits) * p.g
        c0 = split * p.cps
        nc = min(p.chunks - c0, p.cps)
        acc = np.zeros((bm, bn))
        for c in range(c0, c0 + nc):
            sm = Smem(p.halo_bytes + 9 * ck * bn * 2 + 4096)
            sm.tma_box(0, x, (c * ck, tx0 - 1, ty0 if rows else ty0 - 1, n0),
                       (ck, wp, hp, p.g), ps)
            tb = -(-p.halo_bytes // 1024) * 1024
            if p.resident:  # the kernel's own stores (res + swizzle(off))
                for tap, ci, o in itertools.product(range(9), range(ck),
                                                    range(0, bn, 8)):
                    cc = c * ck + ci
                    vals = np.zeros(8)
                    if cc < cin:
                        seg = wt[tap, cc, o:o + 8]
                        vals[:len(seg)] = seg
                    off = (o // bna) * atom + (tap * ck + ci) * rb + \
                        (o % bna) * 2
                    sm.units[(tb + swizzle(off, row_mask(rb))) // 16] = vals
            else:
                for a in range(bn // bna):
                    sm.tma_box(tb + a * atom, wt,
                               (co0 + a * bna, c * ck, 0), (bna, ck, 9), rb)
            for wg, wq, i in itertools.product(range(2), range(4), range(mi)):
                m = (wg * mi + i) * 64 + wq * 16 + lrow
                gi, rem = np.divmod(m, per)
                ty_, tx_ = np.divmod(rem, p.tw)
                aoff = ((gi * hp + ty_) * wp + tx_) * ps + 16 * (lanes // 16)
                for tap, kk in itertools.product(range(9), range(ck // 16)):
                    toff = (tap // 3) * wp * ps + (tap % 3) * ps
                    a_frag = np.zeros((16, 16))
                    for ln in range(32):  # ldmatrix.x4: one row a lane
                        addr = swizzle(int(aoff[ln]) + toff + kk * 32, xsw)
                        k8 = 8 * (ln // 16)
                        a_frag[lrow[ln], k8:k8 + 8] = sm.unit(addr)
                    # B [16 x bn] through the descriptor: N-major, atoms at
                    # LBO = 9 * ck * rb, k groups of 8 rows at SBO = 8 * rb
                    start = tb + (tap * ck + kk * 16) * rb
                    b_frag = np.zeros((16, bn))
                    for k, o in itertools.product(range(16), range(0, bn, 8)):
                        byte = (start + (o // bna) * atom + (k // 8) * 8 * rb
                                + (k % 8) * rb + (o % bna) * 2)
                        b_frag[k, o:o + 8] = sm.unit(
                            swizzle(byte, row_mask(rb)))
                    rows_m = (wg * mi + i) * 64 + wq * 16 + np.arange(16)
                    acc[rows_m] += a_frag @ b_frag
        # the tile's pixels (M order: image, row, column)
        m = np.arange(bm)
        gi, rem = np.divmod(m, per)
        ry, rx = np.divmod(rem, p.tw)
        nn, oy, ox = n0 + gi, ty0 + ry, tx0 + rx
        ok = (nn < n) & (oy < h) & (ox < wd)
        cols = co0 + np.arange(bn)
        cok = cols < cout
        for q in np.nonzero(ok)[0]:
            hits[nn[q], oy[q], ox[q], cols[cok]] += 1
        if p.splits > 1:
            for q in np.nonzero(ok)[0]:
                acc_ws[split, nn[q], oy[q], ox[q], cols[cok]] = acc[q, cok]
            continue
        v = epilogue(acc, noise, nscale, bias, act, nn, oy, ox, ok, cols,
                     cok, stats)
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
    assert (hits == (p.splits if p.splits > 1 else 1)).all(), \
        "every output element once per split"
    if p.splits > 1:  # the finish kernel: splits added in order
        acc = np.zeros((n, h, wd, cout), np.float32)
        for sp in range(p.splits):
            acc = acc + acc_ws[sp].astype(np.float32)
        v_out = epilogue_full(acc, noise, nscale, bias, act)
        if stats:
            partial = None  # the finish kernel's own segment order
    return v_out, partial


def apply_act(v, act):
    if act == "relu":
        return np.maximum(v, 0)
    if act == "leaky":
        return np.where(v >= 0, v, 0.2 * v)
    return v


def epilogue(acc, noise, nscale, bias, act, nn, oy, ox, ok, cols, cok,
             stats):
    v = acc.copy()
    if stats:
        nz = np.zeros(len(nn))
        nz[ok] = noise[nn[ok], oy[ok], ox[ok]]
        v = v + nz[:, None] * np.where(cok, nscale[np.minimum(
            cols, len(nscale) - 1)], 0)
    if bias is not None:
        v = v + np.where(cok, bias[np.minimum(cols, len(bias) - 1)], 0)
    return apply_act(v, act)


def epilogue_full(acc, noise, nscale, bias, act):
    v = acc.astype(np.float64)
    if noise is not None:
        v = v + noise[..., None] * nscale
    if bias is not None:
        v = v + bias
    return apply_act(v, act)


def stat_slots(v, ok, mi, one):
    """The statistics' slots in the kernel's order and in f32: a lane adds
    its rows r and r + 8 of each m64 tile (``one``: every tile of its warp,
    tile by tile, into one sum), then three xor-shuffles (lanes 4, 8, 16
    apart: row pairs 1, 2, 4 apart).  ``one`` (the block holds one image):
    a slot per warp, (warpgroup, warp) order; else a slot per 16-row
    fragment, M order."""
    v32 = np.where(ok[:, None], v, 0).astype(np.float32)
    rows = v32.reshape(2, mi, 4, 16, v.shape[1])  # wg, tile, warp, row
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


def bf16_values(rng, shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(
        torch.bfloat16).double().numpy()


# (n, h_out, w, cin, cout, kernel 1?, row band?, act): ragged tiles, a tile
# of images (g > 1) with images past N, split-K with 128-channel atoms
# through TMA, Cout 2 and 24 (masked channels, stores from registers),
# resident taps of two chunks, row bands
EMULATED = [(2, 12, 20, 32, 16, True, False, "leaky"),
            (3, 8, 8, 32, 24, False, False, "relu"),
            (8, 4, 4, 64, 128, True, False, "leaky"),
            (2, 16, 16, 16, 2, False, False, "none"),
            (1, 16, 32, 64, 64, True, False, "leaky"),
            (2, 5, 16, 16, 32, True, True, "leaky"),
            (3, 2, 8, 32, 16, False, True, "leaky")]


@pytest.mark.parametrize("case", EMULATED,
                         ids=["-".join(map(str, c)) for c in EMULATED])
def test_emulated_body_matches_plain(case):
    n, h, w, cin, cout, k1, rows, act = case
    rng = np.random.default_rng(sum(case[:5]))
    x = bf16_values(rng, (n, h + 2 if rows else h, w, cin))
    wt = bf16_values(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    noise = rng.standard_normal((n, h, w)).astype(np.float32) if k1 else None
    nscale = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    p = tc_plan.plan_sm90(n, h, w, cin, cout, k1)
    assert p is not None
    v, partial = emulate(x, wt, noise, nscale, bias, act, p, rows)
    tx, tw_ = torch.from_numpy(x).float(), torch.from_numpy(wt).float()
    tb = torch.from_numpy(bias)
    if k1:
        args = (tx, tw_, torch.from_numpy(noise), torch.from_numpy(nscale),
                tb)
        if rows:
            y, s1, s2 = conv3x3_noise_bias_lrelu_instats_rows_plain(*args)
        else:
            y, mean, var = conv3x3_noise_bias_lrelu_instats_plain(*args)
            s1, s2 = mean * h * w, (var + mean * mean) * h * w
    else:
        kw = dict(relu=act == "relu",
                  leaky=0.2 if act == "leaky" else None)
        fn = conv3x3_small_rows_plain if rows else conv3x3_small_plain
        y = fn(tx, tw_, tb, **kw)
    np.testing.assert_allclose(v, y.double().numpy(), rtol=1e-5, atol=1e-5)
    if k1 and partial is not None:
        sums = partial.astype(np.float64).sum(axis=1)  # the tile axis
        np.testing.assert_allclose(sums[:, 0], s1.double().numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(sums[:, 1], s2.double().numpy(),
                                   rtol=1e-4, atol=1e-4)
        # the same operands give the same slots: the order is fixed
        again = emulate(x, wt, noise, nscale, bias, act, p, rows)[1]
        assert np.array_equal(partial, again)


@pytest.mark.parametrize("ck", [16, 32])
@pytest.mark.parametrize("tw", [16, 8, 4])
def test_ldmatrix_rows_fall_in_distinct_bank_groups(ck, tw):
    """The 8 row addresses of every ldmatrix of every tap (each lane's
    swizzled halo address) fall in 8 distinct 16-byte bank groups where a
    tile row holds 8 or 16 pixels (every layer from 8^2 up); with 4-pixel
    rows (4^2 images) a group takes at most 2 rows."""
    ps = ck * 2
    mask = row_mask(ps)
    for mi in (1, 2):
        bm = 128 * mi
        th = max(16 // tw, 4 if tw == 4 else 1)
        th = min(bm // tw, th if tw == 4 else bm // tw)
        g = bm // (tw * th)
        wp = tw + 2
        lanes = np.arange(32)
        lrow = lanes % 8 + 8 * ((lanes // 8) % 2)
        for wg, wq, i in itertools.product(range(2), range(4), range(mi)):
            m = (wg * mi + i) * 64 + wq * 16 + lrow
            gi, rem = np.divmod(m, th * tw)
            ty, tx = np.divmod(rem, tw)
            aoff = ((gi * (th + 2) + ty) * wp + tx) * ps + 16 * (lanes // 16)
            for tap, kk in itertools.product(range(9), range(ck // 16)):
                toff = (tap // 3) * wp * ps + (tap % 3) * ps + kk * 32
                addr = np.array([swizzle(int(a) + toff, mask) for a in aoff])
                for j in range(4):  # the x4's matrices: lanes 8j..8j+7
                    banks = (addr[8 * j:8 * j + 8] // 16) % 8
                    worst = np.bincount(banks, minlength=8).max()
                    assert worst <= (2 if tw == 4 else 1), (
                        ck, tw, g, tap, kk, j, banks)


@pytest.mark.parametrize("name,body", [
    ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<128, 2, 16, "
     "1>(gst::sm90::(anonymous namespace)::Args)", "sm90"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_kernel<64, 8, 32, 1>("
     "gst::tc::(anonymous namespace)::Args)", "mma_sync"),
    ("void gst::tf32::(anonymous namespace)::conv3x3_tf32_kernel<32, 8, 2, "
     "16, 2>(gst::tf32::(anonymous namespace)::Args)", "3xtf32"),
    ("void gst::tc::(anonymous namespace)::conv3x3_tc_finish_kernel<false>("
     "gst::tc::(anonymous namespace)::Args, int, int)", None)])
def test_traces_tell_the_bodies_apart(name, body):
    """chip_smoke.py counts each traced launch of kernels 1 and 2 by body,
    so its kernels line shows the Hopper body's launches on every path."""
    import chip_smoke
    assert chip_smoke.body_of(name) == body

"""The f32 calls of kernels 1 and 2 on the 3xTF32 tensor-core body
(``csrc/conv3x3_tf32.cuh``), checked where a CPU can check them: the launch
plan (``tc_plan.plan_f32``) with its split-K and its statistics slots at
every f32 shape of the generate, train and evaluate paths and at the split's
edge shapes; what the wrappers hand to the C entry points; the routing in
the sources; and the numerics of the split-K sum and of the statistics,
emulated on the operands.  The kernels themselves run on the card
(``tests/test_torch_kernels.py::test_cuda_kernels_match_plain`` and
``chip_smoke.py``)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gan_segmentation_tpu_torch.core.config import SolverConfig, gan_config
from gan_segmentation_tpu_torch.kernels import _build, tc_plan

CSRC = Path(tc_plan.__file__).parents[1] / "csrc"
TOL = dict(atol=1e-4, rtol=1e-4)        # chip_smoke.py's TOL["f32"]


def _kernel1_shapes(batch, gan="ffhq"):
    """conv_2 of every synthesis block of the generator of ``gan``."""
    gcfg = gan_config(gan)
    return [(batch, 2 ** r, 2 ** r, gcfg.num_features(r), gcfg.num_features(r))
            for r in range(2, gcfg.max_res_log2 + 1)]


def _kernel2_shapes(batch, gan="ffhq"):
    """Every 3x3 conv of the decoder of ``gan`` (ffhq evaluate: all 26 at
    batch 1)."""
    scfg = SolverConfig(max_res_log2=gan_config(gan).max_res_log2)
    f, cin = scfg.features, scfg.in_channels
    last = len(cin) - 1
    out = []
    for i in range(last + 1):
        r = 2 ** (i + 2)
        out.append((batch, r, r, cin[i], f[i]))
        c_in = f[i] * (2 if i > 0 else 1)
        if i < last:
            out += [(batch, 2 * r, 2 * r, c_in, f[i + 1]),
                    (batch, 2 * r, 2 * r, f[i + 1], f[i + 1])]
        else:
            out.append((batch, r, r, c_in, f[i + 1]))
    return out


# split-K edges: one 4^2 image of Cin 512 (one item, 32 chunks), 512 -> 512
# at batch 1 and 8, a ragged 13 x 21 with a split, Cin 3 (scalar staging,
# one chunk), a tile of eight 4^2 images with three present, Cin 40 -> Cout
# 24 (masked channels, a short last split), 2^2 images (tile rows raised
# to keep 16 pixels per image)
SPLIT_EDGES = [(1, 4, 4, 512, 32), (1, 16, 16, 512, 512), (8, 4, 4, 512, 512),
               (1, 13, 21, 512, 32), (2, 9, 7, 3, 16), (3, 4, 4, 64, 64),
               (2, 5, 6, 40, 24), (2, 2, 2, 8, 8), (1, 32, 32, 500, 32)]

CASES = ([(s, False) for s in _kernel2_shapes(1) + _kernel2_shapes(8)]
         + [(s, True) for s in _kernel1_shapes(8) + _kernel1_shapes(1)]
         + [(s, st) for s in SPLIT_EDGES for st in (False, True)])
# cars 512^2 and bedrooms 256^2: their generators' shapes are ffhq's first
# 8 and 7, their decoders' all but the tail (64 -> 2 at 512^2 and 256^2)
CASES += [c for gan in ("cars", "bedrooms") for b in (1, 8)
          for c in ([(s, False) for s in _kernel2_shapes(b, gan)]
                    + [(s, True) for s in _kernel1_shapes(b, gan)])
          if c not in CASES]
# batch 2, the annotation run's gan_batch_size
CASES += [c for c in ([(s, False) for s in _kernel2_shapes(2)]
                      + [(s, True) for s in _kernel1_shapes(2)])
          if c not in CASES]


def test_the_paths_give_26_and_9_shapes():
    assert len(_kernel2_shapes(1)) == 26 and len(_kernel1_shapes(8)) == 9
    assert _kernel1_shapes(8)[0] == (8, 4, 4, 512, 512)
    assert _kernel1_shapes(8)[-1] == (8, 1024, 1024, 16, 16)
    assert _kernel2_shapes(1)[0] == (1, 4, 4, 512, 32)
    assert _kernel2_shapes(8, "cars")[-1] == (8, 512, 512, 64, 2)
    assert _kernel2_shapes(8, "bedrooms")[-1] == (8, 256, 256, 64, 2)
    assert ((8, 512, 512, 64, 2), False) in CASES
    assert ((1, 256, 256, 64, 2), False) in CASES


def _items(p):
    """(tile, Cout block, image group, split) of every item, in the
    kernel's order (conv3x3_tf32.cuh::item)."""
    for it in range(p.blocks):
        rest, cb = divmod(it, p.cout_blocks)
        z, tile = divmod(rest, p.tiles)
        grp, split = divmod(z, p.splits)
        yield tile, cb, grp, split


def _pixels(p, tile, grp, n, h, w):
    """(tile pixel q, image, row, column) of the item's pixels inside the
    tensor (conv3x3_tf32.cuh::pixel)."""
    ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
    for q in range(p.bm):
        gi, rem = divmod(q, p.th * p.tw)
        nn, oy, ox = grp * p.g + gi, ty0 + rem // p.tw, tx0 + rem % p.tw
        if nn < n and oy < h and ox < w:
            yield q, nn, oy, ox


@pytest.mark.parametrize("shape,stats", CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else ("k1" if v else "k2"))
def test_plan_f32_of_kernels_1_and_2(shape, stats):
    """Fits a block's 227 KB; a tile the header instantiates; every Cin
    chunk in exactly one split and no split empty; the workspace sized for
    the splits; and, where the tensor is small enough to walk, every output
    written exactly once per split and every pixel counted in exactly one
    (image, tile) partial, through a statistics slot of its own image."""
    n, h, w, cin, cout = shape
    p = tc_plan.plan_f32(n, h, w, cin, cout, stats=stats)
    assert p.stats == stats and p.smem_bytes <= tc_plan.MAX_SMEM, p
    assert p.bn in (8, 16, 32, 64) and p.bn >= min(cout, 64), p
    assert (p.wm, p.mi) in ((4, 2), (4, 4), (8, 2)), p
    assert p.mi == 2 or p.bn <= 16
    assert p.tw * p.th * p.g == p.bm == 16 * p.mi * p.wm, p
    assert p.ck in (8, 16) and (p.chunks - 1) * p.ck < cin <= p.chunks * p.ck
    assert p.stages in (2, 3)
    assert p.cout_blocks * p.bn >= cout > (p.cout_blocks - 1) * p.bn
    # the split: chunk c belongs to split c // cps, the last split not empty
    assert p.splits >= 1 and p.cps >= 1
    assert (p.splits - 1) * p.cps < p.chunks <= p.splits * p.cps, p
    owners = [c // p.cps for c in range(p.chunks)]
    assert sorted(set(owners)) == list(range(p.splits))
    assert not p.resident or (p.cout_blocks == 1 and p.splits == 1)
    assert p.ws_elems(n, h, w, cout) == (
        p.splits * n * h * w * cout if p.splits > 1 else 0)
    assert len(p.args()) == 11 and p.args()[9:] == (p.splits, p.cps)
    assert p.blocks < 2 ** 31 and p.groups <= 65535
    assert -(-cout // 8) <= 65535            # the finish kernel's grid
    # a split only where the items alone leave SMs idle or one chain would
    # be longer than MAX_CPS_F32 chunks; never below MIN_CPS_F32 chunks
    assert p.cps <= tc_plan.MAX_CPS_F32, p
    if p.splits > 1:
        assert (p.blocks // p.splits < tc_plan.NUM_SMS
                or p.chunks > tc_plan.MAX_CPS_F32)
        assert p.cps >= tc_plan.MIN_CPS_F32
    per = p.th * p.tw
    if stats:
        assert per % 16 == 0, p              # an m16 fragment in one image
        warp_px = 16 * p.mi
        uniform = per % warp_px == 0
        assert p.stat_slots == (p.wm if uniform else p.wm * p.mi)
    if n * h * w > 1 << 14:
        return
    written, counted = {}, {}
    for tile, cb, grp, split in _items(p):
        assert tile < p.tiles
        for q, nn, oy, ox in _pixels(p, tile, grp, n, h, w):
            key = (nn, oy, ox, cb, split)
            written[key] = written.get(key, 0) + 1
            if stats and cb == 0 and split == 0:
                # the slot the pixel's sums go to, and the image whose
                # partial adds that slot (conv3x3_tf32.cuh's epilogue)
                slot_px = warp_px if uniform else 16
                slot, spi = q // slot_px, per // slot_px
                assert grp * p.g + slot // spi == nn
                assert slot < p.stat_slots
                counted.setdefault((nn, oy, ox), []).append((nn, tile))
    assert len(written) == n * h * w * p.cout_blocks * p.splits
    assert set(written.values()) == {1}
    if stats:
        assert len(counted) == n * h * w
        assert all(len(v) == 1 for v in counted.values())


def test_plan_f32_splits_where_the_design_says():
    """cvt_0..3 at batch 1 and kernel 1's 512 -> 512 at 4^2 split K to fill
    the card; Cin 512 / 256 layers that do fill it split into chains of 8
    chunks; layers of up to 128 input channels that fill the card do not
    split; kernel 3's plans never do."""
    for res in (4, 8, 16, 32):
        assert tc_plan.plan_f32(1, res, res, 512, 32).splits == 16
    assert tc_plan.plan_f32(8, 4, 4, 512, 512, stats=True).splits == 16
    for shape, splits in [((8, 32, 32, 512, 512), 4),
                          ((8, 64, 64, 256, 256), 2)]:
        p = tc_plan.plan_f32(*shape, stats=True)
        assert (p.splits, p.cps) == (splits, 8)
    for shape in [(8, 128, 128, 128, 128), (8, 1024, 1024, 16, 16),
                  (1, 1024, 1024, 64, 16), (1, 128, 128, 128, 32)]:
        assert tc_plan.plan_f32(*shape, stats=True).splits == 1
    assert tc_plan.plan_f32(1, 4, 4, 512, 32, splits=1).splits == 1
    assert tc_plan.plan_f32(1, 4, 4, 512, 32, splits=4).args()[9:] == (4, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_get_a_plan_and_a_workspace_in_both_dtypes(dtype):
    """``tc_launch_args`` serves every body: for bf16 int[11] from
    ``plan_sm90`` (the Hopper body, ``plan_bf16``'s rule) and, for a view
    TMA refuses, int[9] from ``plan``; int[11] for f32 from
    ``plan_f32_body``: ``plan_f32`` for kernel 2 at Cin 512, kernel 1's
    Hopper plan (``plan_tf32_in_stats``, its taps resident here); the
    workspace sized by the plan's split, the plan cached per shape."""
    n, h, w, cin, cout = 1, 4, 4, 512, 32
    x = torch.zeros((n, h, w, cin), dtype=dtype)
    for noise in (False, True):
        p, c, ws = _build.tc_launch_args(x, n, h, w, cin, cout, noise=noise)
        assert isinstance(c, ctypes.Array) and tuple(c) == p.args()
        if dtype == torch.float32:
            assert len(c) == 11 and p == tc_plan.plan_f32_body(
                n, h, w, cin, cout, noise=noise)
            if noise:
                assert p == tc_plan.plan_tf32_in_stats(n, h, w, cin, cout)
                assert p.resident and p.layout_elems(cout) == 0
            else:
                assert p == tc_plan.plan_f32(n, h, w, cin, cout)
        else:
            assert len(c) == 11 and isinstance(p, tc_plan.PlanSM90)
            assert p == tc_plan.plan_sm90(n, h, w, cin, cout, noise)
        assert p.splits > 1 and ws.dtype == torch.float32
        assert ws.numel() == p.splits * n * h * w * cout
        assert _build.tc_launch_args(x, n, h, w, cin, cout,
                                     noise=noise)[1] is c
    if dtype == torch.bfloat16:  # a view 2 bytes off 16: the mma.sync body
        view = torch.zeros(n * h * w * cin + 1, dtype=dtype)[1:].view(
            n, h, w, cin)
        p, c, _ = _build.tc_launch_args(view, n, h, w, cin, cout)
        assert len(c) == 9 and isinstance(p, tc_plan.Plan)
    x = torch.zeros((8, 64, 64, 16), dtype=dtype)
    assert _build.tc_launch_args(x, 8, 64, 64, 16, 16)[2] is None


def test_f32_of_kernels_1_and_2_runs_no_ffma_body():
    """small_conv.cu and conv_in_stats.cu hold no kernel of their own any
    more: f32 goes to conv3x3_tf32.cuh (kernel 1 with its statistics
    epilogue), bf16 to conv3x3_tc.cuh, anything else is refused; the FFMA
    core serves kernel 3's bf16 body alone."""
    for name, k in (("small_conv.cu", 2), ("conv_in_stats.cu", 1)):
        text = (CSRC / name).read_text()
        code = re.sub(r"//.*", "", text)
        assert "__global__" not in code and "conv3x3_accumulate" not in code
        assert "dispatch_ct" not in code and "num_tiles" not in code
        assert code.count(f"gst::tf32::run<{k}>(") == 1
        assert code.count(f"gst::tc::run<{k}>(") == 1
        assert "return (int)cudaErrorInvalidValue;" in code
    assert "conv3x3_accumulate" in (CSRC / "bil_conv.cu").read_text()
    wrappers = Path(tc_plan.__file__).parent
    for name in ("small_conv.py", "conv_in_stats.py", "_build.py"):
        assert "num_tiles" not in (wrappers / name).read_text()


# ---------------------------------------------------------------- numerics

def _tf32_trunc(v):
    bits = torch.from_numpy(np.ascontiguousarray(v, np.float32)).view(
        torch.int32)
    return (bits & -8192).view(torch.float32).numpy()


def _split(v):
    hi = _tf32_trunc(v)
    return hi, _tf32_trunc((v - hi).astype(np.float32))


def _toward_zero(v):
    """f64 -> f32 rounded toward zero, as the tensor cores round their f32
    accumulator."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma_sum(x, w, toward_zero=False):
    """The kernel's 3xTF32 sum over K, one m16n8k8 step (8 of k) at a time:
    lo*hi, hi*lo, hi*hi, each step's exact terms added to the f32
    accumulator with one rounding (tests/test_torch_bil_tc.py): to nearest,
    or toward zero as measured on the card."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], 8):
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            step = acc.astype(np.float64) + a[:, k0:k0 + 8].astype(
                np.float64) @ b[k0:k0 + 8].astype(np.float64)
            acc = _toward_zero(step) if toward_zero else step.astype(
                np.float32)
    return acc


def _split_sum(x, w, p, toward_zero):
    """Split by split as plan ``p`` cuts Cin (x (m, 9, cin), w (9, cin, n)):
    inside a split the kernel's K order is chunk, then tap, then channel;
    the finish kernel adds the splits in order in f32, to nearest."""
    m, n = x.shape[0], w.shape[2]
    total = np.zeros((m, n), np.float32)
    for s in range(p.splits):
        chunk0 = range(s * p.cps * p.ck,
                       min(x.shape[2], (s + 1) * p.cps * p.ck), p.ck)
        xs = np.concatenate([x[:, :, c:c + p.ck].reshape(m, -1)
                             for c in chunk0], axis=1)
        ws = np.concatenate([w[:, c:c + p.ck].reshape(-1, n)
                             for c in chunk0], axis=0)
        total = total + _mma_sum(xs, ws, toward_zero)
    return total


def _k4608_case(m=2048, n=8, cin=512):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, 9, cin)).astype(np.float32)
    w = (rng.standard_normal((9, cin, n)) / np.sqrt(9 * cin)).astype(
        np.float32)
    ref = np.einsum("mtc,tcn->mn", x.astype(np.float64), w.astype(np.float64))
    return x, w, ref


@pytest.mark.parametrize("splits", [1, 2, 5, 16])
def test_split_k_sum_keeps_f32_tolerance_at_k_9x512(splits):
    """K = 9 * 512, x ~ N(0, 1), w ~ N(0, 1) / sqrt(K) as chip_smoke.py
    draws them.  Each split sums its Cin chunks (CK 16, all 9 taps) in
    3xTF32 into its own f32 accumulator; the finish kernel adds the splits
    in order in f32.  Every output stays within TOL["f32"] of the f64 sum,
    and the split sum is no worse than a plain f32 sum."""
    x, w, ref = _k4608_case()
    p = tc_plan.plan_f32(1, 4, 4, 512, 8, splits=splits)
    assert p.splits == splits and p.ck == 16
    err = np.abs(_split_sum(x, w, p, toward_zero=False) - ref)
    assert (err <= TOL["atol"] + TOL["rtol"] * np.abs(ref)).all(), err.max()
    f32 = np.einsum("mtc,tcn->mn", x, w)
    assert err.max() < 4 * np.abs(f32 - ref).max() + 1e-6


def test_chains_of_8_chunks_keep_the_truncating_accumulator_in_tolerance():
    """The card's MMAs round the accumulator toward zero (its errors at
    K = 9 * 512 match this emulation: 1.9e-4 to 2.2e-4 in one chain, 4e-5 in
    four).  One chain of 32 chunks then drifts one-sidedly to over half of
    TOL["f32"]; the plan's chains of MAX_CPS_F32 chunks, added to nearest by
    the finish kernel, stay under a quarter of it."""
    x, w, ref = _k4608_case()
    tol = TOL["atol"] + TOL["rtol"] * np.abs(ref)
    one = tc_plan.plan_f32(8, 32, 32, 512, 8, splits=1)
    rule = tc_plan.plan_f32(8, 32, 32, 512, 8)
    assert (one.splits, one.cps) == (1, 32)
    assert (rule.splits, rule.cps) == (4, tc_plan.MAX_CPS_F32)
    used_one = (np.abs(_split_sum(x, w, one, True) - ref) / tol).max()
    used_rule = (np.abs(_split_sum(x, w, rule, True) - ref) / tol).max()
    assert 0.5 < used_one < 1.0, used_one
    assert used_rule < 0.25, used_rule


def test_statistics_from_slot_sums_keep_their_tolerance():
    """Kernel 1's variance is E[y^2] - mean^2 from f32 sums taken slot by
    slot (32 or 64 pixels a slot), then tile by tile in the wrapper: at
    1024^2 pixels of lrelu(N(0.3, 1)) values both statistics stay within
    chip_smoke.py's STAT_TOL["f32"] (atol 1e-4, rtol 1e-3) of the f64 ones."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal(1 << 20).astype(np.float32) + np.float32(0.3)
    v = np.where(v >= 0, v, np.float32(0.2) * v).astype(np.float32)
    slots = v.reshape(-1, 64)                 # a 64-pixel warp's slot
    s1 = slots.sum(axis=1, dtype=np.float32).reshape(-1, 4)
    s2 = (slots * slots).sum(axis=1, dtype=np.float32).reshape(-1, 4)
    # a tile's partial adds its 4 slots in order; the wrapper adds the tiles
    t1 = torch.from_numpy(s1[:, 0] + s1[:, 1] + s1[:, 2] + s1[:, 3]).sum()
    t2 = torch.from_numpy(s2[:, 0] + s2[:, 1] + s2[:, 2] + s2[:, 3]).sum()
    mean = float(t1) / v.size
    var = float(t2) / v.size - mean * mean
    v64 = v.astype(np.float64)
    assert abs(mean - v64.mean()) <= 1e-4 + 1e-3 * abs(v64.mean())
    assert abs(var - v64.var()) <= 1e-4 + 1e-3 * v64.var()

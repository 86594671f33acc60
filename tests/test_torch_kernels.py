"""The port's three kernel wrappers (gan_segmentation_tpu_torch/kernels).

On the CPU each wrapper runs its plain PyTorch version; those are held here
to the archived Pallas kernels run through the Pallas interpreter, as
tests/test_pallas_conv.py runs them.  Tolerance rtol 1e-4, atol 1e-5, the
same as that file's (f32 sums in different orders).  The archived
``bil_conv.py`` kernel, which had no test, is also held to ``lax.conv``.
The CUDA kernels themselves are compared with the plain versions by the
tests marked ``cuda``, which skip without a card, and by chip_smoke.py.
"""

import contextlib
import functools
import itertools
import sys
from os.path import dirname, join
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, join(dirname(__file__), "..", "experiments",
                        "pallas_archive"))

import bil_conv as pallas_bil  # noqa: E402
import conv_in_stats as pallas_in_stats  # noqa: E402
import small_conv as pallas_small  # noqa: E402
from jax import lax  # noqa: E402
from gan_segmentation_tpu.ops.norm import instance_norm  # noqa: E402

from gan_segmentation_tpu_torch.kernels import _build, tc_plan  # noqa: E402
from gan_segmentation_tpu_torch.kernels.bil_conv import (  # noqa: E402
    EDGE_SHAPES, conv3x3_bil, conv3x3_bil_plain)
from gan_segmentation_tpu_torch.kernels.conv3x3_grad import (  # noqa: E402
    Conv3x3, conv3x3)
from gan_segmentation_tpu_torch.kernels.conv_in_stats import (  # noqa: E402
    conv3x3_noise_bias_lrelu_instats, conv3x3_noise_bias_lrelu_instats_plain,
    conv3x3_noise_bias_lrelu_instats_rows,
    conv3x3_noise_bias_lrelu_instats_rows_plain)
from gan_segmentation_tpu_torch.kernels.small_conv import (  # noqa: E402
    conv3x3_small, conv3x3_small_plain, conv3x3_small_rows,
    conv3x3_small_rows_plain)
from gan_segmentation_tpu_torch.ops.norm import instance_norm_apply  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

RTOL, ATOL = 1e-4, 1e-5


def _interp(module, fn_name, monkeypatch):
    orig = module.pl.pallas_call
    monkeypatch.setattr(module.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    return getattr(module, fn_name).__wrapped__


@pytest.fixture
def pallas_k1(monkeypatch):
    return _interp(pallas_in_stats, "conv3x3_noise_bias_lrelu_instats",
                   monkeypatch)


@pytest.fixture
def pallas_k2(monkeypatch):
    return _interp(pallas_small, "conv3x3_small", monkeypatch)


@pytest.fixture
def pallas_k3(monkeypatch):
    return _interp(pallas_bil, "conv3x3_bil", monkeypatch)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels build with nvcc)")
    # the plain side's f32 convs would otherwise run in TF32 on cuDNN
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


# (n, h, w, cin, cout, tile_h): the 4^2 block (H = 4), an odd width, a
# ragged Cin / Cout that no tile divides
SHAPES = [(2, 16, 16, 16, 16, 8), (2, 4, 4, 32, 32, 4), (1, 8, 12, 8, 4, 8),
          (1, 16, 8, 20, 3, 8)]


def _conv_inputs(rng, n, h, w, cin, cout):
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("n,h,w,cin,cout,tile_h", SHAPES)
def test_in_stats_plain_matches_pallas(pallas_k1, rng, n, h, w, cin, cout,
                                       tile_h):
    x, wt = _conv_inputs(rng, n, h, w, cin, cout)
    noise = rng.randn(n, h, w).astype(np.float32)
    nscale = (0.1 * rng.randn(cout)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    want = pallas_k1(x, wt, noise, nscale, bias, tile_h=tile_h)
    got = conv3x3_noise_bias_lrelu_instats(
        *map(torch.from_numpy, (x, wt, noise, nscale, bias)))
    for g, wnt, what in zip(got, want, ("y", "mean", "var")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


@pytest.mark.parametrize("n,h,w,cin,cout,tile_h", SHAPES)
@pytest.mark.parametrize("epilogue", ["none", "relu", "leaky"])
def test_small_conv_plain_matches_pallas(pallas_k2, rng, n, h, w, cin, cout,
                                         tile_h, epilogue):
    x, wt = _conv_inputs(rng, n, h, w, cin, cout)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    kw = {"none": {}, "relu": dict(relu=True),
          "leaky": dict(leaky=0.2)}[epilogue]
    want = pallas_k2(x, wt, b, tile_h=tile_h, **kw)
    got = conv3x3_small(torch.from_numpy(x), torch.from_numpy(wt),
                        torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_small_conv_without_bias(pallas_k2, rng):
    x, wt = _conv_inputs(rng, 1, 8, 8, 8, 8)
    want = pallas_k2(x, wt, tile_h=8, leaky=0.2)
    got = conv3x3_small(torch.from_numpy(x), torch.from_numpy(wt), leaky=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_in_stats_feed_instance_norm(rng):
    """The statistics normalize like the JAX package's instance_norm of y,
    after the consumer's clamp (the AdaIN contract)."""
    x, wt = _conv_inputs(rng, 2, 8, 8, 8, 8)
    noise = rng.randn(2, 8, 8).astype(np.float32)
    zeros = np.zeros(8, np.float32)
    y, mean, var = conv3x3_noise_bias_lrelu_instats(
        *map(torch.from_numpy, (x, wt, noise, zeros, zeros)))
    got = instance_norm_apply(y, mean, var)
    want = np.asarray(instance_norm(y.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_cpu_wrappers_take_the_plain_path_and_count_nothing(rng):
    x, wt = (torch.from_numpy(a) for a in _conv_inputs(rng, 1, 4, 4, 4, 4))
    z = torch.zeros(4)
    before = (conv3x3_noise_bias_lrelu_instats.launches,
              conv3x3_small.launches)
    y, _, _ = conv3x3_noise_bias_lrelu_instats(x, wt, torch.zeros(1, 4, 4),
                                               z, z)
    torch.testing.assert_close(y, conv3x3_noise_bias_lrelu_instats_plain(
        x, wt, torch.zeros(1, 4, 4), z, z)[0], rtol=0, atol=0)
    torch.testing.assert_close(conv3x3_small(x, wt, leaky=0.2),
                               conv3x3_small_plain(x, wt, leaky=0.2),
                               rtol=0, atol=0)
    assert (conv3x3_noise_bias_lrelu_instats.launches,
            conv3x3_small.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "layout", "bias_dtype",
                                 "device", "both_acts"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 4)
    b = torch.zeros(4)
    kw = {}
    if bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "w_shape":
        w = torch.zeros(3, 3, 4, 4)
    elif bad == "layout":
        x = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)  # NCHW storage
    elif bad == "bias_dtype":
        b = b.double()
    elif bad == "device":
        # neither CPU nor CUDA: no fallback, the wrapper raises
        x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
    else:
        kw = dict(relu=True, leaky=0.2)
    with pytest.raises((TypeError, ValueError)):
        conv3x3_small(x, w, b, **kw)
    if bad != "both_acts":
        noise = torch.zeros(1, 4, 4, device=x.device)
        with pytest.raises((TypeError, ValueError)):
            conv3x3_noise_bias_lrelu_instats(x, w, noise, b, b)


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler error is raised, never swallowed into a fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_library()
    assert list(tmp_path.iterdir()) == []


def test_build_cache_key_covers_every_source():
    names = sorted(p.rsplit("/", 1)[-1] for p in _build._sources())
    assert names == ["bil_conv.cu", "bil_conv_sm90.cu", "conv3x3_core.cuh",
                     "conv3x3_sm90.cuh", "conv3x3_tc.cuh", "conv3x3_tf32.cuh",
                     "conv_in_stats.cu", "conv_in_stats_f32.cu",
                     "conv_in_stats_rows.cu",
                     "conv_in_stats_s8.cu", "quantize_s8.cu", "sm90_util.cuh",
                     "small_conv.cu", "small_conv_f32.cu",
                     "small_conv_rows.cu", "small_conv_s8.cu"]
    assert _build._source_tag() == _build._source_tag()


# Edge cases of the tensor-core kernels, bf16 (conv3x3_sm90.cuh where TMA's
# rules take the shape, and conv3x3_tc.cuh) and f32 (conv3x3_tf32.cuh,
# 3xTF32): 4^2 images with Cin 512 (a tile spanning
# images, split-K), W = 20 / H = 12 (ragged tiles), Cout = 2 (N padded to
# 8), Cin = 3 (scalar staging), batch 1, Cout 24 (N = 32 with masked
# channels), 256-pixel blocks of 64 channels with a ragged W, one 4^2 image
# of Cin 512 (one item split 16 ways), a ragged 13 x 21 with a split
TC_EDGE_SHAPES = [(8, 4, 4, 512, 512), (8, 4, 4, 512, 32), (3, 12, 20, 32, 16),
                  (2, 33, 40, 32, 2), (2, 9, 7, 3, 16), (1, 64, 64, 64, 16),
                  (1, 16, 16, 512, 512), (2, 5, 6, 40, 24),
                  (8, 64, 72, 64, 64), (1, 4, 4, 512, 32),
                  (1, 13, 21, 512, 32)]


@contextlib.contextmanager
def _mma_sync_body():
    """bf16 kernels 1 and 2 on the mma.sync body (conv3x3_tc.cuh) inside:
    the rule's Hopper plan swapped out."""
    _build._tc_plan_c.cache_clear()
    try:
        with mock.patch.object(tc_plan, "plan_sm90",
                               lambda *args, **kw: None):
            yield
    finally:
        _build._tc_plan_c.cache_clear()


def _bodies(dtype):
    """The bodies a dtype's calls can take: bf16 the Hopper body (where
    TMA's rules take the shape) and the mma.sync body, f32 its one."""
    return ((contextlib.nullcontext, _mma_sync_body)
            if dtype == torch.bfloat16 else (contextlib.nullcontext,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(cuda, dtype, tol):
    for body in _bodies(dtype):
        with body():
            _kernels_match_plain(cuda, dtype, tol)


def _kernels_match_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = [s[:5] for s in SHAPES] + [(2, 64, 64, 64, 2)] + TC_EDGE_SHAPES
    for (n, h, w, cin, cout) in shapes:
        x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
        wt = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
              / (9 * cin) ** 0.5).to(dtype)
        noise = torch.randn((n, h, w), generator=g, device=cuda)
        b = 0.1 * torch.randn((cout,), generator=g, device=cuda)
        launches = conv3x3_noise_bias_lrelu_instats.launches
        got = conv3x3_noise_bias_lrelu_instats(x, wt, noise, b, b)
        assert conv3x3_noise_bias_lrelu_instats.launches == launches + 1
        want = conv3x3_noise_bias_lrelu_instats_plain(x, wt, noise, b, b)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_.float(), w_.float(), rtol=tol,
                                       atol=tol)
        for kw in (dict(leaky=0.2), dict(relu=True), {}):
            torch.testing.assert_close(
                conv3x3_small(x, wt, b, **kw).float(),
                conv3x3_small_plain(x, wt, b, **kw).float(), rtol=tol,
                atol=tol)
        # two launches on the same input are bit-identical (split-K and the
        # statistics reduce in a fixed order)
        again = conv3x3_noise_bias_lrelu_instats(x, wt, noise, b, b)
        for a_, b_ in zip(got, again):
            assert torch.equal(a_, b_)
        assert torch.equal(conv3x3_small(x, wt, b, leaky=0.2),
                           conv3x3_small(x, wt, b, leaky=0.2))


def _path_shapes(batch, gan="ffhq"):
    """(n, h, w, cin, cout) of every kernel-1 and kernel-2 call of the
    generate path of ``gan`` (ffhq 1024^2, cars 512^2, bedrooms 256^2) at
    this batch."""
    from gan_segmentation_tpu_torch.core.config import (SolverConfig,
                                                        gan_config)
    gcfg = gan_config(gan)
    scfg = SolverConfig(max_res_log2=gcfg.max_res_log2)
    out = []
    for res in range(2, gcfg.max_res_log2 + 1):
        c = gcfg.num_features(res)
        out.append((batch, 2 ** res, 2 ** res, c, c))
    f, cin = scfg.features, scfg.in_channels
    for i in range(len(cin)):
        r = 2 ** (i + 2)
        out.append((batch, r, r, cin[i], f[i]))
        c_in = f[i] * (2 if i > 0 else 1)
        if i < len(cin) - 1:
            out.append((batch, 2 * r, 2 * r, c_in, f[i + 1]))
            out.append((batch, 2 * r, 2 * r, f[i + 1], f[i + 1]))
        else:
            out.append((batch, r, r, c_in, f[i + 1]))
    return out


def _covered(p, n, h, w):
    """Each output pixel under the kernel's index map (conv3x3_tc.cuh: an
    item is (image group, spatial tile, Cout block); its tile pixel p is
    (image, row, column) of g x th x tw), with the (image, tile) of the
    statistics partial it lands in."""
    hits = {}
    for z in range(p.groups):
        for tile in range(p.tiles):
            ty0 = (tile // p.tiles_x) * p.th
            tx0 = (tile % p.tiles_x) * p.tw
            for q in range(p.bm):
                gi, rem = divmod(q, p.th * p.tw)
                nn, oy, ox = (z * p.g + gi, ty0 + rem // p.tw,
                              tx0 + rem % p.tw)
                if nn < n and oy < h and ox < w:
                    hits.setdefault((nn, oy, ox), []).append((nn, tile))
    return hits


@pytest.mark.parametrize("batch", [8, 1, 2])
def test_tc_plan_fits_every_path_shape(batch):
    """The bf16 launch plan of every kernel-1 / kernel-2 call on the ffhq,
    cars and bedrooms paths (the last two end in a 64 -> 2 conv at 512^2
    and 256^2; batch 2 is the annotation run's sampler and Generate) and of
    the edge cases: within a block's 227 KB of shared memory, N a
    multiple of 8 spanning Cout up to 64, whole warps of 32 pixels, the
    split-K covering every Cin chunk once, a grid inside CUDA's limits, and
    a partial extent (tiles) under which every output pixel of every image
    lands in exactly one (image, tile) partial."""
    tails = [_path_shapes(batch, gan)[-1] for gan in ("cars", "bedrooms")]
    assert tails == [(batch, 512, 512, 64, 2), (batch, 256, 256, 64, 2)]
    shapes = sorted(set(_path_shapes(batch) + _path_shapes(batch, "cars")
                        + _path_shapes(batch, "bedrooms")))
    assert set(tails) <= set(shapes) and len(shapes) > len(
        set(_path_shapes(batch)))
    shapes += [(batch, *s[1:]) for s in TC_EDGE_SHAPES]
    for (n, h, w, cin, cout), noise in itertools.product(shapes, (False,
                                                                   True)):
        p = tc_plan.plan(n, h, w, cin, cout, noise)
        assert p.smem_bytes <= tc_plan.MAX_SMEM, (n, h, w, cin, cout, p)
        assert p.bn % 8 == 0 and p.bn >= min(cout, 64), p
        assert p.tw * p.th * p.g == p.bm == 32 * p.wm, p
        chunks = -(-cin // p.ck)
        assert (p.splits - 1) * p.cps < chunks <= p.splits * p.cps, p
        assert p.blocks < 2 ** 31 and p.groups <= 65535  # CUDA's grid
        assert p.ws_elems(n, h, w, cout) == (
            p.splits * n * h * w * cout if p.splits > 1 else 0)
        if n * h * w <= 4096:  # the index map, where it is cheap to walk
            hits = _covered(p, n, h, w)
            assert len(hits) == n * h * w
            assert all(len(v) == 1 and v[0][1] < p.tiles
                       for v in hits.values())
    # the Cin-512 layers at 4^2-16^2 fill the card by splitting K, as far
    # as their 16 Cin chunks allow
    for res in (4, 8, 16):
        p = tc_plan.plan(8, res, res, 512, 512)
        assert p.splits > 1
        assert p.blocks >= min(tc_plan.NUM_SMS, p.blocks // p.splits * 16)


# ------------------------------------------------------------ row bands
def _band_inputs(x, a, b):
    """Rows a..b-1 of x with the row above and below (zeros outside the
    image), as ``core/spatial.py::with_halo`` gives a band."""
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    return padded[:, a:b + 2].contiguous()


# (n, h, w, cin, cout, tile_h, bands): the Pallas kernels' tile_h, then the
# band split held to the full image's rows (an odd split of 13 rows, one
# row a band, bands that no tile divides)
BAND_SHAPES = [(2, 16, 16, 16, 16, 8, 2), (1, 8, 12, 8, 4, 8, 8),
               (2, 16, 8, 20, 3, 8, 3), (1, 8, 13, 32, 8, 8, 4)]


@pytest.mark.parametrize("n,h,w,cin,cout,tile_h,bands", BAND_SHAPES)
def test_band_forms_are_the_full_images_rows(pallas_k1, pallas_k2, rng, n, h,
                                             w, cin, cout, tile_h, bands):
    """The row-band forms' plain twins over each band (with its halo rows)
    equal the full-image kernels' rows exactly, kernel 1's band sums equal
    the plain sums of those rows, and the full-image outputs are the
    Pallas kernels' (interpret mode) within this file's tolerance."""
    from gan_segmentation_tpu_torch.core.spatial import band_rows
    x, wt = _conv_inputs(rng, n, h, w, cin, cout)
    noise = rng.randn(n, h, w).astype(np.float32)
    nscale = (0.1 * rng.randn(cout)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    xt, wtt, nt, st, bt = map(torch.from_numpy, (x, wt, noise, nscale, bias))
    y1, _, _ = conv3x3_noise_bias_lrelu_instats(xt, wtt, nt, st, bt)
    y2 = conv3x3_small(xt, wtt, bt, leaky=0.2)
    np.testing.assert_allclose(
        y1.numpy(), np.asarray(pallas_k1(x, wt, noise, nscale, bias,
                                         tile_h=tile_h)[0]),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        y2.numpy(), np.asarray(pallas_k2(x, wt, bias, tile_h=tile_h,
                                         leaky=0.2)), rtol=RTOL, atol=ATOL)
    for a, b in band_rows(h, bands):
        xb = _band_inputs(xt, a, b)
        yb, s1, s2 = conv3x3_noise_bias_lrelu_instats_rows(
            xb, wtt, nt[:, a:b].contiguous(), st, bt)
        assert yb.shape == (n, b - a, w, cout)
        assert torch.equal(yb, y1[:, a:b])
        assert torch.equal(s1, y1[:, a:b].sum(dim=(1, 2)))
        assert torch.equal(s2, (y1[:, a:b] * y1[:, a:b]).sum(dim=(1, 2)))
        assert torch.equal(conv3x3_small_rows(xb, wtt, bt, leaky=0.2),
                           y2[:, a:b])
        assert torch.equal(conv3x3_small_rows(xb, wtt, None, relu=True),
                           conv3x3_small(xt, wtt, relu=True)[:, a:b])


@pytest.mark.parametrize("bad", ["rows", "noise", "dtype"])
def test_band_wrappers_refuse_what_the_kernels_do_not_take(bad):
    x = torch.zeros(1, 6, 4, 8)
    w = torch.zeros(3, 3, 8, 4)
    noise, v = torch.zeros(1, 4, 4), torch.zeros(4)
    if bad == "rows":
        x = torch.zeros(1, 2, 4, 8)
    elif bad == "noise":
        noise = torch.zeros(1, 6, 4)
    else:
        x = x.double()
    with pytest.raises((ValueError, TypeError)):
        conv3x3_noise_bias_lrelu_instats_rows(x, w, noise, v, v)
    if bad != "noise":
        with pytest.raises((ValueError, TypeError)):
            conv3x3_small_rows(x, w, v)
    assert conv3x3_small_rows.launches == 0
    assert conv3x3_noise_bias_lrelu_instats_rows.launches == 0


def band_path_shapes(batch, n, gan="ffhq"):
    """(n, h_out, w, cin, cout) of every band of every kernel-1 and kernel-2
    call of ``gan``'s generate path over ``n`` bands (``core/spatial.py``'s
    band rule: heights below n run whole, with the full-image kernels)."""
    from gan_segmentation_tpu_torch.core.spatial import BandPlan
    from gan_segmentation_tpu_torch.core.config import gan_config
    plan = BandPlan.of(gan_config(gan), n)
    out = set()
    for (b, h, w, cin, cout) in _path_shapes(batch, gan):
        bounds = plan.bounds(h)
        if bounds is not None:
            out |= {(b, stop - start, w, cin, cout) for start, stop in bounds}
    return sorted(out)


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tc_plan_fits_every_band_shape(batch, n):
    """The bf16 and f32 plans of every band of the ffhq generate path at N
    in {2, 4, 8}: planned for the band's output rows (its input holds two
    more), within a block's shared memory, every Cin chunk in one split,
    kernel 1's partial extent covering every output pixel once."""
    shapes = band_path_shapes(batch, n)
    # the first banded height: 4 rows in 2 bands, 4 (or 8) in one-row bands
    assert min(s[1] for s in shapes) == (2 if n == 2 else 1)
    for (b, h, w, cin, cout), noise in itertools.product(shapes,
                                                         (False, True)):
        p = tc_plan.plan(b, h, w, cin, cout, noise)
        assert p.smem_bytes <= tc_plan.MAX_SMEM, (b, h, w, cin, cout, p)
        assert p.tw * p.th * p.g == p.bm == 32 * p.wm, p
        chunks = -(-cin // p.ck)
        assert (p.splits - 1) * p.cps < chunks <= p.splits * p.cps, p
        assert p.tiles == p.tiles_x * -(-h // p.th)
        if b * h * w <= 4096:
            hits = _covered(p, b, h, w)
            assert len(hits) == b * h * w
            assert all(len(v) == 1 for v in hits.values())
        f = tc_plan.plan_f32(b, h, w, cin, cout, stats=noise)
        assert f.smem_bytes <= tc_plan.MAX_SMEM, (b, h, w, cin, cout, f)
        assert (f.splits - 1) * f.cps < f.chunks <= f.splits * f.cps, f
        assert f.cps <= tc_plan.MAX_CPS_F32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_band_forms_match_plain(cuda, dtype, tol):
    """The row-band forms of kernels 1 and 2 on the card against their
    plain twins at band shapes (a split-K band of Cin 512, one-row bands,
    ragged tiles), each launch counted once, repeats bit-identical; bf16
    on both bodies."""
    for body in _bodies(dtype):
        with body():
            _band_forms_match_plain(cuda, dtype, tol)


def _band_forms_match_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    for (n, h, w, cin, cout) in [(8, 1, 8, 512, 512), (8, 2, 16, 512, 512),
                                 (2, 3, 20, 32, 16), (1, 64, 64, 64, 16),
                                 (2, 5, 6, 40, 2), (8, 16, 64, 64, 32)]:
        x = torch.randn((n, h + 2, w, cin), generator=g,
                        device=cuda).to(dtype)
        wt = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
              / (9 * cin) ** 0.5).to(dtype)
        noise = torch.randn((n, h, w), generator=g, device=cuda)
        b = 0.1 * torch.randn((cout,), generator=g, device=cuda)
        k1 = conv3x3_noise_bias_lrelu_instats_rows
        launches = k1.launches
        got = k1(x, wt, noise, b, b)
        assert k1.launches == launches + 1
        want = conv3x3_noise_bias_lrelu_instats_rows_plain(x, wt, noise, b,
                                                           b)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=tol, atol=tol)
        for g_, w_ in zip(got[1:], want[1:]):  # sums over h * w pixels
            torch.testing.assert_close(g_, w_, rtol=tol,
                                       atol=tol * h * w)
        assert all(torch.equal(a_, b_) for a_, b_ in zip(
            got, k1(x, wt, noise, b, b)))
        y = conv3x3_small_rows(x, wt, b, leaky=0.2)
        torch.testing.assert_close(
            y.float(), conv3x3_small_rows_plain(x, wt, b, leaky=0.2).float(),
            rtol=tol, atol=tol)
        assert torch.equal(y, conv3x3_small_rows(x, wt, b, leaky=0.2))


# (n, h, w, cin, cout, tile_h) of kernel 3: its design case B*C = 128, a
# batch-1 layer with Cin 64, and the 4^2 shape with Cout = 2
BIL_SHAPES = [(8, 8, 8, 16, 16, 4), (1, 8, 16, 64, 32, 4),
              (1, 4, 4, 32, 2, 4)]


@pytest.mark.parametrize("n,h,w,cin,cout,tile_h", BIL_SHAPES)
@pytest.mark.parametrize("epilogue", ["none", "relu", "leaky"])
@pytest.mark.parametrize("bias", [True, False])
def test_bil_plain_matches_pallas(pallas_k3, rng, n, h, w, cin, cout, tile_h,
                                  epilogue, bias):
    x, wt = _conv_inputs(rng, n, h, w, cin, cout)
    b = (0.1 * rng.randn(cout)).astype(np.float32) if bias else None
    kw = {"none": {}, "relu": dict(relu=True),
          "leaky": dict(leaky=0.2)}[epilogue]
    want = pallas_k3(x, wt, b, tile_h=tile_h, **kw)
    got = conv3x3_bil(torch.from_numpy(x), torch.from_numpy(wt),
                      None if b is None else torch.from_numpy(b), **kw)
    assert got.shape == (n, h, w, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,h,w,cin,cout,tile_h", BIL_SHAPES)
def test_bil_pallas_kernel_matches_lax_conv(pallas_k3, rng, n, h, w, cin,
                                            cout, tile_h):
    """The archived kernel itself (block-diagonal taps, batch in lanes)
    computes the conv: max |err| <= 2e-6 against lax.conv at full f32
    precision.  Outputs reach |y| ~ 4, where an f32 ulp is 4.8e-7, and the
    two sum up to 9*64 products in different orders; measured here
    1.67e-6, 1.01e-6 and 0.95e-6 at the three shapes."""
    x, wt = _conv_inputs(rng, n, h, w, cin, cout)
    want = lax.conv_general_dilated(
        x, wt, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST)
    got = pallas_k3(x, wt, tile_h=tile_h)
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= 2e-6


@pytest.mark.parametrize("n,cin,cout", [(9, 16, 16), (1, 129, 8),
                                        (4, 8, 33)])
def test_bil_refuses_what_breaks_its_contract(n, cin, cout):
    """B*Cin or B*Cout above 128 raises on every device; the train conv's
    dispatch takes kernel 2 for such a layer instead."""
    x = torch.randn(n, 4, 4, cin)
    w = torch.randn(3, 3, cin, cout)
    with pytest.raises(ValueError, match="B\\*Cin"):
        conv3x3_bil(x, w)
    torch.testing.assert_close(conv3x3(x, w), conv3x3_small_plain(x, w))


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "layout", "bias_dtype",
                                 "device", "both_acts"])
def test_bil_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 4)
    b = torch.zeros(4)
    kw = {}
    if bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "w_shape":
        w = torch.zeros(3, 3, 4, 4)
    elif bad == "layout":
        x = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)  # NCHW storage
    elif bad == "bias_dtype":
        b = b.double()
    elif bad == "device":
        x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
    else:
        kw = dict(relu=True, leaky=0.2)
    with pytest.raises((TypeError, ValueError)):
        conv3x3_bil(x, w, b, **kw)


def test_bil_cpu_wrapper_takes_the_plain_path_and_counts_nothing(rng):
    x, wt = (torch.from_numpy(a) for a in _conv_inputs(rng, 2, 5, 7, 8, 8))
    before = (conv3x3_bil.launches, conv3x3_small.launches)
    torch.testing.assert_close(conv3x3_bil(x, wt, leaky=0.2),
                               conv3x3_bil_plain(x, wt, leaky=0.2),
                               rtol=0, atol=0)
    y = Conv3x3.apply(x.requires_grad_(), wt, torch.zeros(8))
    y.sum().backward()
    assert (conv3x3_bil.launches, conv3x3_small.launches) == before


# kernel 3 on the card at the edges of its contract and of its f32 plan
# (kernels/bil_conv.py::EDGE_SHAPES)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_bil_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    for (n, h, w, cin, cout) in EDGE_SHAPES:
        x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
        wt = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
              / (9 * cin) ** 0.5).to(dtype)
        b = 0.1 * torch.randn((cout,), generator=g, device=cuda)
        for kw in ({}, dict(leaky=0.2), dict(relu=True)):
            launches = conv3x3_bil.launches
            got = conv3x3_bil(x, wt, b, **kw)
            assert conv3x3_bil.launches == launches + 1
            torch.testing.assert_close(
                got.float(), conv3x3_bil_plain(x, wt, b, **kw).float(),
                rtol=tol, atol=tol)
        torch.testing.assert_close(conv3x3_bil(x, wt).float(),
                                   conv3x3_bil_plain(x, wt).float(),
                                   rtol=tol, atol=tol)
        # no atomics, a fixed summation order: repeats are bit-identical
        assert torch.equal(conv3x3_bil(x, wt, b), conv3x3_bil(x, wt, b))


@pytest.mark.cuda
def test_cuda_conv3x3_grads_match_autograd(cuda):
    """Conv3x3 through the kernels against torch.autograd through the plain
    conv, f32 with TF32 off: dX, dW and db within 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for (n, h, w, cin, cout) in [(1, 32, 32, 64, 16), (1, 16, 16, 512, 32),
                                 (2, 9, 13, 32, 2), (8, 16, 16, 16, 16)]:
        x = torch.randn((n, h, w, cin), generator=g, device=cuda)
        wt = torch.randn((3, 3, cin, cout), generator=g, device=cuda) \
            / (9 * cin) ** 0.5
        b = torch.randn((cout,), generator=g, device=cuda)
        dy = torch.randn((n, h, w, cout), generator=g, device=cuda)
        leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
        Conv3x3.apply(*leaves).backward(dy)
        ref = [t.clone().requires_grad_() for t in (x, wt, b)]
        conv3x3_small_plain(*ref).backward(dy)
        for got, want in zip(leaves, ref):
            torch.testing.assert_close(got.grad, want.grad, rtol=1e-4,
                                       atol=1e-4)

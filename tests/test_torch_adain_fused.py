"""The synthesis block's two per-pixel passes (kernels/adain_fused.py):
pass A (noise, bias, leaky relu and the instance-norm sums) and pass B
(the AdaIN apply).

On the CPU each op runs its plain version: held here to the JAX
package's ``AddNoise`` -> ``Bias`` -> ``leaky_relu`` -> ``AdaIN`` chain in
f32 (tolerance 1e-5, as tests/test_torch_layers.py), to ``ops/norm.py::
instance_norm``, and, in bf16, to the chain written one PyTorch op at a
time as the block ran it before the passes (the passes round once where
that chain rounded at every op, so they may not land further from f32).
The calls a batch makes are counted through the ffhq generator's nine
blocks.  The tests marked ``cuda`` hold the CUDA kernels to the
plain versions computed on the CPU (bit for bit: the kernels round in the
plain versions' order with the IEEE intrinsics; the sums, added in
another order, to f32 rounding) and skip without a card.  JAX is imported
inside the one test that uses it, so the card's run of this file needs
none.
"""

import importlib.util
import re
from collections import Counter
from os.path import dirname, join

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gan_segmentation_tpu_torch.core import graphs, spatial
from gan_segmentation_tpu_torch.core.config import GanConfig, gan_config
from gan_segmentation_tpu_torch.kernels import adain_fused as af
from gan_segmentation_tpu_torch.kernels.conv_in_stats import \
    conv3x3_noise_bias_lrelu_instats
from gan_segmentation_tpu_torch.models import layers as tl
from gan_segmentation_tpu_torch.models.stylegan import (StyleBlock,
                                                        StyleGanGenerator)
from gan_segmentation_tpu_torch.ops.norm import (instance_norm,
                                                 instance_norm_apply)

torch.set_num_threads(2)  # the test workers share the host's cores

ROOT = dirname(dirname(__file__))
TOL = dict(rtol=1e-5, atol=1e-5)
# every synthesis block's (H = W, C) of ffhq; cars and bedrooms run the
# first 8 and 7 of them
BLOCK_SHAPES = [(4 * 2 ** i, c) for i, c in enumerate(
    gan_config("ffhq").feature_channels)]


def _inputs(n, h, w, c, dtype, seed=0, device="cpu"):
    """x, noise (N, H, W), nscale, bias for pass A; a shift makes the
    leaky branch and the mean both matter."""
    g = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn(n, h, w, c, generator=g) + 0.3).to(dtype)
    noise = torch.randn(n, h, w, generator=g)
    nscale = 0.5 * torch.randn(c, generator=g)
    bias = 0.5 * torch.randn(c, generator=g)
    return [t.to(device) for t in (x, noise, nscale, bias)]


def _styles(n, c, dtype, seed=1, device="cpu"):
    """(ys, yb) as views of one (N, 2C) affine output, as AdaIN hands them
    over."""
    y = torch.randn(n, 2 * c, generator=torch.Generator().manual_seed(seed))
    y = y.to(dtype).to(device)
    return y[:, :c], y[:, c:]


# ------------------------------------------------------------- the twins
@pytest.mark.parametrize("shape", [(2, 5, 4, 6), (3, 4, 4, 16)])
def test_twins_match_the_jax_chain(shape, rng):
    """Pass A then pass B (from pass A's sums) in f32 against the JAX
    package's AddNoise -> Bias -> leaky_relu -> AdaIN on the same
    parameters."""
    from gan_segmentation_tpu.models import layers as jl
    n, h, w, c = shape
    x = (rng.randn(n, h, w, c) * 2 + 0.5).astype(np.float32)
    noise = rng.randn(n, h, w, 1).astype(np.float32)
    wv = rng.randn(n, 9).astype(np.float32)
    nscale, bias = (rng.randn(c).astype(np.float32) for _ in range(2))
    aff_w = rng.randn(9, 2 * c).astype(np.float32)
    aff_b = rng.randn(2 * c).astype(np.float32)
    adain = jl.AdaIN(c)
    v = jl.AddNoise().apply({"params": {"scale_factors": nscale}}, x, noise)
    v = jl.leaky_relu(jl.Bias().apply({"params": {"bias": bias}}, v))
    want = adain.apply({"params": {"affine": {"weight": aff_w,
                                              "bias": aff_b}}}, v, wv)

    y, s1, s2 = af.noise_bias_lrelu_stats_plain(
        torch.from_numpy(x), torch.from_numpy(noise[..., 0]),
        torch.from_numpy(nscale), torch.from_numpy(bias))
    np.testing.assert_allclose(y.numpy(), np.asarray(v), **TOL)
    tm = tl.AdaIN(c, 9)
    with torch.no_grad():
        tm.affine.weight.copy_(torch.from_numpy(aff_w.T))
        tm.affine.bias.copy_(torch.from_numpy(aff_b))
        got = tm.apply_stats(y, s1, s2, torch.from_numpy(wv), count=h * w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sums_give_instance_norm(dtype):
    """Pass A's sums turned into moments by pass B (``count``) normalize
    as ``ops/norm.py::instance_norm`` does, and so do the moments handed
    in (kernel 1's form); with ys = yb = 0 the apply is the norm alone."""
    x, noise, nscale, bias = _inputs(3, 6, 5, 8, dtype)
    y, s1, s2 = af.noise_bias_lrelu_stats_plain(x, noise, nscale, bias)
    zero = torch.zeros(3, 16, dtype=dtype)
    want = instance_norm(y)
    got = af.adain_apply_plain(y, s1, s2, zero[:, :8], zero[:, 8:], count=30)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=ulp,
                               atol=ulp)
    mean = s1 / 30
    var = s2 / 30 - mean * mean
    torch.testing.assert_close(
        af.adain_apply_plain(y, mean, var, zero[:, :8], zero[:, 8:]).float(),
        instance_norm_apply(y, mean, var).float(), rtol=ulp, atol=ulp)


def test_variance_is_clamped():
    """A negative variance (kernel 1's is not clamped, and E[v^2] -
    mean^2 of a constant channel can round below 0) normalizes as 0 does:
    finite, where rsqrt of a negative would be NaN."""
    x, _, _, _ = _inputs(2, 4, 4, 8, torch.float32)
    ys, yb = _styles(2, 8, torch.float32)
    mean = x.mean(dim=(1, 2))
    var = x.var(dim=(1, 2))
    var[:, 3] = -0.5
    got = af.adain_apply_plain(x, mean, var, ys, yb)
    var[:, 3] = 0.0
    torch.testing.assert_close(got, af.adain_apply_plain(x, mean, var, ys,
                                                         yb), rtol=0, atol=0)
    assert torch.isfinite(got).all()
    const = torch.full((1, 8, 8, 2), 0.1)  # sums that round
    s1, s2 = const.sum(dim=(1, 2)), (const * const).sum(dim=(1, 2))
    out = af.adain_apply_plain(const, s1, s2, ys[:1, :2], yb[:1, :2],
                               count=64)
    assert torch.isfinite(out).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, noise, nscale, bias = _inputs(2, 4, 4, 8, torch.bfloat16)
    ys, yb = _styles(2, 8, torch.bfloat16)
    s = torch.zeros(2, 8)
    bad_stats = [
        ((x.float().half(), noise, nscale, bias), TypeError),
        ((x, noise[..., None], nscale, bias), ValueError),
        ((x, noise, nscale.double(), bias), TypeError),
        ((x.transpose(1, 2), noise, nscale, bias), ValueError),
    ]
    for args, err in bad_stats:
        with pytest.raises(err):
            af.noise_bias_lrelu_stats(*args)
    bad_apply = [
        ((x, s, s, ys.float(), yb), TypeError),
        ((x, s, s[:1], ys, yb), ValueError),
        ((x, s, s, ys.t().contiguous().t(), yb), ValueError),
        ((x, s.double(), s, ys, yb), TypeError),
    ]
    for args, err in bad_apply:
        with pytest.raises(err):
            af.adain_apply(*args)
    with pytest.raises(ValueError, match="1024 channels"):
        af.noise_bias_lrelu_stats(*_inputs(1, 1, 1, 1040, torch.float32))


# ---------------------------------------------------------- the tile plan
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("hw,c", BLOCK_SHAPES + [(5, 12), (33, 1024)])
def test_tile_plan_covers_each_image_once(n, hw, c):
    """The tiles cover every pixel, none empty, about 8 blocks an SM over
    the batch, and no block below the least work unless the image is."""
    p, sms = hw * hw, 132
    tile_px, tiles = af.tile_plan(n, p, c, sms)
    assert tile_px * tiles >= p > (tiles - 1) * tile_px
    assert n * tiles <= max(n, 8 * sms + n)
    if tiles > 1:
        assert tile_px >= (af._BLOCK_ELEMS // c) // 2
    assert tiles == 1 or n * tiles >= min(8 * sms, n * p * c // 8192) // 2


# ------------------------------------------------- the block and the batch
def _eager_adain(adain, x, mean, var, w):
    y = adain.affine(w)
    c = adain.channels
    xn = instance_norm_apply(x, mean, var)
    return (xn * (y[:, :c][:, None, None, :] + 1.0)
            + y[:, c:][:, None, None, :]).to(x.dtype)


def _eager_forward(self, x, w1, w2, noise=(None, None), generator=None,
                   quant=None, absmax=None, name=""):
    """``StyleBlock.forward`` (float path) with its chain written one
    PyTorch op at a time, rounding to the compute dtype after each, as the
    block ran it before the two passes."""
    y = x
    if not self.first:
        y = self.blur_1(getattr(self, self.up_name)(y))
    y = y + (noise[0] * self.noise_1.scale_factors).to(y.dtype)
    y = tl.leaky_relu(y + self.bias_1.bias.to(y.dtype))
    yf = y.float()
    mean = yf.mean(dim=(1, 2))
    y = _eager_adain(self.adain_1, y, mean,
                     (yf * yf).mean(dim=(1, 2)) - mean * mean, w1)
    y, mean, var = conv3x3_noise_bias_lrelu_instats(
        y.contiguous(), self.conv_2.effective_weight().contiguous(),
        noise[1][..., 0].contiguous(), self.noise_2.scale_factors,
        self.bias_2.bias, leaky=0.2)
    return _eager_adain(self.adain_2, y, mean, var, w2)


NARROW = dict(max_res_log2=6, fmap_base=256, fmap_max=32, latent_size=32)


def _narrow_generators(seed=4):
    """The same narrow generator in f32 and bf16, every noise scale and
    bias nonzero."""
    f32 = StyleGanGenerator(GanConfig(**NARROW))
    f32.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in f32.named_parameters():
            if name.endswith(("scale_factors", "bias")) and \
                    "mapping" not in name:
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    bf16 = StyleGanGenerator(GanConfig(**NARROW), torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    return f32.eval(), bf16.eval()


def test_bf16_block_rounds_no_more_than_the_eager_chain(monkeypatch):
    """In bf16 the passes land as close to the f32 generator as the
    op-at-a-time chain did, block by block and in the rgb image: no
    further on average, and their largest error within a quarter of the
    chain's (a single rounding that flips is amplified by the blocks after
    it, either way)."""
    f32, bf16 = _narrow_generators()
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(7))
    noise = f32.draw_noise(3, torch.Generator().manual_seed(8))
    with torch.no_grad():
        rgb_want, want = f32(z, noise=noise)
        rgb_got, got = bf16(z, noise=noise)
        monkeypatch.setattr(StyleBlock, "forward", _eager_forward)
        rgb_eager, eager = bf16(z, noise=noise)
    for w, g, e in zip([rgb_want, *want], [rgb_got, *got],
                       [rgb_eager, *eager]):
        err_got = (g.float() - w).abs()
        err_eager = (e.float() - w).abs()
        assert err_got.mean() <= err_eager.mean()
        assert err_got.max() <= 1.25 * err_eager.max()


class _OpCalls(TorchDispatchMode):
    """The calls of each ``torch.ops.gst`` op under the mode."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "gst":
            self.calls[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_ffhq_batch_calls_each_pass(dtype):
    """A batch through the ffhq generator's nine blocks (4^2 to 1024^2; at
    narrow widths here, which the calls do not depend on) calls pass A
    once a block and pass B twice: 9 and 18, beside kernel 1's 9."""
    cfg = GanConfig(max_res_log2=10, fmap_base=1024, fmap_max=8,
                    latent_size=16)
    model = StyleGanGenerator(cfg, dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    z = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    noise = model.draw_noise(2, torch.Generator().manual_seed(2))
    with _OpCalls() as ops, torch.no_grad():
        rgb, feats = model(z, noise=noise)
    assert tuple(rgb.shape) == (2, 1024, 1024, 3)
    assert [f.shape[1] for f in feats] == [hw for hw, _ in BLOCK_SHAPES]
    assert ops.calls == {"noise_bias_lrelu_stats": 9, "adain_apply": 18,
                         "conv3x3_in_stats": 9}


def test_captures_count_the_passes():
    """Both wrappers are counted in a capture's launch deltas."""
    assert af.noise_bias_lrelu_stats in graphs.COUNTED
    assert af.adain_apply in graphs.COUNTED


# ------------------------------------------- the benchmark's kernel family
def _trace_module():
    spec = importlib.util.spec_from_file_location(
        "gsbench_trace", join(ROOT, "benchmark", "gsbench", "trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_counts_the_passes_as_glue():
    """The benchmark's trace reader (``gsbench/trace.py::family``) puts
    the passes' kernels in "glue", as it did the PyTorch ops they replace:
    a name holding one of its library words (conv, nhwc, sm90_, ...) would
    move them to "library" and shrink the glue metric by hand.  The names
    are read from the CUDA source, in the profiler's demangled form with
    each instantiation's template and argument types."""
    trace = _trace_module()
    with open(join(ROOT, "gan_segmentation_tpu_torch", "csrc",
                   "adain_fused.cu")) as fh:
        src = fh.read()
    kernels = set(re.findall(r"\b(\w+_kernel)\(", src))  # declarations
    assert sorted(kernels) == ["gst_adain_apply_kernel",
                               "gst_in_sums_finish_kernel",
                               "gst_noise_bias_lrelu_stats_kernel"]
    names = []
    for t, v in (("__nv_bfloat16", 8), ("__nv_bfloat16", 1), ("float", 4),
                 ("float", 1)):
        names.append(
            f"void gst::(anonymous namespace)::gst_noise_bias_lrelu_stats_"
            f"kernel<{t}, {v}>({t} const*, float const*, float const*, "
            f"float const*, {t}*, float*, int, int, int, float)")
        names.append(
            f"void gst::(anonymous namespace)::gst_adain_apply_kernel<{t}, "
            f"{v}>({t} const*, float const*, float const*, {t} const*, "
            f"{t} const*, long long, long long, {t}*, int, int, int, float, "
            f"float)")
    names.append("gst::(anonymous namespace)::gst_in_sums_finish_kernel("
                 "float const*, float*, float*, int, int)")
    for name in names:
        assert trace.family(name) == "glue", name
        assert trace.kernel_of(name) is None


# -------------------------------------------------------------- on a card
@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels build with nvcc)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _sums_close(got, want, y):
    """Sums added in another order: within f32 rounding of the sum of
    the magnitudes."""
    yf = y.float()
    scale = (yf.abs().sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2)))
    for g, w, s in zip(got, want, scale):
        assert ((g.cpu() - w).abs() <= 1e-6 * s + 1e-6).all()


EDGES = [(2, 5, 7, 12, 0), (2, 4, 4, 16, 2), (1, 3, 3, 1024, 0)]


def _shapes():
    out = [(n, hw, hw, c, 0) for hw, c in BLOCK_SHAPES for n in (1, 3, 8)]
    return out + EDGES


def _misaligned(t, elems):
    """``t``'s values at a storage offset of ``elems`` elements (not 16-
    byte aligned for elems = 2): the kernels' one-channel path."""
    if not elems:
        return t
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _shapes())
def test_cuda_passes_match_the_twins(cuda, dtype, shape):
    """Both kernels against their plain versions on the CPU at every
    block shape of ffhq, cars and bedrooms (N 1, 3, 8), and at a
    channel count and a storage offset that take the one-channel path:
    y bit for bit, the sums to f32 rounding."""
    n, h, w, c, off = shape
    x, noise, nscale, bias = _inputs(n, h, w, c, dtype, seed=h + c + n)
    ys, yb = _styles(n, c, dtype)
    want = af.noise_bias_lrelu_stats_plain(x, noise, nscale, bias)
    got = af.noise_bias_lrelu_stats(
        _misaligned(x.to(cuda), off), noise.to(cuda), nscale.to(cuda),
        bias.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    _sums_close(got[1:], want[1:], want[0])
    y = want[0]
    for count, (a, b) in ((h * w, want[1:]),
                          (0, (want[1] / (h * w), want[2] / (h * w)))):
        b = b - a * a if not count else b
        ref = af.adain_apply_plain(y, a, b, ys, yb, count=count)
        out = af.adain_apply(_misaligned(y.to(cuda), off), a.to(cuda),
                             b.to(cuda), ys.to(cuda), yb.to(cuda),
                             count=count)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_repeats_are_bit_identical(cuda, dtype):
    """Repeats agree bit for bit, eagerly and as replays of a CUDA graph
    (a ``GraphedCall``), and one ffhq-shaped block chain counts one pass-A
    and two pass-B launches."""
    x, noise, nscale, bias = _inputs(8, 256, 256, 64, dtype, device=cuda)
    ys, yb = _styles(8, 64, dtype, device=cuda)

    def chain():
        y, s1, s2 = af.noise_bias_lrelu_stats(x, noise, nscale, bias)
        y = af.adain_apply(y, s1, s2, ys, yb, count=256 * 256)
        return af.adain_apply(y, s1 / 65536, s2 / 65536, ys, yb), s1, s2

    before = (af.noise_bias_lrelu_stats.launches, af.adain_apply.launches)
    first = chain()
    assert (af.noise_bias_lrelu_stats.launches - before[0],
            af.adain_apply.launches - before[1]) == (1, 2)
    for _ in range(3):
        for a, b in zip(chain(), first):
            assert torch.equal(a, b)
    call = graphs.GraphedCall(chain, cuda)
    for _ in range(4):
        out = call()
        torch.cuda.synchronize()
        for a, b in zip(out, first):
            assert torch.equal(a, b)
    assert call.replays == 3
    assert call.deltas[af.noise_bias_lrelu_stats] == 1
    assert call.deltas[af.adain_apply] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_spatial_grid_matches_one_device(cuda, dtype):
    """A 1 x 2 band grid on one card (``core/spatial.py``, pass A per band,
    the bands' sums added) against the block on the whole image: the same
    features up to the order of the sums (f32) or a bf16 rounding."""
    f32, bf16 = _narrow_generators()
    model = (f32 if dtype == torch.float32 else bf16).to(cuda)
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(9))
    noise = model.draw_noise(3, torch.Generator(cuda).manual_seed(10))
    plan = spatial.BandPlan.of(model.cfg, 2)
    with torch.inference_mode():
        _, want = model(z.to(cuda), noise=noise)
        _, got = spatial.synthesize([model, model], [cuda, cuda], z.to(cuda),
                                    noise, plan)
    for w, g in zip(want, got):
        g, w = spatial.gather(g, cuda).float(), w.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:  # a rounding flipped by the sums' order carries on
            far = (g - w).abs() > 0.05 + 0.02 * w.abs()
            assert far.float().mean() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ffhq_batch_launches(cuda, dtype, monkeypatch):
    """One ffhq batch of 8 at 1024^2 on the card: 9 pass-A and 18 pass-B
    launches, and the output bit-identical on a repeat (with cuDNN's
    deterministic algorithms: its default f32 ones for the up-sampling
    convs differ run to run)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = gan_config("ffhq")
    model = StyleGanGenerator(cfg, dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    z = torch.randn(8, cfg.latent_size, device=cuda)
    noise = model.draw_noise(8, torch.Generator(cuda).manual_seed(1))
    before = (af.noise_bias_lrelu_stats.launches, af.adain_apply.launches)
    with torch.inference_mode():
        rgb, _ = model(z, noise=noise)
        assert (af.noise_bias_lrelu_stats.launches - before[0],
                af.adain_apply.launches - before[1]) == (9, 18)
        again, _ = model(z, noise=noise)
    assert torch.equal(rgb, again)

"""The port's int8 generation (gan_segmentation_tpu_torch/ops/quant.py, the
int8 modes of models/{layers,stylegan,decoder}.py, core/params_bridge.py's
int8 bridge) against the JAX package's ops/quant.py on the CPU.

Numpy-seeded inputs go through both packages.  Tolerances:
- ``quantize_weight``, ``quantize_act``, JAX's ``conv2d_s8`` against the
  port's s8 product on each route the program runs (kernels 1 and 2's s8
  entries, the 1x1 product, the sub-pixel form), and the weight
  transforms' integers: bit for bit;
- JAX's ``conv2d_s8_fused`` against the port's 3x3 site (``qconv3x3``):
  the s32 sums equal, 1e-6 relative after dequant;
- the decoder (f32, ``SolverConfig(max_res_log2=5)``, random weights): with
  the JAX quantized tree carried across, logits within 1e-3 relative L2
  and argmax equal on >= 99.9% of pixels (an activation landing within an
  f32 rounding of a .5 tie may quantize one code apart); with the port's
  own calibration on the same pyramids, codes equal on >= 99.9% of entries
  and never more than 1 apart, logits within 7e-3 relative L2 (measured
  5.34e-3 and 3.64e-3: the scales' ~1e-6 differences flip a few activation
  codes);
The generator's int8 sites are held in ``test_torch_quant_generator.py``,
the pipeline in ``test_torch_quant_pipeline.py``.  The JAX
``FusedPipeline(quant=...)`` is not called: its XLA CPU int8 compile takes
minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_segmentation_tpu.core.config import SolverConfig as JSolverConfig
from gan_segmentation_tpu.models.decoder import decoder_from_config as jdec
from gan_segmentation_tpu.ops import conv as jconv
from gan_segmentation_tpu.ops import quant as jq
from gan_segmentation_tpu.ops import s2d_decoder as js2d

from gan_segmentation_tpu_torch.core.config import SolverConfig
from gan_segmentation_tpu_torch.core.params_bridge import (
    decoder_int8_state, decoder_state_dict)
from gan_segmentation_tpu_torch.kernels import conv_in_stats as k1m
from gan_segmentation_tpu_torch.kernels import quantize as kqm
from gan_segmentation_tpu_torch.kernels import small_conv as k2m
from gan_segmentation_tpu_torch.models.decoder import decoder_from_config
from gan_segmentation_tpu_torch.ops import conv as tconv
from gan_segmentation_tpu_torch.ops import quant as tq

torch.set_num_threads(2)  # the test workers share the host's cores

T = torch.from_numpy


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------------- ops
def test_quantize_weight_bit_equal():
    """Per-channel scales and codes equal, with .5 ties constructed (k /
    scale lands on n + 0.5: round half to even) and an all-zero channel
    (the 1e-12 floor)."""
    rng = np.random.RandomState(0)
    k = (rng.randn(3, 3, 8, 16) * rng.rand(16) * 5).astype(np.float32)
    k[..., 3] = 0.0
    # channel 5: absmax 127 -> scale 1, entries at n + 0.5
    k[..., 5] = rng.randint(-126, 126, (3, 3, 8)) + 0.5
    k[0, 0, 0, 5] = 127.0
    jqw, jsc = jq.quantize_weight(jnp.asarray(k))
    tqw, tsc = tq.quantize_weight(T(k))
    assert tqw.dtype == torch.int8
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_act_bit_equal(dtype):
    """``round(x * inv)`` half to even, saturating at +-127, from f32 and
    bf16 inputs (the product in f32), with ties and overflow."""
    rng = np.random.RandomState(1)
    x = np.concatenate([np.arange(-130, 130) + 0.5,
                        [300.0, -300.0, 126.5, -126.5, 127.5, 0.4999999],
                        rng.randn(500) * 60]).astype(np.float32)
    xt = T(x).to(dtype)
    for inv in (1.0, 0.5, 127.0 / 3.3):
        inv32 = np.float32(inv)
        want = jq.quantize_act(jnp.asarray(xt.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
            inv32)
        got = tq.quantize_act(xt, torch.tensor([inv32]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, kqm.quantize_s8_plain(xt, torch.tensor(
            [inv32])))


def _s8_sums(route, x, w):
    """The s32 sums of the port's s8 product on the route the program runs
    for a (kh, kw, Cin, Cout) int8 kernel ``w`` over int8 ``x``, as int32:
    kernel 2's or kernel 1's s8 body (3x3, stride 1, pad 1; ``deq`` 1, no
    bias, noise or activation, f32 out), the 1x1 integer product, or the
    sub-pixel form of a 4x4 kernel over the 2-dilated input padded by 2."""
    cout = w.shape[-1]
    one = torch.ones(cout)
    if route == "kernel2":
        y = k2m.conv3x3_small_s8(x, tq._layout3x3(w), one,
                                 out_dtype=torch.float32)
    elif route == "kernel1":
        n, h, wd, _ = x.shape
        y, _, _ = k1m.conv3x3_noise_bias_lrelu_instats_s8(
            x, tq._layout3x3(w), one, torch.zeros(n, h, wd),
            torch.zeros(cout), torch.zeros(cout), leaky=1.0,
            out_dtype=torch.float32)
    elif route == "1x1":
        q = tq.QConv(tq._layout1x1(w), one, None, torch.ones(1))
        y = tq.qconv1x1(None, q, torch.float32, xq=x)
    else:
        q = tq.QConv(tq._layout3x3(tq.subpixel_kernel(w)),
                     one.repeat_interleave(4), None, torch.ones(1))
        y = tq.depth_to_space(tq.qconv3x3(None, q, None, torch.float32,
                                          xq=x))
    return y.round().to(torch.int32)


S8_ROUTES = {"kernel2": (3, dict(padding=1)), "kernel1": (3, dict(padding=1)),
             "1x1": (1, dict()), "subpixel": (4, dict(padding=2,
                                                      lhs_dilation=2))}


# ids as the cases had when they ran the port's own conv2d_s8
@pytest.mark.parametrize("route", list(S8_ROUTES),
                         ids=[f"case{i}" for i in range(len(S8_ROUTES))])
def test_conv2d_s8_bit_equal(route):
    """JAX's ``conv2d_s8`` against the port's s8 product on each route the
    program runs (the plain versions on the CPU, the kernels' references):
    the same s32 sums.  Every sum here is below 2^24, so the f32 outputs
    hold them exactly."""
    rng = np.random.RandomState(2)
    k, case = S8_ROUTES[route]
    x = rng.randint(-127, 128, (2, 9, 10, 8)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, 8, 6)).astype(np.int8)
    want = np.asarray(jq.conv2d_s8(jnp.asarray(x), jnp.asarray(w), **case))
    np.testing.assert_array_equal(_s8_sums(route, T(x), T(w)).numpy(), want)


def test_conv2d_s8_fused_matches_jax():
    """JAX's ``conv2d_s8_fused`` (quantize, s8 conv, dequantize, bias)
    against the port's 3x3 site, ``qconv3x3`` through kernel 2's s8 entry
    with its epilogue: the s32 sums equal, 1e-6 relative after dequant."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    wq, wsc = jq.quantize_weight(jnp.asarray(rng.randn(3, 3, 16, 8),
                                             jnp.float32))
    inv = np.float32(127.0 / np.abs(x).max())
    deq = np.asarray(wsc) / inv
    b = rng.randn(8).astype(np.float32)
    want = jq.conv2d_s8_fused(jnp.asarray(x), inv, wq, jnp.asarray(deq),
                              jnp.asarray(b), padding=1)
    s32 = jq.conv2d_s8(jq.quantize_act(jnp.asarray(x), inv), wq, padding=1)
    inv_t = torch.tensor([inv])
    got_s32 = _s8_sums("kernel2", tq.quantize_act(T(x), inv_t),
                       T(np.asarray(wq)))
    np.testing.assert_array_equal(got_s32.numpy(), np.asarray(s32))
    q = tq.QConv(tq._layout3x3(T(np.asarray(wq))), T(deq), T(b), inv_t)
    got = tq.qconv3x3(T(x), q, None, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


# ---------------------------------------------------- the weight transforms
def test_compose_kernel_2d_matches_jax():
    w = np.random.RandomState(4).randn(3, 3, 5, 7).astype(np.float32)
    want = np.asarray(jconv.compose_kernel_2d(jnp.asarray(w), jconv._UP2))
    got = tconv.compose_kernel_2d(T(w), tconv._UP2).numpy()
    np.testing.assert_array_equal(tconv._UP2, jconv._UP2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_upsample_conv_kernel_s2d_matches_jax():
    assert tq._ROW_UP == js2d._ROW_UP
    w = np.random.RandomState(5).randn(3, 3, 4, 6).astype(np.float32)
    want = np.asarray(js2d.upsample_conv_kernel_s2d(jnp.asarray(w)))
    np.testing.assert_allclose(tq.upsample_conv_kernel_s2d(T(w)).numpy(),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("feats,n_block", [((4,), 3), ((4, 4, 4, 4), 3),
                                           ((4, 4, 4, 4), 2),
                                           ((4,) * 9, 3)])
def test_plan_matches_jax(feats, n_block):
    class Dec:
        in_channels, start_res = feats, 0
    if len(feats) < 2:
        with pytest.raises(AssertionError):
            js2d._plan(Dec, n_block)
        with pytest.raises(ValueError):
            tq._plan(len(feats), 0, n_block)
        return
    assert tq._plan(len(feats), 0, n_block) == js2d._plan(Dec, n_block)


@pytest.mark.parametrize("deconv", [False, True])
def test_subpixel_form_is_the_same_integers(deconv):
    """A 4x4 s8 kernel over the 2-dilated input padded by 2 (the JAX
    package's composed nearest-2x conv and k4 s2 p1 deconv) equals the
    port's sub-pixel form: a coarse 3x3 s8 conv with 4 x Cout channels,
    then depth-to-space, integer for integer."""
    rng = np.random.RandomState(6 + deconv)
    x = rng.randint(-127, 128, (2, 5, 6, 8)).astype(np.int8)
    if deconv:
        k = rng.randint(-127, 128, (4, 4, 8, 3)).astype(np.int8)
    else:  # the composition of a 3x3 kernel with the nearest-2x filter
        k3 = rng.randint(-31, 32, (3, 3, 8, 3)).astype(np.float32)
        k = np.asarray(jconv.compose_kernel_2d(jnp.asarray(k3), jconv._UP2)
                       ).round().astype(np.int8)
    want = jq.conv2d_s8(jnp.asarray(x), jnp.asarray(k), padding=2,
                        lhs_dilation=2)
    w = tq._layout3x3(tq.subpixel_kernel(T(k)))
    acc = k2m.conv3x3_s8_acc(T(x), w)
    got = tq.depth_to_space(acc).round().to(torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ decoder
DEC_CFG = dict(max_res_log2=5)


def _pyramids(cfg, seed, batch=2):
    return [np.random.RandomState(seed + i).randn(
        batch, 2 ** (i + 2), 2 ** (i + 2), c).astype(np.float32)
        for i, c in enumerate(cfg.in_channels)]


def _decoder_vars(model, cfg, seed):
    """Variables of the JAX decoder's init shapes drawn with numpy, with
    batch-norm statistics off their init (so the fold shows)."""
    feats = [jnp.zeros((1, 2 ** (i + 2), 2 ** (i + 2), c), jnp.float32)
             for i, c in enumerate(cfg.in_channels)]
    shapes = jax.eval_shape(lambda k, f: model.init(k, f, False),
                            jax.random.PRNGKey(0), feats)
    rng = np.random.RandomState(seed)

    def draw(path, p):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = np.prod(p.shape[:3])
            return (rng.uniform(-1, 1, p.shape) * np.sqrt(2.34 / fan_in)
                    ).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (0.1 * rng.randn(*p.shape)).astype(np.float32)

    out = {}
    for col, tree in shapes.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        out[col] = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [draw(path, p) for path, p in flat])
    return out


@pytest.fixture(scope="module", params=[3, 2], ids=["block3", "block2"])
def decoders(request):
    """(n_block_stages, JAX model, variables, JAX int8 tree, port decoder,
    calibration pyramids): the JAX tail with every resblock stage a block
    stage (3) and with a fine one first (2)."""
    n_block = request.param
    jcfg = JSolverConfig(**DEC_CFG)
    model = jdec(jcfg)
    v = _decoder_vars(model, jcfg, 10 + n_block)
    calib = [_pyramids(jcfg, 50), _pyramids(jcfg, 60)]
    qtree = jax.device_get(jq.prepare_s2d_int8(
        model, v, [[jnp.asarray(f) for f in c] for c in calib], n_block))
    port = decoder_from_config(SolverConfig(**DEC_CFG)).eval()
    port.load_state_dict(decoder_state_dict(v["params"], v["batch_stats"]))
    return n_block, model, v, qtree, port, calib


def _jax_logits(model, qtree, feats, n_block):
    return np.asarray(jax.jit(lambda q, f: jq.apply_s2d_int8(
        model, q, f, n_block, fine_logits=True))(
        qtree, [jnp.asarray(f) for f in feats]))


def test_decoder_state_matches_prepare_s2d_int8(decoders):
    """The port's own calibration and quantization on the same pyramids
    against the JAX tree carried across: the same sites, block conv_0 in
    its c * 4 + parity order, codes equal on >= 99.9% of entries and never
    more than 1 apart, scales within 1e-5."""
    n_block, _, _, qtree, port, calib = decoders
    mine = tq.prepare_decoder_int8(
        port, [[T(f) for f in c] for c in calib], torch.float32, n_block)
    theirs = decoder_int8_state(qtree, port, n_block)
    assert mine.names == theirs.names and mine.first_block == \
        theirs.first_block == 3 - n_block
    assert theirs["main_0.conv_0"].w.shape[2] == (
        4 * 32 if n_block == 3 else 32)
    same = total = 0
    for name in mine.names:
        a, b = mine[name], theirs[name]
        assert a.w.shape == b.w.shape and a.w.dtype == torch.int8, name
        diff = (a.w.int() - b.w.int()).abs()
        assert int(diff.max()) <= 1, name
        same += int((diff == 0).sum())
        total += diff.numel()
        for t in ("deq", "b", "inv"):
            np.testing.assert_allclose(getattr(a, t).numpy(),
                                       getattr(b, t).numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name}.{t}")
    assert same / total >= 0.999, same / total


def test_decoder_int8_logits_match_jax(decoders):
    """The JAX tree carried across: the port's natural-layout int8 forward
    equals apply_s2d_int8(fine_logits=True) within 1e-3 (argmax >= 99.9%),
    and its int8 logits keep the JAX package's worst-case bounds against
    the float path (rel < 0.06, agreement > 0.97)."""
    n_block, model, v, qtree, port, calib = decoders
    feats = _pyramids(JSolverConfig(**DEC_CFG), 20)
    want = _jax_logits(model, qtree, feats, n_block)
    tf = [T(f) for f in feats]
    with torch.no_grad():
        got = port.forward_int8(tf, decoder_int8_state(qtree, port, n_block),
                                torch.float32).numpy()
        ref = port(tf).numpy()
    assert got.shape == want.shape == ref.shape
    assert rel_l2(got, want) <= 1e-3, rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
    assert rel_l2(got, ref) < 0.06
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.97


def test_decoder_own_calibration_logits_match_jax(decoders):
    """The port's own calibration on the same pyramids: its int8 logits lie
    within 7e-3 relative L2 of the JAX int8 logits, argmax equal on >= 99%
    of pixels.  The two float calibration paths sum their convs in
    different orders (and XLA's rsqrt in the BN fold is not correctly
    rounded), so the scales differ by ~1e-6 relative and a few weight
    codes by one; activations near a .5 tie then quantize one code apart,
    layer after layer: measured 5.34e-3 with every stage a block stage,
    3.64e-3 with a fine stage first, against 2.8e-2 and 3.0e-2 from int8
    to float (the codes themselves are held above)."""
    n_block, model, v, qtree, port, calib = decoders
    feats = _pyramids(JSolverConfig(**DEC_CFG), 20)
    want = _jax_logits(model, qtree, feats, n_block)
    tf = [T(f) for f in feats]
    with torch.no_grad():
        own = port.forward_int8(tf, tq.prepare_decoder_int8(
            port, [[T(f) for f in c] for c in calib], torch.float32,
            n_block), torch.float32).numpy()
    assert rel_l2(own, want) <= 7e-3, rel_l2(own, want)
    assert (own.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_decoder_calibration_covers_every_site(decoders):
    n_block, model, v, qtree, port, calib = decoders
    stats = tq.collect_calibration(port, [T(f) for f in calib[0]],
                                   torch.float32, n_block)
    assert list(stats) == tq.decoder_sites(port, n_block)
    assert all(float(s) > 0 for s in stats.values())
    # one JAX site per port site
    assert sum(len([k for k in st if k in ("cvt_k", "k0", "k1", "ksc",
                                            "kf")])
               for st in qtree["stages"].values()) == len(stats)


def test_shortcut_shares_conv_0s_quantized_input(decoders, monkeypatch):
    """A resblock's shortcut reads conv_0's input, at conv_0's scale: the
    int8 forward quantizes it once for both (one quantize pass per site
    but the shortcuts), and a state whose two scales differ is refused."""
    n_block, model, v, qtree, port, calib = decoders
    state = decoder_int8_state(qtree, port, n_block)
    shortcuts = [s for s in state.names if s.endswith(".shortcut")]
    assert shortcuts
    calls, real = [], tq.quantize_act
    monkeypatch.setattr(tq, "quantize_act",
                        lambda x, inv: calls.append(inv) or real(x, inv))
    with torch.no_grad():
        port.forward_int8([T(f) for f in _pyramids(JSolverConfig(**DEC_CFG),
                                                   20)], state, torch.float32)
    assert len(calls) == len(state.names) - len(shortcuts)
    stats = tq.collect_calibration(port, [T(f) for f in calib[0]],
                                   torch.float32, n_block)
    stats[shortcuts[0]] = stats[shortcuts[0]] * 1.5
    with pytest.raises(ValueError, match="read one input"):
        tq.prepare_decoder_int8(port, [], torch.float32, n_block,
                                stats=stats)

"""The DeepLab trainer's compiled programs in the port
(gan_segmentation_tpu_torch/train/deeplab_trainer.py): the train step as
``GraphedTrainStep`` (static inputs, the optimizer's rates in tensors,
the dropout uniforms drawn before each call), validation and the tester's
bucket call as ``GraphedFunction``.  On the CPU ``GraphedCall`` runs the
graphed-mode body eagerly, so these tests run that body: tiny (1, 1, 1, 1)
backbone under the real heads, crop 32, batch 2-4, f32.

- five graphed-mode steps with dropout equal five eager ``train_step``s bit
  for bit (losses, logits, weights and statistics, momentum, the dropout
  generator's state);
- with dropout off, two graphed-mode trainer steps match the JAX package's
  jitted ``SegmentationTrainer._train_step`` within the tolerances of
  ``tests/test_torch_deeplab_step.py::
  test_train_and_eval_steps_match_the_jax_steps`` (first step: loss 1e-5
  relative, logits 2e-3 of the largest; second: 1e-3 and 2e-2; weights and
  statistics 2e-3);
- the scheduler fills the same rate tensors; ``draw_dropout`` makes the
  bits the eager forward draws; the padded ragged validation tail gives
  the unpadded metric; the tester's scores and ``bucket_calls`` are those
  of the eager evaluator when its calls replay.

The ``cuda`` tests hold replays to eager steps on the card (cuDNN's
deterministic mode) and a ``GraphedFunction``'s graphs to one memory pool,
and skip without one.  This module imports jax only
inside the test that needs it, so the ``cuda`` tests run where jax is
installed without its neural-network library.
"""

import copy

import numpy as np
import pytest
import torch

from gan_segmentation_tpu_torch.core import graphs
from gan_segmentation_tpu_torch.models import deeplab as tdl
from gan_segmentation_tpu_torch.ops import dropout as tdropout
from gan_segmentation_tpu_torch.train import deeplab_trainer as ttrainer

torch.set_num_threads(2)  # the test workers share the host's cores

CROP = 32
STEPS = 5


@pytest.fixture(scope="module")
def tiny_model():
    """One DeepLabV3+ on the (1, 1, 1, 1) backbone, dropout on; tests take
    copies."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
        return tdl.DeepLabV3Plus(2, "tiny", crop_size=CROP,
                                 generator=torch.Generator().manual_seed(7))


def _batches(n=STEPS, batch=4, seed=0):
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy(rs.randint(0, 256, (batch, CROP, CROP, 3))
                              .astype(np.uint8)),
             torch.from_numpy(rs.randint(-1, 2, (batch, CROP, CROP))
                              .astype(np.int8))) for _ in range(n)]


def _run(model, batches, graphed, device="cpu", dtype=torch.float32,
         optimizer_graphed=None):
    """``len(batches)`` steps -> (losses, logits, model, optimizer,
    scheduler, generator); ``optimizer_graphed`` picks the eager steps'
    optimizer (default: ``graphed``)."""
    og = graphed if optimizer_graphed is None else optimizer_graphed
    opt, sched = ttrainer.make_optimizer(model, 0.005, 10, 2e-4, 0.9,
                                         graphed=og)
    gen = torch.Generator(device=device).manual_seed(3)
    step = (ttrainer.GraphedTrainStep(model, opt, sched, gen, dtype=dtype)
            if graphed else None)
    losses, logits = [], []
    for images, masks in batches:
        images, masks = images.to(device), masks.to(device)
        if graphed:
            loss, pred = step(images, masks)
        else:
            loss, pred = ttrainer.train_step(model, opt, sched, images,
                                             masks, gen, dtype=dtype)
        losses.append(loss.clone())  # a graphed step's outputs are reused
        logits.append(pred.clone())
    return losses, logits, model, opt, sched, gen


def _same_runs(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0])), "losses"
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1])), "logits"
    sa, sb = a[2].state_dict(), b[2].state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    ma = [s["momentum_buffer"] for s in a[3].state.values()]
    mb = [s["momentum_buffer"] for s in b[3].state.values()]
    assert len(ma) == len(mb) > 0
    assert all(torch.equal(x, y) for x, y in zip(ma, mb)), "momentum"
    assert a[4].last_epoch == b[4].last_epoch == len(a[0])
    assert torch.equal(a[5].get_state(), b[5].get_state()), "generator"


def test_graphed_steps_equal_eager_steps_bit_for_bit(tiny_model):
    """Five steps with dropout on, batch 4 at 32^2: equal bit for bit (the
    graphed side's warm-up steps and its three 'replays' alike)."""
    batches = _batches()
    eager = _run(copy.deepcopy(tiny_model), batches, graphed=False)
    graphed = _run(copy.deepcopy(tiny_model), batches, graphed=True)
    assert not torch.equal(eager[0][0], eager[0][1])
    _same_runs(graphed, eager)


def test_graphed_step_matches_the_jax_step(tmp_path, monkeypatch, rng):
    """The inputs, weights and tolerances of
    ``test_train_and_eval_steps_match_the_jax_steps`` (one uint8 batch of 2
    at 48^2 and int8 masks with ignored pixels, twice; SGD 0.9, weight
    decay 2e-4, poly rate over 10 steps, head at 10x; dropout off): two
    graphed-mode steps of the port's trainer (``SegmentationTrainer.step``:
    staged host batches, static inputs, tensor rates) against the JAX
    trainer's jitted ``_train_step``.  The rate is 2e-4, as in
    ``tests/test_torch_deeplab_trainer.py``'s trainers: at 0.005 the JAX
    trainer's step and the JAX step written out in that test already differ
    by 4.9e-3 of the largest weight after two steps (the ill-conditioned
    train-mode gradient, see tests/test_torch_deeplab.py)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from test_deeplab import make_rgb_dataset
    from test_torch_deeplab import _close, _no_dropout, jax_variables
    from test_torch_deeplab_trainer import MODEL_CFG, OPT, _args, _sets

    from gan_segmentation_tpu.core.mesh import make_mesh
    from gan_segmentation_tpu.data import augment as jaug
    from gan_segmentation_tpu.data import segmentation as jseg
    from gan_segmentation_tpu.models import deeplab as jdl
    from gan_segmentation_tpu.train import deeplab_trainer as jtrainer

    from gan_segmentation_tpu_torch.core.params_bridge import \
        deeplab_state_dict
    from gan_segmentation_tpu_torch.data import augment as taug
    from gan_segmentation_tpu_torch.data import segmentation as tseg

    monkeypatch.setitem(jdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
    monkeypatch.setitem(tdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
    images = rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    masks = rng.randint(-1, 2, (2, 48, 48)).astype(np.int8)
    # 10 training images at batch 2 over OPT's 2 epochs: 10 steps
    make_rgb_dataset(tmp_path, "train_generated", 10, size=40, seed=3)
    make_rgb_dataset(tmp_path, "val", 2, size=40, seed=4)
    jm = jdl.DeepLabV3Plus(2, "tiny", crop_size=48)
    opt = dict(OPT, baselr=2e-4)
    jt = jtrainer.SegmentationTrainer(
        _args(tmp_path / "jax", batch_size=2), jm, MODEL_CFG,
        *_sets(jseg, jaug, tmp_path), opt, image_dump_interval=0,
        mesh=make_mesh(jax.devices()[:1]))
    v = jax_variables(jm, jnp.zeros((1, 48, 48, 3)), False, seed=6)
    jt.state = jt.state.replace(params=jax.device_put(v["params"]),
                                batch_stats=jax.device_put(
                                    v["batch_stats"]))
    model = tdl.DeepLabV3Plus(2, "tiny", crop_size=48, use_dropout=False)
    model.load_state_dict(deeplab_state_dict(v["params"],
                                             v["batch_stats"]))
    tt = ttrainer.SegmentationTrainer(
        _args(tmp_path / "torch", batch_size=2, device="cpu"), model,
        MODEL_CFG, *_sets(tseg, taug, tmp_path), opt, image_dump_interval=0,
        graphed=True)
    assert tt.graphed and tt.total_iters == jt.total_iters == 10
    assert isinstance(tt.scheduler, ttrainer.TensorRateLambdaLR)
    for step in range(2):
        with nn.intercept_methods(_no_dropout):  # traced on the first call
            jt.state, want_loss, want_pred = jt._train_step(
                jt.state, jnp.asarray(images), jnp.asarray(masks),
                jax.random.PRNGKey(0))
        loss, pred = tt.step(images, masks)
        np.testing.assert_allclose(float(loss), float(want_loss),
                                   rtol=(1e-5, 1e-3)[step])
        _close(pred, np.asarray(want_pred), (2e-3, 2e-2)[step],
               f"step {step} logits")
    state = tt.model.state_dict()
    for k, w in deeplab_state_dict(
            jax.device_get(jt.state.params),
            jax.device_get(jt.state.batch_stats)).items():
        if not k.endswith("num_batches_tracked"):
            _close(state[k], w.numpy(), 2e-3, k)


def test_scheduler_fills_the_same_rate_tensors(tiny_model):
    model = copy.deepcopy(tiny_model)
    opt, sched = ttrainer.make_optimizer(model, 0.005, 7, 2e-4, 0.9,
                                         graphed=True)
    rates = [g["lr"] for g in opt.param_groups]
    assert all(isinstance(r, torch.Tensor) for r in rates)
    poly = ttrainer.poly_schedule(0.005, 7)
    for step in range(1, 9):
        sched.step()
        assert all(g["lr"] is r for g, r in zip(opt.param_groups, rates))
        want = [poly(step), 10 * poly(step)]
        assert sched.get_last_lr() == pytest.approx(want, rel=1e-12)
        np.testing.assert_allclose([float(r) for r in rates], want,
                                   rtol=1e-6)
    assert float(rates[0]) == 0.0  # clipped past the end


@pytest.mark.parametrize("kind", ["v3plus", "v3", "v3plus_no_aux"])
@pytest.mark.parametrize("hw", [(32, 32), (45, 37)])
def test_draw_dropout_gives_the_eager_bits(kind, hw, monkeypatch):
    """The shapes ``dropout_shapes`` gives are the ones the eager forward
    draws, in its order; the forward on ``draw_dropout``'s draws equals the
    eager forward bit for bit and leaves the generator where it left it."""
    monkeypatch.setitem(tdl._BACKBONE_LAYERS, "tiny", (1, 1, 1, 1))
    cls = tdl.DeepLabV3 if kind == "v3" else tdl.DeepLabV3Plus
    model = cls(2, "tiny", aux=kind != "v3plus_no_aux",
                generator=torch.Generator().manual_seed(1)).train()
    x = torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(2))
    drawn = []
    real = tdropout.dropout

    def spy(t, generator=None, rate=0.5, uniform=None):
        drawn.append(tuple(t.shape))
        return real(t, generator, rate, uniform)

    monkeypatch.setattr(tdl, "dropout", spy)
    g_eager = torch.Generator().manual_seed(3)
    with torch.no_grad():
        want = model(x, generator=g_eager)
    assert drawn == model.dropout_shapes(x.shape)
    assert len(drawn) == {"v3plus": 2, "v3": 3, "v3plus_no_aux": 1}[kind]
    g_drawn = torch.Generator().manual_seed(3)
    u = model.draw_dropout(x.shape, g_drawn)
    assert [tuple(t.shape) for t in u] == drawn
    with torch.no_grad():
        got = model(x, dropout_u=u)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(g_drawn.get_state(), g_eager.get_state())


@pytest.mark.parametrize("sizes", [(7, 5, 13, 11), (60, 60, 120, 120),
                                   (1, 4, 3, 9), (9, 9, 4, 4)])
def test_bilinear_backward_by_matrices_is_the_interpolate_backward(sizes):
    """The gradient ``bilinear_resize`` takes on a CUDA device (the
    transposed resize as two products with the interpolation matrices, no
    atomics), run here on the CPU: the forward is ``F.interpolate``'s, the
    gradient equals its backward within 1e-5 relative (the matrices' f32
    weights)."""
    from gan_segmentation_tpu_torch.ops import resize

    h, w, oh, ow = sizes
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, h, w, generator=g, requires_grad=True)
    grad = torch.randn(2, 3, oh, ow, generator=g)
    y = resize._BilinearAC.apply(x, oh, ow)
    want_y = torch.nn.functional.interpolate(x, size=(oh, ow),
                                             mode="bilinear",
                                             align_corners=True)
    assert torch.equal(y, want_y)
    got, = torch.autograd.grad(y, x, grad)
    want, = torch.autograd.grad(want_y, x, grad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def _val_trainer(model, root, path, graphed, test_batch):
    from test_torch_deeplab_trainer import MODEL_CFG, OPT, _args, _sets

    from gan_segmentation_tpu_torch.data import augment as taug
    from gan_segmentation_tpu_torch.data import segmentation as tseg

    return ttrainer.SegmentationTrainer(
        _args(path, device="cpu", test_batch_size=test_batch), model,
        MODEL_CFG, *_sets(tseg, taug, root, 4), OPT, image_dump_interval=0,
        graphed=graphed)


def test_padded_validation_tail_gives_the_unpadded_metric(tiny_model,
                                                         tmp_path,
                                                         monkeypatch):
    """5 val images at test batch 3: the graphed validation pads the tail
    of 2 to 3 (one batch shape, ``GraphedFunction`` sees only it) and gives
    the eager validation's pixAcc and mIoU exactly."""
    from test_deeplab import make_rgb_dataset

    make_rgb_dataset(tmp_path, "train_generated", 4, size=40, seed=3)
    make_rgb_dataset(tmp_path, "val", 5, size=40, seed=4)
    shapes = []
    real = ttrainer.eval_step

    def spy(model, images, **kw):
        shapes.append(tuple(images.shape))
        return real(model, images, **kw)

    monkeypatch.setattr(ttrainer, "eval_step", spy)
    out = {}
    for graphed in (False, True):
        shapes.clear()
        trainer = _val_trainer(copy.deepcopy(tiny_model), tmp_path,
                               tmp_path / str(graphed), graphed, 3)
        out[graphed] = (trainer.validation(0), list(shapes))
    assert out[False][1] == [(3, CROP, CROP, 3), (2, CROP, CROP, 3)]
    assert out[True][1] == [(3, CROP, CROP, 3)] * 2
    assert out[True][0] == out[False][0]


class ReplayingFunction(graphs.GraphedFunction):
    """``GraphedFunction`` as a card runs it, on the CPU: after its first
    call of a signature, a call runs no Python of the evaluator (its model
    call counter stays), as a replay does."""

    def __call__(self, *args):
        key = tuple(tuple(a.shape) for a in args)
        evaluator = self.fn.__self__
        if key not in self.inputs:
            self.inputs[key] = args
            return self.fn(*args)
        calls = evaluator.calls
        out = self.fn(*args)
        evaluator.calls = calls
        return out


def test_tester_scores_and_bucket_calls_unchanged_when_graphed(
        tiny_model, monkeypatch):
    """Three same-shape batches, sliding windows at two scales with flip:
    the graphed evaluator's scores equal the eager one's, and its ``calls``
    count the model calls of every replay (``bucket_calls`` reads them)."""
    monkeypatch.setattr(ttrainer, "GraphedFunction", ReplayingFunction)
    monkeypatch.setattr(ttrainer.MultiEvalModel, "max_windows", 4)
    rs = np.random.RandomState(9)
    batches = [[rs.randn(40, 56, 3).astype(np.float32) for _ in range(2)]
               for _ in range(3)]
    kw = dict(base_size=48, crop_size=32, flip=True, scales=(0.75, 1.0))
    out = {}
    for graphed in (False, True):
        ev = ttrainer.MultiEvalModel(copy.deepcopy(tiny_model), 2,
                                     graphed=graphed, **kw)
        per_batch, scores = [], []
        for batch in batches:
            before = ev.calls
            scores.append(ev.device_scores_batch(batch).clone())
            per_batch.append(ev.calls - before)
        out[graphed] = (scores, per_batch)
    assert all(torch.equal(a, b) for a, b in zip(out[True][0],
                                                 out[False][0]))
    assert out[True][1] == out[False][1]
    assert out[False][1][0] > 1  # several model calls a batch


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graphed_steps_equal_eager_steps(cuda, tiny_model, dtype):
    """On the card, in cuDNN's deterministic mode: the eager steps with the
    graphed optimizer (fused SGD, rate tensors) and the graphed steps (two
    warm-up steps, a capture, replays) are equal bit for bit."""
    batches = _batches(n=6)
    eager = _run(copy.deepcopy(tiny_model).to(cuda), batches, False, cuda,
                 dtype, optimizer_graphed=True)
    graphed = _run(copy.deepcopy(tiny_model).to(cuda), batches, True, cuda,
                   dtype)
    _same_runs(graphed, eager)


@pytest.mark.cuda
def test_cuda_graphed_evaluation(cuda, tiny_model):
    """On the card: ``eval_step`` and ``MultiEvalModel`` through their graphs
    equal the eager calls, and replays count their model calls."""
    model = copy.deepcopy(tiny_model).to(cuda).eval()
    images = _batches(n=3, batch=3)
    fn = graphs.GraphedFunction(
        lambda x: ttrainer.eval_step(model, x), cuda)
    for x, _ in images:
        x = x.to(cuda)
        assert torch.equal(fn(x).clone(), ttrainer.eval_step(model, x))
    rs = np.random.RandomState(9)
    batch = [rs.randn(40, 56, 3).astype(np.float32) for _ in range(2)]
    kw = dict(base_size=48, crop_size=32, flip=True, scales=(0.75, 1.0))
    eager = ttrainer.MultiEvalModel(model, 2, graphed=False, **kw)
    graphed = ttrainer.MultiEvalModel(model, 2, **kw)
    want = eager.device_scores_batch(batch)
    for _ in range(3):  # warm-up, capture, replay
        assert torch.equal(graphed.device_scores_batch(batch), want)
    assert graphed.calls == 3 * eager.calls
    assert graphed._graph.calls and all(
        c.replays == 2 for c in graphed._graph.calls.values())



@pytest.mark.cuda
def test_cuda_graphed_function_shares_one_pool(cuda):
    """On the card: the graphs of two input shapes share one memory pool.
    Each capture frees a 256 MiB temporary into the pool; the second
    capture reuses it, so the two graphs keep about one temporary's memory
    reserved, not two (a tester that meets many image shapes would
    otherwise keep one activation pool per shape)."""
    big = 64 * 2 ** 20  # f32 elements: 256 MiB

    def body(x):
        return x + torch.ones(big, device=x.device).sum()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    fn = graphs.GraphedFunction(body, cuda)
    grown = []
    for n in (4, 8):
        x = torch.arange(n, dtype=torch.float32, device=cuda)
        want = body(x)
        for _ in range(3):  # warm-up, capture, replay
            assert torch.equal(fn(x), want)
        del want
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        grown.append(torch.cuda.memory_reserved() - base)
    assert len(fn.calls) == 2
    assert {c.pool for c in fn.calls.values()} == {fn.pool}
    temp = big * 4
    assert temp <= grown[0] < 1.5 * temp, grown
    assert grown[1] - grown[0] < 0.25 * temp, grown

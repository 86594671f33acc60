"""The port's scale-out primitives (gan_segmentation_tpu_torch: core/
distributed.py, core/mesh.py, ops/norm.py's global-batch batch norm,
ops/losses.py's global normalisers, train/deeplab_trainer.py::batch_iter's
process shards) against the JAX package, on the CPU.

Two processes are two spawned gloo processes (``tests/test_torch_spawn.py``)
that each hold half of one seeded global batch.  Tolerances:

- ``batch_iter`` shards: equal, item for item, to JAX ``batch_iter
  (process_index, process_count)``'s;
- global BN against flax ``BatchNorm`` on the whole batch, f32: output,
  running statistics and the input / scale / shift gradients within 1e-5
  (sums of 100 values in different orders); over a world of one, the
  written-out global BN within 1e-5 of the one-process formula (its
  gradients are the same sums in another order);
- the global loss normalisers: within 1e-6 of the JAX losses on the whole
  batch; the counters of ``allreduce_sum``: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import test_torch_spawn as spawn
from test_torch_feed_items import Items

from gan_segmentation_tpu.ops import losses as jlosses
from gan_segmentation_tpu.train.deeplab_trainer import \
    batch_iter as jbatch_iter

from gan_segmentation_tpu_torch.core import distributed as dist_
from gan_segmentation_tpu_torch.core import mesh as tmesh
from gan_segmentation_tpu_torch.train.deeplab_trainer import batch_iter

torch.set_num_threads(2)  # the test workers share the host's cores


# -------------------------------------------------------------- batch_iter
@pytest.mark.parametrize("n,batch,world,seed", [
    (19, 3, 2, 5), (16, 2, 4, 0), (10, 1, 3, 7), (5, 2, 2, 1), (3, 2, 2, 0)])
@pytest.mark.parametrize("workers", [1, 2])
def test_batch_iter_shards_match_jax(n, batch, world, seed, workers):
    """Every process's batches equal the JAX package's shard for it, item
    for item, with the decode thread and with decode processes; their
    union, global batch by global batch, is the one-process order."""
    ds = Items(n)
    shards = []
    for pi in range(world):
        got = list(batch_iter(ds, batch, shuffle=True, seed=seed,
                              process_index=pi, process_count=world,
                              decode_workers=workers))
        want = list(jbatch_iter(ds, batch, shuffle=True, seed=seed,
                                prefetch=1, process_index=pi,
                                process_count=world))
        assert len(got) == len(want) == n // (batch * world)
        for g, w in zip(got, want):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
        shards.append(got)
    one = list(batch_iter(ds, batch * world, shuffle=True, seed=seed))
    for s, global_batch in enumerate(one):
        merged = np.concatenate([shards[pi][s][0] for pi in range(world)])
        assert np.array_equal(merged, global_batch[0])


def test_batch_iter_shard_resumes_mid_epoch():
    ds = Items(20)
    full = list(batch_iter(ds, 2, shuffle=True, seed=3, process_index=1,
                           process_count=2, decode_workers=2))
    late = list(batch_iter(ds, 2, shuffle=True, seed=3, process_index=1,
                           process_count=2, decode_workers=2, start_batch=2))
    assert len(late) == len(full) - 2
    for g, w in zip(late, full[2:]):
        assert np.array_equal(g[0], w[0])


# ------------------------------------------------------------- one process
def test_one_process_makes_no_group(monkeypatch):
    """Without a launcher, or with a world of one, nothing joins a group
    and every helper is the identity."""
    for env in ({}, {"RANK": "0", "WORLD_SIZE": "1"}):
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert dist_.initialize(cuda=False) is False
        assert not torch.distributed.is_initialized()
    assert dist_.group() is None
    assert (dist_.process_index(), dist_.process_count()) == (0, 1)
    assert dist_.is_primary()
    assert dist_.any_flag(True) and not dist_.any_flag(False)
    tree = (np.arange(3), {"a": 2})
    assert dist_.allreduce_sum(tree) is tree
    assert dist_.broadcast_str("x") == "x"
    t = [torch.ones(2)]
    dist_.allreduce_mean_(t, None)
    assert t[0].tolist() == [1.0, 1.0]
    assert dist_.rank_seed(5, 0) == 5 and dist_.rank_seed(5, 1) != 5


# ------------------------------------------------------------------- mesh
def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("kw,ids", [
    (dict(), [0, 1, 2, 3]), (dict(gpus="0,2"), [0, 2]),
    (dict(ngpus=2), [0, 1]), (dict(ngpus=9), [0, 1, 2, 3]),
    (dict(kvstore="local", gpus="1,2"), [1]),
    (dict(kvstore="dist_sync"), [0, 1, 2, 3])])
def test_kvstore_devices_choose_the_cards(monkeypatch, kw, ids):
    """The JAX ``kvstore_to_mesh`` / runner rules over four cards."""
    _cards(monkeypatch, 4)
    assert tmesh.kvstore_devices(**kw) == [torch.device("cuda", i)
                                           for i in ids]


def test_kvstore_devices_refusals(monkeypatch):
    _cards(monkeypatch, 4)
    with pytest.raises(ValueError, match="4 CUDA device"):
        tmesh.kvstore_devices(gpus="1,4")
    assert tmesh.kvstore_devices(gpus="0,1", no_cuda=True) == [
        torch.device("cpu")]
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="pass --no-cuda"):
        tmesh.kvstore_devices(gpus="0,1")


def test_generate_devices_follow_spatial_mesh():
    """``--dp`` as the JAX ``spatial_mesh(dp=...)``: None for one device,
    0 = every card, a subset is fine, past the cards or below 0 raises;
    ``--spatial N`` gives the (data, space) grid as rows of N cards
    (``tests/test_torch_spatial.py`` holds it to ``spatial_mesh`` case by
    case), and N must divide the cards without ``--dp``."""
    cards = [torch.device("cuda", i) for i in range(3)]
    assert tmesh.generate_devices(1, None, cards) is None
    assert tmesh.generate_devices(1, 1, cards) is None
    assert tmesh.generate_devices(1, 0, cards) == cards
    assert tmesh.generate_devices(1, 2, cards) == cards[:2]
    assert tmesh.generate_devices(1, 0, cards[:1]) is None
    for dp in (4, -1):
        with pytest.raises(ValueError):
            tmesh.generate_devices(1, dp, cards)
    with pytest.raises(ValueError, match="divide"):
        tmesh.generate_devices(2, None, cards)
    assert tmesh.generate_devices(3, None, cards) == [cards]
    assert tmesh.generate_devices(2, 1, cards) == [cards[:2]]
    assert tmesh.generate_devices(2, 0, cards) == [cards[:2]]


# ------------------------------------------------------ two processes
@pytest.fixture(scope="module")
def collectives():
    return spawn.run_world(spawn.collectives, 2)


def test_any_flag_sum_and_broadcast(collectives):
    for out in collectives:
        assert out["flags"] == [True, False]
        ints, count, floats = out["sums"]
        assert ints.dtype == np.int64 and ints.tolist() == [0, 3, 6]
        assert count == 3
        np.testing.assert_array_equal(floats["f"], [0.5, 0.5])
        assert out["str"] == "run-0"


def _flax_bn(x, dy):
    """flax BatchNorm(momentum 0.9, eps 1e-5) on the whole batch: output,
    running mean and var, and the gradients of sum(y * dy)."""
    scale = 1 + 0.3 * spawn.draw(2, 6)
    bias = 0.2 * spawn.draw(3, 6)
    var0 = 1 + 0.1 * spawn.draw(4, 6) ** 2
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.zeros(6), "var": jnp.asarray(var0)}

    def f(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd["batch_stats"])

    (_, (y, st)), (dx, dw, db) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), scale, bias)
    return {k: np.asarray(v) for k, v in dict(
        y=y, dx=dx, dw=dw, db=db, mean=st["mean"], var=st["var"]).items()}


@pytest.mark.parametrize("form", ["decoder", "deeplab"])
def test_global_batch_norm_matches_flax(collectives, form):
    """Two processes with half the batch each against flax on the whole:
    the output and input gradient by rows, the running statistics on
    each, the scale and shift gradients summed over the processes."""
    x, dy = spawn.draw(0, 4, 5, 5, 6), spawn.draw(1, 4, 5, 5, 6)
    want = _flax_bn(x, dy)
    got = [out["bn"][form] for out in collectives]
    tol = dict(rtol=1e-5, atol=1e-5)
    for k in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]),
                                   want[k], **tol, err_msg=k)
    for k in ("dw", "db"):
        np.testing.assert_allclose(got[0][k] + got[1][k], want[k], **tol,
                                   err_msg=k)
    for g in got:
        for k in ("mean", "var"):
            np.testing.assert_allclose(g[k], want[k], **tol, err_msg=k)


def test_global_batch_norm_over_one_process_is_the_formula(collectives):
    for out in collectives:
        own, plain = out["bn"]["own"], out["bn"]["own_plain"]
        for k in plain:
            np.testing.assert_allclose(own[k], plain[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_global_loss_normalisers_match_jax(collectives):
    """The processes' mean of ``softmax_ce_valid_norm`` is the JAX loss
    over the whole batch (its valid count spans both halves); the focal
    mean multiplier is the whole batch's."""
    logits = spawn.draw(5, 4, 6, 6, 3)
    labels = np.random.RandomState(6).randint(-1, 3, (4, 6, 6))
    want = float(jlosses.softmax_ce_valid_norm(jnp.asarray(logits),
                                               jnp.asarray(labels)))
    got = np.mean([out["ce"] for out in collectives])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want_mult = float(jlosses.normalized_focal_loss_softmax(
        jnp.asarray(logits), jnp.asarray(labels))[1])
    for out in collectives:
        np.testing.assert_allclose(out["mult"], want_mult, rtol=1e-6)

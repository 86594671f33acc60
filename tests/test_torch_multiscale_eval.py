"""The port's batched multi-scale + flip evaluation
(gan_segmentation_tpu_torch/train/deeplab_trainer.py: ``MultiEvalModel``,
``_pad_image``, ``label_map``, ``SegmentationTester``) against the JAX
package's on the same weights, on the CPU in f32.

The model is a two-conv segmenter written in both packages (the protocol,
not the model, is under test; ``tests/test_torch_deeplab.py`` holds the
DeepLab models).  Tolerances: scores within 2e-3 of the largest score (both
sides sum 3x3 convs in another order, then resize and average);
batched scores equal the per-image ones within 1e-5; the tester's metrics
within 1e-3 (a pixel whose probability sits at the threshold may flip); the
pad exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gan_segmentation_tpu.train import deeplab_trainer as jtrainer

from gan_segmentation_tpu_torch.core.params_bridge import deeplab_state_dict
from gan_segmentation_tpu_torch.models.resnet import Conv2d
from gan_segmentation_tpu_torch.train import deeplab_trainer as ttrainer

torch.set_num_threads(2)  # the test workers share the host's cores

NCLASS = 2


class JaxSeg(nn.Module):
    nclass: int = NCLASS

    @nn.compact
    def __call__(self, x, train=False):
        y = nn.relu(nn.Conv(8, (3, 3), padding=1, name="conv0")(x))
        return (nn.Conv(self.nclass, (3, 3), padding=1, name="conv1")(y),)


class TorchSeg(torch.nn.Module):
    def __init__(self, nclass=NCLASS):
        super().__init__()
        self.conv0 = Conv2d(3, 8, 3, padding=1, bias=True)
        self.conv1 = Conv2d(8, nclass, 3, padding=1, bias=True)

    def forward(self, x):
        return (self.conv1(torch.relu(self.conv0(x))),)


@pytest.fixture(scope="module")
def weights():
    rs = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda: JaxSeg().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))["params"]
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rs.randn(*s.shape)).astype(np.float32), shapes)


def port_model(params):
    model = TorchSeg()
    model.load_state_dict(deeplab_state_dict(params, {}))
    return model


def _images(shape, n=2, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape, 3).astype(np.float32) for _ in range(n)]


def _close(got, want, scale=2e-3):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * float(np.abs(want).max()))


CASES = {
    # base <= crop: one padded window per image and scale
    "pad": dict(base_size=24, crop_size=32, flip=False, scales=(1.0,)),
    "pad_flip": dict(base_size=24, crop_size=32, flip=True, scales=(1.0,)),
    # base > crop: sliding windows at a 2/3 stride
    "sliding": dict(base_size=48, crop_size=32, flip=False, scales=(1.0,)),
    "sliding_flip_two_scales": dict(base_size=48, crop_size=32, flip=True,
                                    scales=(0.5, 1.0)),
    "prob_avg": dict(base_size=48, crop_size=32, flip=True,
                     scales=(0.75, 1.25), prob_avg=True),
}


@pytest.mark.parametrize("hw", [(40, 56), (52, 36)], ids=["wide", "tall"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_eval_matches_jax(weights, case, hw):
    kw = CASES[case]
    images = _images(hw)
    jev = jtrainer.MultiEvalModel(JaxSeg(), weights, {}, NCLASS, **kw)
    want = np.asarray(jev.device_scores_batch(images))
    tev = ttrainer.MultiEvalModel(port_model(weights), NCLASS, **kw)
    got = tev.device_scores_batch(images)
    assert got.dtype == torch.float32
    _close(got, want)
    assert tev.calls == 1  # all windows, scales and flips in one call
    if kw.get("prob_avg"):
        assert float(got.min()) >= 0.0
        assert float(got.max()) <= len(kw["scales"]) + 1e-5


def test_windows_and_scaled_sizes_match_jax(weights):
    jev = jtrainer.MultiEvalModel(JaxSeg(), weights, {}, NCLASS,
                                  base_size=520, crop_size=480)
    tev = ttrainer.MultiEvalModel(port_model(weights), NCLASS,
                                  base_size=520, crop_size=480)
    for ph, pw in ((480, 480), (520, 693), (1000, 481), (961, 961)):
        assert tev._window_positions(ph, pw) == jev._window_positions(ph, pw)
    assert tev._window_positions(512, 512) == [(0, 0), (0, 32), (32, 0),
                                               (32, 32)]
    for c in (3, 4):
        np.testing.assert_array_equal(ttrainer._pad_fill(c),
                                      jev._pad_fill(c))


def test_batched_scores_equal_per_image(weights):
    kw = CASES["sliding_flip_two_scales"]
    tev = ttrainer.MultiEvalModel(port_model(weights), NCLASS, **kw)
    tev.max_windows = 5
    images = _images((44, 60), n=3, seed=2)
    batched = tev.device_scores_batch(images)
    assert tev.calls > 1  # max_windows splits the windows into chunks
    for im, got in zip(images, batched):
        np.testing.assert_allclose(got.numpy(), tev(im), rtol=0, atol=1e-5)
    outs = tev.parallel_forward(images[:2] + [images[2][:40]])
    np.testing.assert_allclose(outs[0], batched[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(outs[2], tev(images[2][:40]), atol=1e-5)


@pytest.mark.parametrize("shape,crop,pad_values", [
    ((10, 20, 3), 16, None), ((10, 20, 4), 24, None),
    ((7, 5, 3), 9, (1.0, 2.0)), ((16, 16, 3), 16, None)])
def test_pad_image_matches_jax(rng, shape, crop, pad_values):
    img = rng.randn(*shape).astype(np.float32)
    got = ttrainer._pad_image(img, crop, pad_values)
    want = jtrainer._pad_image(img, crop, pad_values)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_label_map_threshold_semantics():
    """Binary: P(class 1) > threshold on the softmax, strictly; otherwise
    (threshold None, or more than two classes) the argmax, ties to the
    first class."""
    scores = torch.tensor([[[0.0, 0.0], [0.0, 1e-3], [2.0, -2.0],
                            [-30.0, 0.0]]])
    p1 = torch.softmax(scores, -1)[..., 1]
    for t in (0.5, 1e-15, 0.9):
        got = ttrainer.label_map(scores, t, 2)
        assert got.dtype == torch.uint8
        assert got.tolist() == (p1 > t).to(torch.uint8).tolist()
    assert ttrainer.label_map(scores, 0.5, 2).tolist() == [[0, 1, 0, 1]]
    assert ttrainer.label_map(scores, 1e-15, 2).tolist() == [[1, 1, 1, 1]]
    assert ttrainer.label_map(scores, None, 2).tolist() == [[0, 1, 0, 1]]
    three = torch.tensor([[[1.0, 1.0, 0.0], [0.0, 2.0, 3.0]]])
    assert ttrainer.label_map(three, 0.5, 3).tolist() == [[0, 2]]


class _TestSet:
    """(image, mask[, path]) items of two shapes; 3 + 2 images."""

    num_class = NCLASS
    pred_offset = 0

    def __init__(self, root=None):
        rs = np.random.RandomState(5)
        self.items = []
        for i, hw in enumerate([(40, 56)] * 3 + [(52, 36)] * 2):
            img = rs.randn(*hw, 3).astype(np.float32)
            mask = (img[..., 0] > 0).astype(np.int32)
            mask[:2] = -1
            path = None
            if root is not None:
                import cv2
                path = str(root / "imgs" / f"img_{i}.jpg")
                (root / "imgs").mkdir(exist_ok=True)
                cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
            self.items.append((img, mask, path))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        img, mask, path = self.items[i]
        return (img, mask) if path is None else (img, mask, path)


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "last_checkpoint.params"
    jtrainer.save_checkpoint_file(str(path), weights, {})
    return str(path)


@pytest.mark.parametrize("threshold", [0.5, None])
def test_tester_matches_jax(checkpoint, threshold):
    """``test`` on 5 images of two shapes at test batch 2 (buckets of 2, 1,
    2: the second padded with a repeat), two scales, flip; the weights from
    the JAX package's msgpack checkpoint in both testers."""
    kw = dict(num_classes=NCLASS, use_flip=True, scales=[0.75, 1.0],
              threshold=threshold, base_size=48, crop_size=32)
    args = types.SimpleNamespace(weights=checkpoint, test_batch_size=2,
                                 device="cpu")
    jt = jtrainer.SegmentationTester(JaxSeg(), args, **kw)
    tt = ttrainer.SegmentationTester(TorchSeg(), args, **kw)
    testset = _TestSet()
    want, got = jt.test(testset), tt.test(testset)
    assert got.keys() == want.keys() == {"accuracy", "mean-iou"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    gn, gv = tt.metric.get()
    wn, wv = jt.metric.get()
    assert gn == wn
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-3)
    assert tt.bucket_calls == [1, 1, 1]


def test_vizualizate_writes_what_jax_writes(checkpoint, tmp_path):
    import cv2
    kw = dict(num_classes=NCLASS, use_flip=False, scales=[1.0],
              base_size=48, crop_size=32)
    args = types.SimpleNamespace(weights=checkpoint, device="cpu")
    testset = _TestSet(tmp_path)
    for pkg, tester in (("jax", jtrainer.SegmentationTester(JaxSeg(), args,
                                                            **kw)),
                        ("torch", ttrainer.SegmentationTester(
                            TorchSeg(), args, **kw))):
        tester.vizualizate(testset, tmp_path / pkg, suffix="_x")
    for i in range(len(testset)):
        for name in ("image", "image_gt", "image_predicted_x"):
            got = cv2.imread(str(tmp_path / "torch" / "imgs" /
                                 f"img_{i}_{name}.jpg"))
            want = cv2.imread(str(tmp_path / "jax" / "imgs" /
                                  f"img_{i}_{name}.jpg"))
            assert got is not None and want is not None, name
            assert np.array_equal(got, want), (i, name)

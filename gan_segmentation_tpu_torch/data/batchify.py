"""Batchify helpers (gluoncv ``Tuple/Stack/Pad`` + the reference's
``MultiPad``, `lib/data/multi_pad.py`).

A copy of ``gan_segmentation_tpu/data/batchify.py``;
``tests/test_torch_seg_data.py`` pins the two together.  Padding every
sample of a batch to the per-batch maximum keeps the set of batch shapes
small.
"""

from typing import Sequence

import numpy as np


class Stack:
    def __call__(self, data):
        return np.stack([np.asarray(d) for d in data])


class Tuple:
    """Apply the i-th batchify fn to the i-th element of each sample."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        assert len(data[0]) == len(self._fns)
        return tuple(fn([sample[i] for sample in data])
                     for i, fn in enumerate(self._fns))


class MultiPad:
    """Pad a set of axes to the per-batch maximum (`multi_pad.py:5-41`).

    Returns (batch, original_lengths) when ``ret_length``.
    """

    def __init__(self, axis=(0,), pad_val=0, ret_length: bool = False):
        if isinstance(axis, int):
            axis = (axis,)
        assert isinstance(axis, tuple), f"axis must be a tuple, got {axis!r}"
        self._axis = axis
        self._pad_val = pad_val
        self._ret_length = ret_length

    def __call__(self, data: Sequence[np.ndarray]):
        arrs = [np.asarray(d) for d in data]
        original = np.array([[a.shape[ax] for ax in self._axis] for a in arrs],
                            np.int32)
        max_size = original.max(axis=0)
        ret_shape = list(arrs[0].shape)
        for ax, m in zip(self._axis, max_size):
            ret_shape[ax] = int(m)
        ret = np.full((len(arrs),) + tuple(ret_shape), self._pad_val,
                      arrs[0].dtype)
        for i, a in enumerate(arrs):
            sl = tuple(slice(0, a.shape[d]) for d in range(a.ndim))
            ret[(i,) + sl] = a
        if self._ret_length:
            return ret, original
        return ret


def pad_to_multiple(x: np.ndarray, multiple: int, axes=(0, 1), value=0):
    """Pad ``axes`` up to a multiple of ``multiple`` (bucketed eval shapes)."""
    pads = [(0, 0)] * x.ndim
    for ax in axes:
        rem = (-x.shape[ax]) % multiple
        pads[ax] = (0, rem)
    if all(p == (0, 0) for p in pads):
        return x
    return np.pad(x, pads, constant_values=value)

"""bn_ms_per_step.dl: device ms a train step in the batch norms' kernels on
rank 0's card (``batch_norm_*``: statistics, elemt, backward reduce and
elemt, and the cats of the sums each all-reduce takes;
``gsbench/deeplab.py::bn_ms_per_unit``), over the profiled stretch."""

from gsbench import deeplab


def read(run):
    return deeplab.bn_ms_per_unit(run.stretch)

"""allreduce_ms_per_step.dl: device ms a train step in NCCL's kernels on
rank 0's card (the batch norms' 134 all-reduces of their sums and the
gradients' one, each with its wait for the other cards), over the
profiled stretch (traffic ``trace_steps`` steps)."""

from gsbench import deeplab


def read(run):
    return deeplab.nccl_ms_per_unit(run.stretch)

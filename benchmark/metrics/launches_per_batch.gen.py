"""launches_per_batch.gen: device kernels per batch (copies left out) in the
profiled stretch (traffic ``trace_batches`` batches)."""

from gsbench import readers


def read(run):
    return readers.launches_per_unit(run.stretch)

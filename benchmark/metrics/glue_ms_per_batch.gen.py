"""glue_ms_per_batch.gen: device ms per batch of the kernels that are none
of kernels 1-3 (with their split-K finish) and no cuDNN / cuBLAS / PyTorch
conv or GEMM: the generator's and decoder's elementwise, reduction, cat and
gather kernels, in the profiled stretch (traffic ``trace_batches``)."""

from gsbench import readers


def read(run):
    return readers.per_unit_ms(run.stretch, "glue")

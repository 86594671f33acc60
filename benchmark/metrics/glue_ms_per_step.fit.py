"""glue_ms_per_step.fit: device ms per train step of the elementwise and
reduction kernels (BN, leaky, dropout, cats, loss, Adam): every kernel that
is none of kernels 1-3 and no cuDNN / cuBLAS conv or GEMM, in the profiled
stretch (traffic ``trace_epochs`` epochs)."""

from gsbench import readers


def read(run):
    return readers.per_unit_ms(run.stretch, "glue")

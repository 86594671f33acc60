"""device_idle.gen: the share of the profiled stretch (traffic
``trace_batches``) in which no device operation ran, %: one less the union
of every kernel's and copy's interval over the stretch."""

from gsbench import readers


def read(run):
    return readers.idle_pct(run.stretch)

"""device_idle.fit: the share of the profiled stretch (traffic
``trace_epochs`` epochs) in which no device operation ran, %: one less the union
of every kernel's and copy's interval over the stretch."""

from gsbench import readers


def read(run):
    return readers.idle_pct(run.stretch)

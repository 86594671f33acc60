"""device_idle.dl: the share of the profiled stretch (traffic
``trace_steps`` steps, from an empty launch queue) in which no device
operation ran on rank 0's card, %: one less the union of every kernel's and
copy's interval over the stretch."""

from gsbench import readers


def read(run):
    return readers.idle_pct(run.stretch)

"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``).
Each returns None where the run has nothing to read: no profiled stretch,
or no launch of the kernel in it."""

from . import counts


def empty(stretch):
    """No stretch, or one in which no device operation ran (a run on the
    CPU)."""
    return stretch is None or not stretch.ops or not stretch.units


def per_unit_ms(stretch, fam):
    """Device ms per batch or step of the kernels of family ``fam``
    (``trace.family``) in the stretch."""
    if empty(stretch):
        return None
    return stretch.ms_by_family().get(fam, 0.0) / stretch.units


def launches_per_unit(stretch):
    """Device kernels (not copies) per batch or step in the stretch."""
    if empty(stretch):
        return None
    from .trace import is_copy
    return sum(1 for e in stretch.ops if not is_copy(e.name)) / stretch.units


def roofline_pct(stretch, kernel, bound_ms_per_unit, calls_per_unit):
    """The kernel's share of its roofline, %: its bound over the calls it
    made in the stretch (launches / calls a unit, units of ``bound_ms_per_
    unit``) over the device time of its bodies and helpers."""
    if empty(stretch):
        return None
    from .trace import kernel_of
    ops = stretch.kernel_ops(kernel)
    launches = sum(1 for e in ops if kernel_of(e.name) == kernel)
    if not launches:
        return None
    ms = sum(e.end - e.start for e in ops) / 1e3
    return 100.0 * bound_ms_per_unit * launches / calls_per_unit / ms


def idle_pct(stretch):
    if empty(stretch) or stretch.seconds <= 0:
        return None
    return 100.0 * (1.0 - stretch.busy_seconds() / stretch.seconds)


def mfu_pct(stretch, flop_per_sample, samples_per_unit, precision):
    """Model FLOP of the samples the stretch completed over its seconds,
    over the precision's peak, %."""
    if empty(stretch) or stretch.seconds <= 0:
        return None
    rate = flop_per_sample * samples_per_unit * stretch.units / stretch.seconds
    return 100.0 * rate / counts.effective_peak(precision)

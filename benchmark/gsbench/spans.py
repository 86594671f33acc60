"""Reading the program's own spans in a profiled stretch.

The port names host ranges ``gst.<layer>.<what>`` (its
``utils/profiling.py``): FUNCTION-scope ranges that a running profiler
records in its host lane, on the clock of the device's operations, and
that it does not mirror onto the device.  A stretch holds them among its
host events (``trace.Stretch.host``).  A program without them (an older
commit) leaves every reader here at None.

Host times under the profiler are mostly the profiler's: it adds a cost
to each operation and to each kernel of a graph's launch.  On an H100's
host a gen batch's ``gst.graph.replay`` reads 2.1-2.4 ms under it and
0.10-0.15 ms without it, a fit step's 4.5-6.4 ms and 0.38 ms.
"""

import statistics

from . import readers

# An epoch's first steps meet an empty launch queue: before the epoch the
# host copied the previous epoch's series, which waited for the card.
# Later in the epoch the host leads the card by several steps, and each
# launch, the graph's or an eager operation's, waits in the runtime for
# room in the queue (the fit's from its 5th step without the profiler,
# from about its 7th under it): a reading of those follows the card, not
# the host.
HEAD_STEPS = 3


def starting_inside(stretch, name):
    """The host events named ``name`` that start inside the stretch, or
    None where there are none, or nothing to read (``readers.empty``)."""
    if readers.empty(stretch):
        return None
    found = [e for e in stretch.host
             if e.name == name and stretch.start <= e.start < stretch.end]
    return found or None


def within(events, outer):
    """The events that start inside ``outer``'s interval."""
    return [e for e in events if outer.start <= e.start < outer.end]


def ms_per_unit(stretch, name):
    """Host ms a batch or step inside the spans ``name`` that start in the
    stretch."""
    found = starting_inside(stretch, name)
    if found is None:
        return None
    return sum(e.end - e.start for e in found) / 1e3 / stretch.units


def head_steps(stretch):
    """The first ``HEAD_STEPS`` ``gst.fit.step`` spans of each
    ``gst.fit.epoch`` that starts in the stretch, or None."""
    epochs = starting_inside(stretch, "gst.fit.epoch")
    if epochs is None:
        return None
    steps = sorted((e for e in stretch.host if e.name == "gst.fit.step"),
                   key=lambda e: e.start)
    found = [s for ep in epochs for s in within(steps, ep)[:HEAD_STEPS]]
    return found or None


def head_step_ms(stretch, part):
    """The median over the epochs' first steps (``head_steps``) of
    ``part(step, graph)``, host ms, where ``graph`` holds the
    ``gst.graph.*`` spans inside the step; steps where ``part`` gives
    None are left out."""
    steps = head_steps(stretch)
    if steps is None:
        return None
    graph = [e for e in stretch.host if e.name.startswith("gst.graph.")]
    got = [part(s, within(graph, s)) for s in steps]
    got = [us for us in got if us is not None]
    return statistics.median(got) / 1e3 if got else None


def launch_us(step, graph):
    """The step's replay launch (µs), None for a step without one."""
    replays = [e for e in graph if e.name == "gst.graph.replay"]
    return sum(e.end - e.start for e in replays) if replays else None


def own_us(step, graph):
    """The step's host time less its graph call's (µs)."""
    return (step.end - step.start) - sum(e.end - e.start for e in graph)


def idle_ms(stretch, a, b):
    """Ms of [a, b] (µs) with no device operation running: its length less
    the union of the operations' intervals clipped to it."""
    if b <= a:
        return 0.0
    busy, at = 0.0, a
    for e in stretch.device_ops:  # sorted by start
        lo, hi = max(e.start, at), min(e.end, b)
        if hi > lo:
            busy += hi - lo
            at = hi
    return (b - a - busy) / 1e3


def edge_idle_ms(stretch):
    """Device idle ms an epoch at its start, the mean over the
    ``gst.fit.epoch`` spans that start in the stretch: from the end of the
    last device operation that started before the epoch began to the first
    that starts after the epoch's first ``gst.graph.replay`` began, less
    the busy time in between (the union of intervals)."""
    epochs = starting_inside(stretch, "gst.fit.epoch")
    if epochs is None:
        return None
    replays = sorted(e.start for e in stretch.host
                     if e.name == "gst.graph.replay")
    ops = stretch.device_ops
    gaps = []
    for ep in epochs:
        first = next((t for t in replays if ep.start <= t < ep.end), None)
        before = [e for e in ops if e.start < ep.start]
        if first is None or not before:
            continue
        after = next((e for e in ops if e.start >= first), None)
        if after is None:
            continue
        gaps.append(idle_ms(stretch, before[-1].end, after.start))
    return sum(gaps) / len(gaps) if gaps else None

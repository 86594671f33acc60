"""epoch_edge_idle_ms.fit: device idle ms an epoch at the epoch's start,
the mean over the program's ``gst.fit.epoch`` spans that start in the
profiled stretch (traffic ``trace_epochs`` epochs): from the end of the
last device operation that started before the epoch began to the first
that starts after the epoch's first ``gst.graph.replay`` began, less the
busy time in between (the union of intervals, as ``device_idle.fit``)."""

from gsbench import spans


def read(run):
    return spans.edge_idle_ms(run.stretch)

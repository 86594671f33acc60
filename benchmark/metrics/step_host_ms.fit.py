"""step_host_ms.fit: the solver's own host ms a train step, inside the
program's ``gst.fit.step`` span (``SegSolver._graphed_epochs``: the rate
filled, the step's indices, the dropout draws) less the graph's call in it
(``gst.graph.*``), the median over the first ``spans.HEAD_STEPS`` steps of
each ``gst.fit.epoch`` that starts in the profiled stretch (traffic
``trace_epochs`` epochs), whose launches wait for no room in the launch
queue.  Under the profiler."""

from gsbench import spans


def read(run):
    return spans.head_step_ms(run.stretch, spans.own_us)

"""replay_launch_ms.fit: host ms of the train step graph's launch, inside
the program's ``gst.graph.replay`` span (``GraphedCall``), the median over
the first ``spans.HEAD_STEPS`` steps of each ``gst.fit.epoch`` that starts
in the profiled stretch (traffic ``trace_epochs`` epochs): those launches
meet an empty launch queue, where later ones wait in the launch for the
card.  Under the profiler, which adds a cost for each kernel of the
graph."""

from gsbench import spans


def read(run):
    return spans.head_step_ms(run.stretch, spans.launch_us)

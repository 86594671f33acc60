"""step_host_ms.dl: the trainer's own host ms a train step on rank 0, inside
the program's ``gst.dl.step`` span (``SegmentationTrainer.step``: the
pinned staging, the dropout draws, the rate) less the graph's call in it
(``gst.graph.*``), the median of the profiled stretch's first
``spans.HEAD_STEPS`` steps, which start on an empty launch queue.  Under
the profiler."""

from gsbench import deeplab


def read(run):
    return deeplab.head_step_host_ms(run.stretch)

"""replay_launch_ms.gen: host ms a batch inside the program's
``gst.graph.replay`` span (``GraphedCall``'s replay of the batch's CUDA
graph), over the spans that start in the profiled stretch (traffic
``trace_batches``).  Under the profiler, whose cost for each of the
graph's ~900 kernels is most of it: the whole of ``_enqueue`` takes less
outside the profiler (``enqueue_ms.gen``) than the launch inside it."""

from gsbench import spans


def read(run):
    return spans.ms_per_unit(run.stretch, "gst.graph.replay")

"""pipe_host_ms.gen: host ms a batch inside the program's
``gst.pipe.enqueue`` span (``FusedPipeline._enqueue``: the batch's
inputs drawn, the graph replayed, the copies to pinned memory enqueued),
under the profiler, over the spans that start in the profiled stretch
(traffic ``trace_batches``)."""

from gsbench import spans


def read(run):
    return spans.ms_per_unit(run.stretch, "gst.pipe.enqueue")

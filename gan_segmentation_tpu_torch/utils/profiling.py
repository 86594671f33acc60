"""The port's spans: named host ranges on ``torch.profiler``'s timeline.

``span(name)`` is a context manager.  With no torch profiler running it
costs one read of ``torch.autograd.profiler._is_profiler_enabled`` and
records nothing.  Under a running ``torch.profiler.profile`` (an operator's,
or the benchmark's ``--trace 1``) it opens a FUNCTION-scope range
(``_RecordFunctionFast``): a ``cpu_op`` event in the profiler's host lane,
on the clock of the kernels and copies it launches.  Unlike
``torch.profiler.record_function`` (a ``user_annotation``, and dearer),
kineto mirrors nothing of it onto the device, so a span is never counted
as device work.

Names are ``gst.<layer>.<what>``; a span's parent is the span it runs
inside on the same thread:

- ``gst.pipe.enqueue`` (``FusedPipeline._enqueue``) holding
  ``gst.pipe.draw`` (z and noise) and ``gst.pipe.copy`` (pinned buffers,
  copies and events); ``gst.pipe.wait`` (``generate_batches``' wait for a
  batch's copies);
- ``gst.graph.eager`` / ``gst.graph.capture`` / ``gst.graph.replay``
  (``core/graphs.py::GraphedCall``);
- ``gst.fit.epoch`` (``SegSolver._graphed_epochs``' epoch) holding
  ``gst.fit.stage`` (its order and indices) and one ``gst.fit.step`` a
  step.

What each span answers for an operator, and which benchmark metric reads
it, is listed in the README ("Tracing a run").
"""

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named ``name`` while a torch profiler runs, else a
    context that does nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF

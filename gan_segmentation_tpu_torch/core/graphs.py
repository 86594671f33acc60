"""One callable captured as a CUDA graph and replayed: the PyTorch
counterpart of the JAX package's compiled programs (``jax.jit`` of a
generate batch, the ``lax.scan`` epoch of ``SolverConfig.scan_epochs``).

``GraphedCall(fn, device, warmup)``: ``fn()`` takes no arguments.  It reads
its inputs from static tensors that the caller refills before each call,
and returns its outputs (a tensor, or lists, tuples and dicts of them).

- On a CPU device every call runs ``fn`` eagerly: the kernel wrappers take
  their plain versions there.
- On a CUDA device the first ``warmup`` calls run ``fn`` eagerly on a side
  stream.  They are real calls (a real batch, a real train step) and pass
  every first-use set-up (the kernel library, cuDNN's and cuBLAS's handles
  and plans, the optimizer's state) before the capture.  The next call
  captures ``fn`` in a ``torch.cuda.CUDAGraph`` and replays it; every later
  call replays.  A replay returns the same static output tensors, which
  the next replay overwrites.  A capture that fails raises: there is no
  eager fallback.
- Launch counts: every kernel wrapper counts its launches in ``launches``,
  where it launches: the eager calls' and, at the capture, those it
  records into the graph.  A replay runs the recorded launches without
  calling a wrapper, so it moves no counter.  ``deltas`` keeps how many
  launches of each wrapper the capture recorded and ``replays`` how often
  the graph ran; what the card ran is read from a device trace
  (``chip_smoke.py``).  ``collectives`` keeps, the same way, the
  all-reduces the capture recorded (``core/distributed.py::counters``:
  calls and bytes), which every replay runs again.
- Spans (``utils/profiling.py``): a call runs inside ``gst.graph.eager``
  (on a CPU device, and the warm-up calls), ``gst.graph.capture`` or
  ``gst.graph.replay``.
- ``spans``: the other cards on which ``fn`` also runs work (a spatial
  grid's, ``train/generator.py::GridProgram``).  The capture takes their
  work into the same graph (``_spanning``), so one replay on ``device``'s
  stream runs the whole grid's batch, and the next replay on that stream
  starts only after every card's part of this one has ended.  A grid that
  repeats one card spans no other card and runs the same code.
"""

import contextlib
import functools
from typing import Callable, Dict, Sequence

import torch

from ..kernels.adain_fused import adain_apply, noise_bias_lrelu_stats
from ..kernels.bil_conv import conv3x3_bil
from ..kernels.conv_in_stats import (conv3x3_noise_bias_lrelu_instats,
                                     conv3x3_noise_bias_lrelu_instats_rows,
                                     conv3x3_noise_bias_lrelu_instats_s8)
from ..kernels.quantize import quantize_s8
from ..kernels.small_conv import (conv3x3_small, conv3x3_small_rows,
                                  conv3x3_small_s8)
from ..utils.profiling import span
from . import distributed

# the kernel wrappers whose launches a capture records (``deltas``): kernels
# 1-3, int8 generation's s8 bodies and quantize pass, the row-band forms of
# kernels 1 and 2 (a spatial grid's), then the synthesis block's two
# per-pixel passes
COUNTED = (conv3x3_noise_bias_lrelu_instats, conv3x3_small, conv3x3_bil,
           conv3x3_noise_bias_lrelu_instats_s8, conv3x3_small_s8,
           quantize_s8, conv3x3_noise_bias_lrelu_instats_rows,
           conv3x3_small_rows, noise_bias_lrelu_stats, adain_apply)

# eager steps of a train step's ``GraphedCall`` before its capture: they
# create the optimizer's state and cuDNN's plans (real steps)
GRAPH_WARMUP_STEPS = 2


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The side stream of the captures on ``device``: one per card
    (``torch.cuda.graph``'s own default is one stream on whichever card was
    current at its first use, which a capture on another card cannot
    use)."""
    return torch.cuda.Stream(device)


def launch_counts() -> Dict[Callable, int]:
    return {fn: fn.launches for fn in COUNTED}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


class GraphedCall:
    """``pool``: a ``torch.cuda.graph_pool_handle()`` that the capture
    shares with other graphs (default: a private pool).  ``spans``: the
    other devices ``fn`` runs work on (``device`` itself is left out)."""

    def __init__(self, fn: Callable, device, warmup: int = 1, pool=None,
                 spans: Sequence = ()):
        self.fn = fn
        self.pool = pool
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.warmup = warmup
        self.calls = 0
        self.replays = 0
        self.graph = None
        self.outputs = None
        self.deltas: Dict[Callable, int] = {}
        self.collectives: Dict[str, int] = {}
        self.spans = [d for d in dict.fromkeys(map(torch.device, spans))
                      if d != self.device]
        if any(d.type != self.device.type for d in self.spans):
            raise ValueError(f"a call on {self.device} cannot span "
                             f"{self.spans}")
        self._pools = []  # the spanned devices' memory pools (a capture's)

    def __call__(self):
        if self.device.type == "cpu":
            with span("gst.graph.eager"):
                return self.fn()
        if self.calls < self.warmup:
            self.calls += 1
            with span("gst.graph.eager"):
                return self._warm()
        if self.graph is None:
            before = launch_counts()
            held = dict(distributed.counters)
            with span("gst.graph.capture"):
                self.outputs = self._capture()
            self.deltas = {fn: fn.launches - n for fn, n in before.items()}
            self.collectives = {k: n - held[k]
                                for k, n in distributed.counters.items()}
        with span("gst.graph.replay"):
            self._replay()
        self.calls += 1
        self.replays += 1
        return self.outputs

    def _warm(self):
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn()
        main.wait_stream(side)
        for t in _tensors(out):  # made on the side stream, used on main
            t.record_stream(main)
        return out

    def _capture(self):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(self.graph, pool=self.pool,
                                 stream=_capture_stream(self.device)), \
                self._spanning():
            return self.fn()

    @contextlib.contextmanager
    def _spanning(self):
        """Inside the capture on ``device``: each device of ``spans`` works
        on its own capture stream, forked from the capturing stream by an
        event and joined back by one at the end, so that its kernels and
        copies land in the same graph; between them, the events that
        PyTorch's cross-device copies record on both devices' current
        streams become the graph's edges.  ``torch.cuda.graph`` routes only
        the capturing device's allocations into the graph's pool: each
        spanned device allocates from a pool of its own (``MemPool``), kept
        as long as the graph."""
        main = torch.cuda.current_stream(self.device)
        prev = [torch.cuda.current_stream(d) for d in self.spans]
        sides = [_capture_stream(d) for d in self.spans]
        self._pools = []
        for d in self.spans:
            with torch.cuda.device(d):
                self._pools.append(torch.cuda.MemPool())
        with contextlib.ExitStack() as stack:
            try:
                for d, side, pool in zip(self.spans, sides, self._pools):
                    stack.enter_context(torch.cuda.use_mem_pool(pool, d))
                    side.wait_stream(main)
                    torch.cuda.set_stream(side)  # may switch the device
                torch.cuda.set_device(main.device)
                yield
                for side in sides:
                    main.wait_stream(side)
            finally:
                for p in prev:
                    torch.cuda.set_stream(p)
                torch.cuda.set_device(main.device)

    def _replay(self):
        self.graph.replay()


class GraphedFunction:
    """``fn(*tensors)`` as one ``GraphedCall`` per input signature (the
    shapes and dtypes of the arguments): a call copies its arguments into
    that signature's static tensors (non-blocking) and runs the call.
    ``warmup`` as ``GraphedCall``'s.

    On a card the graphs share one memory pool, so a set of many shapes
    keeps about the memory of its largest graph, not the sum.  The calls
    run in order on one stream, and the outputs are static: the next call,
    of any signature, may overwrite them."""

    def __init__(self, fn: Callable, device, warmup: int = 1):
        self.fn = fn
        self.device = torch.device(device)
        self.warmup = warmup
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.calls: Dict[tuple, GraphedCall] = {}
        self.inputs: Dict[tuple, Sequence[torch.Tensor]] = {}

    def __call__(self, *args: torch.Tensor):
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        call = self.calls.get(key)
        if call is None:
            static = [torch.empty(a.shape, dtype=a.dtype, device=self.device)
                      for a in args]
            call = GraphedCall(lambda: self.fn(*static), self.device,
                               self.warmup, self.pool)
            self.calls[key], self.inputs[key] = call, static
        for s, a in zip(self.inputs[key], args):
            s.copy_(a, non_blocking=True)
        return call()

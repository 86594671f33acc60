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
  (``chip_smoke.py``).
"""

import functools
from typing import Callable, Dict, Sequence

import torch

from ..kernels.bil_conv import conv3x3_bil
from ..kernels.conv_in_stats import (conv3x3_noise_bias_lrelu_instats,
                                     conv3x3_noise_bias_lrelu_instats_s8)
from ..kernels.quantize import quantize_s8
from ..kernels.small_conv import conv3x3_small, conv3x3_small_s8

# the kernel wrappers whose launches a capture records (``deltas``): kernels
# 1-3, then int8 generation's s8 bodies and quantize pass
COUNTED = (conv3x3_noise_bias_lrelu_instats, conv3x3_small, conv3x3_bil,
           conv3x3_noise_bias_lrelu_instats_s8, conv3x3_small_s8,
           quantize_s8)

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
    shares with other graphs (default: a private pool)."""

    def __init__(self, fn: Callable, device, warmup: int = 1, pool=None):
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

    def __call__(self):
        if self.device.type == "cpu":
            return self.fn()
        if self.calls < self.warmup:
            self.calls += 1
            return self._warm()
        if self.graph is None:
            before = launch_counts()
            self.outputs = self._capture()
            self.deltas = {fn: fn.launches - n for fn, n in before.items()}
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
                                 stream=_capture_stream(self.device)):
            return self.fn()

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

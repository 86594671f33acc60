"""Reading a profiled stretch: device operations as intervals, the
stretch they are clipped to, the hand-written kernels by name, and the
union of busy time.

A stretch is a ``torch.profiler`` trace (CPU and CUDA activities) around a
few steady batches or steps of the measured window; the benchmark marks
the part it counts with a ``record_function`` named ``STRETCH`` and its
host phases with names that start with ``gsbench.``.  ``from_profiler``
turns the kineto events into ``Event`` tuples; every reader works on
those, so a test can hand it a synthetic trace.

Kernel names map to kernels 1-3 as ``chip_smoke.py::{kernel_of,
body_of}`` map them (copied here): the bodies carry their kernel's number
as the last template argument; the split-K finish and the f32 tap-layout
kernels that a call of kernels 1-3 launches right after (or before) its
body are its own, and are given to the call they sit beside on the
stream.
"""

import re
from collections import namedtuple

STRETCH = "gsbench.stretch"

# (name, on_device, start_us, end_us)
Event = namedtuple("Event", "name device start end")

# the kernel a body's template tag names (chip_smoke.py::KERNEL_NUMBERS)
KERNEL_NUMBERS = {"1": "k1", "2": "k2", "3": "k3", "4": "k1_s8",
                  "5": "k2_s8", "6": "k1_rows", "7": "k2_rows", "8": "k2",
                  "9": "k1"}
# launched by a call of kernels 1-3 beside its body: split-K finish, the
# f32 K-major tap layout
HELPERS = ("conv3x3_tc_finish_kernel", "conv3x3_tf32_finish_kernel",
           "tf32_taps_kernel")
LIBRARY = ("conv", "gemm", "xmma", "cudnn", "cutlass", "nhwc", "nchw",
           "sm90_", "sm80_", "wgrad", "dgrad")


def kernel_of(name):
    """"k1", "k2", "k3" (and the s8 and row-band forms) for a body of the
    hand-written kernels, else None."""
    m = re.search(r"conv3x3_(?:tc|tf32|sm90)_kernel<[^>]*,\s*(\d)>", name)
    if m:
        return KERNEL_NUMBERS[m.group(1)]
    if "quantize_s8_kernel<" in name:
        return "quantize_s8"
    return "k3" if "conv3x3_bil_kernel<" in name else None


def is_helper(name):
    return any(h in name for h in HELPERS)


def is_copy(name):
    low = name.lower()
    return low.startswith(("memcpy", "memset"))


def family(name):
    """"kernel" (kernels 1-3 with their helpers), "library" (cuDNN /
    cuBLAS convs and GEMMs, PyTorch's conv kernels), "copy" (memcpy,
    memset) or "glue" (every other kernel: elementwise, reductions, cats,
    gathers, BN, dropout, loss, Adam)."""
    if kernel_of(name) is not None or is_helper(name):
        return "kernel"
    if is_copy(name):
        return "copy"
    low = name.lower()
    if any(k in low for k in LIBRARY):
        return "library"
    return "glue"


def is_marker(name):
    return name.startswith(("gsbench.", "Optimizer.", "ProfilerStep"))


def profiler(torch, device):
    """A ``torch.profiler.profile`` of the host and, on a card, the
    device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def from_profiler(prof):
    """The kineto events of a finished ``torch.profiler.profile`` as
    ``Event`` tuples (µs)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), dev, start, start + e.duration_ns() / 1e3))
    return out


class Stretch:
    """The counted part of a trace: the ``STRETCH`` marker's interval on
    the host, the device operations that start inside it, and ``units``,
    the batches or steps that completed inside it."""

    def __init__(self, events, units):
        marks = [e for e in events if not e.device and e.name == STRETCH]
        if len(marks) != 1:
            raise ValueError(f"{len(marks)} stretch markers in the trace")
        self.start, self.end = marks[0].start, marks[0].end
        self.units = units
        self.host = [e for e in events if not e.device
                     and e.name != STRETCH]
        # device operations, the profiler's annotation ranges left out
        self.device_ops = sorted(
            (e for e in events if e.device and not is_marker(e.name)
             and e.end > e.start),
            key=lambda e: e.start)
        self.ops = [e for e in self.device_ops
                    if self.start <= e.start < self.end]

    @property
    def seconds(self):
        return (self.end - self.start) / 1e6

    def busy_intervals(self):
        """The union of every device operation's interval, clipped to the
        stretch (overlapping operations count once)."""
        spans = sorted((max(e.start, self.start), min(e.end, self.end))
                       for e in self.device_ops
                       if e.end > self.start and e.start < self.end)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_seconds(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self):
        """(start, end) of each stretch of the window with no device
        operation running."""
        gaps, at = [], self.start
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.end:
            gaps.append((at, self.end))
        return gaps

    def host_activity(self, t):
        """What the host was doing at ``t``: the innermost host event over
        it (the latest started), or "host: no traced activity"."""
        best = None
        for e in self.host:
            if e.start <= t < e.end and (best is None or e.start > best.start):
                best = e
        return best.name if best is not None else "host: no traced activity"

    def kernel_ops(self, kernel):
        """The operations of one hand-written kernel in the stretch: its
        bodies and the helpers launched beside them (each helper goes to
        the body that precedes it on the device, or follows it when the
        helper comes first, as the f32 tap layout does)."""
        out, last, pending = [], None, []
        for e in self.ops:
            k = kernel_of(e.name)
            if k is not None:
                if k == kernel:
                    out.append(e)
                    out.extend(pending)
                pending = []
                last = k
            elif is_helper(e.name):
                if "taps" in e.name:
                    pending.append(e)
                elif last == kernel:
                    out.append(e)
            elif family(e.name) != "copy":
                last, pending = None, []
        return out

    def ms_by_family(self):
        fam = {}
        for e in self.ops:
            f = family(e.name)
            fam[f] = fam.get(f, 0.0) + (e.end - e.start) / 1e3
        return fam

    def top_ops(self, n=10):
        """The ``n`` device operations that took most time, by name:
        [[name, seconds], ...]."""
        by = {}
        for e in self.ops:
            by[e.name] = by.get(e.name, 0.0) + (e.end - e.start) / 1e6
        return [[k[:200], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n=10):
        """The ``n`` longest idle gaps, named by what the host was doing
        in the middle of each: [[name, seconds], ...]."""
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_activity((a + b) / 2)[:200], (b - a) / 1e6]
                for a, b in gaps]

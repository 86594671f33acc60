"""Processes of a data-parallel run (PyTorch counterpart of
``gan_segmentation_tpu/core/distributed.py``): one process per card, joined
by ``torch.distributed``.

A launcher (``torchrun``, or ``train/experiments.py``'s spawn of one
process per ``--gpus`` card) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``.  ``initialize()`` reads them and joins
the process group: NCCL on a card, gloo on the CPU, or the backend the
caller names.  Without that environment, or with a world of one process,
it does nothing: no group is made and every path runs as one process.

The collectives here are ``all_reduce`` and ``broadcast`` only, the two
that gloo also takes on CUDA tensors (so two processes can share one card
over gloo).  gloo has no ``ReduceOp.AVG``: a mean is a sum, divided.

- ``group()``: the world's group when it spans more than one process,
  else None; every ``group`` argument of the port means "no collective"
  when it is None.
- ``any_flag``: a cross-process OR (the agreed preemption stop).
- ``allreduce_sum``: numpy counters summed over the processes.
- ``allreduce_mean_``: tensors averaged in place through one flat buffer
  (the gradients of a step: one collective).
- ``broadcast_str``: the primary's string (the run dir) to every process.

Every ``all_reduce`` of the port goes through ``all_reduce`` here, which
counts it in ``counters`` where it is issued: ``distributed.allreduce.calls``
and ``distributed.allreduce.bytes`` (the reduced tensor's).  An eager call
counts, and so does the recording of one into a CUDA graph's capture
(``core/graphs.py::GraphedCall.collectives`` keeps what a capture holds); a
replay runs the recorded collectives without Python and moves no counter,
as a kernel wrapper's ``launches`` behave.
"""

import gc
import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the all-reduces this process issued (``all_reduce``)
counters = {"distributed.allreduce.calls": 0, "distributed.allreduce.bytes": 0}


def all_reduce(t: torch.Tensor, grp) -> torch.Tensor:
    """Sum ``t`` over ``grp`` in place, counted in ``counters``; -> ``t``."""
    counters["distributed.allreduce.calls"] += 1
    counters["distributed.allreduce.bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, group=grp)
    return t


def free_port() -> int:
    """A port free on this host now, for a rendezvous on ``127.0.0.1``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launched() -> bool:
    """Whether a launcher set this process's place in a world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(cuda: bool = True, backend: Optional[str] = None) -> bool:
    """Join the launcher's process group; -> whether the world has more
    than one process.  ``cuda``: this process runs on ``local_device()``
    (made current) and the default backend is NCCL; else gloo.  A failed
    rendezvous raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not launched() or int(os.environ["WORLD_SIZE"]) <= 1:
        return False
    if cuda:
        torch.cuda.set_device(local_device())
    backend = backend or ("nccl" if cuda else "gloo")
    kw = {}
    if backend == "nccl":  # binds the communicator to this card
        kw["device_id"] = local_device()
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one.  The CUDA
    graphs that captured its collectives go first (a garbage collection
    frees those no one holds): NCCL's communicator waits for every graph
    that holds its work before it is destroyed."""
    if dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and images."""
    return process_index() == 0


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK``."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def group():
    """The world's group when it has more than one process, else None."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def rank_of(grp) -> int:
    return 0 if grp is None else dist.get_rank(grp)


def size_of(grp) -> int:
    return 1 if grp is None else dist.get_world_size(grp)


def comm_device(grp) -> torch.device:
    """Where a host value crosses ``grp``: the current card for NCCL, the
    CPU for gloo."""
    if grp is not None and dist.get_backend(grp) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_flag(flag: bool, grp=None) -> bool:
    """Cross-process OR of a host bool.  A collective: every process calls
    it at the same point (the same step)."""
    grp = group() if grp is None else grp
    if grp is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=comm_device(grp))
    return bool(all_reduce(t, grp).item())


def barrier(grp=None) -> None:
    """Wait until every process got here (an ``all_reduce``)."""
    any_flag(False, grp)


def allreduce_sum(tree, grp=None):
    """Numpy counters (an array, a number, or tuples, lists and dicts of
    them) summed over the processes, each in its own dtype."""
    grp = group() if grp is None else grp
    if grp is None:
        return tree
    if isinstance(tree, dict):
        return {k: allreduce_sum(v, grp) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(allreduce_sum(v, grp) for v in tree)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(arr).copy()).to(
        comm_device(grp))
    out = all_reduce(t, grp).cpu().numpy().astype(arr.dtype, copy=False)
    return out if isinstance(tree, np.ndarray) else out[()]


def allreduce_mean_(tensors: Sequence[torch.Tensor], grp) -> None:
    """Average ``tensors`` (one dtype, one device) over ``grp`` in place,
    through one flat buffer: one collective.  Capturable in a CUDA graph
    over NCCL once the communicator has run a collective."""
    tensors = [t for t in tensors if t is not None]
    if grp is None or not tensors:
        return
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), grp)
    flat.div_(size_of(grp))
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def broadcast_tensors_(tensors: List[torch.Tensor], grp, src: int = 0):
    """The primary's values of ``tensors`` into every process's, in place
    (replicas that must start equal)."""
    if grp is None:
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=grp)


def broadcast_str(value: Optional[str], grp=None, src: int = 0) -> str:
    """``src``'s string on every process (two broadcasts: its length, then
    its UTF-8 bytes)."""
    grp = group() if grp is None else grp
    if grp is None:
        return value
    dev = comm_device(grp)
    mine = (value or "").encode() if rank_of(grp) == src else b""
    n = torch.tensor([len(mine)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=src, group=grp)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if rank_of(grp) == src:
        buf.copy_(torch.frombuffer(bytearray(mine), dtype=torch.uint8))
    dist.broadcast(buf, src=src, group=grp)
    return bytes(buf.cpu().numpy()).decode()


def rank_seed(seed: int, rank: int) -> int:
    """A random stream's seed for ``rank``: ``seed`` itself on rank 0 (one
    process draws as before), a stream of its own on every other rank."""
    return (seed + (rank << 32)) % 2 ** 63

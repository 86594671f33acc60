"""Batches of a dataset decoded in worker processes: the process path of
``train/deeplab_trainer.py::batch_iter`` (``decode_workers > 1``).

Decoding, augmenting and stacking run in ``workers`` processes, so they
share neither the GIL nor a core with the process that launches the
device's work.  Each worker holds a copy of the dataset (pickled to it)
and builds whole batches: worker ``w`` builds the epoch's batches ``w``,
``w + workers``, ... in order, so the parent takes batch ``b`` from worker
``b % workers`` and yields the batches in the epoch's order.  A batch's
stacks travel through a shared-memory block that the worker creates and
the parent copies out of and unlinks.  The workers never touch CUDA and
are started by ``forkserver`` (a fresh server process, not a fork of the
parent).

Random draws.  A copy of a dataset in each worker would repeat the same
stream (the dataset's ``random.Random`` index draw, its augmentator's
``RandomState``).  So the parent gives every item a seed of its own,
``SeedSequence((seed, position in the epoch))``, and a worker calls
``dataset.reseed(item_seed)`` before it decodes an item, where the
dataset has ``reseed``: no two items of an epoch share their draws, and
the batches are a function of ``seed``.  They are not the thread path's
batches, whose draws come from the dataset's own streams in call order.

A worker's exception reaches the consumer after the batches before it; a
consumer that stops early stops every worker (none is left alive).
"""

import pickle
import queue
import traceback
from multiprocessing import resource_tracker
from multiprocessing.shared_memory import SharedMemory
from typing import Iterator, List, Optional, Sequence

import numpy as np

# seconds a stopping worker has to exit before it is terminated
_JOIN_S = 5.0


def stack_first(items):
    """The items' first elements stacked; component-wise when they are
    tuples (an (image, depth) pair)."""
    if isinstance(items[0][0], tuple):
        k = len(items[0][0])
        return tuple(np.stack([it[0][j] for it in items]) for j in range(k))
    return np.stack([it[0] for it in items])


def stack_batch(items):
    """-> ``(images, masks, extra)``, ``extra`` the items' third elements
    (paths) or None."""
    extra = [it[2] for it in items] if len(items[0]) > 2 else None
    return stack_first(items), np.stack([it[1] for it in items]), extra


def item_seeds(seed: int, positions: Sequence[int]) -> List[int]:
    """The seed of the item at each position of an epoch."""
    return [int(np.random.SeedSequence((int(seed), int(p))).generate_state(
        1)[0]) for p in positions]


def _arrays(images, masks):
    return (list(images) if isinstance(images, tuple) else [images]) + [masks]


def _to_shm(arrays):
    """Arrays -> (a new shared-memory block holding them, layout)."""
    layout, size = [], 0
    for a in arrays:
        layout.append((a.shape, a.dtype.str, size))
        size += (a.nbytes + 63) // 64 * 64
    shm = SharedMemory(create=True, size=max(size, 1))
    # the parent attaches, copies and unlinks it: its tracker entry is the
    # parent's, so this process drops its own
    resource_tracker.unregister(shm._name, "shared_memory")
    for a, (shape, dtype, off) in zip(arrays, layout):
        np.ndarray(shape, dtype, shm.buf, off)[...] = a
    return shm, layout


def _from_shm(name, layout):
    """Copies of the arrays in block ``name``, which is then unlinked."""
    shm = SharedMemory(name=name)
    try:
        return [np.ndarray(shape, dtype, shm.buf, off).copy()
                for shape, dtype, off in layout]
    finally:
        shm.close()
        shm.unlink()


def _unlink(name):
    try:
        shm = SharedMemory(name=name)
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def _put(out, msg, stop) -> bool:
    while not stop.is_set():
        try:
            out.put(msg, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _worker(dataset, jobs, out, stop):
    """Build each job's batch: ``jobs`` = [(batch, indices, item seeds)]."""
    try:  # one core a worker: cv2's own pool in every worker oversubscribes
        import cv2
        cv2.setNumThreads(1)
    except ImportError:
        pass
    reseed = getattr(dataset, "reseed", None)
    try:
        for b, sel, seeds in jobs:
            items = []
            for i, s in zip(sel, seeds):
                if stop.is_set():
                    return
                if reseed is not None:
                    reseed(s)
                items.append(dataset[int(i)])
            images, masks, extra = stack_batch(items)
            shm, layout = _to_shm(_arrays(images, masks))
            shm.close()
            msg = ("batch", b, shm.name, layout,
                   isinstance(images, tuple), extra)
            if not _put(out, msg, stop):
                _unlink(shm.name)
                return
    except BaseException as exc:  # handed to the consumer, which raises it
        exc.add_note("in a decode worker process:\n"
                     + "".join(traceback.format_exception(exc)))
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(
                "".join(traceback.format_exception(exc))))
        _put(out, ("error", None, payload, None, None, None), stop)


def process_batches(dataset, batches: Sequence[np.ndarray], workers: int,
                    seed: int, prefetch: int = 2, first_position: int = 0,
                    positions: Optional[Sequence[Sequence[int]]] = None
                    ) -> Iterator:
    """Yield ``(images, masks, extra)`` for each index array of
    ``batches``, in order, decoded by ``workers`` processes that run up to
    ``prefetch`` batches ahead each.  ``first_position``: the epoch position
    of ``batches[0]``'s first item (item seeds are by position; the batches
    follow each other); ``positions``: each batch's item positions instead
    (one process's slices of global batches)."""
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    workers = max(1, min(workers, len(batches)))
    stop = ctx.Event()
    queues = [ctx.Queue(maxsize=max(1, prefetch)) for _ in range(workers)]
    jobs = [[] for _ in range(workers)]
    pos = first_position
    for b, sel in enumerate(batches):
        at = range(pos, pos + len(sel)) if positions is None else positions[b]
        jobs[b % workers].append((b, np.asarray(sel), item_seeds(seed, at)))
        pos += len(sel)
    procs = [ctx.Process(target=_worker, args=(dataset, jobs[w], queues[w],
                                               stop),
                         name=f"decode-{w}", daemon=True)
             for w in range(workers)]
    for p in procs:
        p.start()
    try:
        for b in range(len(batches)):
            w = b % workers
            while True:
                try:
                    kind, got, name, layout, tup, extra = queues[w].get(
                        timeout=0.5)
                    break
                except queue.Empty:
                    if not procs[w].is_alive():
                        raise RuntimeError(
                            f"decode worker {w} exited with code "
                            f"{procs[w].exitcode} before batch {b}")
            if kind == "error":
                raise pickle.loads(name)
            assert got == b, (got, b)
            arrays = _from_shm(name, layout)
            images = tuple(arrays[:-1]) if tup else arrays[0]
            yield images, arrays[-1], extra
    finally:
        stop.set()
        for p in procs:
            p.join(_JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join()
        for q in queues:  # blocks a stopped worker made but did not hand off
            while True:
                try:
                    msg = q.get_nowait()
                except (queue.Empty, OSError, EOFError):
                    break
                if msg[0] == "batch":
                    _unlink(msg[2])
            q.close()
            q.join_thread()

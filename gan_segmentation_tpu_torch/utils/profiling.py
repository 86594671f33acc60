"""A samples/sec/chip meter (the JAX package's
``gan_segmentation_tpu/utils/profiling.py::Speedometer``, copied: that
module imports jax for its trace context; ``tests/test_torch_helpers.py``
pins the two together).  The port's traces are ``torch.profiler``'s."""

import time


class Speedometer:
    """samples/sec/chip meter (`seg_solver.py:436-448` semantics)."""

    def __init__(self, display_every: int = 4, n_chips: int = 1):
        self.display_every = display_every
        self.n_chips = max(1, n_chips)
        self.reset()

    def reset(self):
        self._tic = time.time()
        self._count = 0

    def update(self, batch_size: int):
        """Returns samples/sec/chip every ``display_every`` calls, else None."""
        self._count += 1
        if self._count % self.display_every == 0:
            dt = time.time() - self._tic
            rate = self.display_every * batch_size / dt / self.n_chips
            self._tic = time.time()
            return rate
        return None

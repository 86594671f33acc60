"""Small picklable datasets for the tests of the port's batch feed
(``train/deeplab_trainer.py::batch_iter``), kept out of the test modules
that import jax, so that a decode worker process imports only this module
(which holds no test) to unpickle one."""

import os
import time

import numpy as np


class Items:
    """``n`` items (image, mask) or ((image, depth), mask[, path]) whose
    values name their index; ``fail_at`` raises on one index."""

    def __init__(self, n, depth=False, paths=False, fail_at=None, delay=0.0):
        self.n, self.depth, self.paths = n, depth, paths
        self.fail_at, self.delay = fail_at, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"cannot decode item {i}")
        time.sleep(self.delay)
        img = np.full((2, 3, 3), i, np.uint8)
        mask = np.full((2, 3), i % 3 - 1, np.int32)
        first = (img, np.full((2, 3, 1), i / 7, np.float32)) if self.depth \
            else img
        return (first, mask, f"p{i}") if self.paths else (first, mask)


class Pids(Items):
    """Items whose path is the id of the process that decoded them."""

    def __init__(self, n, delay=0.0):
        super().__init__(n, paths=True, delay=delay)

    def __getitem__(self, i):
        img, mask, _ = super().__getitem__(i)
        return img, mask, os.getpid()

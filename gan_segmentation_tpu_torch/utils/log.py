"""Logging of the experiment runs (`deeplabv3plus/lib/utils/log.py`).

The counterpart of ``gan_segmentation_tpu/utils/log.py``: the port's
modules log through ``logging.getLogger(__name__)``, so their records reach
the package logger ``logger`` below; ``add_file_handler`` writes them to a
run's log file and ``add_console_handler`` to stderr (both called by
``train.experiments.init_exp``, not at import).  ``TqdmToLogger`` bridges
tqdm's progress lines into the logger.
"""

import io
import logging
import time

logger = logging.getLogger("gan_segmentation_tpu_torch")
logger.setLevel(logging.INFO)

_FORMAT = logging.Formatter("(%(levelname)s) %(asctime)s: %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")


def add_file_handler(path) -> logging.FileHandler:
    """Log the package to ``path`` from now on.  One run log at a time: a
    file handler added by an earlier call is closed and removed, so runs
    made one after another in a process keep their own files."""
    for h in [h for h in logger.handlers if getattr(h, "_run_log", False)]:
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(str(path))
    fh.setFormatter(_FORMAT)
    fh._run_log = True
    logger.addHandler(fh)
    return fh


def add_console_handler() -> None:
    """Log the package to stderr (once per process)."""
    if not any(getattr(h, "_console", False) for h in logger.handlers):
        h = logging.StreamHandler()
        h.setFormatter(_FORMAT)
        h._console = True
        logger.addHandler(h)


class TqdmToLogger(io.StringIO):
    """Redirect tqdm output into the logger (`log.py:14-35`)."""

    def __init__(self, target_logger=None, level=logging.INFO, mininterval=5):
        super().__init__()
        self.logger = target_logger or logger
        self.level = level
        self.mininterval = mininterval
        self._last = 0
        self.buf = ""

    def write(self, buf):
        self.buf = buf.strip("\r\n\t ")

    def flush(self):
        if len(self.buf) > 0 and time.time() - self._last > self.mininterval:
            self.logger.log(self.level, self.buf)
            self._last = time.time()

"""The CLIs' logger and the train loop's smoothed metrics.

Port of ``diffusionvid_tpu/utils/logging.py`` (the reference's
``mega_core/utils/logger.py``, a stream and ``log.txt`` logger, and
``mega_core/utils/metric_logger.py``, the window-20 ``SmoothedValue`` /
``MetricLogger`` of the train loop, engine/trainer.py:155-172).
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import sys
from collections import defaultdict, deque

_FORMAT = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")


def setup_logger(name: str = "diffusionvid_torch", save_dir: str | None = None) -> logging.Logger:
    """The named logger, set up on its first call (later calls return it
    as it is)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(_FORMAT)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(_FORMAT)
        logger.addHandler(fh)
    return logger


@contextlib.contextmanager
def log_to_file(logger: logging.Logger, save_dir: str):
    """Copy ``logger``'s records to ``save_dir/log.txt`` inside the block,
    whatever file an earlier run in this process logged to."""
    os.makedirs(save_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(_FORMAT)
    logger.addHandler(fh)
    try:
        yield logger
    finally:
        logger.removeHandler(fh)
        fh.close()


class SmoothedValue:
    """A series, reported as the median and mean of its last ``window``
    values and its mean over all."""

    def __init__(self, window: int = 20):
        self.values = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.values.append(v)
        self.total += v
        self.count += 1

    @property
    def median(self) -> float:
        return statistics.median(self.values) if self.values else 0.0

    @property
    def avg(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Named ``SmoothedValue`` meters; ``str`` gives ``name: median (global
    mean)`` for each."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
                                   for name, m in self.meters.items())

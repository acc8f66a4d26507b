"""Trace a region, or a window of loop iterations, with ``torch.profiler``
(the counterpart of ``diffusionvid_tpu/utils/profiling.py``: ``trace`` and
``StepProfiler``)."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


def _profile():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed region, host and (where there is one) card, and
    write a Chrome trace ``trace.json`` to ``logdir``; a no-op when None."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    with _profile() as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepProfiler:
    """Profile the iterations ``[start, stop)`` of a loop into
    ``logdir/trace.json``; a no-op without ``logdir``.  Call ``step(it)``
    before iteration ``it`` and ``close()`` after the loop."""

    def __init__(self, logdir: Optional[str], start: int = 10, stop: int = 15):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None

    def step(self, it: int) -> None:
        if not self.logdir:
            return
        if it == self.start and self._prof is None:
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = _profile()
            self._prof.start()
        elif it == self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
            self._prof = None

"""Trace a region with ``torch.profiler`` (the counterpart of
``diffusionvid_tpu/utils/profiling.py:21``)."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed region, host and (where there is one) card, and
    write a Chrome trace ``trace.json`` to ``logdir``; a no-op when None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

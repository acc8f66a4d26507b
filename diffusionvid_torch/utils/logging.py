"""The CLIs' logger (port of ``diffusionvid_tpu/utils/logging.py:16``, the
reference's ``mega_core/utils/logger.py``): stdout, plus ``log.txt`` in the
output directory."""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(name: str = "diffusionvid_torch", save_dir: str | None = None) -> logging.Logger:
    """The named logger, set up on its first call (later calls return it
    as it is)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger

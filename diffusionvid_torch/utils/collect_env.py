"""The environment report the train CLI logs at startup (the reference's
``mega_core/utils/collect_env.py``, ``tools/train_net.py:219-220``)."""

from __future__ import annotations

import platform
import subprocess
import sys

import numpy as np
import torch


def collect_env_info() -> str:
    """Python, torch, CUDA, the card's name and power limit (when there is
    a card) and numpy, one per line."""
    lines = [f"python: {sys.version.split()[0]} ({platform.platform()})",
             f"torch: {torch.__version__}  cuda: {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines.append(f"card: {torch.cuda.get_device_name(0)} "
                     f"(count {torch.cuda.device_count()})")
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=30, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            smi = f"unavailable ({e})"
        lines.append(f"nvidia-smi: {smi}")
    else:
        lines.append("card: none")
    lines.append(f"numpy: {np.__version__}")
    return "\n".join(lines)

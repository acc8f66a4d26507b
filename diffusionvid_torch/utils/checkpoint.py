"""Checkpoint save and load with resume semantics.

Port of ``diffusionvid_tpu/utils/checkpoint.py`` (the reference's
``Checkpointer``, ``mega_core/utils/checkpoint.py:32-155``) in torch
format: one ``model_<step>.pth`` file holds the model's state dict, the
optimizer's state and the step, and a ``last_checkpoint`` pointer file names
the newest one, so a restarted run resumes from it.  ``merge_pretrained``
and ``filter_params`` are the class-head transfer (``skip_modules``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_LAST = "last_checkpoint"


def _ckpt_path(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"model_{step:07d}.pth")


def save_checkpoint(output_dir: str, step: int, model_state, opt_state=None,
                    extra: Optional[dict] = None) -> str:
    """Save the model state (and optionally the optimizer state) at
    ``step``, then point ``last_checkpoint`` at it.  Returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    path = _ckpt_path(output_dir, step)
    payload = {"model": model_state, "step": int(step)}
    if opt_state is not None:
        payload["optimizer"] = opt_state
    if extra:
        payload["extra"] = extra
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(output_dir, _LAST), "w") as f:
        f.write(path)
    return path


def last_checkpoint(output_dir: str) -> Optional[str]:
    """The path ``last_checkpoint`` names, or None when there is none."""
    p = os.path.join(output_dir, _LAST)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        path = f.read().strip()
    return path if os.path.exists(path) else None


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The saved dict: ``model``, ``step`` and, when saved, ``optimizer``
    and ``extra``."""
    return torch.load(path, map_location=map_location, weights_only=False)


def _skipped(name: str, skip_keys) -> bool:
    return any(k in part for part in name.split(".") for k in skip_keys)


def filter_params(state, skip_keys=("class_logits",)):
    """The state dict without the tensors whose name has a part containing
    any of ``skip_keys`` (the COCO → VID class-head transfer)."""
    return {k: v for k, v in state.items() if not _skipped(k, skip_keys)}


def merge_pretrained(target_state, loaded_state, skip_keys=("class_logits",)):
    """Copy the loaded tensors into the target state dict, keeping the
    target's tensor where the name matches ``skip_keys``, is missing from
    the load, or has another shape.  Returns (merged state, tensors copied)."""
    out, copied = {}, 0
    for name, tval in target_state.items():
        lval = loaded_state.get(name)
        if (lval is not None and not _skipped(name, skip_keys)
                and tuple(lval.shape) == tuple(tval.shape)):
            out[name] = lval.to(dtype=tval.dtype)
            copied += 1
        else:
            out[name] = tval
    return out, copied

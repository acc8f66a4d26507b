"""Data parallelism over ``torch.distributed``: one process a card.

The counterpart of the JAX package's ``parallel/mesh.py`` and
``parallel/multihost.py``.  Under ``torchrun --nproc_per_node W`` each
process trains on one sample an iteration and ``DistributedDataParallel``
averages the gradients (``engine/train.py: wrap_data_parallel``), which is
the gradient of the mean of the W samples' losses, as the JAX step's psum
over a mesh of W devices; evaluation shards the videos by rank and
``gather_predictions`` merges them on every rank.

``initialize`` reads the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without
it nothing starts and every function here answers for one process.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize(device=None, backend: str | None = None,
               timeout_s: float | None = None) -> bool:
    """Join the process group that the ``torchrun`` environment describes;
    without ``RANK`` and ``WORLD_SIZE`` do nothing.  ``nccl`` on the card,
    ``gloo`` when ``device`` is the CPU (or ``backend`` as given).  On the
    card, ``LOCAL_RANK`` becomes the current device before any model is
    built.  ``timeout_s``: how long a collective waits for the other ranks
    (the backend's default without it).  Returns whether a group is up."""
    if is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train over gloo on the CPU")
        torch.cuda.set_device(local_rank())
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"), **kw)
    return True


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def gather_objects(obj) -> list:
    """``obj`` of every rank, in rank order (``[obj]`` without a group)."""
    if not is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


class RankFailed(RuntimeError):
    """Raised on the ranks that did not fail when another rank did."""


@contextlib.contextmanager
def all_or_none():
    """Under a process group every rank leaves the block the same way: when
    the block raised on any rank, it raises on every rank (the rank that
    failed its own error, the others ``RankFailed`` naming it), so that no
    rank goes on to a collective that a failed rank never reaches.  Every
    rank must enter the block.  Without a group: the block as it is."""
    if not is_initialized():
        yield
        return
    error = None
    try:
        yield
    except Exception as e:
        error = e
    notes = gather_objects(None if error is None else f"{type(error).__name__}: {error}")
    if error is not None:
        raise error
    failed = [f"rank {r}: {note}" for r, note in enumerate(notes) if note is not None]
    if failed:
        raise RankFailed("failed on " + "; ".join(failed))


def all_reduce_mean(tensors: dict) -> dict:
    """The mean over ranks of each scalar tensor of ``tensors``, in one
    all-reduce (``gloo`` has no average: a sum, then a division)."""
    if not is_initialized() or not tensors:
        return tensors
    keys = sorted(tensors)
    flat = torch.stack([tensors[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    flat /= world_size()
    return {k: flat[i] for i, k in enumerate(keys)}


def gather_predictions(tagged):
    """``[(video_index, [items...]), ...]`` of every rank (the per-video
    predictions, or GT), sorted by video index and flattened: the items in
    the dataset's order, on every rank (``all_gather_object``; the
    reference's pickle all_gather merge, engine/inference.py:97-116)."""
    if is_initialized():
        parts = [None] * world_size()
        dist.all_gather_object(parts, list(tagged))
        tagged = [item for part in parts for item in part]
    out = []
    for _, items in sorted(tagged, key=lambda t: t[0]):
        out.extend(items)
    return out

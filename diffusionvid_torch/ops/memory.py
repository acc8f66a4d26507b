"""Fixed-size diverse global memory (DiffusionVID's FPS-dedup memory).

Port of ``diffusionvid_tpu/ops/memory.py``.  The memory is a static
``[capacity, D]`` buffer whose valid slots are a prefix of ``count``.  The
count is a host integer here (the JAX package keeps it on the device), so
the port decides on the host whether the merged set must be thinned by FPS
and runs FPS only then; the result is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fps import farthest_point_sample, pairwise_l2_distance


class FeatureMemory(NamedTuple):
    feats: torch.Tensor  # [capacity, D]
    count: int           # valid prefix length


def init_memory(capacity: int, dim: int, dtype=torch.float32,
                device="cpu") -> FeatureMemory:
    return FeatureMemory(torch.zeros(capacity, dim, dtype=dtype, device=device), 0)


def update_erase_memory(mem: FeatureMemory, new_feats, new_count: int) -> FeatureMemory:
    """Merge the valid prefix of ``new_feats`` [M, D] into the memory.

    If the merged set fits, keep everything (memory first, then new, order
    kept); otherwise greedily keep ``capacity`` max-min-distance features
    (diffusion_det.py:841-867)."""
    capacity, _ = mem.feats.shape
    new_feats = new_feats.to(mem.feats.dtype)
    total = mem.count + new_count
    if total <= capacity:
        out = mem.feats.clone()
        out[mem.count:total] = new_feats[:new_count]
        return FeatureMemory(out, total)
    merged = torch.cat([mem.feats, new_feats], 0)
    ar = torch.arange(merged.shape[0], device=merged.device)
    valid = torch.where(ar < capacity, ar < mem.count, (ar - capacity) < new_count)
    idx = farthest_point_sample(pairwise_l2_distance(merged), capacity, valid)
    return FeatureMemory(merged[idx], capacity)

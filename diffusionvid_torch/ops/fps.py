"""Farthest-point sampling over feature vectors (the diversity memory core).

Port of ``diffusionvid_tpu/ops/fps.py``: start from index 0, then greedily
pick the point with the largest min-distance to the selected set; invalid
rows are never picked.
"""

from __future__ import annotations

import torch


def pairwise_l2_distance(feats, eps: float = 1e-12):
    """[N, N] L2 distance matrix (reference: torch.cdist p=2)."""
    sq = (feats * feats).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * feats @ feats.T
    return torch.sqrt(d2.clamp(min=eps))


def farthest_point_sample(distance, k: int, valid=None):
    """Greedy max-min-distance selection → ``[k]`` int64 indices.  The
    selection stays on the device: no host round trip per step."""
    n = distance.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=distance.device)
    neg = torch.full((n,), -1.0, dtype=distance.dtype, device=distance.device)
    temp = torch.where(valid, torch.full_like(neg, 1e10), neg)
    out = torch.zeros(k, dtype=torch.long, device=distance.device)
    last = out[0]
    for j in range(1, k):
        temp = torch.where(valid, torch.minimum(temp, distance[last]), neg)
        last = torch.argmax(temp)
        out[j] = last
    return out

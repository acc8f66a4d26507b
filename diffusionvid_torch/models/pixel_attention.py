"""Pixel-level attention of MEGA's pixel paths (``LOCAL/GLOBAL.PIXEL_ATTEND``).

Port of ``diffusionvid_tpu/models/pixel_attention.py:35-103``: the 2D
sinusoidal positional embedding of feature-map pixels and
``PixelMemoryAttention`` (the reference's ``update_lm_pixel``,
roi_box_feature_extractors.py:1214-1236), the map's pixels attending over a
reference pixel set and pixel memories through geometry-free grouped
relation attention, with a residual.  Module names follow the JAX package's
tree (``attn`` below ``pixel_attn``).

The JAX module's ``SparseSpatioTemporalAttention`` (and its
``sparse_block_mask``) is reached by no entry point there and draws its
mask from a ``jax.random`` key: ROADMAP.md A8.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .relation import RelationAttention


def pixel_positional_embedding(height: int, width: int, d_model: int,
                               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``[H, W, d_model]``: the first half of the channels encodes the x
    position, the second half the y position, each as interleaved sin/cos
    (``cal_positional_embedding_pixel``, roi_box_feature_extractors.py:257-279)."""
    if d_model % 4 != 0:
        raise ValueError(f"d_model must be divisible by 4, got {d_model}")
    half = d_model // 2
    div = torch.exp(torch.arange(0, half, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / half))
    pw = torch.arange(width, dtype=torch.float32, device=device)[:, None] * div[None]
    ph = torch.arange(height, dtype=torch.float32, device=device)[:, None] * div[None]
    k = div.shape[0]
    pe = torch.zeros(height, width, d_model, dtype=torch.float32, device=device)
    pe[:, :, 0:half:2] = torch.sin(pw)[None].expand(height, width, k)
    pe[:, :, 1:half:2] = torch.cos(pw)[None].expand(height, width, k)
    pe[:, :, half::2] = torch.sin(ph)[:, None].expand(height, width, k)
    pe[:, :, half + 1::2] = torch.cos(ph)[:, None].expand(height, width, k)
    return pe.to(dtype)


class PixelMemoryAttention(nn.Module):
    """``update_lm_pixel``: a map's pixels → grouped relation attention
    (8 groups, the reference's ``groups_p``) over a pixel set, residual.
    On channels-last maps ``[H, W, C]``."""

    def __init__(self, feat_dim: int = 1024, groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.attn = RelationAttention(feat_dim, groups, geometry=False, dtype=dtype)

    def forward(self, feats, memory=None, memory_valid=None, keys=None, keys_valid=None):
        """``feats`` ``[H, W, C]`` queries; ``keys`` ``[K, C]`` the base
        reference pixels (None: the query's own pixels); ``memory``
        ``[M, C]`` extra pixel keys after them.  Returns the enhanced
        ``[H, W, C]`` map."""
        h, w, c = feats.shape
        px = feats.reshape(-1, c)
        if keys is None:
            keys = px
            valid = torch.ones(px.shape[0], dtype=torch.bool, device=px.device)
        else:
            keys = keys.to(px.dtype)
            valid = (keys_valid if keys_valid is not None
                     else torch.ones(keys.shape[0], dtype=torch.bool, device=px.device))
        if memory is not None:
            keys = torch.cat([keys, memory.to(px.dtype)], 0)
            mvalid = (memory_valid if memory_valid is not None
                      else torch.ones(memory.shape[0], dtype=torch.bool, device=px.device))
            valid = torch.cat([valid, mvalid], 0)
        return (px + self.attn(px, keys, None, valid)).reshape(h, w, c)

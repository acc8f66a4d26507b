"""Region Proposal Network of the C4 architectures, inference half.

Port of ``diffusionvid_tpu/models/rpn.py:35-123``: anchors (sizes 64-512 x
ratios 0.5/1/2 at stride 16, the caffe2 convention), the 3x3 conv +
objectness/delta head, and the fixed-size proposal selection (top
``pre_nms`` objectness → decode → clip → small-box filter → greedy NMS →
the first ``post_nms`` survivors, ``ops/nms.py: nms_select``).  The MEGA
family's reference-frame proposals are the same selection with another
``post_nms``.  The loss half (``match_anchors``, ``sample_balanced``,
``rpn_loss``) belongs to the train half (ROADMAP.md A7.5).

As in the JAX package, the deltas decode with the Fast R-CNN weights
(10, 10, 5, 5) and the 6,000 pre-NMS candidates are ``PRE_NMS_TOP_N_TEST``
for the reference frames too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import nms_select
from ..structures.boxes import decode_boxes
from .resnet import Conv2d


def generate_anchors(sizes=(64, 128, 256, 512), ratios=(0.5, 1.0, 2.0),
                     stride: int = 16) -> np.ndarray:
    """[A, 4] base anchors centred on (stride-1)/2, ratio-major."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in sizes:
            scale = s / stride
            w_s, h_s = ws * scale, hs * scale
            out.append([cx - 0.5 * (w_s - 1), cy - 0.5 * (h_s - 1),
                        cx + 0.5 * (w_s - 1), cy + 0.5 * (h_s - 1)])
    return np.asarray(out, np.float32)


def shift_anchors(base: np.ndarray, feat_h: int, feat_w: int, stride: int) -> np.ndarray:
    """[H*W*A, 4] grid anchors in (h, w, a) order."""
    sx = np.arange(feat_w) * stride
    sy = np.arange(feat_h) * stride
    xx, yy = np.meshgrid(sx, sy)
    shifts = np.stack([xx.ravel(), yy.ravel(), xx.ravel(), yy.ravel()], 1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4).astype(np.float32)


class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness and deltas (rpn/rpn.py:69-106).
    Takes the NCHW trunk map and returns the JAX package's layouts,
    logits ``[B, H, W, A]`` and deltas ``[B, H, W, 4A]``, so that their
    flattening is (h, w, a) as ``shift_anchors`` orders the anchors."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, bias=True)
        self.cls_logits = Conv2d(channels, num_anchors, 1, bias=True)
        self.bbox_pred = Conv2d(channels, 4 * num_anchors, 1, bias=True)

    def forward(self, feat):
        t = F.relu(self.conv(feat))
        return (self.cls_logits(t).permute(0, 2, 3, 1),
                self.bbox_pred(t).permute(0, 2, 3, 1))


class Proposals(NamedTuple):
    boxes: torch.Tensor   # [B, K, 4]
    scores: torch.Tensor  # [B, K]
    valid: torch.Tensor   # [B, K]


def select_proposals(logits, deltas, anchors, image_hw, *, pre_nms: int,
                     post_nms: int, nms_thresh: float = 0.7,
                     min_size: float = 0.0) -> Proposals:
    """Per-image proposal selection with static shapes.  logits
    ``[B, H, W, A]``, deltas ``[B, H, W, 4A]``, anchors ``[H*W*A, 4]``,
    ``image_hw`` the true (h, w).  The top ``pre_nms`` keep ``lax.top_k``'s
    order (ties: lower index first)."""
    b = logits.shape[0]
    n = anchors.shape[0]
    obj = logits.reshape(b, n).float()
    dl = deltas.reshape(b, -1, 4).float()
    pre = min(pre_nms, n)
    h, w = image_hw
    out = []
    for o, d in zip(obj, dl):
        top_o, top_i = torch.sort(o, descending=True, stable=True)
        top_o, top_i = top_o[:pre], top_i[:pre]
        boxes = decode_boxes(d[top_i], anchors[top_i]).reshape(pre, 4)
        x1, y1, x2, y2 = boxes.unbind(-1)
        boxes = torch.stack([x1.clamp(0, w - 1), y1.clamp(0, h - 1),
                             x2.clamp(0, w - 1), y2.clamp(0, h - 1)], 1)
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        ok = (ws >= min_size) & (hs >= min_size)
        idx, val = nms_select(boxes, torch.where(ok, top_o, torch.full_like(top_o, -float("inf"))),
                              post_nms, nms_thresh, valid=ok, plus_one=True)
        out.append((boxes[idx], top_o[idx], val))
    return Proposals(*(torch.stack(t) for t in zip(*out)))

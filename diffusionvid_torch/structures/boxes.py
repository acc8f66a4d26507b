"""Box structures and box ops on tensors.

Port of ``diffusionvid_tpu/structures/boxes.py``: a fixed-size padded
detection set plus a validity mask, and the xyxy/cxcywh, IoU, GIoU,
clipping and delta encoding and decoding functions the inference and
training paths use.  Every function takes leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class BoxArray(NamedTuple):
    """Fixed-size padded detection set."""

    boxes: torch.Tensor   # [..., N, 4] xyxy absolute
    scores: torch.Tensor  # [..., N]
    labels: torch.Tensor  # [..., N] int64 (1..num_classes)
    valid: torch.Tensor   # [..., N] bool


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def box_area(boxes, plus_one: bool = False):
    off = 1.0 if plus_one else 0.0
    return (boxes[..., 2] - boxes[..., 0] + off) * (boxes[..., 3] - boxes[..., 1] + off)


def pairwise_intersection(boxes1, boxes2, plus_one: bool = False):
    """[..., N, M] intersection areas."""
    off = 1.0 if plus_one else 0.0
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + off).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1, boxes2, plus_one: bool = False):
    inter = pairwise_intersection(boxes1, boxes2, plus_one)
    a1 = box_area(boxes1, plus_one)
    a2 = box_area(boxes2, plus_one)
    union = a1[..., :, None] + a2[..., None, :] - inter
    return inter / union.clamp(min=torch.finfo(inter.dtype).tiny)


def pairwise_giou(boxes1, boxes2):
    """Generalized IoU [..., N, M] (reference: generalized_box_iou,
    loss.py:231-254)."""
    iou = pairwise_iou(boxes1, boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=torch.finfo(iou.dtype).tiny)


def elementwise_giou(boxes1, boxes2):
    """GIoU of boxes1[..., i] against boxes2[..., i]."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    iou = inter / union.clamp(min=torch.finfo(inter.dtype).tiny)
    lt_h = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_h = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_h = (rb_h - lt_h).clamp(min=0.0)
    hull = wh_h[..., 0] * wh_h[..., 1]
    return iou - (hull - union) / hull.clamp(min=torch.finfo(iou.dtype).tiny)


def clip_to_image(boxes, image_size_hw, plus_one: bool = False):
    """Clamp xyxy boxes to the image (reference BoxList.clip_to_image)."""
    h, w = image_size_hw
    off = 1.0 if plus_one else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0.0, w - off), y1.clamp(0.0, h - off),
                        x2.clamp(0.0, w - off), y2.clamp(0.0, h - off)], -1)


_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def encode_boxes(reference_boxes, proposals, weights=(10.0, 10.0, 5.0, 5.0),
                 plus_one: bool = True):
    """The deltas ``[..., 4]`` that take ``proposals`` to ``reference_boxes``
    (maskrcnn BoxCoder.encode), the inverse of ``decode_boxes``."""
    off = 1.0 if plus_one else 0.0
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0] + off
    ex_h = proposals[..., 3] - proposals[..., 1] + off
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + off
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + off
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)], -1)


def decode_boxes(deltas, boxes, weights=(10.0, 10.0, 5.0, 5.0),
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP,
                 plus_one: bool = True):
    """Decode ``deltas`` [..., k*4] against ``boxes`` [..., 4]
    (maskrcnn BoxCoder.decode; ``plus_one=False`` is detectron2's)."""
    off = 1.0 if plus_one else 0.0
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + off
    heights = boxes[..., 3] - boxes[..., 1] + off
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = torch.clamp(deltas[..., 2::4] / ww, max=scale_clamp)
    dh = torch.clamp(deltas[..., 3::4] / wh, max=scale_clamp)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w - off,
                       pred_cy + 0.5 * pred_h - off], -1)   # [..., k, 4]
    return out.reshape(*deltas.shape[:-1], -1)


def apply_deltas_diffusion(deltas, boxes, weights=(2.0, 2.0, 1.0, 1.0)):
    """DiffusionDet RCNNHead.apply_deltas (box_head.py:550-590)."""
    return decode_boxes(deltas, boxes, weights=weights, plus_one=False)

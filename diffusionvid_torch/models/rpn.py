"""Region Proposal Network of the C4 architectures.

Port of ``diffusionvid_tpu/models/rpn.py``: anchors (sizes 64-512 x
ratios 0.5/1/2 at stride 16, the caffe2 convention), the 3x3 conv +
objectness/delta head, and the fixed-size proposal selection (top
``pre_nms`` objectness → decode → clip → small-box filter → greedy NMS →
the first ``post_nms`` survivors, ``ops/nms.py: nms_select``).  The MEGA
family's reference-frame proposals are the same selection with another
``post_nms``.  The loss (rpn/loss.py): anchors matched to the GT at IoU
0.7 / 0.3 with the low-quality matches recovered (``match_anchors``), 256
of them sampled half positive (``sample_balanced``), the objectness BCE and
the smooth-L1 of the deltas (``rpn_loss``).

The sampler takes its random keys as an input, two uniforms a row
(positives' and negatives'), which the train step draws from a generator
seeded by the iteration; it keeps the JAX package's threshold trick (a row
is drawn when its key is at least the k-th largest key of its kind:
ROADMAP.md §C deviation 8), so that the JAX package's keys give its masks.

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

from ..ops.losses import smooth_l1_loss
from ..ops.nms import nms_select
from ..structures.boxes import decode_boxes, encode_boxes, pairwise_iou
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


def _clip(x, hi):
    """``x`` clipped to [0, hi] as ``jnp.clip``: at a bound the gradient is
    halved (``torch.clamp`` passes it whole)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_tensor(float(hi)))


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
    order (ties: lower index first).  Differentiable in the selected boxes
    and scores: the MEGA family's reference proposals stay on the gradient
    path in training, as in the JAX package."""
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
        boxes = torch.stack([_clip(x1, w - 1), _clip(y1, h - 1), _clip(x2, w - 1),
                             _clip(y2, h - 1)], 1)
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        ok = (ws >= min_size) & (hs >= min_size)
        masked = torch.where(ok, top_o, torch.full_like(top_o, -float("inf")))
        with torch.no_grad():   # indices: the gradient takes the gather below
            idx, val = nms_select(boxes, masked, post_nms, nms_thresh, valid=ok, plus_one=True)
        out.append((boxes[idx], top_o[idx], val))
    return Proposals(*(torch.stack(t) for t in zip(*out)))


def match_anchors(anchors, gt_boxes, gt_valid, fg_thresh: float = 0.7,
                  bg_thresh: float = 0.3):
    """Anchors ``[N, 4]`` against one image's GT ``[G, 4]`` (matcher.py):
    (the best GT of each anchor ``[N]``, labels ``[N]``: 1 foreground at IoU
    ``fg_thresh`` and above, 0 background below ``bg_thresh``, -1 between);
    each valid GT's best anchors (IoU above 0) are foreground too."""
    iou = pairwise_iou(anchors, gt_boxes, plus_one=True)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(1)
    labels = torch.where(best_iou >= fg_thresh, 1, torch.where(best_iou < bg_thresh, 0, -1))
    gt_best = iou.max(0).values
    is_best = (iou == gt_best[None, :]) & gt_valid[None, :] & (iou > 0)
    return best_gt, torch.where(is_best.any(1), 1, labels)


def sample_balanced(keys, labels, batch_size: int = 256, pos_fraction: float = 0.5):
    """At most ``batch_size`` rows, at most ``pos_fraction`` of them
    positive (balanced_positive_negative_sampler.py), chosen by the random
    ``keys`` ``[2, N]`` (uniforms in [0, 1): the positives' row, then the
    negatives'): the rows of a kind whose key is at least the k-th largest
    of that kind.  Labels: 1 positive, 0 negative, -1 neither.  Returns the
    bool masks (positives, negatives)."""
    n = labels.shape[0]
    pos, neg = labels == 1, labels == 0
    key_pos = torch.where(pos, keys[0], torch.full_like(keys[0], -1.0))
    key_neg = torch.where(neg, keys[1], torch.full_like(keys[1], -1.0))
    n_pos = pos.sum().clamp(max=int(batch_size * pos_fraction))
    n_neg = torch.minimum(neg.sum(), batch_size - n_pos)
    pos_thr = key_pos.sort(descending=True).values[(n_pos - 1).clamp(0, n - 1)]
    neg_thr = key_neg.sort(descending=True).values[(n_neg - 1).clamp(0, n - 1)]
    return pos & (key_pos >= pos_thr) & (n_pos > 0), neg & (key_neg >= neg_thr) & (n_neg > 0)


def rpn_loss(keys, logits, deltas, anchors, gt_boxes, gt_valid, batch_size: int = 256,
             pos_fraction: float = 0.5) -> dict:
    """Objectness BCE and smooth-L1 (beta 1/9) of the deltas on each image's
    sampled anchors, both over the sampled count, averaged over the images
    (rpn/loss.py).  ``keys`` ``[B, 2, N]``: ``sample_balanced``'s of each
    image; logits ``[B, H, W, A]``, deltas ``[B, H, W, 4A]``, anchors
    ``[N, 4]``, GT ``[B, G, 4]`` with ``gt_valid`` ``[B, G]``."""
    b = logits.shape[0]
    cls_l, reg_l = [], []
    for u, o, d, gt_b, gt_v in zip(keys, logits.reshape(b, -1).float(),
                                   deltas.reshape(b, -1, 4).float(), gt_boxes, gt_valid):
        matched, labels = match_anchors(anchors, gt_b, gt_v)
        pos_sel, neg_sel = sample_balanced(u, labels, batch_size, pos_fraction)
        count = (pos_sel | neg_sel).sum().clamp(min=1)
        tgt = labels.clamp(min=0).float()
        # max(o, 0) as jnp.maximum: half the gradient to each side at 0
        bce = torch.maximum(o, torch.zeros_like(o)) - o * tgt + torch.log1p(torch.exp(-o.abs()))
        cls_l.append((bce * (pos_sel | neg_sel)).sum() / count)
        reg = smooth_l1_loss(d, encode_boxes(gt_b[matched], anchors), beta=1.0 / 9).sum(-1)
        reg_l.append((reg * pos_sel).sum() / count)
    return {"loss_objectness": torch.stack(cls_l).mean(),
            "loss_rpn_box_reg": torch.stack(reg_l).mean()}

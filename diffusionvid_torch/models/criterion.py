"""Static-shape simOTA matcher and the set criterion.

Port of ``diffusionvid_tpu/models/criterion.py`` (itself a static-shape
rewrite of the reference's ``HungarianMatcherDynamicK`` and
``SetCriterionDynamicK``, ``box_head/loss.py:257-688``).  The matcher gives
every proposal the index of its matched GT and an fg flag, against GT
padded to ``G`` slots with a validity mask; every loss is a mask-weighted
sum.  The JAX package maps the matcher over frames with ``vmap``; here it
is batched over the leading frame axis, and the repair pass runs once per
GT slot over all frames at once.

The assignment is discrete, so ties break as in JAX: sorts are stable,
``argmin`` and ``argmax`` take the first index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.losses import sigmoid_focal_loss
from ..structures.boxes import (
    elementwise_giou, pairwise_giou, pairwise_iou, xyxy_to_cxcywh)


class MatchResult(NamedTuple):
    matched_gt: torch.Tensor  # [B, N] int64 index of the matched GT (0 if none)
    fg: torch.Tensor          # [B, N] bool, the proposal is matched


def _in_boxes_info(prop_cxcywh, gt_cxcywh, gt_xyxy, gt_valid,
                   center_radius: float = 2.5):
    """(loss.py:613-642) → (fg_union [B, N], in_box_and_center [B, N, G])."""
    cx = prop_cxcywh[..., 0:1]
    cy = prop_cxcywh[..., 1:2]
    gx = gt_xyxy[:, None]                                        # [B, 1, G, 4]
    in_box = ((cx > gx[..., 0]) & (cx < gx[..., 2])
              & (cy > gx[..., 1]) & (cy < gx[..., 3]))
    gw = (gt_xyxy[..., 2] - gt_xyxy[..., 0])[:, None]
    gh = (gt_xyxy[..., 3] - gt_xyxy[..., 1])[:, None]
    gcx = gt_cxcywh[..., 0][:, None]
    gcy = gt_cxcywh[..., 1][:, None]
    in_center = ((cx > gcx - center_radius * gw) & (cx < gcx + center_radius * gw)
                 & (cy > gcy - center_radius * gh) & (cy < gcy + center_radius * gh))
    valid = gt_valid[:, None, :]
    in_box, in_center = in_box & valid, in_center & valid
    return in_box.any(-1) | in_center.any(-1), in_box & in_center


@torch.no_grad()
def simota_match(pred_logits, pred_boxes, gt_labels, gt_boxes_xyxy, gt_valid,
                 image_whwh, ota_k: int = 5, focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0, cost_class: float = 2.0,
                 cost_bbox: float = 5.0, cost_giou: float = 2.0) -> MatchResult:
    """simOTA over a batch of frames: logits [B, N, K], boxes [B, N, 4]
    absolute xyxy, gt_labels [B, G] (1..K), gt boxes [B, G, 4] absolute,
    gt_valid [B, G], whwh [B, 4]."""
    b, n, k = pred_logits.shape
    g = gt_labels.shape[1]
    prob = torch.sigmoid(pred_logits.float())
    boxes = pred_boxes.float()
    gt_xyxy = gt_boxes_xyxy.float()
    whwh = image_whwh.float()[:, None, :]

    fg_union, in_both = _in_boxes_info(xyxy_to_cxcywh(boxes), xyxy_to_cxcywh(gt_xyxy),
                                       gt_xyxy, gt_valid)
    ious = pairwise_iou(boxes, gt_xyxy)                          # [B, N, G]

    # focal-style classification cost at the GT labels (loss.py:573-577)
    pos = focal_alpha * ((1 - prob) ** focal_gamma) * (-torch.log(prob + 1e-8))
    neg = (1 - focal_alpha) * (prob ** focal_gamma) * (-torch.log(1 - prob + 1e-8))
    cls_ids = (gt_labels.long() - 1).clamp(0, k - 1)[:, None, :].expand(b, n, g)
    c_class = pos.gather(2, cls_ids) - neg.gather(2, cls_ids)

    c_bbox = ((boxes / whwh)[:, :, None, :] - (gt_xyxy / whwh)[:, None, :, :]).abs().sum(-1)
    c_giou = -pairwise_giou(boxes, gt_xyxy)

    cost = (cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
            + 100.0 * (~in_both))
    cost = cost + torch.where(fg_union, 0.0, 10000.0)[..., None]
    # invalid GT columns never match
    cost = torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, 1e15))

    # dynamic k from the top-ota_k IoU sum per GT (loss.py:649-651)
    dynamic_k = torch.topk(ious, ota_k, dim=1).values.sum(1).to(torch.int64).clamp(min=1)

    # per GT, the dynamic_k lowest-cost proposals: the rank of each proposal
    order = torch.argsort(cost, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=cost.device)[None, :, None].expand(b, n, g))
    match = (rank < dynamic_k[:, None, :]) & gt_valid[:, None, :]

    # a proposal matched to more than one GT keeps its lowest-cost GT
    n_match = match.sum(-1)
    onehot_best = F.one_hot(cost.argmin(-1), g).bool()
    match = torch.where((n_match > 1)[..., None], onehot_best & match, match)

    # repair: a valid GT with no proposal takes its lowest-cost proposal among
    # those not matched yet (loss.py:666-678); one GT slot at a time, so two
    # repaired GTs cannot take the same proposal
    frames = torch.arange(b, device=cost.device)
    for gi in range(g):
        taken = match.any(-1)
        col = cost[:, :, gi] + torch.where(taken, 1e5, 0.0)
        p = col.argmin(1)
        need = gt_valid[:, gi] & ~match[:, :, gi].any(1)
        match[frames, p, gi] |= need

    fg = match.any(-1)
    matched_gt = match.to(torch.uint8).argmax(-1)
    return MatchResult(matched_gt, fg)


def criterion_losses(pred_logits, pred_boxes, gt_labels, gt_boxes_xyxy, gt_valid,
                     image_whwh, num_classes: int, focal_alpha: float = 0.25,
                     focal_gamma: float = 2.0, ota_k: int = 5):
    """One stage's unweighted losses over a batch of frames (loss.py:327-443):
    focal CE over every proposal, L1 on normalized xyxy and GIoU on absolute
    boxes over the matched pairs, each divided by the matched count."""
    match = simota_match(pred_logits, pred_boxes, gt_labels, gt_boxes_xyxy,
                         gt_valid, image_whwh, ota_k=ota_k, focal_alpha=focal_alpha,
                         focal_gamma=focal_gamma)
    k = pred_logits.shape[-1]
    fg = match.fg.float()
    num_matched = fg.sum().clamp(min=1.0)

    lbl = gt_labels.long().gather(1, match.matched_gt)                # [B, N]
    cls_target = F.one_hot((lbl - 1).clamp(0, k - 1), k).float() * fg[..., None]
    ce = sigmoid_focal_loss(pred_logits.float(), cls_target, alpha=focal_alpha,
                            gamma=focal_gamma)
    loss_ce = ce.sum() / num_matched

    gt_b = gt_boxes_xyxy.float().gather(1, match.matched_gt[..., None].expand(-1, -1, 4))
    boxes = pred_boxes.float()
    norm = image_whwh.float()[:, None, :]
    l1 = (boxes / norm - gt_b / norm).abs().sum(-1)
    loss_bbox = (l1 * fg).sum() / num_matched
    giou = elementwise_giou(boxes, gt_b)
    loss_giou = ((1.0 - giou) * fg).sum() / num_matched
    return {"loss_ce": loss_ce, "loss_bbox": loss_bbox, "loss_giou": loss_giou}


def set_criterion(all_logits, all_boxes, gt_labels, gt_boxes_xyxy, gt_valid,
                  image_whwh, num_classes: int, class_weight: float = 2.0,
                  l1_weight: float = 5.0, giou_weight: float = 2.0):
    """Deep-supervised total loss over stacked stage outputs [S, B, N, K] /
    [S, B, N, 4] (loss.py:465-505 and diffusion_det.py:370-375).  Returns
    (total, per-stage losses; the last stage's keys have no suffix)."""
    s = all_logits.shape[0]
    losses = {}
    total = 0.0
    for i in range(s):
        d = criterion_losses(all_logits[i], all_boxes[i], gt_labels, gt_boxes_xyxy,
                             gt_valid, image_whwh, num_classes)
        suffix = "" if i == s - 1 else f"_{i}"
        for name, v in d.items():
            losses[name + suffix] = v
        total = total + (class_weight * d["loss_ce"] + l1_weight * d["loss_bbox"]
                         + giou_weight * d["loss_giou"])
    return total, losses

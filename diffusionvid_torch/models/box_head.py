"""Classic ROI box head of the C4 architectures.

Port of ``diffusionvid_tpu/models/box_head.py``: the C4 feature extractor
(14x14 ROIAlign on res4 at 1/16 → the res5 stage → mean pool,
``:38-60``), the Fast R-CNN predictor (``:80-89``), its loss
(``fast_rcnn_loss``, ``:92-134``: proposals matched at IoU 0.5, 512 sampled
a quarter positive by ``rpn.sample_balanced`` on keys the caller draws, the
cross-entropy and the class-specific smooth-L1) and the classic
post-processing (``:137-165``: softmax, class-specific decode, one
class-offset NMS over every foreground class, the first ``detections``
survivors).  ``FPN2MLPFeatureExtractor`` is reached by no architecture
(A8).

As in the JAX package, the post-processing keeps its defaults (score 0.05,
NMS 0.5, 300 detections) whatever ``MODEL.ROI_HEADS`` says.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.losses import smooth_l1_loss
from ..ops.nms import nms_select
from ..ops.roi_align import roi_align
from ..structures.boxes import BoxArray, clip_to_image, decode_boxes, encode_boxes, pairwise_iou
from .heads import Linear
from .resnet import ResNetStage
from .rpn import sample_balanced


class C4BoxFeatureExtractor(nn.Module):
    """ROIAlign(14x14, 1/16, sampling ratio 2, aligned) → res5 → mean pool
    → ``[B, R, 2048]``; res5 grouped as the trunk (ResNeXt)."""

    def __init__(self, depth: int = 101, dilation: int = 1, num_groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        self.head = ResNetStage(depth, 5, 2, dilation, num_groups, width_per_group)

    def forward(self, res4_nhwc, boxes):
        pooled = roi_align(res4_nhwc, boxes, 1.0 / 16, output_size=14, sampling_ratio=2)
        b, r = pooled.shape[:2]
        x = pooled.reshape(b * r, 14, 14, -1).permute(0, 3, 1, 2)
        x = self.head(x).mean(dim=(2, 3))
        return x.reshape(b, r, -1)


class FastRCNNPredictor(nn.Module):
    """cls_score [K+1] and class-specific bbox_pred [(K+1)*4], in float32
    (the JAX package's default dtype for these two layers)."""

    def __init__(self, in_features: int, num_classes: int = 31):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.bbox_pred = Linear(in_features, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


def fast_rcnn_loss(keys, class_logits, box_deltas, proposals, prop_valid, gt_boxes, gt_labels,
                   gt_valid, *, fg_thresh: float = 0.5, bg_thresh: float = 0.5,
                   batch_size: int = 512, pos_fraction: float = 0.25) -> dict:
    """Per image, the cross-entropy and the smooth-L1 (beta 1) of the GT
    class's deltas on the sampled proposals, both over the sampled count,
    averaged over the images (box_head/loss.py:20-198).  Proposals at IoU
    ``fg_thresh`` or more with a valid GT take its label, the other valid
    ones the background; invalid proposals are neither.  ``keys``
    ``[B, 2, R]`` (``rpn.sample_balanced``'s); class_logits ``[B, R, K+1]``,
    box_deltas ``[B, R, (K+1)*4]``, proposals ``[B, R, 4]``."""
    k1 = class_logits.shape[-1]
    cls_l, reg_l = [], []
    for u, logits, deltas, props, pv, gt_b, gt_l, gt_v in zip(
            keys, class_logits, box_deltas, proposals, prop_valid, gt_boxes, gt_labels,
            gt_valid):
        iou = pairwise_iou(props, gt_b, plus_one=True)
        iou = torch.where(gt_v[None, :] & pv[:, None], iou, torch.full_like(iou, -1.0))
        best_iou, best_gt = iou.max(1)
        fg = best_iou >= fg_thresh
        labels = torch.where(pv, torch.where(fg, gt_l[best_gt].long(), 0), -1)
        match = torch.where(fg, 1, torch.where(pv, 0, -1))
        pos_sel, neg_sel = sample_balanced(u, match, batch_size, pos_fraction)
        sel = pos_sel | neg_sel
        count = sel.sum().clamp(min=1)
        cls = labels.clamp(min=0)
        ce = -torch.log_softmax(logits.float(), -1).gather(1, cls[:, None])[:, 0]
        cls_l.append((ce * sel).sum() / count)
        d = deltas.reshape(-1, k1, 4).gather(1, cls[:, None, None].expand(-1, 1, 4))[:, 0]
        # the positives' targets only: a proposal of zero width (an RPN dw
        # below about -25) encodes to inf, and 0 * inf would make the sum NaN
        # (the JAX package's fault, ROADMAP.md §C)
        tgt = torch.where(pos_sel[:, None], encode_boxes(gt_b[best_gt], props),
                          props.new_zeros(()))
        reg = smooth_l1_loss(d.float(), tgt, beta=1.0).sum(-1)
        reg_l.append((reg * pos_sel).sum() / count)
    return {"loss_classifier": torch.stack(cls_l).mean(),
            "loss_box_reg": torch.stack(reg_l).mean()}


def postprocess_classic(class_logits, box_deltas, proposals, prop_valid, image_hw, *,
                        score_thresh: float = 0.05, nms_thresh: float = 0.5,
                        detections: int = 300) -> BoxArray:
    """One image: softmax → class-specific decode → clip → one NMS over
    every foreground class's candidates, classes kept apart by offsetting
    each class's boxes by ``label * (max(h, w) + 1)`` → the first
    ``detections`` survivors (box_head/inference.py:12-103)."""
    r, k1 = class_logits.shape
    probs = torch.softmax(class_logits.float(), -1)
    boxes_k = decode_boxes(box_deltas.float(), proposals).reshape(r, k1, 4)
    fg = k1 - 1
    cand_boxes = clip_to_image(boxes_k[:, 1:].reshape(-1, 4), image_hw, plus_one=True)
    cand_scores = probs[:, 1:].reshape(-1)
    cand_labels = torch.arange(1, k1, device=class_logits.device).repeat(r)
    ok = (cand_scores > score_thresh) & prop_valid.repeat_interleave(fg)
    h, w = image_hw
    offs = cand_labels.float()[:, None] * (max(float(h), float(w)) + 1.0)
    idx, val = nms_select(cand_boxes + offs, cand_scores, detections, nms_thresh,
                          valid=ok, plus_one=True)
    return BoxArray(cand_boxes[idx], cand_scores[idx], cand_labels[idx], val)

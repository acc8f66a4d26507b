"""Classic ROI box head of the C4 architectures, inference half.

Port of ``diffusionvid_tpu/models/box_head.py``: the C4 feature extractor
(14x14 ROIAlign on res4 at 1/16 → the res5 stage → mean pool,
``:38-60``), the Fast R-CNN predictor (``:80-89``) and the classic
post-processing (``:137-165``: softmax, class-specific decode, one
class-offset NMS over every foreground class, the first ``detections``
survivors).  ``fast_rcnn_loss`` belongs to the train half (ROADMAP.md
A7.5); ``FPN2MLPFeatureExtractor`` is reached by no architecture (A8).

As in the JAX package, the post-processing keeps its defaults (score 0.05,
NMS 0.5, 300 detections) whatever ``MODEL.ROI_HEADS`` says.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.nms import nms_select
from ..ops.roi_align import roi_align
from ..structures.boxes import BoxArray, clip_to_image, decode_boxes
from .heads import Linear
from .resnet import ResNetStage


class C4BoxFeatureExtractor(nn.Module):
    """ROIAlign(14x14, 1/16, sampling ratio 2, aligned) → res5 → mean pool
    → ``[B, R, 2048]``."""

    def __init__(self, depth: int = 101, dilation: int = 1):
        super().__init__()
        self.head = ResNetStage(depth, 5, 2, dilation)

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

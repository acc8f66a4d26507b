"""Detection post-processing with static shapes.

Port of ``diffusionvid_tpu/engine/postprocess.py`` (``DiffusionDet.inference``,
diffusion_det.py:754-839): sigmoid scores over class x proposal, top-K,
class-aware NMS, clip; and the xN ensemble's merge of the per-step
selections.  Frames are a leading batch dimension.
"""

from __future__ import annotations

import torch

from ..ops.nms import batched_nms_mask
from ..structures.boxes import BoxArray, clip_to_image


def select_topk_detections(logits, boxes, num_detections: int):
    """Flattened class x proposal top-K.  logits ``[..., N, K]`` raw, boxes
    ``[..., N, 4]`` → (boxes ``[..., D, 4]``, scores ``[..., D]``, labels
    ``[..., D]`` in 1..K).  Ties keep the lower flat index first, as
    ``lax.top_k`` does."""
    n, k = logits.shape[-2:]
    num_detections = min(num_detections, n * k)
    scores = torch.sigmoid(logits).flatten(-2)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores = top_scores[..., :num_detections]
    top_idx = top_idx[..., :num_detections]
    prop_idx = top_idx // k
    labels = top_idx % k + 1
    det_boxes = torch.gather(boxes, -2, prop_idx[..., None].expand(*prop_idx.shape, 4))
    return det_boxes, top_scores, labels


def postprocess_frame(logits, boxes, image_hw, num_detections: int = 300,
                      use_nms: bool = True, nms_thresh: float = 0.5) -> BoxArray:
    """Post-processing → fixed-size ``BoxArray`` (any leading frame dims)."""
    det_boxes, det_scores, det_labels = select_topk_detections(
        logits, boxes, num_detections)
    valid = torch.ones_like(det_scores, dtype=torch.bool)
    if use_nms:
        valid = batched_nms_mask(det_boxes, det_scores, det_labels, nms_thresh)
    return BoxArray(clip_to_image(det_boxes, image_hw), det_scores, det_labels, valid)


def postprocess_ensemble(boxes_steps, scores_steps, labels_steps, image_hw,
                         nms_thresh: float = 0.5) -> BoxArray:
    """xN ensemble: the per-step top-D selections (boxes ``[..., D, 4]``,
    scores and labels ``[..., D]``) concatenated in step order along the
    detection axis, one class-aware NMS over them, then the clip; no cap
    after the NMS (diffusion_det.py:598-627)."""
    boxes = torch.cat(list(boxes_steps), -2)
    scores = torch.cat(list(scores_steps), -1)
    labels = torch.cat(list(labels_steps), -1)
    valid = batched_nms_mask(boxes, scores, labels, nms_thresh)
    return BoxArray(clip_to_image(boxes, image_hw), scores, labels, valid)

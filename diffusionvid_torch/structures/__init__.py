from .boxes import (
    BoxArray, apply_deltas_diffusion, box_area, clip_to_image, cxcywh_to_xyxy,
    decode_boxes, pairwise_intersection, pairwise_iou, xyxy_to_cxcywh,
)

__all__ = ["BoxArray", "apply_deltas_diffusion", "box_area", "clip_to_image",
           "cxcywh_to_xyxy", "decode_boxes", "pairwise_intersection",
           "pairwise_iou", "xyxy_to_cxcywh"]

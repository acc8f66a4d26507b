"""Test-time box augmentation (h-flip and multi-scale ensembling).

The port's own copy of ``diffusionvid_tpu/engine/bbox_aug.py:15-76`` (the
reference's ``mega_core/engine/bbox_aug.py``), pure numpy with the same
arithmetic: detections of an augmented frame mapped back to the base
frame, then merged by class-aware NMS.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def flip_boxes_back(boxes: np.ndarray, image_width: float) -> np.ndarray:
    """Boxes detected on a horizontally flipped image, back on the image
    (``BoxList.transpose``, TO_REMOVE = 1)."""
    out = boxes.copy()
    out[:, 0] = image_width - boxes[:, 2] - 1
    out[:, 2] = image_width - boxes[:, 0] - 1
    return out


def merge_augmented(det_sets: Sequence[dict], iou_thresh: float = 0.5,
                    max_dets: int = 300) -> dict:
    """Several augmentations' detections of one frame → one set: score
    order, then greedy NMS with the classes kept apart by an offset of
    ``label * (max box coordinate + 1)``, at most ``max_dets``."""
    boxes = np.concatenate([d["boxes"] for d in det_sets]).astype(np.float64)
    scores = np.concatenate([d["scores"] for d in det_sets]).astype(np.float64)
    labels = np.concatenate([d["labels"] for d in det_sets]).astype(np.int64)
    if len(boxes) == 0:
        return {"boxes": boxes.astype(np.float32), "scores": scores.astype(np.float32),
                "labels": labels}

    order = scores.argsort()[::-1]
    boxes, scores, labels = boxes[order], scores[order], labels[order]
    ob = boxes + labels[:, None] * (boxes.max() + 1.0)
    areas = (ob[:, 2] - ob[:, 0]) * (ob[:, 3] - ob[:, 1])
    keep = []
    alive = np.ones(len(ob), bool)
    for i in range(len(ob)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) >= max_dets:
            break
        x1 = np.maximum(ob[i, 0], ob[i + 1:, 0])
        y1 = np.maximum(ob[i, 1], ob[i + 1:, 1])
        x2 = np.minimum(ob[i, 2], ob[i + 1:, 2])
        y2 = np.minimum(ob[i, 3], ob[i + 1:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        iou = inter / np.maximum(areas[i] + areas[i + 1:] - inter, 1e-12)
        alive[i + 1:] &= iou <= iou_thresh
    keep = np.asarray(keep, int)
    return {"boxes": boxes[keep].astype(np.float32),
            "scores": scores[keep].astype(np.float32),
            "labels": labels[keep]}


def hflip_tta(detect_fn: Callable, frames: np.ndarray, whwh, **detect_kw) -> list:
    """``detect_fn(frames, whwh)`` (a list of per-frame ``boxes``,
    ``scores``, ``labels``) on the frames and on their mirror images, merged
    frame by frame."""
    w = float(whwh[0])
    base = detect_fn(frames, whwh, **detect_kw)
    flipped = detect_fn(frames[:, :, ::-1], whwh, **detect_kw)
    merged = []
    for d0, d1 in zip(base, flipped):
        d1b = dict(d1)
        d1b["boxes"] = flip_boxes_back(np.asarray(d1["boxes"]), w)
        merged.append(merge_augmented([d0, d1b]))
    return merged

"""Seq-NMS video-level post-processing (host-side numpy).

Port of ``diffusionvid_tpu/engine/seq_nms.py`` (the reference's
FGFA-derived seq-NMS, ``seq_nms.py:38-225``, run from
``engine/inference.py:54-89`` when ``TEST.SEQ_NMS`` is on): per class,
repeatedly find the maximum-score temporal chain of detections linked by
IoU >= 0.5 across consecutive frames, rescore the chain to its mean score,
and suppress boxes overlapping the chain (IoU >= 0.3) in the chain's
frames, until the best chain score falls under a threshold.

The chain search runs in the host library ``csrc/vidkit.cpp``
(``native.max_chain_native``) over the flat boxes of the class, with the
dead boxes rebuilt each round.  ``native=False`` runs the Python dynamic
program over explicit links instead, the library's oracle in the tests.
It runs once per video on the host.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..native import max_chain_native

LINK_IOU = 0.5      # chain linking threshold (seq_nms.py:34)
SUPPRESS_IOU = 0.3  # in-frame suppression around the chain (seq_nms.py:33)
MIN_CHAIN_SCORE = 1e-2  # stop when best chain mean-sum drops below (":35")


def _iou_one_to_many(box, boxes):
    """+1-pixel IoU of one box vs many (seq_nms link/suppress convention)."""
    area1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    return inter / (area1 + areas - inter)


def _build_links(frames: List[np.ndarray]) -> List[List[List[int]]]:
    """links[f][i] = indices in frame f+1 linked to box i of frame f."""
    links = []
    for f in range(len(frames) - 1):
        b1, b2 = frames[f], frames[f + 1]
        frame_links = []
        for i in range(len(b1)):
            if len(b2) == 0:
                frame_links.append([])
                continue
            ious = _iou_one_to_many(b1[i], b2)
            frame_links.append(np.nonzero(ious >= LINK_IOU)[0].tolist())
        links.append(frame_links)
    return links


def _max_path(links, scores, dead):
    """DP over frames: best-sum chain over alive boxes only.
    Returns (root_frame, path, sum)."""
    num_frames = len(scores)
    neg = -np.inf
    best = [np.where(dead[f], neg, scores[f]) if len(scores[f]) else
            np.zeros(0) for f in range(num_frames)]
    back = [np.full(len(scores[f]), -1, int) for f in range(num_frames)]

    for f in range(1, num_frames):
        for i, nexts in enumerate(links[f - 1]):
            if len(best[f - 1]) == 0 or dead[f - 1][i]:
                continue
            w = best[f - 1][i]
            for j in nexts:
                if dead[f][j]:
                    continue
                cand = w + scores[f][j]
                if cand > best[f][j]:
                    best[f][j] = cand
                    back[f][j] = i

    # global argmax over all alive (frame, box)
    top_f, top_j, top_v = -1, -1, 0.0
    for f in range(num_frames):
        if len(best[f]):
            alive_best = np.where(dead[f], 0.0, best[f])
            if alive_best.max() > top_v:
                top_f = f
                top_j = int(alive_best.argmax())
                top_v = float(alive_best.max())
    if top_f < 0:
        return 0, [], 0.0

    path = [top_j]
    f, j = top_f, top_j
    while back[f][j] != -1:
        j = int(back[f][j])
        f -= 1
        path.append(j)
    path.reverse()
    return f, path, top_v


def seq_nms_class(boxes_frames: List[np.ndarray],
                  scores_frames: List[np.ndarray], native: bool = True):
    """Run seq-NMS for one class of one video.

    Returns (keep_masks, new_scores): per-frame bool mask of surviving boxes
    and the (possibly rescored) scores.  ``native`` picks the chain search:
    the host library, or the Python dynamic program with its links.
    """
    num_frames = len(boxes_frames)
    boxes = [np.asarray(b, np.float64).reshape(-1, 4) for b in boxes_frames]
    scores = [np.asarray(s, np.float64).copy() for s in scores_frames]
    keep = [np.ones(len(s), bool) for s in scores]
    dead = [np.zeros(len(s), bool) for s in scores]  # chained or suppressed

    if native:
        # the library recomputes the links from the dead mask each round
        offsets = np.zeros(num_frames + 1, np.int32)
        np.cumsum([len(s) for s in scores], out=offsets[1:])
        flat_boxes = np.concatenate(boxes) if offsets[-1] else np.zeros((0, 4))
        links = None
    else:
        links = _build_links(boxes)

    while True:
        if native:
            flat_dead = (np.concatenate(dead).astype(np.uint8) if offsets[-1]
                         else np.zeros(0, np.uint8))
            flat_scores = np.concatenate(scores) if offsets[-1] else np.zeros(0)
            root, gpath, total = max_chain_native(flat_boxes, flat_scores, flat_dead,
                                                  offsets, LINK_IOU)
            path = [g - int(offsets[root + i]) for i, g in enumerate(gpath)]
        else:
            root, path, total = _max_path(links, scores, dead)
        if len(path) < 1 or total < MIN_CHAIN_SCORE:
            break
        mean_score = total / len(path)
        for i, bi in enumerate(path):
            f = root + i
            scores[f][bi] = mean_score
            dead[f][bi] = True  # chain members can't be reused
            # suppress same-frame overlaps (but keep the chain box itself)
            if len(boxes[f]):
                ious = _iou_one_to_many(boxes[f][bi], boxes[f])
                sup = (ious >= SUPPRESS_IOU) & ~dead[f]
                keep[f] &= ~sup
                dead[f] |= sup
                scores[f][sup] = 0.0
                if links is not None:
                    # the suppressed boxes leave the links
                    if f < len(links):
                        for s_idx in np.nonzero(sup)[0]:
                            links[f][s_idx] = []
                    if f > 0:
                        for prior in links[f - 1]:
                            for s_idx in np.nonzero(sup)[0]:
                                if s_idx in prior:
                                    prior.remove(s_idx)
    return keep, [s.astype(np.float32) for s in scores]


def seq_nms_video(pred_frames: Sequence[dict], num_classes: int = 30,
                  native: bool = True):
    """Apply seq-NMS to a whole video's predictions.

    pred_frames: per-frame {"boxes" [n,4], "scores" [n], "labels" [n]}.
    Returns the same structure with suppressed boxes removed and chain
    scores rescored.  ``native`` as for ``seq_nms_class``.
    """
    out = [{"boxes": [], "scores": [], "labels": []} for _ in pred_frames]
    for cls in range(1, num_classes + 1):
        cls_boxes, cls_scores = [], []
        for fr in pred_frames:
            m = np.asarray(fr["labels"]).reshape(-1) == cls
            cls_boxes.append(np.asarray(fr["boxes"]).reshape(-1, 4)[m])
            cls_scores.append(np.asarray(fr["scores"]).reshape(-1)[m])
        if sum(len(s) for s in cls_scores) == 0:
            continue
        keep, new_scores = seq_nms_class(cls_boxes, cls_scores, native)
        for f in range(len(pred_frames)):
            kb = cls_boxes[f][keep[f]]
            ks = new_scores[f][keep[f]]
            out[f]["boxes"].append(kb)
            out[f]["scores"].append(ks)
            out[f]["labels"].append(np.full(len(ks), cls, np.int64))
    result = []
    for f in range(len(pred_frames)):
        if out[f]["boxes"]:
            result.append({
                "boxes": np.concatenate(out[f]["boxes"]),
                "scores": np.concatenate(out[f]["scores"]),
                "labels": np.concatenate(out[f]["labels"]),
            })
        else:
            result.append({"boxes": np.zeros((0, 4), np.float32),
                           "scores": np.zeros(0, np.float32),
                           "labels": np.zeros(0, np.int64)})
    return result

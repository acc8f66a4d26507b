"""ImageNet-VID evaluation: AP50 with motion-IoU buckets, CorLoc and
proposal recall.

Port of ``diffusionvid_tpu/evaluation/vid_eval.py`` (the reference
evaluator, ``mega_core/data/datasets/evaluation/vid/vid_eval.py:14-441``)
over numpy prediction dicts.  Semantics preserved:

  * per-class score-ordered greedy matching with ignore-aware tie-breaks
    (vid_eval.py:225-264): each prediction matches the highest-IoU
    unmatched GT >= thresh; matches to ignored GTs count as neither TP nor
    FP; unmatched predictions are discounted by the ignored share;
  * "integer typed boxes": +1 on the far corners, then +1-pixel IoU
    (vid_eval.py:221-228);
  * motion-specific buckets (all/fast/medium/slow = [0,1]/[0,.7]/[.7,.9]/
    [.9,1]) from per-GT motion IoU values, with the empty-image discount
    weight (vid_eval.py:170-194);
  * area-under-PR AP (VOC >= 2010 style, vid_eval.py:298-354) and CorLoc.

The matching runs in Python: the JAX package's optional C++ path
(``native/libvidkit.so``) gives the same results and is not ported
(ROADMAP.md A12).  Host-side bookkeeping, as in the reference.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _iou_matrix_plus2(pred, gt):
    """IoU with the VID integer-box convention: far corner +1, then the
    +1-pixel width convention (vid_eval.py:221-228 → boxlist_iou)."""
    pred = pred.copy()
    gt = gt.copy()
    pred[:, 2:] += 1
    gt[:, 2:] += 1
    aw = pred[:, 2] - pred[:, 0] + 1
    ah = pred[:, 3] - pred[:, 1] + 1
    bw = gt[:, 2] - gt[:, 0] + 1
    bh = gt[:, 3] - gt[:, 1] + 1
    area_p = aw * ah
    area_g = bw * bh
    lt = np.maximum(pred[:, None, :2], gt[None, :, :2])
    rb = np.minimum(pred[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_p[:, None] + area_g[None, :] - inter)


def calc_prec_rec(gt_list, pred_list, motion_ious=None, iou_thresh: float = 0.5,
                  motion_range=(0.0, 1.0), num_classes: int = 30):
    """Per-class (precision, recall) curves.

    gt_list: per-frame dicts {"boxes" [n,4], "labels" [n]}.
    pred_list: per-frame dicts {"boxes" [m,4], "labels" [m], "scores" [m]}.
    motion_ious: per-frame [n] motion-IoU of each GT, or None.
    """
    n_pos = defaultdict(float)
    score = defaultdict(list)
    match = defaultdict(list)
    pred_ig = defaultdict(list)

    if motion_ious is None:
        motion_list = [None] * len(gt_list)
        empty_weight = 0.0
    else:
        motion_list = motion_ious
        allm = np.concatenate([np.asarray(m).reshape(-1) for m in motion_ious]) \
            if len(motion_ious) else np.zeros(0)
        if len(allm):
            inb = (allm >= motion_range[0]) & (allm <= motion_range[1])
            empty_weight = float(inb.sum()) / float(len(allm))
            if empty_weight == 1.0:
                empty_weight = 0.0
        else:
            empty_weight = 0.0

    for gt, pred, miou in zip(gt_list, pred_list, motion_list):
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt["labels"], np.int64).reshape(-1)
        p_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        p_labels = np.asarray(pred["labels"], np.int64).reshape(-1)
        p_scores = np.asarray(pred["scores"], np.float64).reshape(-1)

        gt_ignore = np.zeros(len(gt_boxes))
        if miou is not None and len(gt_boxes):
            m = np.asarray(miou).reshape(-1)
            gt_ignore = ((m < motion_range[0]) | (m > motion_range[1])).astype(float)

        for l in np.unique(np.concatenate([p_labels, gt_labels])).astype(int):
            pm = p_labels == l
            pb = p_boxes[pm]
            ps = p_scores[pm]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]

            gm = gt_labels == l
            gb = gt_boxes[gm]
            gi = gt_ignore[gm]

            n_pos[l] += len(gb) - gi.sum()
            score[l].extend(ps.tolist())

            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[l].extend([0] * len(pb))
                pred_ig[l].extend([empty_weight] * len(pb))
                continue

            iou = _iou_matrix_plus2(pb, gb)
            taken = np.zeros(len(gb), bool)
            for j in range(len(pb)):
                best = iou_thresh
                best_ig = -1.0
                best_nig = -1.0
                arg = -1
                for k in range(len(gb)):
                    v = iou[j, k]
                    if gi[k] == 1 and v > best_ig:
                        best_ig = v
                    if gi[k] == 0 and v > best_nig:
                        best_nig = v
                    if taken[k] or v < best:
                        continue
                    if v == best:
                        if arg < 0 or gi[arg]:
                            arg = k
                    else:
                        arg = k
                    best = v
                if arg >= 0:
                    match[l].append(1)
                    pred_ig[l].append(gi[arg])
                    taken[arg] = True
                else:
                    match[l].append(0)
                    if best_nig > best_ig:
                        pred_ig[l].append(0.0)
                    elif best_ig > best_nig:
                        pred_ig[l].append(1.0)
                    else:
                        pred_ig[l].append(gi.sum() / float(len(gb)))

    n_cls = num_classes + 1
    prec = [None] * n_cls
    rec = [None] * n_cls
    for l in n_pos.keys():
        sl = np.asarray(score[l])
        ml = np.asarray(match[l], np.int8)
        il = np.asarray(pred_ig[l], np.float64)
        order = sl.argsort()[::-1]
        ml, il = ml[order], il[order]
        tps = np.logical_and(ml == 1, il != 1)
        fps = np.logical_and(ml == 0, il != 1).astype(np.float64)
        il2 = il.copy()
        il2[il2 == 0] = 1
        fps = fps * il2
        tp = np.cumsum(tps)
        fp = np.cumsum(fps)
        prec[l] = tp / (fp + tp + np.spacing(1))
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec


def calc_ap(prec, rec, use_07_metric: bool = False) -> np.ndarray:
    """Area-under-PR AP per class (vid_eval.py:298-354)."""
    n = len(prec)
    ap = np.empty(n)
    for l in range(n):
        if prec[l] is None or rec[l] is None:
            ap[l] = np.nan
            continue
        if use_07_metric:
            ap[l] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[l] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[l])[rec[l] >= t])
                ap[l] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[l]), [0]))
            mrec = np.concatenate(([0], rec[l], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def corloc(gt_list, pred_list, iou_thresh: float = 0.5):
    """Per-class CorLoc: over frames containing class l, the fraction where
    the top-scored class-l prediction hits a class-l GT (vid_eval.py:356+)."""
    hit = defaultdict(int)
    total = defaultdict(int)
    for gt, pred in zip(gt_list, pred_list):
        gt_labels = np.asarray(gt["labels"], np.int64).reshape(-1)
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        p_labels = np.asarray(pred["labels"], np.int64).reshape(-1)
        p_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        p_scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        for l in np.unique(gt_labels).astype(int):
            total[l] += 1
            pm = p_labels == l
            if not pm.any():
                continue
            top = p_boxes[pm][np.argmax(p_scores[pm])][None]
            iou = _iou_matrix_plus2(top, gt_boxes[gt_labels == l])
            if iou.max() >= iou_thresh:
                hit[l] += 1
    out = {l: hit[l] / total[l] for l in total}
    avg = float(np.mean(list(out.values()))) if out else float("nan")
    return out, avg


def _iou_matrix_plus1(a, b):
    """Plain +1-pixel-width IoU with NO corner shift — the boxlist_iou
    convention the proposal-recall path uses (boxlist_ops.py:53-89, unlike
    the detection path's extra far-corner +1)."""
    aw = a[:, 2] - a[:, 0] + 1
    ah = a[:, 3] - a[:, 1] + 1
    bw = b[:, 2] - b[:, 0] + 1
    bh = b[:, 3] - b[:, 1] + 1
    area_a = aw * ah
    area_b = bw * bh
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def eval_proposals(gt_list, pred_list, iou_thresh: float = 0.5,
                   limit: int = 300):
    """Proposal recall — the ``box_only`` / MODEL.RPN_ONLY evaluation mode
    (vid_eval.py:85-130 ``eval_proposals_vid``).

    Per frame: order proposals by objectness (falls back to "scores"),
    cap at ``limit``, then greedily match — each round takes, over GTs,
    the best (per-GT max-IoU) pair, records its IoU, and retires both the
    proposal and the GT.  Recall = fraction of all GTs whose recorded
    overlap clears ``iou_thresh``.
    """
    gt_overlaps = []
    num_pos = 0
    for gt, pred in zip(gt_list, pred_list):
        boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        obj = np.asarray(pred.get("objectness", pred.get("scores")),
                         np.float64).reshape(-1)
        order = np.argsort(-obj)
        boxes = boxes[order][:limit]
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        num_pos += len(gt_boxes)
        if len(gt_boxes) == 0 or len(boxes) == 0:
            continue
        overlaps = _iou_matrix_plus1(boxes, gt_boxes)
        per_gt = np.zeros(len(gt_boxes))
        for j in range(min(len(boxes), len(gt_boxes))):
            max_overlaps = overlaps.max(axis=0)       # best proposal per GT
            argmax_overlaps = overlaps.argmax(axis=0)
            gt_ind = int(max_overlaps.argmax())       # easiest GT first
            box_ind = int(argmax_overlaps[gt_ind])
            per_gt[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        gt_overlaps.append(per_gt)
    flat = np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
    recall = float((flat >= iou_thresh).sum()) / max(float(num_pos), 1.0)
    return {"recall": recall}


MOTION_RANGES = ((0.0, 1.0), (0.0, 0.7), (0.7, 0.9), (0.9, 1.0))
MOTION_NAMES = ("all", "fast", "medium", "slow")


def evaluate_vid(gt_list, pred_list, motion_ious=None, iou_thresh: float = 0.5,
                 num_classes: int = 30, motion_specific: bool = False):
    """Full evaluation → {"ap50": float, "per_motion": {...}, "ap": [...],
    "corloc": float}."""
    ranges = MOTION_RANGES if (motion_specific and motion_ious is not None) \
        else (MOTION_RANGES[0],)
    per_motion = {}
    ap_all = None
    for name, rng in zip(MOTION_NAMES, ranges):
        prec, rec = calc_prec_rec(gt_list, pred_list, motion_ious, iou_thresh,
                                  rng, num_classes)
        ap = calc_ap(prec, rec)
        per_motion[name] = float(np.nanmean(ap[1:]))
        if name == "all":
            ap_all = ap
    _, corloc_avg = corloc(gt_list, pred_list, iou_thresh)
    return {
        "ap50": per_motion["all"],
        "per_motion": per_motion,
        "ap": ap_all,
        "corloc": corloc_avg,
    }


def load_motion_iou_mat(path: str):
    """Load the reference's per-GT motion-IoU .mat file
    (vid_groundtruth_motion_iou.mat, vid_eval.py:143-148)."""
    import scipy.io as sio
    raw = sio.loadmat(path)["motion_iou"]
    return [
        np.asarray([raw[i][0][j][0] if len(raw[i][0][j]) else 0
                    for j in range(len(raw[i][0]))])
        for i in range(len(raw))
    ]

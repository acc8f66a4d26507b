"""COCO detection mAP in numpy.

Port of ``diffusionvid_tpu/evaluation/coco_eval.py:39-190``, which
re-implements pycocotools' ``COCOeval`` bbox algorithm (pycocotools is not
installed):

  * greedy matching per (image, category) in descending score order, each
    detection taking the unmatched GT of the highest IoU >= t (ties keep
    the earlier GT, as ``COCOeval.evaluateImg`` does);
  * IoU thresholds 0.50:0.05:0.95, 101 recall points 0:0.01:1;
  * the area ranges all/small/medium/large with COCOeval's ignore rules
    (ignored GT absorb detections without counting; an unmatched detection
    outside the range is ignored);
  * at most ``max_dets`` (100) detections an image; the precision envelope
    (monotone non-increasing) before sampling at the recall grid;
  * classes without GT left out of the mean (COCOeval's -1).

IoU is COCO's (no +1 pixel), unlike the ImageNet-VID evaluator's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_xyxy(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[D, 4] x [G, 4] → [D, G] IoU, COCO convention (w = x2 - x1)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    ix1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    iy1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    ix2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    iy2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    a_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a_d[:, None] + a_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_image(det_boxes, det_scores, gt_boxes, gt_ignore, max_dets, gt_crowd=None):
    """``COCOeval.evaluateImg`` for one (image, category, area range).

    ``gt_ignore`` marks GT outside the area range (a detection matched to
    one is neither TP nor FP); ``gt_crowd`` marks crowd GT, which several
    detections may match.  An ignored GT that is not a crowd is matched once
    only.  The datasets here carry no crowd, so ``gt_crowd`` defaults to
    none.  Returns (scores [D], tp [T, D] bool, ignored [T, D] bool,
    the count of GT not ignored)."""
    order = np.argsort(-det_scores, kind="mergesort")[:max_dets]
    det_boxes = det_boxes[order]
    det_scores = det_scores[order]
    d, g, t = len(det_boxes), len(gt_boxes), len(IOU_THRS)
    tp = np.zeros((t, d), bool)
    ig = np.zeros((t, d), bool)
    n_gt = int((~gt_ignore).sum())
    if gt_crowd is None:
        gt_crowd = np.zeros(g, bool)
    if g:
        # GT not ignored first (COCOeval sorts the GT by _ignore)
        gt_order = np.argsort(gt_ignore, kind="mergesort")
        gt_boxes, gt_ignore, gt_crowd = gt_boxes[gt_order], gt_ignore[gt_order], gt_crowd[gt_order]
        ious = _iou_xyxy(det_boxes, gt_boxes)
        for ti, thr in enumerate(IOU_THRS):
            taken = np.zeros(g, bool)
            for di in range(d):
                best = -1
                best_iou = min(thr, 1 - 1e-10)
                for gi in range(g):
                    if taken[gi] and not gt_crowd[gi]:
                        continue
                    # once matched to a GT that counts, never to an ignored one
                    if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best = gi
                if best == -1:
                    continue
                taken[best] = True
                if gt_ignore[best]:
                    ig[ti, di] = True
                else:
                    tp[ti, di] = True
    return det_scores, tp, ig, n_gt


def evaluate_coco(gt_list: List[dict], pred_list: List[dict], num_classes: int,
                  max_dets: int = 100) -> Dict[str, float]:
    """``gt_list`` / ``pred_list``: an image's dict each, ``boxes`` [N, 4]
    xyxy and ``labels`` [N] in 1..K (and the predictions' ``scores``).
    Returns COCO's summary: AP, AP50, AP75, APsmall/medium/large, AR@100."""
    assert len(gt_list) == len(pred_list)
    t, r = len(IOU_THRS), len(REC_THRS)
    precision = {a: np.full((t, r, num_classes), -1.0) for a in AREA_RANGES}
    recall = {a: np.full((t, num_classes), -1.0) for a in AREA_RANGES}

    for cls in range(1, num_classes + 1):
        per_img = []
        for gt, pr in zip(gt_list, pred_list):
            gsel = np.asarray(gt["labels"]) == cls
            gb = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[gsel]
            psel = np.asarray(pr["labels"]) == cls
            pb = np.asarray(pr["boxes"], np.float64).reshape(-1, 4)[psel]
            ps = np.asarray(pr["scores"], np.float64).reshape(-1)[psel]
            per_img.append((pb, ps, gb))

        for aname, (lo, hi) in AREA_RANGES.items():
            scores_all, tp_all, ig_all = [], [], []
            total_gt = 0
            for pb, ps, gb in per_img:
                areas = ((gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                         if len(gb) else np.zeros((0,)))
                s, tp, ig, n_gt = _match_image(pb, ps, gb, (areas < lo) | (areas > hi),
                                               max_dets)
                if len(s):   # an unmatched detection outside the range is ignored
                    da = pb[np.argsort(-ps, kind="mergesort")[:max_dets]]
                    dareas = (da[:, 2] - da[:, 0]) * (da[:, 3] - da[:, 1])
                    out = (dareas < lo) | (dareas > hi)
                    ig = ig | (out[None, :] & ~tp)
                scores_all.append(s)
                tp_all.append(tp)
                ig_all.append(ig)
                total_gt += n_gt
            if total_gt == 0:
                continue
            scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
            order = np.argsort(-scores, kind="mergesort")
            tp = (np.concatenate(tp_all, axis=1)[:, order]
                  if scores_all else np.zeros((t, 0), bool))
            ig = (np.concatenate(ig_all, axis=1)[:, order]
                  if scores_all else np.zeros((t, 0), bool))

            for ti in range(t):
                keep = ~ig[ti]
                tps = np.cumsum(tp[ti][keep])
                fps = np.cumsum(~tp[ti][keep])
                rc = tps / total_gt
                pr = tps / np.maximum(tps + fps, 1e-12)
                recall[aname][ti, cls - 1] = rc[-1] if len(rc) else 0.0
                # the precision envelope, then sampled at the recall grid
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(r)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[aname][ti, :, cls - 1] = q

    def mean_valid(x):
        v = x[x > -1]
        return float(v.mean()) if v.size else float("nan")

    return {"AP": mean_valid(precision["all"]),
            "AP50": mean_valid(precision["all"][0]),
            "AP75": mean_valid(precision["all"][5]),
            "APsmall": mean_valid(precision["small"]),
            "APmedium": mean_valid(precision["medium"]),
            "APlarge": mean_valid(precision["large"]),
            "AR@100": mean_valid(recall["all"])}

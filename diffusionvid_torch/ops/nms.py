"""Fixed-shape masked NMS in plain PyTorch.

Port of ``diffusionvid_tpu/ops/nms.py``: a boolean keep mask over the
fixed-size input instead of a ragged index list.  Greedy semantics match the
reference kernel: boxes in descending score order, a surviving box
suppresses later boxes with IoU strictly above the threshold.  Both
functions take leading batch dimensions (one independent NMS per row).
"""

from __future__ import annotations

import torch

from ..structures.boxes import pairwise_iou


def nms_mask(boxes, scores, iou_threshold: float, valid=None,
             plus_one: bool = False):
    """Greedy NMS → bool keep mask ``[..., N]`` aligned with the inputs.

    The order is the JAX package's: a stable ascending sort reversed, so
    among tied scores the higher index goes first.  The greedy pass is
    solved as the unique fixed point of ``keep[j] = valid[j] and no kept
    i < j suppresses j``; iterating from ``keep = valid`` fixes at least
    one more position per step, and in practice converges in a few steps
    of whole-tensor work."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(valid, -1, order)

    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (pairwise_iou(sboxes, sboxes, plus_one) > iou_threshold) & later

    keep = svalid
    for it in range(1, n + 2):
        killed = (suppress & keep[..., :, None]).any(-2)
        nxt = svalid & ~killed
        if torch.equal(nxt, keep):
            break
        keep = nxt
    nms_mask.iterations = it   # passes of the last call, one host sync each
    return torch.zeros_like(keep).scatter(-1, order, keep)


nms_mask.iterations = 0


def batched_nms_mask(boxes, scores, labels, iou_threshold: float, valid=None,
                     plus_one: bool = False):
    """Class-aware NMS by the coordinate-offset trick (detectron2
    ``batched_nms``: boxes of different labels never interact)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    max_coord = torch.where(valid[..., None], boxes,
                            torch.zeros_like(boxes)).amax(dim=(-2, -1), keepdim=True)
    offsets = labels.to(boxes.dtype)[..., None] * (max_coord + 1.0)
    return nms_mask(boxes + offsets, scores, iou_threshold, valid=valid,
                    plus_one=plus_one)


def _greedy_survivors(suppress, live):
    """The greedy pass over score-sorted candidates: ``keep[j] = live[j]``
    and no kept ``i < j`` has ``suppress[i, j]``.  Iterated from ``keep =
    live`` to its unique fixed point, as in ``nms_mask``."""
    keep = live
    for _ in range(live.shape[0] + 1):
        nxt = live & ~(suppress & keep[:, None]).any(0)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return keep


def nms_select(boxes, scores, k: int, iou_threshold: float, valid=None,
               plus_one: bool = False, block: int = 2048):
    """Greedy NMS → the first ``k`` survivors' indices in selection order,
    ``[k]`` int64, and ``[k]`` bool valid; the slots past the survivors are
    index 0 and invalid (the JAX package's ``nms_select``, one image).

    The JAX package selects one box a step by ``argmax``, so among tied
    scores the LOWER index goes first (``nms_mask`` puts the higher first).
    Here the candidates (valid, score above -inf) are sorted by a stable
    descending sort, which gives the same order, and the greedy pass is
    solved over them at once; the first ``k`` survivors do not depend on
    later ones.  The IoU is the JAX package's: ``inter / max(union,
    1e-12)``.  The suppression matrix is built ``block`` rows at a time."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    neg_inf = torch.full_like(scores, -float("inf"))
    live = valid & (scores > neg_inf)
    order = torch.sort(torch.where(live, scores, neg_inf), descending=True, stable=True).indices
    m = int(live.sum())
    order = order[:m]
    sb = boxes[order]
    off = 1.0 if plus_one else 0.0
    area = (sb[:, 2] - sb[:, 0] + off) * (sb[:, 3] - sb[:, 1] + off)
    cols = torch.arange(m, device=dev)
    suppress = torch.empty(m, m, dtype=torch.bool, device=dev)
    for s in range(0, m, block):
        rows = sb[s:s + block]
        lt = torch.maximum(rows[:, None, :2], sb[None, :, :2])
        rb = torch.minimum(rows[:, None, 2:], sb[None, :, 2:])
        wh = (rb - lt + off).clamp(min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area[s:s + block, None] + area[None, :] - inter).clamp(min=1e-12)
        later = cols[None, :] > cols[s:s + block, None]
        suppress[s:s + block] = (iou > iou_threshold) & later
    keep = _greedy_survivors(suppress, torch.ones(m, dtype=torch.bool, device=dev))
    picked = order[keep][:k]
    idx = torch.zeros(k, dtype=torch.long, device=dev)
    idx[:picked.shape[0]] = picked
    ok = torch.arange(k, device=dev) < picked.shape[0]
    return idx, ok

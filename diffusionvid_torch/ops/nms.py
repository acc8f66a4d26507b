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

"""Loss primitives.

Port of ``diffusionvid_tpu/ops/losses.py``: the sigmoid focal loss (fvcore
``sigmoid_focal_loss_jit`` semantics, as the DiffusionDet criterion uses
it), the numerically stable binary cross-entropy with logits under it, and
the smooth L1 loss of ``mega_core/layers/smooth_l1_loss.py``.
"""

from __future__ import annotations

import torch


def sigmoid_ce(logits, labels):
    """Numerically stable binary cross-entropy with logits, elementwise."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """FL = -alpha_t (1 - p_t)^gamma log(p_t), elementwise, for {0, 1}
    targets; same shape as ``logits``."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def smooth_l1_loss(pred, target, beta: float = 1.0 / 9):
    """Elementwise smooth L1 (quadratic below ``beta``)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)

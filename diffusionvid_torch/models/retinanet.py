"""RetinaNet: the single-stage focal-loss detector.

Port of ``diffusionvid_tpu/models/retinanet.py:36-213`` (the reference's
``mega_core/modeling/rpn/retinanet/{retinanet,loss,inference}.py``; built
under ``MODEL.RETINANET_ON``): a ResNet trunk and an FPN over res3–res5
without the max-pool level, P6 from C5 by a 3x3 stride-2 conv and P7 from
``relu(P6)`` by another; a shared head of four 3x3 convs + ReLU a tower
(classes, boxes) over the five levels, the class logits offset by the
focal prior ``-log((1 - 0.01) / 0.01)``; anchors at three octave scales
(``size * 2^(i/3)``) and three ratios a level.

``postprocess`` (one image): the sigmoid of every anchor x class, the first
``pre_nms_top_n`` of them in ``lax.top_k``'s order (a stable descending
sort: on a tie the lower index first), their boxes decoded and clipped
(+1 convention), then one NMS over the classes kept apart by a
class offset (``nms_select``) → ``detections`` rows.  ``losses``: the focal
loss over every anchor outside the ignore band (IoU 0.4–0.5 to its best
GT) and the smooth L1 on the positives, both over the positives' count.

Module names follow the JAX package's tree: ``backbone.bottom_up`` and
``backbone.fpn_*`` (the FPN owns the trunk, as in the DiffusionVID model),
``p6``, ``p7`` and ``head.{cls,bbox}_tower{i}``, ``head.cls_logits``,
``head.bbox_pred``.  NCHW inside; images come in ``[B, H, W, 3]`` in 0..255.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ..ops.nms import nms_select
from ..structures.boxes import BoxArray, clip_to_image, decode_boxes, encode_boxes, pairwise_iou
from .fpn import FPN
from .resnet import Conv2d, ResNet, he_init_
from .rpn import generate_anchors, shift_anchors


class RetinaNetHead(nn.Module):
    """The shared class and box towers → per level ``[B, A*K, H, W]``
    logits and ``[B, A*4, H, W]`` deltas."""

    def __init__(self, num_classes: int = 30, num_anchors: int = 9, num_convs: int = 4,
                 channels: int = 256, prior_prob: float = 0.01):
        super().__init__()
        self.num_convs = num_convs
        self.bias_init = float(-np.log((1 - prior_prob) / prior_prob))
        for kind in ("cls", "bbox"):
            for i in range(num_convs):
                self.add_module(f"{kind}_tower{i}",
                                Conv2d(channels, channels, 3, padding=1, bias=True))
        self.cls_logits = Conv2d(channels, num_anchors * num_classes, 3, padding=1, bias=True)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 3, padding=1, bias=True)

    def tower(self, kind: str, x):
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"{kind}_tower{i}")(x))
        return x

    def forward(self, feats: Sequence[torch.Tensor]):
        return ([self.cls_logits(self.tower("cls", f)) + self.bias_init for f in feats],
                [self.bbox_pred(self.tower("bbox", f)) for f in feats])


class RetinaNet(nn.Module):
    """``forward(images, image_hw)`` → ``BoxArray`` ``[B, detections]``;
    ``train_loss(images, gt_boxes, gt_labels, gt_valid)`` → the loss dict."""

    def __init__(self, depth: int = 50, num_classes: int = 30,
                 anchor_sizes: Sequence[int] = (32, 64, 128, 256, 512),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 strides: Sequence[int] = (8, 16, 32, 64, 128), scales_per_octave: int = 3,
                 octave: float = 2.0, fg_iou: float = 0.5, bg_iou: float = 0.4,
                 loss_alpha: float = 0.25, loss_gamma: float = 2.0, reg_beta: float = 0.11,
                 reg_weight: float = 4.0, pre_nms_top_n: int = 1000, score_thresh: float = 0.05,
                 nms_thresh: float = 0.4, detections: int = 100,
                 pixel_mean=(123.675, 116.280, 103.530), pixel_std=(58.395, 57.120, 57.375),
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_sizes, self.aspect_ratios = tuple(anchor_sizes), tuple(aspect_ratios)
        self.strides = tuple(strides)
        self.scales_per_octave, self.octave = scales_per_octave, octave
        self.fg_iou, self.bg_iou = fg_iou, bg_iou
        self.loss_alpha, self.loss_gamma = loss_alpha, loss_gamma
        self.reg_beta, self.reg_weight = reg_beta, reg_weight
        self.pre_nms_top_n, self.score_thresh = pre_nms_top_n, score_thresh
        self.nms_thresh, self.detections = nms_thresh, detections
        self.compute_dtype = compute_dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)
        trunk = ResNet(depth, out_features=("res3", "res4", "res5"))
        self.backbone = FPN(trunk, ("res3", "res4", "res5"), (512, 1024, 2048), 256)
        self.p6 = Conv2d(2048, 256, 3, stride=2, padding=1, bias=True)
        self.p7 = Conv2d(256, 256, 3, stride=2, padding=1, bias=True)
        self.num_anchors = len(self.aspect_ratios) * scales_per_octave
        self.head = RetinaNetHead(num_classes, self.num_anchors)
        self._anchor_cache = {}

    def reset_parameters(self, gen: torch.Generator):
        """He init of every convolution, zero biases (the JAX package's
        initializers, normal instead of truncated)."""
        self.backbone.reset_parameters(gen)
        for m in (self.p6, self.p7, self.head):
            he_init_(m, gen)
        for m in list(self.head.modules()) + [self.p6, self.p7]:
            if isinstance(m, Conv2d):
                with torch.no_grad():
                    m.bias.zero_()

    def features(self, images):
        """images ``[B, H, W, 3]`` → the five NCHW maps P3–P7."""
        x = ((images - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        trunk = self.backbone.bottom_up(x.permute(0, 3, 1, 2))
        pyr = self.backbone(trunk)
        p6 = self.p6(trunk["res5"])
        p7 = self.p7(F.relu(p6))
        return [pyr["p3"], pyr["p4"], pyr["p5"], p6, p7]

    def anchors(self, feat_shapes, device) -> torch.Tensor:
        """Every level's anchors, concatenated ``[N, 4]`` (anchor_generator.py
        with octave scales)."""
        key = (tuple(feat_shapes), str(device))
        if key not in self._anchor_cache:
            levels = []
            for (h, w), size, stride in zip(feat_shapes, self.anchor_sizes, self.strides):
                sizes = tuple(size * self.octave ** (i / self.scales_per_octave)
                              for i in range(self.scales_per_octave))
                levels.append(shift_anchors(generate_anchors(sizes, self.aspect_ratios, stride),
                                            h, w, stride))
            self._anchor_cache[key] = torch.from_numpy(np.concatenate(levels)).to(device)
        return self._anchor_cache[key]

    def _flatten(self, cls_outs, box_outs):
        """Per level NCHW → ``[B, N, K]`` logits and ``[B, N, 4]`` deltas in
        the JAX package's (y, x, anchor) order."""
        b, k = cls_outs[0].shape[0], self.num_classes
        cls = torch.cat([c.permute(0, 2, 3, 1).reshape(b, -1, k) for c in cls_outs], 1)
        box = torch.cat([d.permute(0, 2, 3, 1).reshape(b, -1, 4) for d in box_outs], 1)
        return cls, box

    def head_outputs(self, images):
        """(logits ``[B, N, K]``, deltas ``[B, N, 4]``, anchors ``[N, 4]``)."""
        feats = self.features(images)
        cls, box = self._flatten(*self.head(feats))
        return cls, box, self.anchors([f.shape[2:] for f in feats], images.device)

    def forward(self, images, image_hw) -> BoxArray:
        cls, box, anchors = self.head_outputs(images)
        dets = [self.postprocess(c, d, anchors, image_hw) for c, d in zip(cls, box)]
        return BoxArray(*(torch.stack(t) for t in zip(*dets)))

    def train_loss(self, images, gt_boxes, gt_labels, gt_valid) -> dict:
        """The JAX package's ``train=True`` forward: the loss dict."""
        cls, box, anchors = self.head_outputs(images)
        return self.losses(cls, box, anchors, gt_boxes, gt_labels, gt_valid)

    def losses(self, cls, box, anchors, gt_boxes, gt_labels, gt_valid) -> dict:
        """The mean over images of the focal loss and of ``reg_weight`` x the
        smooth L1 on the positives (IoU >= 0.5 to their best valid GT, the
        first of a tie), each over the positives' count (at least 1).  The
        regression targets are taken on the positives only: a GT of no width
        gives no NaN outside them."""
        cls_l, reg_l = [], []
        k = self.num_classes
        for logits, deltas, gt_b, gt_l, gt_v in zip(cls, box, gt_boxes, gt_labels, gt_valid):
            iou = torch.where(gt_v[None, :], pairwise_iou(anchors, gt_b, plus_one=True), -1.0)
            best_iou, best_gt = iou.max(1).values, iou.argmax(1)
            pos = best_iou >= self.fg_iou
            ignore = (best_iou >= self.bg_iou) & ~pos
            tgt_cls = torch.where(pos, gt_l[best_gt].long(), 0)
            onehot = ((torch.arange(k, device=logits.device)[None] == tgt_cls[:, None] - 1)
                      & pos[:, None]).float()
            fl = sigmoid_focal_loss(logits.float(), onehot, alpha=self.loss_alpha,
                                    gamma=self.loss_gamma)
            fl = torch.where(ignore[:, None], 0.0, fl)
            n_pos = pos.sum().clamp(min=1)
            cls_l.append(fl.sum() / n_pos)
            tgt = torch.where(pos[:, None], encode_boxes(gt_b[best_gt], anchors), 0.0)
            reg = smooth_l1_loss(deltas.float(), tgt, beta=self.reg_beta).sum(-1)
            reg_l.append(self.reg_weight * torch.where(pos, reg, 0.0).sum() / n_pos)
        return {"loss_retina_cls": torch.stack(cls_l).mean(),
                "loss_retina_reg": torch.stack(reg_l).mean()}

    def postprocess(self, logits, deltas, anchors, image_hw) -> BoxArray:
        """One image: ``[N, K]`` logits, ``[N, 4]`` deltas → ``detections``
        rows (retinanet/inference.py)."""
        k = self.num_classes
        h, w = image_hw
        flat = torch.sigmoid(logits.float()).reshape(-1)
        top = min(self.pre_nms_top_n, flat.shape[0])
        scores, idx = torch.sort(flat, descending=True, stable=True)
        scores, idx = scores[:top], idx[:top]
        a_idx, c_idx = idx // k, idx % k
        boxes = decode_boxes(deltas.float()[a_idx], anchors[a_idx])
        boxes = clip_to_image(boxes, image_hw, plus_one=True)
        offs = (c_idx + 1).float()[:, None] * (max(float(h), float(w)) + 1.0)
        keep, val = nms_select(boxes + offs, scores, self.detections, self.nms_thresh,
                               valid=scores > self.score_thresh, plus_one=True)
        return BoxArray(boxes[keep], scores[keep], c_idx[keep] + 1, val)

"""The mask and keypoint ROI heads, their losses and their host decoders.

Port of ``diffusionvid_tpu/models/mask_keypoint.py:26-247`` (the reference's
maskrcnn-benchmark ``roi_heads/mask_head`` and ``keypoint_head``, built
under ``MODEL.MASK_ON`` / ``KEYPOINT_ON``):

  * ``MaskHead``: 14x14 ROIAlign → 4 x (3x3 conv, 256, no bias) + ReLU →
    2x2 stride-2 transposed conv + ReLU → 1x1 logits, 28x28 a class;
  * ``KeypointHead``: 14x14 ROIAlign → 8 x (3x3 conv, 512) + ReLU → 4x4
    stride-2 transposed conv (padding 1) → bilinear x2 in fp32, 56x56 a
    keypoint;
  * ``mask_loss`` / ``keypoint_loss``: the BCE on each positive proposal's
    bilinear crop of its best-IoU GT mask, and the softmax cross-entropy over
    heatmap positions at the visible GT keypoints;
  * ``paste_masks`` / ``heatmaps_to_keypoints``: the host-side Masker and
    keypoint decode (numpy; ``paste_masks`` imports ``cv2`` when called).

Both heads pool one map (the C4 trunk's res4 at 1/16) with the C4 box
head's pooler ``ops/roi_align.py: roi_align``, the plain gather on every
device: the JAX package's ``multilevel_roi_align_auto`` takes its Pallas
kernel only for three FPN levels, so on one level it runs its gather
(``multilevel_roi_align``) on a TPU too.  The heads take NHWC maps and
return channels-last outputs ``[B, R, M, M, K]``, as the JAX package's do.

``ConvTranspose`` keeps the JAX package's ``[in, out, k, k]`` weight, which
``lax.conv_transpose`` (no ``transpose_kernel``) correlates with the
stride-dilated input as stored: ``F.conv_transpose2d`` on the kernel flipped
in both spatial axes, with padding ``pad`` for JAX's ``k - 1 - pad``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.roi_align import roi_align
from .resnet import Conv2d, he_init_


class ConvTranspose(nn.Module):
    """Transposed convolution with bias, weight ``[in, out, k, k]``
    (mega_core.layers.ConvTranspose2d), NCHW, in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator):
        """He normal over the JAX package's fan-out of this shape
        (``k * in * out``)."""
        cin, cout, k, _ = self.weight.shape
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (k * cin * cout)), generator=gen)
            self.bias.zero_()

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype).flip(-1, -2),
                                  self.bias.to(x.dtype), self.stride, self.padding)


def _pool(feat, spatial_scale: float, boxes, p: int, sr: int):
    """ROIAlign of ``boxes`` ``[B, R, 4]`` on the NHWC map → ``[B * R, C,
    p, p]``."""
    pooled = roi_align(feat, boxes, spatial_scale, output_size=p, sampling_ratio=sr)
    b, r = boxes.shape[:2]
    return pooled.reshape(b * r, p, p, -1).permute(0, 3, 1, 2)


def _channels_last(x, b: int, r: int):
    """``[B * R, K, M, M]`` → ``[B, R, M, M, K]``."""
    m = x.shape[-1]
    return x.permute(0, 2, 3, 1).reshape(b, r, m, m, -1)


class HeadBase(nn.Module):
    def reset_parameters(self, gen: torch.Generator):
        he_init_(self, gen)
        for m in self.modules():
            if isinstance(m, ConvTranspose):
                m.reset_parameters(gen)
            elif isinstance(m, Conv2d) and m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


class MaskHead(HeadBase):
    """MaskRCNNFPNFeatureExtractor + MaskRCNNC4Predictor
    (roi_mask_feature_extractors.py:16-66, roi_mask_predictors.py:10-31).
    ``forward(feat, spatial_scale, boxes)``: ``feat`` NHWC, ``boxes`` ``[B,
    R, 4]`` → mask logits ``[B, R, 2p, 2p, num_classes]``."""

    def __init__(self, in_channels: int = 1024, num_classes: int = 81,
                 conv_layers: Sequence[int] = (256, 256, 256, 256),
                 pooler_resolution: int = 14, sampling_ratio: int = 2, dilation: int = 1):
        super().__init__()
        self.p, self.sr = pooler_resolution, sampling_ratio
        self.n_convs = len(conv_layers)
        cin = in_channels
        for i, ch in enumerate(conv_layers, 1):
            self.add_module(f"mask_fcn{i}", Conv2d(cin, ch, 3, padding=dilation,
                                                   dilation=dilation))
            cin = ch
        self.conv5_mask = ConvTranspose(cin, cin, 2, 2)
        self.mask_fcn_logits = Conv2d(cin, num_classes, 1, bias=True)

    def forward(self, feat, spatial_scale: float, boxes):
        b, r = boxes.shape[:2]
        x = _pool(feat, spatial_scale, boxes, self.p, self.sr)
        for i in range(1, self.n_convs + 1):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        x = F.relu(self.conv5_mask(x))
        return _channels_last(self.mask_fcn_logits(x), b, r)


class KeypointHead(HeadBase):
    """KeypointRCNNFeatureExtractor + KeypointRCNNPredictor
    (roi_keypoint_feature_extractors.py:11-43, roi_keypoint_predictors.py:
    8-34).  ``forward(feat, spatial_scale, boxes)`` → heatmap logits ``[B,
    R, 4p, 4p, num_keypoints]``; the x2 resize runs in fp32 (bilinear, half
    pixel centres: ``jax.image.resize``'s "linear" upsampling, which has no
    antialiasing to apply)."""

    def __init__(self, in_channels: int = 1024, num_keypoints: int = 17,
                 conv_layers: Sequence[int] = (512,) * 8,
                 pooler_resolution: int = 14, sampling_ratio: int = 2):
        super().__init__()
        self.p, self.sr = pooler_resolution, sampling_ratio
        self.n_convs = len(conv_layers)
        cin = in_channels
        for i, ch in enumerate(conv_layers, 1):
            self.add_module(f"conv_fcn{i}", Conv2d(cin, ch, 3, padding=1, bias=True))
            cin = ch
        self.kps_score_lowres = ConvTranspose(cin, num_keypoints, 4, 2, padding=1)

    def forward(self, feat, spatial_scale: float, boxes):
        b, r = boxes.shape[:2]
        x = _pool(feat, spatial_scale, boxes, self.p, self.sr)
        for i in range(1, self.n_convs + 1):
            x = F.relu(getattr(self, f"conv_fcn{i}")(x))
        x = self.kps_score_lowres(x)
        x = F.interpolate(x.float(), size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                          align_corners=False).to(x.dtype)
        return _channels_last(x, b, r)


def _abs(x):
    """``|x|`` with ``jnp.abs``'s gradient at 0 (+1)."""
    return torch.where(x >= 0, x, -x)


def _crop_targets(masks, match, boxes, m: int):
    """Each box's bilinear ``m x m`` crop of its matched mask of ``masks``
    ``[G, Hm, Wm]`` at the cells' centres (project_masks_on_boxes) →
    ``[R, m, m]``."""
    h, w = masks.shape[1:]
    flat = masks.float().reshape(-1)
    grid = (torch.arange(m, device=boxes.device, dtype=torch.float32) + 0.5) / m
    x1, y1, x2, y2 = boxes.unbind(-1)
    xi = (x1[:, None] + grid * (x2 - x1)[:, None]).clamp(0, w - 1)
    yi = (y1[:, None] + grid * (y2 - y1)[:, None]).clamp(0, h - 1)
    x0 = xi.floor().long().clamp(0, w - 2)
    y0 = yi.floor().long().clamp(0, h - 2)
    ly, lx = (yi - y0)[:, :, None], (xi - x0)[:, None, :]
    base = match[:, None, None] * (h * w) + y0[:, :, None] * w + x0[:, None, :]

    def at(dy: int, dx: int):
        return flat[base + dy * w + dx]

    return (at(0, 0) * (1 - ly) * (1 - lx) + at(1, 0) * ly * (1 - lx)
            + at(0, 1) * (1 - ly) * lx + at(1, 1) * ly * lx)


def mask_loss(mask_logits, boxes, labels, valid, gt_masks, gt_boxes, gt_labels, gt_valid):
    """The mean over images of the per-positive-proposal BCE on ``M x M``
    crops (mask_head/loss.py: project_masks_on_boxes + binary cross-entropy).

    ``mask_logits`` ``[B, R, M, M, K]``; ``boxes`` ``[B, R, 4]``; ``labels``
    ``[B, R]`` (the matched class, 0 background); ``valid`` ``[B, R]``;
    ``gt_masks`` ``[B, G, Hm, Wm]`` in image pixels; each proposal's target is
    the crop of its best-IoU valid GT (the first of a tie).  ``gt_labels`` is
    not read, as in the JAX package.  The BCE's max and abs take the JAX
    package's gradients at 0."""
    del gt_labels
    m = mask_logits.shape[2]
    losses = []
    for logits, bx, lab, val, gmask, gbox, gval in zip(mask_logits, boxes, labels, valid,
                                                       gt_masks, gt_boxes, gt_valid):
        bx, gbox = bx.float(), gbox.float()
        lt = torch.maximum(bx[:, None, :2], gbox[None, :, :2])
        rb = torch.minimum(bx[:, None, 2:], gbox[None, :, 2:])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        area = (((bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1]))[:, None]
                + ((gbox[:, 2] - gbox[:, 0]) * (gbox[:, 3] - gbox[:, 1]))[None] - inter)
        iou = torch.where(gval[None], inter / area.clamp(min=1e-9), -1.0)
        targets = _crop_targets(gmask, iou.argmax(1), bx, m)
        x = logits.float().gather(-1, lab.long()[:, None, None, None].expand(-1, m, m, 1))[..., 0]
        pos = (val & (lab > 0)).float()
        bce = torch.maximum(x, x.new_zeros(())) - x * targets + torch.log1p(torch.exp(-_abs(x)))
        losses.append((bce.mean((-2, -1)) * pos).sum() / pos.sum().clamp(min=1))
    return torch.stack(losses).mean()


def keypoint_loss(kp_logits, boxes, gt_keypoints, valid):
    """The mean over images of the softmax cross-entropy over heatmap
    positions at the visible GT keypoints inside their proposal
    (keypoint_head/loss.py: keypoints_to_heat_map + cross_entropy).

    ``kp_logits`` ``[B, R, S, S, K]``; ``gt_keypoints`` ``[B, R, K, 3]`` (x, y,
    visibility) of each proposal's matched GT; ``valid`` ``[B, R]``."""
    s = kp_logits.shape[2]
    losses = []
    for logits, bx, kps, val in zip(kp_logits, boxes, gt_keypoints, valid):
        r, k = logits.shape[0], logits.shape[-1]
        bx, kps = bx.float(), kps.float()
        x1, y1 = bx[:, 0:1], bx[:, 1:2]
        w = (bx[:, 2:3] - x1).clamp(min=1e-3)
        h = (bx[:, 3:4] - y1).clamp(min=1e-3)
        px = ((kps[..., 0] - x1) / w * s).to(torch.int32).clamp(0, s - 1)
        py = ((kps[..., 1] - y1) / h * s).to(torch.int32).clamp(0, s - 1)
        inside = ((kps[..., 0] >= x1) & (kps[..., 0] < x1 + w)
                  & (kps[..., 1] >= y1) & (kps[..., 1] < y1 + h))
        vis = ((kps[..., 2] > 0) & inside & val[:, None]).float()          # [R, K]
        logp = torch.log_softmax(logits.float().reshape(r, s * s, k), dim=1)
        picked = logp.gather(1, (py * s + px).long()[:, None, :])[:, 0]    # [R, K]
        losses.append(-(picked * vis).sum() / vis.sum().clamp(min=1))
    return torch.stack(losses).mean()


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, img_h: int, img_w: int,
                thresh: float = 0.5) -> np.ndarray:
    """The host Masker (mask_head/inference.py:70-140): each ``M x M``
    probability map resized into its box and thresholded → ``[R, img_h,
    img_w]`` uint8."""
    import cv2

    out = np.zeros((len(boxes), img_h, img_w), np.uint8)
    for i, (p, b) in enumerate(zip(mask_probs, boxes)):
        x1, y1 = int(np.floor(b[0])), int(np.floor(b[1]))
        x2, y2 = int(np.ceil(b[2])), int(np.ceil(b[3]))
        mm = cv2.resize(p.astype(np.float32), (max(x2 - x1, 1), max(y2 - y1, 1)))
        xa, ya = max(x1, 0), max(y1, 0)
        xb, yb = min(x2, img_w), min(y2, img_h)
        if xb > xa and yb > ya:
            out[i, ya:yb, xa:xb] = mm[ya - y1: yb - y1, xa - x1: xb - x1] > thresh
    return out


def heatmaps_to_keypoints(heatmaps: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """The host keypoint decode (keypoint_head/inference.py): each
    heatmap's first maximum mapped back into its box → ``[R, K, 3]`` (x, y,
    score)."""
    r, hm, wm, k = heatmaps.shape
    out = np.zeros((r, k, 3), np.float32)
    for i in range(r):
        x1, y1, x2, y2 = boxes[i]
        w = max(x2 - x1, 1e-3)
        h = max(y2 - y1, 1e-3)
        for j in range(k):
            m = heatmaps[i, :, :, j]
            yy, xx = divmod(int(m.argmax()), wm)
            out[i, j] = (x1 + (xx + 0.5) / wm * w, y1 + (yy + 0.5) / hm * h, m[yy, xx])
    return out

"""GeneralizedRCNN: the single-frame C4 two-stage baseline.

Port of ``diffusionvid_tpu/models/rcnn.py:29-159``: ResNet-C4 trunk (res4
at 1/16) → RPN → C4 box head → Fast R-CNN predictor → classic
post-processing, one fixed-size ``BoxArray`` an image; with ``num_groups``
above 1 the trunk and the res5 head are ResNeXt.  With ``mask_on`` /
``keypoint_on`` (``MODEL.MASK_ON`` / ``KEYPOINT_ON``) the test forward also
runs the mask and keypoint heads (``models/mask_keypoint.py``) on every
detection slot, pooling the res4 map at 1/16, and returns JAX's
``CombinedROIHeads`` dict (``rcnn.py:141-159``): ``dets``, ``masks`` (the
detected class's sigmoid ``[B, D, 28, 28]``) and ``keypoints`` (``[B, D,
56, 56, K]`` logits).  The train forward
(``train_loss``, ``losses_from_features``) selects ``post_nms_train``
proposals without gradient, puts the GT boxes in their last slots, and
returns the RPN's and the Fast R-CNN head's losses; their samplers take
their keys from ``draw`` (``draw(shape)`` gives uniforms in [0, 1) on the
model's device).  The MEGA family (``video_archs.py``) builds on the same
pieces.  The train forward runs no mask or keypoint head (the JAX
package's neither).

Module names follow the JAX package's tree: ``backbone.bottom_up`` the
trunk (detectron2 names, as in the DiffusionVID model), ``rpn``,
``roi_head.head.res5``, ``predictor``, ``mask_head`` and ``kp_head``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..structures.boxes import BoxArray
from .box_head import (C4BoxFeatureExtractor, FastRCNNPredictor, fast_rcnn_loss,
                       postprocess_classic)
from .heads import reset_head_parameters
from .mask_keypoint import KeypointHead, MaskHead
from .resnet import ResNet, he_init_
from .rpn import Proposals, RPNHead, generate_anchors, rpn_loss, select_proposals, shift_anchors


def with_gt(props: Proposals, gt_boxes, gt_valid):
    """The proposals ``[B, K]`` with their last ``G`` slots replaced by the
    GT ``[B, G]`` (add_gt_proposals, rpn/inference.py): (boxes, valid)."""
    g = gt_boxes.shape[1]
    return (torch.cat([props.boxes[:, :-g], gt_boxes.to(props.boxes.dtype)], 1),
            torch.cat([props.valid[:, :-g], gt_valid], 1))


class C4Backbone(nn.Module):
    """The trunk up to res4, held as ``bottom_up`` so its tensors carry the
    DiffusionVID model's ``backbone.bottom_up.*`` names; ResNeXt with
    ``num_groups`` above 1 (``RESNETS.NUM_GROUPS`` / ``WIDTH_PER_GROUP``)."""

    def __init__(self, depth: int, num_groups: int = 1, width_per_group: int = 64):
        super().__init__()
        self.bottom_up = ResNet(depth, out_features=("res4",), num_groups=num_groups,
                                width_per_group=width_per_group)

    def forward(self, x):
        return self.bottom_up(x)["res4"]


class GeneralizedRCNN(nn.Module):
    """C4 faster R-CNN.  ``with_predictor`` False leaves the predictor out:
    the MEGA family's detector never calls its own, and the JAX package
    creates no parameters for it there."""

    def __init__(self, depth: int = 101, num_classes: int = 31,
                 anchor_sizes: Sequence[int] = (64, 128, 256, 512),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0), anchor_stride: int = 16,
                 pre_nms_train: int = 2000, post_nms_train: int = 300,
                 pre_nms_test: int = 2000, post_nms_test: int = 300, ref_post_nms: int = 75,
                 res5_dilation: int = 1, num_groups: int = 1, width_per_group: int = 64,
                 pixel_mean=(123.675, 116.280, 103.530), pixel_std=(58.395, 57.120, 57.375),
                 compute_dtype=torch.float32, with_predictor: bool = True,
                 mask_on: bool = False, keypoint_on: bool = False, num_keypoints: int = 17):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_sizes, self.anchor_ratios = tuple(anchor_sizes), tuple(anchor_ratios)
        self.anchor_stride = anchor_stride
        self.pre_nms_train, self.post_nms_train = pre_nms_train, post_nms_train
        self.pre_nms_test, self.post_nms_test = pre_nms_test, post_nms_test
        self.ref_post_nms = ref_post_nms
        self.compute_dtype = compute_dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)
        self.backbone = C4Backbone(depth, num_groups, width_per_group)
        self.rpn = RPNHead(1024, len(self.anchor_sizes) * len(self.anchor_ratios))
        self.roi_head = C4BoxFeatureExtractor(depth, res5_dilation, num_groups, width_per_group)
        self.predictor = FastRCNNPredictor(2048, num_classes) if with_predictor else None
        self.mask_head = MaskHead(1024, num_classes) if mask_on else None
        self.kp_head = KeypointHead(1024, num_keypoints) if keypoint_on else None
        self._anchor_cache = {}

    def reset_parameters(self, gen: torch.Generator):
        he_init_(self, gen)
        for conv in (self.rpn.conv, self.rpn.cls_logits, self.rpn.bbox_pred):
            with torch.no_grad():
                conv.bias.zero_()
        reset_head_parameters(self, gen)
        for head in (self.mask_head, self.kp_head):
            if head is not None:
                head.reset_parameters(gen)

    def anchors(self, feat_hw, device) -> torch.Tensor:
        key = (tuple(feat_hw), str(device))
        if key not in self._anchor_cache:
            base = generate_anchors(self.anchor_sizes, self.anchor_ratios, self.anchor_stride)
            self._anchor_cache[key] = torch.from_numpy(
                shift_anchors(base, feat_hw[0], feat_hw[1], self.anchor_stride)).to(device)
        return self._anchor_cache[key]

    def features(self, images):
        """images ``[B, H, W, 3]`` in 0..255 → the res4 map, NCHW (its
        memory channels-last)."""
        x = ((images - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        return self.backbone(x.permute(0, 3, 1, 2))

    def proposals(self, feat, image_hw, ref: bool = False):
        """RPN forward + selection; ``ref`` gives the reference-frame count
        (REF_POST_NMS_TOP_N, rpn/rpn.py:200-243)."""
        logits, deltas = self.rpn(feat)
        anchors = self.anchors(feat.shape[2:], feat.device)
        return select_proposals(logits, deltas, anchors, image_hw, pre_nms=self.pre_nms_test,
                                post_nms=self.ref_post_nms if ref else self.post_nms_test)

    def train_proposals(self, feat, image_hw):
        """The RPN's outputs and the ``post_nms_train`` proposals selected
        from them without gradient (the reference's RPN inference runs
        under no_grad): (proposals, logits, deltas, anchors)."""
        logits, deltas = self.rpn(feat)
        anchors = self.anchors(feat.shape[2:], feat.device)
        with torch.no_grad():
            props = select_proposals(logits, deltas, anchors, image_hw,
                                     pre_nms=self.pre_nms_train, post_nms=self.post_nms_train)
        return props, logits, deltas, anchors

    def box_features(self, feat, boxes):
        """Pooled per-proposal features ``[B, R, 2048]``."""
        return self.roi_head(feat.permute(0, 2, 3, 1), boxes)

    def losses_from_features(self, feat, image_hw, gt_boxes, gt_labels, gt_valid,
                             draw) -> dict:
        """The RPN and Fast R-CNN losses on a res4 map ``[B, 1024, h, w]``
        and its GT ``[B, G]``: the shared train tail of ``base``, DFF and
        FGFA (generalized_rcnn_dff.py:88-115, generalized_rcnn_fgfa.py:105-143)."""
        props, logits, deltas, anchors = self.train_proposals(feat, image_hw)
        b = feat.shape[0]
        losses = rpn_loss(draw((b, 2, anchors.shape[0])), logits, deltas, anchors, gt_boxes,
                          gt_valid)
        boxes, valid = with_gt(props, gt_boxes, gt_valid)
        cls_logits, box_deltas = self.predictor(self.box_features(feat, boxes))
        losses.update(fast_rcnn_loss(draw((b, 2, boxes.shape[1])), cls_logits, box_deltas,
                                     boxes, valid, gt_boxes, gt_labels, gt_valid))
        return losses

    def train_loss(self, images, image_hw, gt_boxes, gt_labels, gt_valid, draw) -> dict:
        """images ``[B, H, W, 3]`` and their GT → the loss dict."""
        return self.losses_from_features(self.features(images), image_hw, gt_boxes,
                                         gt_labels, gt_valid, draw)

    def forward(self, images, image_hw):
        """images ``[B, H, W, 3]``; ``image_hw`` the true (h, w) of the
        content → one ``BoxArray`` of 300 detections an image, or with a
        mask or keypoint head the dict of ``roi_heads``."""
        feat = self.features(images)
        dets = self.detect(feat, image_hw)
        return dets if self.mask_head is None and self.kp_head is None else (
            self.roi_heads(feat, dets))

    def roi_heads(self, feat, dets: BoxArray) -> dict:
        """CombinedROIHeads at test time (roi_heads.py:23-58): the mask and
        keypoint heads on the detected boxes, every slot, pooled from the
        res4 map ``[B, 1024, h, w]`` → {"dets", "masks", "keypoints"}."""
        nhwc = feat.permute(0, 2, 3, 1)
        scale = 1.0 / self.anchor_stride
        out = {"dets": dets}
        if self.mask_head is not None:
            logits = self.mask_head(nhwc, scale, dets.boxes).float()     # [B, D, M, M, K]
            m = logits.shape[2]
            idx = dets.labels.long()[:, :, None, None, None].expand(-1, -1, m, m, 1)
            out["masks"] = torch.sigmoid(logits.gather(-1, idx)[..., 0])
        if self.kp_head is not None:
            out["keypoints"] = self.kp_head(nhwc, scale, dets.boxes)
        return out

    def detect(self, feat, image_hw) -> BoxArray:
        """The res4 map ``[B, 1024, h, w]`` → RPN, box head, predictor and
        post-processing (what DFF and FGFA run on their warped maps)."""
        props = self.proposals(feat, image_hw)
        cls_logits, box_deltas = self.predictor(self.box_features(feat, props.boxes))
        dets = [postprocess_classic(cl, bd, pb, pv, image_hw)
                for cl, bd, pb, pv in zip(cls_logits, box_deltas, props.boxes, props.valid)]
        return BoxArray(*(torch.stack(t) for t in zip(*dets)))

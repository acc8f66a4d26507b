"""The MEGA family's video architectures: DFF, FGFA, RDN, MEGA.

Port of ``diffusionvid_tpu/models/video_archs.py:46-818``:

  * ``DFFArch`` (generalized_rcnn_dff.py:42-120): key frames run the trunk;
    the others warp the key frame's res4 map by FlowNetS's flow and scale it
    by the predicted per-channel scale map;
  * ``FGFAArch`` (generalized_rcnn_fgfa.py:45-150): the window's maps,
    flow-warped onto the current frame, averaged with weights from the
    softmax over frames of EmbedNet's cosine similarity to the current one;
  * ``RDNArch`` (generalized_rcnn_rdn.py): the current frame's proposals
    attend over the reference frames' 75 proposals each (relation stages,
    optionally RDN's advanced distillation);
  * ``MEGAArch`` (generalized_rcnn_mega.py:389-672): RDN's stagewise
    current + reference co-refinement, plus the FPS-deduplicated global
    memory of proposal features as keys of every stage and, with
    ``MEMORY.ENABLE``, per-stage rings of earlier frames' stage-refined
    reference features, carried in an explicit ``MegaState``.

The pixel paths (``LOCAL/GLOBAL.PIXEL_ATTEND``): ``_pixel_enhance`` puts
the current res4 map through ``PixelMemoryAttention`` over a strided
subsample of the reference maps' pixels and the pixel memories before the
RPN; with no relation stage the local flag replaces the box relation
(``pixel_replaces_box``, ``MEGAArch.pixel_call``), and the global flag
enhances the global frames' maps and keeps an FPS pixel cache
(``update_global_pixels``).  Their caches live in ``PixelState``.

The train forwards (``train_loss``, MEGA's ``train_loss_mega``) return the
RPN's and the Fast R-CNN head's losses on the current frame's GT, their
samplers' keys from ``draw`` (``rcnn.py``): DFF trains on the key frame's
map warped onto the current frame, FGFA on the sampled references' maps
aggregated against the current frame's embedding (the current frame itself
is not among them), RDN relation-attends the current frame's proposals
over the 75 proposals of the current frame and of each reference, MEGA adds
the memory and global frames' 75 proposals each as geometry-free keys.  As
in the JAX package only the current frame's proposals are detached: the
references' boxes stay on the gradient path (the position embedding, the
pooling), back to the references' RPN deltas.

Module names follow the JAX package's tree: ``detector`` (the C4
``GeneralizedRCNN``; RDN and MEGA build it without its predictor),
``flownet``, ``embednet``, ``reduce``, ``relation``, ``predictor``,
``pixel_attn`` and, for MEGA without relation stages, ``global_lm``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.memory import FeatureMemory, init_memory, update_erase_memory
from ..structures.boxes import BoxArray
from .box_head import FastRCNNPredictor, postprocess_classic
from .flownet import EmbedNet, FlowNetS, warp_features
from .heads import Linear, reset_head_parameters
from .pixel_attention import PixelMemoryAttention, pixel_positional_embedding
from .box_head import fast_rcnn_loss
from .rcnn import GeneralizedRCNN, with_gt
from .relation import RelationAttention, RelationStack
from .rpn import rpn_loss
from .resnet import he_init_

# ---------------------------------------------------------------------------
# the pixel paths' streaming helpers
# ---------------------------------------------------------------------------


def _coprime_stride(n: int, k: int, w: int) -> int:
    """The largest stride at most ``n // k`` coprime with the row width, so
    that a stride lattice over row-major pixels covers the map (the JAX
    package's static stand-in for the reference's ``torch.randperm``)."""
    stride = max(1, n // max(k, 1))
    while stride > 1 and math.gcd(stride, w) != 1:
        stride -= 1
    return stride


def _select_masked(px, mask, k: int, hashed: bool = True):
    """Up to ``k`` rows of ``px`` ``[n, C]`` where ``mask``: the masked rows
    first, in a Knuth-hash order (``i * 2654435761 mod 2**32 mod n``, as the
    JAX package's uint32 arithmetic wraps) or in order.  The hash is not a
    permutation, so scores tie: the sort is stable, as ``jnp.argsort``.
    Returns (``px[idx]`` with ``min(n, k)`` rows, ``[k]`` valid)."""
    n = mask.shape[0]
    ar = torch.arange(n, dtype=torch.int64, device=px.device)
    order = (ar * 2654435761) % 2 ** 32 % n if hashed else ar
    score = torch.where(mask, order, n + order)
    idx = torch.argsort(score, stable=True)[:k]
    valid = torch.arange(k, device=px.device) < mask.sum()
    return px[idx], valid


def _irrelevant_pixels(px, k: int = 100):
    """pixels_irr (generalized_rcnn_mega.py:177-182): up to ``k`` rows whose
    softmax of L2 norm / 32 exceeds the uniform 1/N, in hashed order."""
    l2 = torch.sqrt((px.float() ** 2).sum(-1)) / 32.0
    keep = torch.softmax(l2, 0) > 1.0 / px.shape[0]
    return _select_masked(px, keep, k)


def _pixels_in_boxes(h: int, w: int, boxes, box_valid, stride: float = 16.0):
    """``[h * w]``: the feature-grid pixels whose centre falls in a valid box
    (``get_pixels_index``, roi_box_feature_extractors.py:1517-1545), x
    against the boxes' x and y against their y, as the JAX package does
    (ROADMAP.md §C deviation 8: the reference compares rows with x)."""
    b = boxes / stride
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device) + 0.5
    gx = xs[None, :].expand(h, w).reshape(-1)
    gy = ys[:, None].expand(h, w).reshape(-1)
    inb = ((gx[:, None] >= b[None, :, 0]) & (gx[:, None] <= b[None, :, 2])
           & (gy[:, None] >= b[None, :, 1]) & (gy[:, None] <= b[None, :, 3]))
    return (inb & box_valid[None, :]).any(1)


def _ring_write(mem: FeatureMemory, new, new_valid) -> FeatureMemory:
    """The valid rows of ``new``, compacted in order (a stable sort of
    ``~valid``), written into the ring from slot ``count % cap``."""
    cap, k = mem.feats.shape[0], new.shape[0]
    order = torch.argsort((~new_valid).to(torch.uint8), stable=True)
    nv = int(new_valid.sum())
    ar = torch.arange(k, device=new.device)
    pos = (mem.count + ar) % cap
    out = mem.feats.clone()
    out[pos] = torch.where((ar < nv)[:, None], new[order].to(out.dtype), out[pos])
    return FeatureMemory(out, mem.count + nv)


def _ring_valid(mem: FeatureMemory):
    cap = mem.feats.shape[0]
    return torch.arange(cap, device=mem.feats.device) < min(mem.count, cap)


class PixelState(NamedTuple):
    """The pixel paths' per-video caches (generalized_rcnn_mega.py:269-273,
    430-436) at fixed sizes: ``ext`` (pixel_external_mem: pixels inside
    the score-0.9 detections, a ring), ``last_high`` (inside the latest
    frame's score-0.5 detections), ``irr`` (the latest enhanced map's
    irrelevant pixels), ``gpix`` (the FPS pixel cache of the global frames)
    and ``irr_g`` (the last global frame's irrelevant pixels), each
    ``[rows, C]`` with its valid mask."""

    ext: FeatureMemory
    last_high: torch.Tensor
    last_high_valid: torch.Tensor
    irr: torch.Tensor
    irr_valid: torch.Tensor
    gpix: FeatureMemory
    irr_g: torch.Tensor
    irr_g_valid: torch.Tensor


def local_pixel_frame_offsets(sel_future: int = 5, sel_prev: int = 5, interval: int = 25,
                              key_location: int = 12) -> list:
    """``local_frame_selector`` (generalized_rcnn_mega.py:60-74): offsets
    ±2^i and 0, clamped to the local window, deduplicated and sorted; the
    defaults give [-12, -8, -4, -2, -1, 0, 1, 2, 4, 8, 12]."""
    lo, hi = -key_location, interval - key_location - 1
    offs = ({max(min(-(2 ** i), hi), lo) for i in range(sel_prev)}
            | {0}
            | {max(min(2 ** i, hi), lo) for i in range(sel_future)})
    return sorted(offs)


def _nhwc_rows(feat):
    """One NCHW map ``[C, h, w]`` → its pixels ``[h * w, C]``, row-major."""
    return feat.permute(1, 2, 0).reshape(-1, feat.shape[0])


# ---------------------------------------------------------------------------
# flow-guided architectures
# ---------------------------------------------------------------------------


def _image_pair(cur, ref):
    """Images ``[B, H, W, 3]`` 0..255 → FlowNetS's ``[B, 6, H, W]`` input."""
    return (torch.cat([cur.float(), ref.float()], -1) / 255.0).permute(0, 3, 1, 2)


class _FlowArch(nn.Module):
    """The C4 detector with its predictor, and FlowNetS."""

    def __init__(self, depth: int, num_classes: int, pre_nms: int, post_nms: int,
                 pre_nms_train: int, post_nms_train: int, res5_dilation: int, num_groups: int,
                 width_per_group: int, compute_dtype, predict_scale: bool):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.detector = GeneralizedRCNN(
            depth=depth, num_classes=num_classes, pre_nms_test=pre_nms, post_nms_test=post_nms,
            pre_nms_train=pre_nms_train, post_nms_train=post_nms_train,
            res5_dilation=res5_dilation, num_groups=num_groups,
            width_per_group=width_per_group, compute_dtype=compute_dtype)
        self.flownet = FlowNetS(predict_scale=predict_scale, compute_dtype=compute_dtype)

    def reset_parameters(self, gen: torch.Generator):
        self.detector.reset_parameters(gen)
        he_init_(self.flownet, gen)
        self.flownet.reset_parameters(gen)

    def flow(self, cur_images, ref_images, feat_hw):
        """FlowNetS on (current, reference) pairs, cut to the map's extent."""
        out = self.flownet(_image_pair(cur_images, ref_images))
        fh, fw = feat_hw
        if isinstance(out, tuple):
            return tuple(t[:, :, :fh, :fw] for t in out)
        return out[:, :, :fh, :fw]


class DFFArch(_FlowArch):
    """Deep Feature Flow: detect on the key frame's res4 map, warped by the
    flow to the current frame and scaled.

    ``forward`` recomputes the key frame's trunk on every frame, as the JAX
    package's ``__call__`` does (video_archs.py:226-230); the engine
    (``engine/inference_mega.py``) keeps the key frame's map from its key
    pass instead (``key_features`` once, then ``warp_from_key`` and
    ``detect``), with the same numbers."""

    def __init__(self, depth: int = 101, num_classes: int = 31, key_frame_duration: int = 10,
                 pre_nms: int = 2000, post_nms: int = 300, pre_nms_train: int = 2000,
                 post_nms_train: int = 300, res5_dilation: int = 1, num_groups: int = 1,
                 width_per_group: int = 64, compute_dtype=torch.float32):
        super().__init__(depth, num_classes, pre_nms, post_nms, pre_nms_train, post_nms_train,
                         res5_dilation, num_groups, width_per_group, compute_dtype,
                         predict_scale=True)
        self.key_frame_duration = key_frame_duration

    def key_features(self, images):
        return self.detector.features(images)

    def warp_from_key(self, key_images, cur_images, key_feat):
        """The key frame's map warped onto the current frame and scaled
        (generalized_rcnn_dff.py:72-95)."""
        flow, scale = self.flow(cur_images, key_images, key_feat.shape[2:])
        return warp_features(key_feat, flow) * scale

    def detect(self, feat, image_hw) -> BoxArray:
        return self.detector.detect(feat, image_hw)

    def train_loss(self, cur_images, ref_images, image_hw, gt_boxes, gt_labels, gt_valid,
                   draw) -> dict:
        """The trunk on the sampled key frame ``ref_images`` ``[1, H, W, 3]``
        only, its map warped onto the current frame, the losses on the
        current frame's GT (generalized_rcnn_dff.py:88-115)."""
        key_feat = self.key_features(ref_images)
        feat = self.warp_from_key(ref_images, cur_images, key_feat)
        return self.detector.losses_from_features(feat, image_hw, gt_boxes, gt_labels,
                                                  gt_valid, draw)

    def forward(self, key_images, cur_images, image_hw, is_key: bool = False) -> BoxArray:
        key_feat = self.key_features(key_images)
        feat = key_feat if is_key else self.warp_from_key(key_images, cur_images, key_feat)
        return self.detect(feat, image_hw)


class FGFAArch(_FlowArch):
    """Flow-Guided Feature Aggregation."""

    def __init__(self, depth: int = 101, num_classes: int = 31, pre_nms: int = 2000,
                 post_nms: int = 300, pre_nms_train: int = 2000, post_nms_train: int = 300,
                 res5_dilation: int = 1, num_groups: int = 1, width_per_group: int = 64,
                 compute_dtype=torch.float32):
        super().__init__(depth, num_classes, pre_nms, post_nms, pre_nms_train, post_nms_train,
                         res5_dilation, num_groups, width_per_group, compute_dtype,
                         predict_scale=False)
        self.embednet = EmbedNet()

    def reset_parameters(self, gen: torch.Generator):
        super().reset_parameters(gen)
        he_init_(self.embednet, gen)

    def _warp_refs(self, cur_images, ref_images, ref_feats):
        r = ref_images.shape[0]
        flow = self.flow(cur_images.expand(r, *cur_images.shape[1:]), ref_images,
                         ref_feats.shape[2:])
        return warp_features(ref_feats, flow)

    @staticmethod
    def _weighted(warped, emb, cur_emb):
        """The warped maps' average weighted by the softmax over frames of
        the cosine between their embeddings and ``cur_emb``; in float32."""
        def unit(e):
            e = e.float()
            return e / torch.linalg.vector_norm(e, dim=1, keepdim=True).clamp(min=1e-6)

        weight = torch.softmax((unit(emb) * unit(cur_emb)).sum(1), 0)[:, None]
        return (warped.float() * weight).sum(0, keepdim=True).to(warped.dtype)

    def aggregate(self, cur_images, ref_images, ref_feats):
        """Each reference map warped onto the current frame, then their
        average weighted by the softmax over frames of the cosine between
        each warped map's embedding and the current frame's, the last
        reference (generalized_rcnn_fgfa.py:45-110); in float32."""
        warped = self._warp_refs(cur_images, ref_images, ref_feats)
        emb = self.embednet(warped)
        return self._weighted(warped, emb, emb[-1:])

    def train_loss(self, cur_images, ref_images, image_hw, gt_boxes, gt_labels, gt_valid,
                   draw) -> dict:
        """One trunk pass over [cur, refs]; the references' maps warped onto
        the current frame and aggregated against the current frame's own
        embedding, without the current map among them (as the reference
        trains, generalized_rcnn_fgfa.py:105-143); the losses on the
        current frame's GT."""
        feats = self.detector.features(torch.cat([cur_images, ref_images], 0))
        warped = self._warp_refs(cur_images, ref_images, feats[1:])
        emb = self.embednet(torch.cat([feats[:1], warped], 0))
        feat = self._weighted(warped, emb[1:], emb[:1])
        return self.detector.losses_from_features(feat, image_hw, gt_boxes, gt_labels,
                                                  gt_valid, draw)

    def forward(self, cur_images, ref_images, image_hw) -> BoxArray:
        """``ref_images`` end with the current frame."""
        feat = self.aggregate(cur_images, ref_images, self.detector.features(ref_images))
        return self.detector.detect(feat, image_hw)


# ---------------------------------------------------------------------------
# relation architectures
# ---------------------------------------------------------------------------


class RDNArch(nn.Module):
    """Relation Distillation Network: relation attention over the
    reference frames' proposals.

    ``pixel_attend_local`` (``LOCAL.PIXEL_ATTEND``) arms the pixel path
    only with no relation stage (``ATTENTION.ENABLE`` off): the current map
    is then pixel-enhanced before the RPN and replaces the box relation, as
    in the reference (generalized_rcnn_mega.py:352, 608); with stages the
    flag is inert.  ``pixel_attn`` exists only where a path calls it, as the
    JAX package's tree holds it only then."""

    pixel_sparse = 0.1          # the test-time reference subsample (:609)
    pixel_sparse_train = 0.25   # the train-side subsample, the global maps' (:360, 474)

    def __init__(self, depth: int = 101, num_classes: int = 31, feat_dim: int = 1024,
                 relation_stages: int = 2, advanced_stages: int = 0, advanced_num: int = 15,
                 ref_post_nms: int = 75, pre_nms: int = 2000, post_nms: int = 300,
                 pre_nms_train: int = 2000, post_nms_train: int = 300, joint: bool = False,
                 res5_dilation: int = 1, num_groups: int = 1, width_per_group: int = 64,
                 pixel_attend_local: bool = False, compute_dtype=torch.float32):
        super().__init__()
        self.num_classes, self.feat_dim = num_classes, feat_dim
        self.relation_stages = relation_stages
        self.pixel_attend_local = pixel_attend_local
        self.compute_dtype = compute_dtype
        self.detector = GeneralizedRCNN(
            depth=depth, num_classes=num_classes, pre_nms_test=pre_nms,
            post_nms_test=post_nms, pre_nms_train=pre_nms_train,
            post_nms_train=post_nms_train, ref_post_nms=ref_post_nms,
            res5_dilation=res5_dilation, num_groups=num_groups,
            width_per_group=width_per_group, compute_dtype=compute_dtype,
            with_predictor=False)
        self.reduce = Linear(2048, feat_dim, dtype=compute_dtype)
        self.relation = RelationStack(num_stages=relation_stages, feat_dim=feat_dim,
                                      joint=joint, advanced_stages=advanced_stages,
                                      advanced_num=advanced_num, group_size=ref_post_nms,
                                      dtype=compute_dtype)
        self.predictor = FastRCNNPredictor(feat_dim, num_classes)
        if self.pixel_replaces_box:
            # res4 is 1024 wide at every depth
            self.pixel_attn = PixelMemoryAttention(1024, dtype=compute_dtype)

    @property
    def pixel_replaces_box(self) -> bool:
        return self.pixel_attend_local and self.relation_stages == 0

    def reset_parameters(self, gen: torch.Generator):
        self.detector.reset_parameters(gen)
        reset_head_parameters(self, gen)
        for m in self.modules():
            if isinstance(m, RelationAttention):
                m.reset_parameters(gen)

    def _pixel_enhance(self, cur_feat, ref_feat, ref_frame_valid=None, sparse=None,
                       memory=None, memory_valid=None):
        """The current res4 map ``[1, C, h, w]`` through pixel attention
        (``update_lm_pixel_with_transpose``, generalized_rcnn_mega.py:85-130,
        and ``update_lm_pixel``): the positional embedding added to the
        query and to the reference maps ``[F, C, h, w]`` (and kept on the
        result), keys a stride lattice of ``sparse`` of each reference
        map's pixels (frames masked by ``ref_frame_valid``) and then
        ``memory``.  Returns the enhanced ``[1, C, h, w]`` map."""
        f, c, h, w = ref_feat.shape
        sparse = self.pixel_sparse if sparse is None else sparse
        ps = pixel_positional_embedding(h, w, c, self.compute_dtype, ref_feat.device)
        hw = h * w
        k = max(1, int(round(hw * sparse)))
        stride = _coprime_stride(hw, k, w)
        refs = (ref_feat.permute(0, 2, 3, 1) + ps[None]).reshape(f, hw, c)[:, ::stride][:, :k]
        if ref_frame_valid is None:
            ref_frame_valid = torch.ones(f, dtype=torch.bool, device=ref_feat.device)
        out = self.pixel_attn(cur_feat[0].permute(1, 2, 0) + ps, keys=refs.reshape(f * k, c),
                              keys_valid=ref_frame_valid.repeat_interleave(k),
                              memory=memory, memory_valid=memory_valid)
        return out.permute(2, 0, 1)[None]

    def pooled(self, feat, boxes):
        """[B, R, 2048] box features → relu(reduce) [B, R, 1024]."""
        return F.relu(self.reduce(self.detector.box_features(feat, boxes)))

    def _frames(self, cur_images, ref_images, image_hw):
        """One trunk pass over [cur, refs]; the current frame's proposals
        and pooled features, and the references' (75 a frame, flattened).
        On the pixel path the current map is first enhanced over every map
        of the pass, with no memory (the JAX package's stateless
        ``__call__``; the engine runs ``MEGAArch.pixel_call``)."""
        feats = self.detector.features(torch.cat([cur_images, ref_images], 0))
        cur_feat, ref_feat = feats[:1], feats[1:]
        if self.pixel_replaces_box:
            cur_feat = self._pixel_enhance(cur_feat, feats)
        props = self.detector.proposals(cur_feat, image_hw)
        cur_x = self.pooled(cur_feat, props.boxes)[0]
        return (props, cur_x, *self._ref_pooled(ref_feat, image_hw))

    def _ref_pooled(self, ref_feat, image_hw):
        """The 75 reference proposals of each map ``[F, C, h, w]``: their
        pooled features ``[F*75, D]``, boxes and valid masks, flattened."""
        ref_props = self.detector.proposals(ref_feat, image_hw, ref=True)
        ref_x = self.pooled(ref_feat, ref_props.boxes).reshape(-1, self.feat_dim)
        return ref_x, ref_props.boxes.reshape(-1, 4), ref_props.valid.reshape(-1)

    def train_loss(self, cur_images, ref_images, image_hw, gt_boxes, gt_labels, gt_valid, draw,
                   extra_kv=None, extra_valid=None) -> dict:
        """RDN training (generalized_rcnn_rdn.py:75-106): one trunk pass over
        [cur, refs]; the RPN's loss on the current frame; its proposals
        (detached, the GT in their last slots, GT ``[G]`` unbatched)
        relation-attended over the 75 proposals of the current frame and of
        each reference, then the Fast R-CNN loss.  ``extra_kv`` / ``extra_valid``:
        MEGA's geometry-free memory keys, over which a model without
        relation stages takes one ``global_lm`` pass.  On the pixel path the
        current map is first enhanced over every map of the pass (0.25 of
        their pixels) and their irrelevant pixels
        (generalized_rcnn_mega.py:352-363)."""
        feats = self.detector.features(torch.cat([cur_images, ref_images], 0))
        cur_feat, ref_feat = feats[:1], feats[1:]
        if self.pixel_replaces_box:
            irr, irr_valid = _irrelevant_pixels(
                feats.permute(0, 2, 3, 1).reshape(-1, feats.shape[1]))
            cur_feat = self._pixel_enhance(cur_feat, feats, sparse=self.pixel_sparse_train,
                                           memory=irr, memory_valid=irr_valid)
        props, logits, deltas, anchors = self.detector.train_proposals(cur_feat, image_hw)
        gt_b, gt_l, gt_v = gt_boxes[None], gt_labels[None], gt_valid[None]
        losses = rpn_loss(draw((1, 2, anchors.shape[0])), logits, deltas, anchors, gt_b, gt_v)
        boxes, valid = with_gt(props, gt_b, gt_v)
        cur_x = self.pooled(cur_feat, boxes)[0]
        ref_x, ref_boxes, ref_valid = self._ref_pooled(torch.cat([cur_feat, ref_feat], 0),
                                                       image_hw)
        x = self.relation(cur_x, ref_x, boxes[0], ref_boxes, ref_valid, extra_kv=extra_kv,
                          extra_valid=extra_valid)
        if self.relation_stages == 0 and extra_kv is not None:
            # update_lm at train (roi_box_feature_extractors.py:1259-1263)
            lm = self.global_lm(x, extra_kv, None, extra_valid)
            x = torch.where(extra_valid.any(), x + lm, x)
        cls_logits, box_deltas = self.predictor(x[None])
        losses.update(fast_rcnn_loss(draw((1, 2, boxes.shape[1])), cls_logits, box_deltas,
                                     boxes, valid, gt_b, gt_l, gt_v))
        return losses

    def _detect(self, x, props, image_hw) -> BoxArray:
        cls_logits, box_deltas = self.predictor(x[None])
        det = postprocess_classic(cls_logits[0], box_deltas[0], props.boxes[0],
                                  props.valid[0], image_hw)
        return BoxArray(*(t[None] for t in det))

    def forward(self, cur_images, ref_images, image_hw) -> BoxArray:
        """cur ``[1, H, W, 3]``, refs ``[L, H, W, 3]`` → ``BoxArray`` [1, 300]."""
        props, cur_x, ref_x, ref_boxes, ref_valid = self._frames(cur_images, ref_images,
                                                                 image_hw)
        x = self.relation(cur_x, ref_x, props.boxes[0], ref_boxes, ref_valid)
        return self._detect(x, props, image_hw)


class MegaState(NamedTuple):
    """MEGA's streaming state: the FPS global memory of proposal features
    and, with the stage memory on, per-stage rings ``stage_feats``
    ``[S, cap, D]`` with their fill counts (host integers)."""

    mem: FeatureMemory
    stage_feats: Optional[torch.Tensor] = None
    stage_count: Optional[tuple] = None


class MEGAArch(RDNArch):
    """MEGA = RDN's joint co-refinement + the global FPS memory + the
    optional per-stage memory rings, and the pixel paths'
    ``GLOBAL.PIXEL_ATTEND`` (the global maps self-enhanced over the FPS
    pixel cache, ``pixel_mem_size`` rows) with ``PixelState``."""

    ref_slots = 75   # reference proposals pushed a frame (the JAX package's constant)
    pixel_ext_cap = 2048   # pixel_external_mem's read budget (generalized_rcnn_mega.py:117)

    def __init__(self, *args, memory_size: int = 750, use_stage_mem: bool = False,
                 mem_frames: int = 25, pixel_attend_global: bool = False,
                 pixel_mem_size: int = 1000, **kw):
        kw.setdefault("joint", True)
        super().__init__(*args, **kw)
        self.memory_size = memory_size
        self.use_stage_mem = use_stage_mem
        self.mem_frames = mem_frames
        self.pixel_attend_global = pixel_attend_global
        self.pixel_mem_size = pixel_mem_size
        if pixel_attend_global and not hasattr(self, "pixel_attn"):
            self.pixel_attn = PixelMemoryAttention(1024, dtype=self.compute_dtype)
        if self.relation_stages == 0:
            # update_lm: with no relation stage the global memory still gets
            # one geometry-free attention pass (roi_box_feature_extractors.py:1508-1513)
            self.global_lm = RelationAttention(self.feat_dim, 16, geometry=False,
                                               dtype=self.compute_dtype)

    @property
    def stage_mem_cap(self) -> int:
        return self.mem_frames * self.ref_slots

    def init_state(self) -> MegaState:
        dev = self.reduce.weight.device
        mem = init_memory(self.memory_size, self.feat_dim, device=dev)
        if not self.use_stage_mem:
            return MegaState(mem)
        s = self.relation_stages
        return MegaState(mem, torch.zeros(s, self.stage_mem_cap, self.feat_dim, device=dev),
                         (0,) * s)

    def memory_features(self, images, image_hw, pstate: Optional[PixelState] = None):
        """Global frames → their 75 reference proposals each → pooled
        features [F*75, D] and validity [F*75].  With ``GLOBAL.PIXEL_ATTEND``
        and a pixel state each map is first enhanced over a 0.25 subsample
        of its own pixels and the global pixel cache (:470-478)."""
        feat = self.detector.features(images)
        if self.pixel_attend_global and pstate is not None:
            gvalid = torch.arange(self.pixel_mem_size, device=feat.device) < pstate.gpix.count
            feat = torch.cat([self._pixel_enhance(
                feat[i:i + 1], feat[i:i + 1], sparse=self.pixel_sparse_train,
                memory=pstate.gpix.feats, memory_valid=gvalid) for i in range(feat.shape[0])], 0)
        props = self.detector.proposals(feat, image_hw, ref=True)
        x = self.pooled(feat, props.boxes)
        return x.reshape(-1, self.feat_dim), props.valid.reshape(-1)

    def train_loss_mega(self, cur_images, local_images, mem_images, global_images, image_hw,
                        gt_boxes, gt_labels, gt_valid, draw) -> dict:
        """MEGA training (generalized_rcnn_mega.py:252-388): the memory and
        global frames' 75 reference proposals each, pooled, are the
        geometry-free keys of ``train_loss`` over the local frames."""
        aux = [t for t in (mem_images, global_images) if t is not None and t.shape[0] > 0]
        extra_kv = extra_valid = None
        if aux:
            extra_kv, _, extra_valid = self._ref_pooled(
                self.detector.features(torch.cat(aux, 0)), image_hw)
        return self.train_loss(cur_images, local_images, image_hw, gt_boxes, gt_labels, gt_valid,
                               draw, extra_kv=extra_kv, extra_valid=extra_valid)

    def update_memory(self, state: MegaState, feats, valid) -> MegaState:
        """The valid features, compacted to a prefix in order, merged into
        the global memory."""
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        return state._replace(
            mem=update_erase_memory(state.mem, feats[order], int(valid.sum())))

    # ---- the pixel paths' streaming ----

    def init_pixel_state(self) -> PixelState:
        dev = self.reduce.weight.device
        z100 = torch.zeros(100, 1024, device=dev)
        f100 = torch.zeros(100, dtype=torch.bool, device=dev)
        return PixelState(ext=init_memory(self.pixel_ext_cap, 1024, device=dev),
                          last_high=z100, last_high_valid=f100, irr=z100, irr_valid=f100,
                          gpix=init_memory(self.pixel_mem_size, 1024, device=dev),
                          irr_g=z100, irr_g_valid=f100)

    def update_global_pixels(self, pstate: PixelState, global_images) -> PixelState:
        """``select_pixel_ref(mode='random', update_mem='global')`` for each
        global frame (generalized_rcnn_mega.py:455-461): 250 pixels in
        hashed order merged into the FPS pixel cache (:196-200), and
        ``irr_g`` from the frame's pixels (:177-183, 194)."""
        feats = self.detector.features(global_images)
        g, _, h, w = feats.shape
        gpix, irr_g, irr_gv = pstate.gpix, pstate.irr_g, pstate.irr_g_valid
        everything = torch.ones(h * w, dtype=torch.bool, device=feats.device)
        for i in range(g):
            px = _nhwc_rows(feats[i])
            sel, _ = _select_masked(px, everything, 250)
            gpix = update_erase_memory(gpix, sel, min(250, h * w))
            irr_g, irr_gv = _irrelevant_pixels(px)
        return pstate._replace(gpix=gpix, irr_g=irr_g, irr_g_valid=irr_gv)

    def pixel_call(self, cur_images, ref_images, ref_frame_valid, image_hw,
                   state: Optional[MegaState], pstate: PixelState):
        """A frame on the pixel path that replaces the box relation
        (generalized_rcnn_mega.py:608-620): the current map enhanced over
        the frame selector's reference maps (0.1 of their pixels) and the
        pixel memories (``ext``, ``gpix``, ``irr``, ``last_high``); RPN and
        pooling on the enhanced map with no box reference; one
        geometry-free pass over the global box memory once it holds
        something; then the local pixel memories updated from the enhanced
        map and the detections (:635-636, 148-158, 177-192).  Returns
        (detections, the new ``PixelState``)."""
        feats = self.detector.features(torch.cat([cur_images, ref_images], 0))
        cur_map, ref_maps = feats[:1], feats[1:]
        h, w = feats.shape[2:]
        if h * w < 100:
            raise ValueError(f"the pixel path keeps 100 pixels of a {h}x{w} map: it needs a "
                             f"res4 map of at least 100 pixels")
        dev = feats.device
        mem = torch.cat([pstate.ext.feats, pstate.gpix.feats, pstate.irr.float(),
                         pstate.last_high.float()], 0)
        mem_valid = torch.cat([
            _ring_valid(pstate.ext),
            torch.arange(pstate.gpix.feats.shape[0], device=dev) < pstate.gpix.count,
            pstate.irr_valid, pstate.last_high_valid], 0)
        enhanced = self._pixel_enhance(cur_map, ref_maps, ref_frame_valid,
                                       sparse=self.pixel_sparse, memory=mem,
                                       memory_valid=mem_valid)
        props = self.detector.proposals(enhanced, image_hw)
        x = self.pooled(enhanced, props.boxes)[0]
        if state is not None and state.mem.count > 0:
            valid = torch.arange(self.memory_size, device=dev) < state.mem.count
            x = x + self.global_lm(x, state.mem.feats, None, valid)
        dets = self._detect(x, props, image_hw)

        epx = _nhwc_rows(enhanced[0])
        high = dets.valid[0] & (dets.scores[0] > 0.9)
        sel09, v09 = _select_masked(epx, _pixels_in_boxes(h, w, dets.boxes[0], high), 100)
        mid = dets.valid[0] & (dets.scores[0] > 0.5)
        sel05, v05 = _select_masked(epx, _pixels_in_boxes(h, w, dets.boxes[0], mid), 100)
        irr, irr_valid = _irrelevant_pixels(epx)
        return dets, pstate._replace(ext=_ring_write(pstate.ext, sel09, v09),
                                     last_high=sel05, last_high_valid=v05,
                                     irr=irr, irr_valid=irr_valid)

    def _push_stage_mem(self, state: MegaState, stage_refs) -> MegaState:
        """Ring-write the newest reference frame's 75 stage-i features (the
        last 75 rows of ``stage_refs`` [S, M, D]) into ring i."""
        k, cap = self.ref_slots, self.stage_mem_cap
        newest = stage_refs[:, -k:].to(state.stage_feats.dtype)
        rings = state.stage_feats.clone()
        for i, count in enumerate(state.stage_count):
            idx = (count % cap + torch.arange(k, device=rings.device)) % cap
            rings[i, idx] = newest[i]
        return MegaState(state.mem, rings, tuple(c + k for c in state.stage_count))

    def forward(self, cur_images, ref_images, image_hw, state: MegaState = None,
                return_state: bool = False):
        props, cur_x, ref_x, ref_boxes, ref_valid = self._frames(cur_images, ref_images,
                                                                 image_hw)
        extra_kv = extra_valid = stage_kv = stage_valid = None
        dev = cur_x.device
        if state is not None:
            extra_kv = state.mem.feats
            extra_valid = torch.arange(self.memory_size, device=dev) < state.mem.count
            if self.use_stage_mem and state.stage_feats is not None:
                stage_kv = state.stage_feats
                fill = torch.tensor([min(c, self.stage_mem_cap) for c in state.stage_count],
                                    device=dev)
                stage_valid = torch.arange(self.stage_mem_cap, device=dev)[None] < fill[:, None]
        out = self.relation(cur_x, ref_x, props.boxes[0], ref_boxes, ref_valid,
                            extra_kv=extra_kv, extra_valid=extra_valid, stage_kv=stage_kv,
                            stage_valid=stage_valid, return_stage_refs=stage_kv is not None)
        if stage_kv is not None:
            x, stage_refs = out
            state = self._push_stage_mem(state, stage_refs)
        else:
            x = out
        if self.relation_stages == 0 and extra_kv is not None and state.mem.count > 0:
            # skipped while the memory is empty (the reference's global_cache
            # is None until the first update)
            x = x + self.global_lm(x, extra_kv, None, extra_valid)
        dets = self._detect(x, props, image_hw)
        return (dets, state) if return_state else dets


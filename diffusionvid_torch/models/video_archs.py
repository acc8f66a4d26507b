"""The MEGA family's relation architectures at inference: RDN and MEGA.

Port of ``diffusionvid_tpu/models/video_archs.py:328-818`` (the box path):

  * ``RDNArch`` (generalized_rcnn_rdn.py): the current frame's proposals
    attend over the reference frames' 75 proposals each (relation stages,
    optionally RDN's advanced distillation);
  * ``MEGAArch`` (generalized_rcnn_mega.py:389-672): RDN's stagewise
    current + reference co-refinement, plus the FPS-deduplicated global
    memory of proposal features as keys of every stage and, with
    ``MEMORY.ENABLE``, per-stage rings of earlier frames' stage-refined
    reference features, carried in an explicit ``MegaState``.

The pixel-attention paths (``LOCAL/GLOBAL.PIXEL_ATTEND``: ``_pixel_enhance``,
``PixelState``, ``pixel_call``) are ROADMAP.md A7.2 and raise here.  The
train forwards are A7.5.

Module names follow the JAX package's tree: ``detector`` (the C4
``GeneralizedRCNN`` without its predictor), ``reduce``, ``relation``,
``predictor`` and, for MEGA without relation stages, ``global_lm``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.memory import FeatureMemory, init_memory, update_erase_memory
from ..structures.boxes import BoxArray
from .box_head import FastRCNNPredictor, postprocess_classic
from .heads import Linear, reset_head_parameters
from .rcnn import GeneralizedRCNN
from .relation import RelationAttention, RelationStack

PIXEL_REFUSAL = ("LOCAL/GLOBAL.PIXEL_ATTEND (the pixel-attention paths) is not ported: "
                 "ROADMAP.md A7.2")


class RDNArch(nn.Module):
    """Relation Distillation Network: relation attention over the
    reference frames' proposals."""

    def __init__(self, depth: int = 101, num_classes: int = 31, feat_dim: int = 1024,
                 relation_stages: int = 2, advanced_stages: int = 0, advanced_num: int = 15,
                 ref_post_nms: int = 75, pre_nms: int = 2000, post_nms: int = 300,
                 joint: bool = False, res5_dilation: int = 1,
                 pixel_attend_local: bool = False, compute_dtype=torch.float32):
        super().__init__()
        if pixel_attend_local and relation_stages == 0:
            raise NotImplementedError(PIXEL_REFUSAL)
        self.num_classes, self.feat_dim = num_classes, feat_dim
        self.relation_stages = relation_stages
        self.compute_dtype = compute_dtype
        self.detector = GeneralizedRCNN(
            depth=depth, num_classes=num_classes, pre_nms_test=pre_nms,
            post_nms_test=post_nms, ref_post_nms=ref_post_nms,
            res5_dilation=res5_dilation, compute_dtype=compute_dtype, with_predictor=False)
        self.reduce = Linear(2048, feat_dim, dtype=compute_dtype)
        self.relation = RelationStack(num_stages=relation_stages, feat_dim=feat_dim,
                                      joint=joint, advanced_stages=advanced_stages,
                                      advanced_num=advanced_num, group_size=ref_post_nms,
                                      dtype=compute_dtype)
        self.predictor = FastRCNNPredictor(feat_dim, num_classes)

    def reset_parameters(self, gen: torch.Generator):
        self.detector.reset_parameters(gen)
        reset_head_parameters(self, gen)
        for m in self.modules():
            if isinstance(m, RelationAttention):
                m.reset_parameters(gen)

    def pooled(self, feat, boxes):
        """[B, R, 2048] box features → relu(reduce) [B, R, 1024]."""
        return F.relu(self.reduce(self.detector.box_features(feat, boxes)))

    def _frames(self, cur_images, ref_images, image_hw):
        """One trunk pass over [cur, refs]; the current frame's proposals
        and pooled features, and the references' (75 a frame, flattened)."""
        feats = self.detector.features(torch.cat([cur_images, ref_images], 0))
        cur_feat, ref_feat = feats[:1], feats[1:]
        props = self.detector.proposals(cur_feat, image_hw)
        ref_props = self.detector.proposals(ref_feat, image_hw, ref=True)
        cur_x = self.pooled(cur_feat, props.boxes)[0]
        ref_x = self.pooled(ref_feat, ref_props.boxes).reshape(-1, self.feat_dim)
        return (props, cur_x, ref_x, ref_props.boxes.reshape(-1, 4),
                ref_props.valid.reshape(-1))

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
    optional per-stage memory rings."""

    ref_slots = 75   # reference proposals pushed a frame (the JAX package's constant)

    def __init__(self, *args, memory_size: int = 750, use_stage_mem: bool = False,
                 mem_frames: int = 25, pixel_attend_global: bool = False, **kw):
        if pixel_attend_global:
            raise NotImplementedError(PIXEL_REFUSAL)
        kw.setdefault("joint", True)
        super().__init__(*args, **kw)
        self.memory_size = memory_size
        self.use_stage_mem = use_stage_mem
        self.mem_frames = mem_frames
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

    def memory_features(self, images, image_hw):
        """Global frames → their 75 reference proposals each → pooled
        features [F*75, D] and validity [F*75]."""
        feat = self.detector.features(images)
        props = self.detector.proposals(feat, image_hw, ref=True)
        x = self.pooled(feat, props.boxes)
        return x.reshape(-1, self.feat_dim), props.valid.reshape(-1)

    def update_memory(self, state: MegaState, feats, valid) -> MegaState:
        """The valid features, compacted to a prefix in order, merged into
        the global memory."""
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        return state._replace(
            mem=update_erase_memory(state.mem, feats[order], int(valid.sum())))

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


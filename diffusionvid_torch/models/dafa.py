"""DAFA: Sparse R-CNN with temporal feature aggregation, at inference.

Port of ``diffusionvid_tpu/models/dafa.py`` (the reference's
``sparse_rcnn_dafa.py``, the AP50-84.5 predecessor of DiffusionVID): a
ResNet + FPN trunk, learned proposal boxes and features, and six
``RCNNHead`` stages without time (``use_time=False``), each pooling with
kernel K1 and interacting through kernel K2 on the card.  Before each of
the last ``res_stage`` stages the proposal features attend over the
FPS-deduplicated memory of the global frames' top-75 features
(``extract_topk`` → ``update_memory``).  ``train_loss`` is ROADMAP.md A7.5.

Names follow the JAX package's tree: ``backbone`` (detectron2's FPN module
with the trunk as ``bottom_up``), ``heads.{i}`` (the JAX package's
``head{i}``), ``temporal_attn`` and the two learned proposal tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..ops.memory import FeatureMemory, init_memory, update_erase_memory
from .fpn import FPN
from .heads import MultiheadAttention, RCNNHead, reset_head_parameters
from .resnet import ResNet

_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class DafaState(NamedTuple):
    mem: FeatureMemory


class SparseRCNNDAFA(nn.Module):
    """Sparse R-CNN + temporal feature aggregation.  Parameters float32;
    activations in ``compute_dtype``."""

    def __init__(self, depth: int = 101, num_classes: int = 30, num_proposals: int = 100,
                 hidden_dim: int = 256, num_stages: int = 6, top_k: int = 75,
                 memory_size: int = 750, res_stage: int = 1,
                 fpn_in=("res3", "res4", "res5"), head_levels=("p3", "p4", "p5"),
                 pixel_mean=(123.675, 116.280, 103.530), pixel_std=(58.395, 57.120, 57.375),
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.hidden_dim, self.num_stages, self.top_k = hidden_dim, num_stages, top_k
        self.memory_size, self.res_stage = memory_size, res_stage
        self.head_levels = tuple(head_levels)
        self.compute_dtype = compute_dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)
        self.backbone = FPN(ResNet(depth, out_features=fpn_in), fpn_in,
                            [_CHANNELS[k] for k in fpn_in], hidden_dim)
        self.heads = nn.ModuleList([
            RCNNHead(d_model=hidden_dim, num_classes=num_classes, use_time=False,
                     dtype=compute_dtype) for _ in range(num_stages)])
        self.temporal_attn = MultiheadAttention(hidden_dim, 8, compute_dtype)
        self.init_proposal_boxes = nn.Parameter(
            torch.tensor([0.5, 0.5, 1.0, 1.0]).repeat(num_proposals, 1))
        self.init_proposal_features = nn.Parameter(torch.zeros(num_proposals, hidden_dim))

    def reset_parameters(self, gen: torch.Generator):
        """The JAX package's initializers: He trunk and FPN, the decoder's
        xavier weights, proposal boxes the whole image, proposal features
        normal(0.02)."""
        self.backbone.reset_parameters(gen)
        reset_head_parameters(self, gen)
        with torch.no_grad():
            self.init_proposal_boxes.copy_(torch.tensor([0.5, 0.5, 1.0, 1.0]).repeat(
                self.num_proposals, 1))
            self.init_proposal_features.normal_(0.0, 0.02, generator=gen)

    @property
    def spatial_scales(self):
        return tuple(1.0 / (2 ** int(lvl[1:])) for lvl in self.head_levels)

    def features(self, images):
        """images [B, H, W, 3] in 0..255 → the head levels' NHWC maps."""
        x = ((images - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        pyr = self.backbone(self.backbone.bottom_up(x.permute(0, 3, 1, 2)))
        return [pyr[lvl].permute(0, 2, 3, 1).contiguous() for lvl in self.head_levels]

    def _learned_proposals(self, batch: int, whwh):
        """The learned boxes (cxcywh in [0, 1]) as absolute xyxy and the
        learned features, tiled over the batch."""
        cx, cy, w, h = self.init_proposal_boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        boxes = boxes * whwh[None, :]
        feats = self.init_proposal_features.to(self.compute_dtype)
        return (boxes[None].expand(batch, -1, -1).contiguous(),
                feats[None].expand(batch, -1, -1))

    def init_state(self) -> DafaState:
        return DafaState(init_memory(self.memory_size, self.hidden_dim,
                                     device=self.init_proposal_features.device))

    def extract_topk(self, images, whwh):
        """Reference frames → every stage → the top ``top_k`` proposal
        features of each frame by their best class logit, ``[F*k, D]``."""
        feats = self.features(images)
        boxes, pro = self._learned_proposals(images.shape[0], whwh)
        logits = None
        for head in self.heads:
            logits, pred, pro = head(feats, self.spatial_scales, boxes, pro, None)
            boxes = pred.detach()
        score = logits.amax(-1)
        k = min(self.top_k, self.num_proposals)
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k]
        sel = torch.gather(pro, 1, idx[..., None].expand(-1, -1, pro.shape[-1]))
        return sel.reshape(-1, self.hidden_dim)

    def update_memory(self, state: DafaState, feats) -> DafaState:
        return DafaState(update_erase_memory(state.mem, feats, feats.shape[0]))

    def forward(self, images, whwh, state: DafaState = None):
        """Stacked per-stage float32 (logits [S, B, N, K], boxes [S, B, N, 4]).
        With ``state``, the last ``res_stage`` stages (at least one) are
        each preceded by attention over the memory (DAFA-G: two)."""
        feats = self.features(images)
        b = images.shape[0]
        boxes, pro = self._learned_proposals(b, whwh)
        inter_logits, inter_boxes = [], []
        first_agg = self.num_stages - max(1, self.res_stage)
        for si, head in enumerate(self.heads):
            if state is not None and si >= first_agg:
                mem_mask = torch.arange(self.memory_size, device=pro.device) < state.mem.count
                q = pro.reshape(1, -1, self.hidden_dim)
                kv = state.mem.feats[None].to(q.dtype)
                att = self.temporal_attn(q, kv, kv, key_mask=mem_mask[None])
                pro = pro + att.reshape(b, -1, self.hidden_dim)
            logits, pred, pro = head(feats, self.spatial_scales, boxes, pro, None)
            inter_logits.append(logits)
            inter_boxes.append(pred)
            boxes = pred.detach()
        return torch.stack(inter_logits).float(), torch.stack(inter_boxes).float()

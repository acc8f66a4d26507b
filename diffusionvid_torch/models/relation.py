"""Relation-network attention: the RDN/MEGA proposal-interaction core.

Port of ``diffusionvid_tpu/models/relation.py:23-234`` (the reference's
``AttentionExtractor``, roi_box_feature_extractors.py:130-243): the
rank-geometry position embedding (log-scale centre and size offsets →
sinusoidal embedding → a learned per-group bias) and grouped multi-head
attention with logits ``log(bias + 1e-6) + qk/sqrt(d)``, stacked with a
residual and an FC a stage (RDN), jointly over the current and reference
proposals with per-stage memories (MEGA), or with RDN's advanced
distillation stages.

Parameters keep the JAX package's names (``fc{i}``, ``attn{i}.Wq``,
``attn{i}.Wg_weight`` ...), so its tree carries over by renaming only.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .heads import Linear


def _abs(x):
    """``|x|`` with the JAX package's gradient at 0 (``jnp.abs``: +1;
    ``torch.abs``: 0).  In training a current proposal and the same box
    among the current frame's reference proposals have equal centres, and
    the reference box takes the gradient of that offset."""
    return torch.where(x >= 0, x, -x)


def position_matrix(boxes, ref_boxes):
    """[N, M, 4] log-scale geometry features (+1 width convention; a
    degenerate box's width and height clamp at 1e-3)."""
    def parts(b):
        w = (b[:, 2] - b[:, 0] + 1.0).clamp(min=1e-3)
        h = (b[:, 3] - b[:, 1] + 1.0).clamp(min=1e-3)
        return w, h, 0.5 * (b[:, 0] + b[:, 2]), 0.5 * (b[:, 1] + b[:, 3])

    w, h, cx, cy = parts(boxes)
    wr, hr, cxr, cyr = parts(ref_boxes)
    dx = torch.log(_abs((cx[:, None] - cxr[None, :]) / w[:, None]) + 1e-3)
    dy = torch.log(_abs((cy[:, None] - cyr[None, :]) / h[:, None]) + 1e-3)
    dw = torch.log(w[:, None] / wr[None, :])
    dh = torch.log(h[:, None] / hr[None, :])
    return torch.stack([dx, dy, dw, dh], -1)


def position_embedding(pos_mat, feat_dim: int = 64, wave_length: float = 1000.0):
    """[N, M, feat_dim] sinusoidal embedding of ``position_matrix``."""
    n_freq = feat_dim // 8
    rng = torch.arange(n_freq, dtype=torch.float32, device=pos_mat.device)
    dim_mat = wave_length ** (8.0 / feat_dim * rng)
    div = (pos_mat[..., None] * 100.0) / dim_mat
    emb = torch.cat([torch.sin(div), torch.cos(div)], -1)
    return emb.reshape(*pos_mat.shape[:2], feat_dim)


class RelationAttention(nn.Module):
    """One grouped relation-attention layer (attention_module_multi_head).
    ``geometry`` False builds no ``Wg``: the geometry-free calls (MEGA's
    ``global_lm``) pass no embedding."""

    def __init__(self, feat_dim: int = 1024, groups: int = 16, emb_dim: int = 64,
                 geometry: bool = True, dtype=torch.float32):
        super().__init__()
        self.feat_dim, self.groups, self.emb_dim = feat_dim, groups, emb_dim
        dg = feat_dim // groups
        self.Wq = Linear(feat_dim, feat_dim, bias=False, dtype=dtype)
        self.Wk = Linear(feat_dim, feat_dim, bias=False, dtype=dtype)
        if geometry:
            self.Wg_weight = nn.Parameter(torch.empty(groups, emb_dim))
            self.Wg_bias = nn.Parameter(torch.zeros(groups))
        self.Wv_weight = nn.Parameter(torch.empty(groups, feat_dim, dg))
        self.Wv_bias = nn.Parameter(torch.zeros(feat_dim))

    def reset_parameters(self, gen: torch.Generator):
        """Wg and Wv normal(0.01), their biases zero (the JAX package's
        initializers)."""
        with torch.no_grad():
            for name in ("Wg_weight", "Wv_weight"):
                if hasattr(self, name):
                    getattr(self, name).normal_(0.0, 0.01, generator=gen)

    def forward(self, roi_feat, ref_feat, pos_emb, ref_valid=None):
        """roi_feat [N, D]; ref_feat [M, D]; pos_emb [N, M, emb_dim] or None;
        ref_valid [M] bool → [N, D] in roi_feat's dtype."""
        d, g = self.feat_dim, self.groups
        dg = d // g
        q = self.Wq(roi_feat).reshape(-1, g, dg)
        k = self.Wk(ref_feat).reshape(-1, g, dg)
        aff = torch.einsum("ngd,mgd->nmg", q.float(), k.float()) / math.sqrt(dg)
        if pos_emb is not None:
            bias = F.relu(torch.einsum("nme,ge->nmg", pos_emb.float(), self.Wg_weight)
                          + self.Wg_bias)
            logits = torch.log(bias + 1e-6) + aff
        else:
            logits = aff
        if ref_valid is not None:
            logits = torch.where(ref_valid[None, :, None], logits,
                                 torch.full_like(logits, -1e9))
        att = torch.softmax(logits, 1)
        out = torch.einsum("nmg,md->ngd", att.to(ref_feat.dtype), ref_feat)
        proj = torch.einsum("ngd,gde->nge", out.float(), self.Wv_weight)
        return (proj.reshape(-1, d) + self.Wv_bias).to(roi_feat.dtype)


class RelationStack(nn.Module):
    """Stacked relation attention with residual + FC
    (roi_box_feature_extractors.py:281-488).  ``joint`` is MEGA's test-time
    co-refinement: the current and reference proposals advance together
    through each stage, so later stages key on stage-refined references;
    otherwise (RDN) only the queries advance.  ``advanced_stages`` is RDN's
    distillation: the top ``advanced_num`` proposals of each
    ``group_size`` reference frame are refined over the whole reference
    set, then the queries attend once over them."""

    def __init__(self, num_stages: int = 2, feat_dim: int = 1024, groups: int = 16,
                 emb_dim: int = 64, joint: bool = False, advanced_stages: int = 0,
                 advanced_num: int = 15, group_size: int = 75, dtype=torch.float32):
        super().__init__()
        self.num_stages, self.feat_dim, self.emb_dim = num_stages, feat_dim, emb_dim
        self.joint = joint
        self.advanced_stages, self.advanced_num = advanced_stages, advanced_num
        self.group_size = group_size
        n_fc = num_stages + advanced_stages
        n_attn = num_stages + (advanced_stages + 1 if advanced_stages > 0 else 0)
        for i in range(n_fc):
            self.add_module(f"fc{i}", Linear(feat_dim, feat_dim, dtype=dtype))
        for i in range(n_attn):
            self.add_module(f"attn{i}", RelationAttention(feat_dim, groups, emb_dim,
                                                          dtype=dtype))

    def _fc(self, i, x):
        return F.relu(getattr(self, f"fc{i}")(x))

    def forward(self, feat, ref_feat, boxes, ref_boxes, ref_valid=None, extra_kv=None,
                extra_valid=None, stage_kv=None, stage_valid=None,
                return_stage_refs: bool = False):
        """feat [N, D] queries; ref_feat [M, D]; boxes / ref_boxes their
        geometry; ``extra_kv`` [K, D] geometry-free memory keys added to every
        stage's keys; ``stage_kv`` [S, K2, D] / ``stage_valid`` [S, K2]
        (joint only) stage i's own memory keys; ``return_stage_refs`` also
        returns the stage-refined references [S, M, D]."""
        n, m = feat.shape[0], ref_feat.shape[0]
        if ref_valid is None:
            ref_valid = torch.ones(m, dtype=torch.bool, device=feat.device)
        n_extra = 0 if extra_kv is None else extra_kv.shape[0]
        n_stage = 0 if stage_kv is None else stage_kv.shape[1]
        neutral = torch.tensor([[0.0, 0.0, 1.0, 1.0]], device=feat.device).expand(
            n_extra + n_stage, 4)
        key_boxes = torch.cat([ref_boxes, neutral], 0)
        key_valid = torch.cat([ref_valid] + ([extra_valid] if extra_kv is not None else []), 0)

        if self.joint:
            pos = position_embedding(position_matrix(torch.cat([boxes, ref_boxes], 0),
                                                     key_boxes), self.emb_dim)
            x = torch.cat([feat, ref_feat], 0)
            stage_refs = []
            for i in range(self.num_stages):
                x = self._fc(i, x)
                keys, kv_valid = [x[n:]], key_valid
                if extra_kv is not None:
                    keys.append(extra_kv)
                if stage_kv is not None:
                    keys.append(stage_kv[i])
                    kv_valid = torch.cat([kv_valid, stage_valid[i]], 0)
                x = x + getattr(self, f"attn{i}")(x, torch.cat(keys, 0), pos, kv_valid)
                stage_refs.append(x[n:])
            if return_stage_refs:
                return x[:n], torch.stack(stage_refs)
            return x[:n]

        pos = position_embedding(position_matrix(boxes, key_boxes), self.emb_dim)
        x = feat
        keys = ref_feat if extra_kv is None else torch.cat([ref_feat, extra_kv], 0)
        for i in range(self.num_stages):
            x = self._fc(i, x)
            x = x + getattr(self, f"attn{i}")(x, keys, pos, key_valid)

        if self.advanced_stages > 0:
            gs, k, d = self.group_size, self.advanced_num, self.feat_dim
            nl = m // gs
            adv = ref_feat.reshape(nl, gs, d)[:, :k].reshape(nl * k, d)
            adv_boxes = ref_boxes.reshape(nl, gs, 4)[:, :k].reshape(nl * k, 4)
            adv_valid = ref_valid.reshape(nl, gs)[:, :k].reshape(nl * k)
            pos_adv = position_embedding(position_matrix(adv_boxes, ref_boxes), self.emb_dim)
            for i in range(self.advanced_stages):
                j = self.num_stages + i
                att = getattr(self, f"attn{j}")(adv, ref_feat, pos_adv, ref_valid)
                adv = self._fc(j, adv + att)
            pos_cur_adv = (pos[:, :m].reshape(n, nl, gs, self.emb_dim)[:, :, :k]
                           .reshape(n, nl * k, self.emb_dim))
            j = self.num_stages + self.advanced_stages
            x = x + getattr(self, f"attn{j}")(x, adv, pos_cur_adv, adv_valid)
        return x

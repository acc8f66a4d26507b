"""DiffusionDet decoder (DynamicHead) in PyTorch.

Port of ``diffusionvid_tpu/models/heads.py``: ``RCNNHead`` stages
(self-attention over proposals → DynamicConv → FFN → time FiLM → cls/reg
towers → box deltas), the conditioned stage with its adaptive-norm shift
from the global cross-attention, the time MLP, the top-k condition
features, the local temporal attention (``ATTENTION.ENABLE``) and the
training forward over all stages.  Module names are the reference's
(``head_series.N.*``, ``time_mlp.{1,3}``, ``global_attention.N.0``, ...);
the local attention's are ``local_attention.N`` and ``local_norm.N``.

Dtype discipline follows the JAX package: parameters stay float32 and a
layer casts its weight to its compute dtype at use; mixing a float32 and a
bfloat16 operand promotes to float32 (the time embedding is float32, so
the FiLM and everything after it run in float32); LayerNorm computes in
float32 and returns its input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dynamic_conv import dynamic_conv_fused
from ..ops.roi_align import multilevel_roi_align
from ..structures.boxes import apply_deltas_diffusion


def _dense(x, weight, bias, dtype):
    """``x @ weight.T.astype(dtype) + bias.astype(dtype)`` with JAX's
    promotion: the result has the promoted dtype of ``x`` and ``dtype``."""
    rt = torch.promote_types(x.dtype, dtype)
    w = weight.to(dtype).to(rt)
    b = None if bias is None else bias.to(dtype).to(rt)
    return F.linear(x.to(rt), w, b)


def _xavier_(w, gen):
    fan_out, fan_in = w.shape[0], w.shape[1:].numel()
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=gen)


def sinusoidal_time_embedding(t, dim: int):
    """(box_head.py:729-741): exp-spaced frequencies, [sin | cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], -1)


class SinusoidalPositionEmbeddings(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_time_embedding(t, self.dim)


class Linear(nn.Module):
    """Dense layer, weight [out, in], run in ``dtype`` (promoted with x)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        return _dense(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class MultiheadAttention(nn.Module):
    """Batch-first MHA in the torch parameter layout (fused in_proj).
    Projections run in the query's dtype, scores and softmax in float32;
    masked keys get -1e9, so a row with every key masked is uniform."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def forward(self, query, key, value, key_mask=None):
        """query [B, Lq, D]; key/value [B, Lk, D]; key_mask [B, Lk] bool."""
        d, h = self.d_model, self.num_heads
        dh = d // h
        dt = query.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        b, lq, _ = query.shape
        lk = key.shape[1]
        q = F.linear(query, wq, bq).view(b, lq, h, dh).transpose(1, 2)
        k = F.linear(key, wk, bk).view(b, lk, h, dh).transpose(1, 2)
        v = F.linear(value, wv, bv).view(b, lk, h, dh).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], -1e9)
        attn = torch.softmax(logits, -1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, d)
        return self.out_proj(out)


class DynParamLinear(Linear):
    """The DynamicConv parameter generator: one ``Linear`` (torch rows in
    (half, d, dd) order) applied as two products whose outputs come out
    e-major, ``p1t`` and ``p2e`` both ``[S, dd, d]``: the first half's rows
    are permuted (d, dd) → (dd, d) at use, the second half is e-major as
    stored."""

    def __init__(self, in_features: int, d: int, dd: int, dtype=torch.float32):
        super().__init__(in_features, 2 * d * dd, dtype=dtype)
        self.d, self.dd = d, dd

    def forward(self, x):
        d, dd = self.d, self.dd
        h = d * dd
        w, b = self.weight, self.bias
        w1 = w[:h].reshape(d, dd, -1).transpose(0, 1).reshape(h, -1)
        b1 = b[:h].reshape(d, dd).t().reshape(h)
        p1t = _dense(x, w1, b1, self.dtype).reshape(-1, dd, d)
        p2e = _dense(x, w[h:], b[h:], self.dtype).reshape(-1, dd, d)
        return p1t, p2e


class DynamicConv(nn.Module):
    """Instance interaction (box_head.py:666-711): two per-proposal dynamic
    projections over the 49 pooled positions (kernel K2), then the
    out-projection of the flattened row-major (py, px, c) features."""

    def __init__(self, hidden_dim: int = 256, dim_dynamic: int = 64,
                 pooler_resolution: int = 7, dtype=torch.float32):
        super().__init__()
        self.dynamic_layer = DynParamLinear(hidden_dim, hidden_dim, dim_dynamic, dtype)
        self.norm1 = LayerNorm(dim_dynamic)
        self.norm2 = LayerNorm(hidden_dim)
        self.out_layer = Linear(hidden_dim * pooler_resolution ** 2, hidden_dim, dtype=dtype)
        self.norm3 = LayerNorm(hidden_dim)

    def forward(self, pro_features, roi_features):
        """pro_features [S, D]; roi_features [S, 49, D] → [S, D]."""
        p1t, p2e = self.dynamic_layer(pro_features)
        x = dynamic_conv_fused(roi_features, p1t, p2e, self.norm1.weight,
                               self.norm1.bias, self.norm2.weight, self.norm2.bias)
        x = self.out_layer(x.reshape(x.shape[0], -1))
        return F.relu(self.norm3(x))


def _tower(d: int, n: int, dtype):
    """torch ModuleList [Linear(no bias), LayerNorm, ReLU] x n."""
    mods = []
    for _ in range(n):
        mods += [Linear(d, d, bias=False, dtype=dtype), LayerNorm(d), nn.ReLU()]
    return nn.ModuleList(mods)


class RCNNHead(nn.Module):
    """One decoder stage (box_head.py:438-548); ``conditioned=True`` is
    RCNNHead_cond (box_head.py:593-664): the FiLM shift comes from the
    temporal cross-attention output."""

    def __init__(self, d_model: int = 256, num_classes: int = 30,
                 dim_feedforward: int = 2048, num_heads: int = 8,
                 num_cls: int = 1, num_reg: int = 3, pooler_resolution: int = 7,
                 sampling_ratio: int = 2, conditioned: bool = False,
                 prior_prob: float = 0.01, dtype=torch.float32):
        super().__init__()
        d = d_model
        self.d_model = d
        self.pooler_resolution, self.sampling_ratio = pooler_resolution, sampling_ratio
        self.conditioned, self.prior_prob = conditioned, prior_prob
        self.self_attn = MultiheadAttention(d, num_heads, dtype)
        self.inst_interact = DynamicConv(d, pooler_resolution=pooler_resolution, dtype=dtype)
        self.linear1 = Linear(d, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d, dtype=dtype)
        self.norm1, self.norm2, self.norm3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)
        self.block_time_mlp = nn.Sequential(
            nn.SiLU(), Linear(4 * d, d if conditioned else 2 * d, dtype=dtype))
        if conditioned:
            self.c_mlp = nn.Sequential(nn.SiLU(), Linear(d, d, dtype=dtype))
        self.cls_module = _tower(d, num_cls, dtype)
        self.reg_module = _tower(d, num_reg, dtype)
        self.class_logits = nn.Linear(d, num_classes)
        self.bboxes_delta = Linear(d, 4, dtype=dtype)

    def forward(self, features, spatial_scales, bboxes, pro_features, time_emb,
                cond=None):
        """features: list of [B, Hl, Wl, C] maps; bboxes [B, N, 4] xyxy;
        pro_features [B, N, D] or None; time_emb [B, 4D]; cond [B, N, D].
        Returns (class_logits [B, N, K], pred_boxes [B, N, 4] float32,
        obj_features [B, N, D])."""
        d = self.d_model
        b, n = bboxes.shape[:2]
        roi = multilevel_roi_align(features, bboxes, spatial_scales,
                                   self.pooler_resolution, self.sampling_ratio)
        roi = roi.reshape(b * n, self.pooler_resolution ** 2, d)
        if pro_features is None:
            pro_features = roi.mean(1).reshape(b, n, d)

        attn_out = self.self_attn(pro_features, pro_features, pro_features)
        x = self.norm1(pro_features + attn_out)
        inter = self.inst_interact(x.reshape(b * n, d), roi)
        x = self.norm2(x + inter.reshape(b, n, d))
        y = self.linear2(F.relu(self.linear1(x)))
        obj_features = self.norm3(x + y)

        fc = obj_features.reshape(b * n, d)
        if self.conditioned:
            scale = self.block_time_mlp(time_emb).repeat_interleave(n, 0)
            shift = self.c_mlp(cond.reshape(b * n, d))
        else:
            ss = self.block_time_mlp(time_emb).repeat_interleave(n, 0)
            scale, shift = ss.chunk(2, -1)
        fc = fc * (scale + 1.0) + shift

        cls_feat = fc
        for m in self.cls_module:
            cls_feat = m(cls_feat)
        reg_feat = fc
        for m in self.reg_module:
            reg_feat = m(reg_feat)
        # the class projection runs in its input's dtype (heads.py:350)
        class_logits = _dense(cls_feat, self.class_logits.weight,
                              self.class_logits.bias, cls_feat.dtype)
        deltas = self.bboxes_delta(reg_feat)
        pred = apply_deltas_diffusion(deltas.float().reshape(b, n, 4), bboxes)
        return class_logits.reshape(b, n, -1), pred, obj_features


class DynamicHead(nn.Module):
    """The decoder stack (box_head.py:156-435): ``num_heads`` shared stages,
    ``num_heads_local`` conditioned stages, ``global_stages`` global
    cross-attention layers, ``local_stages`` local attention layers
    (ATTENTION.ENABLE/STAGE, box_head.py:184-194) and the time MLP."""

    def __init__(self, num_classes: int = 30, d_model: int = 256,
                 dim_feedforward: int = 2048, nheads: int = 8,
                 num_heads: int = 3, num_heads_local: int = 1, num_cls: int = 1,
                 num_reg: int = 3, pooler_resolution: int = 7,
                 sampling_ratio: int = 2, global_stages: int = 1,
                 global_enable: bool = True, local_stages: int = 0, top_k=(75, 25),
                 prior_prob: float = 0.01, p_uncond: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.d_model, self.top_k = d_model, tuple(top_k)
        self.p_uncond = p_uncond
        self.global_stages, self.global_enable = global_stages, global_enable
        kw = dict(d_model=d_model, num_classes=num_classes,
                  dim_feedforward=dim_feedforward, num_heads=nheads,
                  num_cls=num_cls, num_reg=num_reg,
                  pooler_resolution=pooler_resolution,
                  sampling_ratio=sampling_ratio, prior_prob=prior_prob, dtype=dtype)
        self.head_series = nn.ModuleList([RCNNHead(**kw) for _ in range(num_heads)])
        self.head_series_cond = nn.ModuleList(
            [RCNNHead(**kw, conditioned=True) for _ in range(num_heads_local)])
        # the global cross-attention runs only in ``condition``, which needs a
        # conditioned stage; the JAX head creates its parameters only there
        self.global_attention = nn.ModuleList(
            [nn.ModuleList([MultiheadAttention(d_model, nheads, dtype)])
             for _ in range(global_stages if global_enable and num_heads_local > 0 else 0)])
        # the local chain: one MultiheadAttention and one LayerNorm a stage
        n_local = local_stages if num_heads_local > 0 else 0
        self.local_attention = nn.ModuleList(
            [MultiheadAttention(d_model, nheads, dtype) for _ in range(n_local)])
        self.local_norm = nn.ModuleList([LayerNorm(d_model) for _ in range(n_local)])
        self.time_mlp = nn.Sequential(
            SinusoidalPositionEmbeddings(d_model),
            Linear(d_model, 4 * d_model, dtype=dtype), nn.GELU(),
            Linear(4 * d_model, 4 * d_model, dtype=dtype))

    def reset_parameters(self, gen: torch.Generator):
        """The JAX package's initializers: xavier-uniform weights, zero
        biases, LayerNorm at identity, the class bias at the focal prior."""
        for m in self.modules():
            if isinstance(m, (Linear, nn.Linear)):
                _xavier_(m.weight, gen)
                if m.bias is not None:
                    with torch.no_grad():
                        m.bias.zero_()
            elif isinstance(m, MultiheadAttention):
                _xavier_(m.in_proj_weight, gen)
                with torch.no_grad():
                    m.in_proj_bias.zero_()
        for m in self.modules():
            if isinstance(m, RCNNHead):
                with torch.no_grad():
                    m.class_logits.bias.fill_(-math.log((1 - m.prior_prob) / m.prior_prob))

    def shared_stages(self, features, spatial_scales, bboxes, t):
        """Run the shared stages → per-stage logits and boxes, the last
        proposal features [B, N, D] and the time embedding."""
        time_emb = self.time_mlp(t)
        inter_logits, inter_boxes = [], []
        pro_features = None
        for head in self.head_series:
            logits, pred, pro_features = head(features, spatial_scales, bboxes,
                                              pro_features, time_emb)
            inter_logits.append(logits)
            inter_boxes.append(pred)
            bboxes = pred.detach()
        return inter_logits, inter_boxes, pro_features, time_emb

    def topk_features(self, class_logits, pro_features):
        """Top-k condition features per frame (box_head.py:304-317) →
        ([B, k1, D], [B, k2, D]); the k2 are the best k2 of the k1."""
        k1, k2 = self.top_k
        score = class_logits.amax(-1)
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k1]
        feats = torch.gather(pro_features, 1,
                             idx[..., None].expand(-1, -1, pro_features.shape[-1]))
        return feats, feats[:, :k2]

    def condition(self, features, spatial_scales, bboxes, pro_features, t,
                  memory, memory_mask, memory_dis=None, memory_dis_mask=None,
                  null=None, local_kv=None):
        """Local and global cross-attention, then the conditioned stage(s).
        pro_features [B, N, D]; memory [M, D] with validity ``memory_mask``
        [M].  ``local_kv``: the local keys, a sequence of [K_i, D] (at test
        the chunk's top-75 and top-25 features); stage i of the local chain
        keys on ``local_kv[min(i, len - 1)]``, with a LayerNorm and no
        residual, and the last stage's output is the condition unless the
        global attention overwrites it (box_head.py:359-394).  In training,
        ``null`` [B] bool nulls the condition of those frames
        (classifier-free guidance, box_head.py:386-394)."""
        b, n, d = pro_features.shape
        time_emb = self.time_mlp(t)
        query = pro_features.reshape(1, b * n, d)
        attn = None
        if len(self.local_attention) and local_kv is not None:
            for i, (mha, norm) in enumerate(zip(self.local_attention, self.local_norm)):
                lkv = local_kv[min(i, len(local_kv) - 1)][None].to(query.dtype)
                attn = norm(mha(query, lkv, lkv))
        if self.global_enable:
            attn = self._global_chain(query, memory, memory_mask, memory_dis,
                                      memory_dis_mask, b, n, d)
        elif attn is None:
            raise ValueError("conditioned stages need a conditioning signal: enable "
                             "GLOBAL.ENABLE or pass local_kv with ATTENTION.ENABLE")
        else:
            attn = attn.reshape(b, n, d)
        if null is not None:
            attn = attn.masked_fill(null[:, None, None], 0.0)
        inter_logits, inter_boxes = [], []
        for head in self.head_series_cond:
            logits, pred, pro_features = head(features, spatial_scales, bboxes,
                                              pro_features, time_emb, cond=attn)
            inter_logits.append(logits)
            inter_boxes.append(pred)
            bboxes = pred.detach()
        return inter_logits, inter_boxes, pro_features

    def forward(self, features, spatial_scales, bboxes, t, num_global: int, null):
        """Training forward (box_head.py:273-435).  ``bboxes`` [B, N, 4] noisy
        boxes for B = 1 current + ``num_global`` frames (with the local
        attention: the current frame and the local refs first); the global
        kv is the top-k features of the trailing ``num_global`` frames, with
        their gradient; ``null`` [B] bool is the classifier-free-guidance
        null mask.  With the local attention, the first ``nl = min(3, B)``
        frames' top-k features key the local chain, the conditioned stage
        runs on those frames only and every stage's outputs are sliced to
        them (box_head.py:325-346, 429-431).  Returns the stacked logits
        [S, nl or B, N, K] and boxes [S, nl or B, N, 4] of every stage."""
        inter_logits, inter_boxes, pro, _ = self.shared_stages(
            features, spatial_scales, bboxes, t)
        if len(self.head_series_cond) == 0:
            return torch.stack(inter_logits), torch.stack(inter_boxes)
        k1, _ = self.topk_features(inter_logits[-1], pro)
        kv = k1[-num_global:] if num_global > 0 else k1
        kv = kv.reshape(-1, self.d_model)
        kv_mask = torch.ones(kv.shape[0], dtype=torch.bool, device=kv.device)
        last_boxes = inter_boxes[-1].detach()
        if len(self.local_attention) == 0:
            cond_logits, cond_boxes, _ = self.condition(
                features, spatial_scales, last_boxes, pro, t, kv, kv_mask, null=null)
            return (torch.stack(inter_logits + cond_logits),
                    torch.stack(inter_boxes + cond_boxes))
        nl = min(3, k1.shape[0])
        local_kv = (k1[:nl].reshape(-1, self.d_model),)
        cond_logits, cond_boxes, _ = self.condition(
            [f[:nl] for f in features], spatial_scales, last_boxes[:nl], pro[:nl], t[:nl],
            kv, kv_mask, null=None if null is None else null[:nl], local_kv=local_kv)
        return (torch.stack([x[:nl] for x in inter_logits] + cond_logits),
                torch.stack([x[:nl] for x in inter_boxes] + cond_boxes))

    def _global_chain(self, query, memory, memory_mask, memory_dis,
                      memory_dis_mask, b, n, d):
        kv = memory[None].to(query.dtype)
        if self.global_stages >= 2:
            if memory_dis is None:
                memory_dis, memory_dis_mask = memory, memory_mask
            q_cat = torch.cat([query, memory_dis[None].to(query.dtype)], 1)
            a0 = self.global_attention[0][0](q_cat, kv, kv, key_mask=memory_mask[None])
            refined = q_cat + a0
            kv2 = refined[:, b * n:]
            attn = self.global_attention[1][0](refined[:, : b * n], kv2, kv2,
                                               key_mask=memory_dis_mask[None])
        else:
            attn = self.global_attention[0][0](query, kv, kv, key_mask=memory_mask[None])
        return attn.reshape(b, n, d)

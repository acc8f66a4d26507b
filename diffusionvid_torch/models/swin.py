"""Swin Transformer trunk, NHWC, in the reference's layout.

Port of ``diffusionvid_tpu/models/swin.py``.  ``kernel_mode`` mirrors the
JAX package's ``DIFFUSIONVID_SWIN_KERNEL`` (the port reads no environment
variable) and chooses the branch of every ``SwinBlock``:

- ``"v3"`` (inference): roll the residual stream by the shift, one fused
  attention half-block (kernel K4: LN1, pad-zero in rolled coordinates,
  window attention with the relative-position bias and the SW-MSA mask,
  out-projection, residual), unroll, one fused MLP half-block (kernel K5);
- ``"v2"`` and ``"v1"``: the JAX package's unfused branch (LN1, pad-zero in
  unrolled coordinates, roll, window attention, unroll, residual, LN2, fc1,
  exact GELU, fc2, residual), whose window attention is kernel K6 with the
  qkv projection inside (``v2``) or the projection as three linears and
  kernel K7 (``v1``).

A forward that needs a gradient (grad enabled and the input or a parameter
requiring one) takes ``v2`` whatever the mode, through K6's autograd
function, as the JAX package's ``use_kernel ... (not train or kernel_mode ==
"v2")`` does.  Drop path is not ported: no JAX entry point reaches it (its
train step runs the trunk with ``train=False``).

The stage loop pads each stage's map to window multiples once and crops it
after the last block.  Module names are the reference's
(``patch_embed.{proj,norm}``, ``layers.{s}.blocks.{i}.{norm1,attn.qkv,
attn.proj,...}``, ``layers.{s}.downsample``, ``norm{s}``), so a reference
checkpoint's ``backbone.bottom_up.*`` tensors load with
``load_state_dict(strict=True)``; ``attn.relative_position_index`` is a
persistent buffer, as there.  The JAX package's W-pack-4 patch embed is the
same arithmetic as the 4x4/s4 convolution here, laid out for the TPU's lanes.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.swin_attention import swin_block_attn, swin_block_mlp
from ..ops.window_attention import WindowAttentionQKVFn, window_attention
from .heads import LayerNorm, Linear, _xavier_

SWIN_SIZES = {
    "T": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window=7),
    "S": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window=7),
    "B": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=7),
    "B-22k": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=7),
    "B-22k-384": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=12),
    "L-22k": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window=7),
    "L-22k-384": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window=12),
}
SWIN_FEATURE_STRIDES = {"swin0": 4, "swin1": 8, "swin2": 16, "swin3": 32}
KERNEL_MODES = ("v3", "v2", "v1")


def relative_position_index(w: int) -> np.ndarray:
    """[w², w²] lookup into the (2w-1)² bias table (standard Swin)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(hp: int, wp: int, w: int, shift: int) -> np.ndarray:
    """SW-MSA mask [nW, w², w²] (0 keep / -100 block)."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA with the relative-position bias: ``qkv``, ``proj``, the bias
    table and the index buffer.  ``forward`` is the JAX module's unfused
    path; in mode ``v3`` K4 computes with the parameters instead
    (``SwinBlock.forward``)."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)))

    def relative_bias(self):
        """[h, w², w²] fp32 bias gathered from the table (with its gradient)."""
        n = self.window * self.window
        table = self.relative_position_bias_table
        return (table[self.relative_position_index.reshape(-1)].reshape(n, n, -1)
                .permute(2, 0, 1).float().contiguous())

    def forward(self, x, mask, mode: str):
        """x [B, Hp, Wp, C] the post-LN1, pad-zeroed, pre-rolled map; mask
        [Hp/w, Wp/w, w², w²] or None → the out-projected attention, same
        shape.  ``v2``: K6 with its backward; ``v1``: q/k/v by three linears
        in the compute dtype, then K7 (inference only, as in JAX)."""
        dt, c = x.dtype, x.shape[-1]
        x = x.contiguous()
        bias = self.relative_bias()
        if mode == "v1":
            wd, bd = self.qkv.weight.to(dt), self.qkv.bias.to(dt)
            q, k, v = (F.linear(x, wd[i * c:(i + 1) * c], bd[i * c:(i + 1) * c])
                       for i in range(3))
            out = window_attention(q, k, v, bias, mask, self.window)
        else:
            out = WindowAttentionQKVFn.apply(x, self.qkv.weight, self.qkv.bias, bias, mask,
                                             self.window, self.num_heads)
        return F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks = {}

    def _mask(self, hp: int, wp: int, shift: int, device):
        key = (hp, wp, shift, device)
        if key not in self._masks:
            w = self.window
            m = shift_attn_mask(hp, wp, w, shift).reshape(hp // w, wp // w, w * w, w * w)
            self._masks[key] = torch.from_numpy(m).to(device)
        return self._masks[key]

    def forward(self, x, orig_hw, mode: str):
        """x [B, Hp, Wp, C] padded to window multiples; ``orig_hw`` the
        true (H, W); ``mode`` the branch (``SwinTransformer.branch``).  The
        residual stream keeps its pad region."""
        _, hp, wp, _ = x.shape
        h, wd = orig_hw
        w = self.window
        shift = self.shift if min(hp, wp) > w else 0
        mask = self._mask(hp, wp, shift, x.device) if shift else None
        if mode == "v3":
            if shift:
                x = torch.roll(x, (-shift, -shift), (1, 2))
            a = self.attn
            x = swin_block_attn(x.contiguous(), self.norm1.weight, self.norm1.bias,
                                a.qkv.weight, a.qkv.bias, a.relative_bias(), mask,
                                a.proj.weight, a.proj.bias, w, a.num_heads, orig_hw,
                                shift=shift)
            if shift:
                x = torch.roll(x, (shift, shift), (1, 2))
            m = self.mlp
            return swin_block_mlp(x.contiguous(), self.norm2.weight, self.norm2.bias,
                                  m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)
        y = self.norm1(x)
        if (hp, wp) != (h, wd):
            # zero LN1's output over the window padding, before the roll
            y = F.pad(y[:, :h, :wd], (0, 0, 0, wp - wd, 0, hp - h))
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        y = self.attn(y, mask, mode)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y
        dt, m = x.dtype, self.mlp
        z = F.gelu(F.linear(self.norm2(x), m.fc1.weight.to(dt), m.fc1.bias.to(dt)))
        return x + F.linear(z, m.fc2.weight.to(dt), m.fc2.bias.to(dt))


class PatchMerging(nn.Module):
    """2x2 concat → LN → Linear 4C→2C (no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        # torch order: (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2, 1::2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        x = self.norm(x)
        return F.linear(x, self.reduction.weight.to(x.dtype))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 mlp_ratio: float, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    """4x4/s4 convolution + LayerNorm."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(embed_dim, 3, 4, 4))
        self.proj.bias = nn.Parameter(torch.zeros(embed_dim))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        """x [B, H, W, 3] → [B, H/4, W/4, C]: the NCHW view of NHWC frames is
        channels-last, so the output's NHWC view is contiguous."""
        y = F.conv2d(x.permute(0, 3, 1, 2), self.proj.weight.to(x.dtype), stride=4)
        y = y.permute(0, 2, 3, 1) + self.proj.bias.to(x.dtype)
        return self.norm(y)


class SwinTransformer(nn.Module):
    """Four-stage Swin trunk emitting ``{"swin<s>": NHWC map}`` for ``s`` in
    ``out_indices`` (strides 4/8/16/32)."""

    def __init__(self, embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7,
                 mlp_ratio: float = 4.0, out_indices: Sequence[int] = (0, 1, 2, 3),
                 kernel_mode: str = "v3"):
        super().__init__()
        if kernel_mode not in KERNEL_MODES:
            raise ValueError(f"kernel_mode must be one of {KERNEL_MODES}, got {kernel_mode!r}")
        self.window, self.out_indices = window, tuple(out_indices)
        self.kernel_mode = kernel_mode
        self.dims = [embed_dim * 2 ** s for s in range(len(depths))]
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([
            BasicLayer(self.dims[s], depth, num_heads[s], window, mlp_ratio,
                       downsample=s < len(depths) - 1)
            for s, depth in enumerate(depths)])
        for s in self.out_indices:
            self.add_module(f"norm{s}", LayerNorm(self.dims[s]))

    @classmethod
    def from_size(cls, size: str, out_indices=(0, 1, 2, 3), kernel_mode: str = "v3"):
        c = SWIN_SIZES[size]
        return cls(embed_dim=c["embed_dim"], depths=c["depths"],
                   num_heads=c["num_heads"], window=c["window"], out_indices=out_indices,
                   kernel_mode=kernel_mode)

    def reset_parameters(self, gen: torch.Generator):
        """The JAX package's initializers: xavier-uniform linears with zero
        biases, normal(0.02) bias tables, a truncated-normal (fan-in,
        variance 1) patch embed, LayerNorm at identity."""
        for m in self.modules():
            if isinstance(m, Linear):
                _xavier_(m.weight, gen)
                if m.bias is not None:
                    with torch.no_grad():
                        m.bias.zero_()
            elif isinstance(m, WindowAttention):
                with torch.no_grad():
                    m.relative_position_bias_table.normal_(0.0, 0.02, generator=gen)
        w = self.patch_embed.proj.weight
        # variance_scaling(1, fan_in, truncated_normal): the std of the
        # normal truncated at two deviations is 1/sqrt(fan_in)
        std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        with torch.no_grad():
            self.patch_embed.proj.bias.zero_()

    def branch(self, x) -> str:
        """The mode a forward on ``x`` runs: ``v2`` when it needs a
        gradient, else ``kernel_mode``."""
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in self.parameters())):
            return "v2"
        return self.kernel_mode

    def forward(self, x):
        """x [B, H, W, 3] in the compute dtype → dict of NHWC stage maps."""
        mode = self.branch(x)
        x = self.patch_embed(x)
        outs = {}
        w = self.window
        for s, layer in enumerate(self.layers):
            h, wd = x.shape[1], x.shape[2]
            hp, wp = -(-h // w) * w, -(-wd // w) * w
            if (hp, wp) != (h, wd):          # pad once per stage, not per block
                x = F.pad(x, (0, 0, 0, wp - wd, 0, hp - h))
            for blk in layer.blocks:
                x = blk(x, (h, wd), mode)
            if (hp, wp) != (h, wd):
                x = x[:, :h, :wd]
            if s in self.out_indices:
                outs[f"swin{s}"] = getattr(self, f"norm{s}")(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs

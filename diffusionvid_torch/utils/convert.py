"""Weights carried from the JAX package's parameter tree to the port.

The JAX package stores every parameter in torch layout (conv weights
[out, in, kh, kw], linear weights [out, in], fused MHA ``in_proj``), so the
carry-over is renaming only: the inverse of the JAX package's
``utils/torch_convert.py: convert_torch_state_dict``, onto the reference's
detectron2/DiffusionDet names that the port's modules carry.

The reference's Swin checkpoints also hold each block's
``attn.relative_position_index``, a buffer the JAX package recomputes
instead of storing.  ``state_dict_from_jax`` fills it from the index
function, so the port's state dict has every tensor of a reference
checkpoint and both load with ``strict=True``.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

from ..models.swin import relative_position_index


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rcnn_head_name(path) -> str:
    """One RCNNHead-relative tree path → its torch name."""
    mod = path[0]
    if mod == "self_attn":
        return "self_attn." + ".".join(path[1:])
    if mod in ("block_time_mlp", "c_mlp"):
        return f"{mod}.1.{path[1]}"
    m = re.fullmatch(r"(cls|reg)_(module|norm)(\d+)", mod)
    if m:
        slot = 3 * int(m.group(3)) + (0 if m.group(2) == "module" else 1)
        return f"{m.group(1)}_module.{slot}.{path[1]}"
    m = re.fullmatch(r"class_logits_(weight|bias)", mod)
    if m:
        return f"class_logits.{m.group(1)}"
    return ".".join(path)   # inst_interact.*, linear1/2, norm1..3, bboxes_delta


_SWIN_ATTN = {"qkv_weight": "qkv.weight", "qkv_bias": "qkv.bias",
              "proj_weight": "proj.weight", "proj_bias": "proj.bias",
              "relative_position_bias_table": "relative_position_bias_table"}


def _swin_name(path) -> str | None:
    """One Swin-trunk tree path (below ``backbone``) → its name below
    ``backbone.bottom_up``, or None."""
    mod = path[0]
    if mod in ("patch_embed_weight", "patch_embed_bias"):
        return f"patch_embed.proj.{mod[len('patch_embed_'):]}"
    if mod == "patch_norm":
        return f"patch_embed.norm.{path[1]}"
    if re.fullmatch(r"norm\d", mod):
        return f"{mod}.{path[1]}"
    m = re.fullmatch(r"layers(\d)\.downsample", mod)
    if m:
        leaf = "reduction.weight" if path[1] == "reduction_weight" else f"norm.{path[2]}"
        return f"layers.{m.group(1)}.downsample.{leaf}"
    m = re.fullmatch(r"layers(\d)\.blocks(\d+)", mod)
    if m:
        block = f"layers.{m.group(1)}.blocks.{m.group(2)}"
        sub = path[1]
        if sub in ("norm1", "norm2"):
            return f"{block}.{sub}.{path[2]}"
        if sub == "attn":
            return f"{block}.attn.{_SWIN_ATTN[path[2]]}"
        mm = re.fullmatch(r"mlp_(fc[12])_(weight|bias)", sub)
        if mm:
            return f"{block}.mlp.{mm.group(1)}.{mm.group(2)}"
    return None


def _torch_name(path, fpn_levels) -> str:
    top = path[0]
    if top == "backbone":
        swin = _swin_name(path[1:])
        if swin is not None:
            return "backbone.bottom_up." + swin
        mod = path[1]
        if mod in ("conv1", "bn1"):
            leaf = path[2]
            return ("backbone.bottom_up.stem.conv1."
                    + (leaf if mod == "conv1" else f"norm.{leaf}"))
        m = re.fullmatch(r"layer(\d)\.(\d+)", mod)
        if m:
            stage, block = int(m.group(1)) + 1, m.group(2)
            sub, leaf = path[2], path[3]
            conv = {"downsample_conv": "shortcut", "downsample_bn": "shortcut"}.get(
                sub, re.sub(r"^bn", "conv", sub))
            tail = leaf if sub.endswith("conv") or sub.startswith("conv") else f"norm.{leaf}"
            return f"backbone.bottom_up.res{stage}.{block}.{conv}.{tail}"
    elif top == "fpn":
        m = re.fullmatch(r"(lateral|output)(\d)", path[1])
        if m and path[2] == "Conv_0":
            return f"backbone.fpn_{m.group(1)}{fpn_levels[int(m.group(2))]}.{path[3]}"
    elif top == "head":
        mod = path[1]
        if mod in ("time_fc1", "time_fc2"):
            return f"head.time_mlp.{1 if mod == 'time_fc1' else 3}.{path[2]}"
        m = re.fullmatch(r"head(_cond)?(\d+)", mod)
        if m:
            series = "head_series_cond" if m.group(1) else "head_series"
            return f"head.{series}.{m.group(2)}.{_rcnn_head_name(path[2:])}"
        m = re.fullmatch(r"global_attn(\d+)", mod)
        if m:
            return f"head.global_attention.{m.group(1)}.0." + ".".join(path[2:])
    raise KeyError(f"no port name for JAX parameter {'/'.join(path)}")


def state_dict_from_jax(params, fpn_levels=(3, 4, 5)) -> Dict[str, torch.Tensor]:
    """JAX ``DiffusionDetArch`` parameter tree (``{"params": ...}`` or the
    bare tree, leaves array-like) → the port's state dict (float32 tensors,
    and each Swin block's int64 ``relative_position_index``)."""
    tree = params.get("params", params)
    state = {}
    for path, v in _flatten(tree):
        name = _torch_name(path, fpn_levels)
        state[name] = torch.from_numpy(np.array(v, np.float32))
        if name.endswith(".attn.relative_position_bias_table"):
            window = (math.isqrt(v.shape[0]) + 1) // 2
            state[name.replace("_bias_table", "_index")] = torch.from_numpy(
                relative_position_index(window))
    return state

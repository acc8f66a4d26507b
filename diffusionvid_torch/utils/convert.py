"""Weights from other formats onto the port's parameter names.

The port's modules carry the reference's detectron2/DiffusionDet names
(``backbone.bottom_up.stem.conv1.weight``, ``head.head_series.0...``).  The
MEGA family's follow the JAX package's tree (``detector.rpn.conv.weight``,
``detector.roi_head.head.res5.0.conv1.weight``, ``relation.attn0.Wq.weight``,
``flownet.deconv5.weight``, ``embednet.embed_conv1.weight``,
``pixel_attn.attn.Wq.weight``, DAFA's ``heads.{i}``), its trunks again
detectron2's names.  A ResNeXt convolution keeps torch's ``[out, in /
groups, k, k]`` on both sides.

``state_dict_from_jax``: the JAX package stores every parameter in torch
layout (conv weights [out, in, kh, kw], linear weights [out, in], fused MHA
``in_proj``), so the carry-over is renaming only: the inverse of the JAX
package's ``utils/torch_convert.py: convert_torch_state_dict``.

``load_pretrained``: the reference's ``MODEL.WEIGHT`` formats
(``diffusionvid_tpu/utils/torch_convert.py:224-354``, the reference's
``c2_model_loading.py`` and ``model_serialization.py``): a full-model
``.pth`` (the port's own checkpoints too), a detectron2 trunk ``.pkl``
(``stem.*``, ``res2.*``), a Caffe2 ``.pkl`` (``res2_0_branch2a_w``) and a
bare trunk in torchvision-style names (``conv1``, ``bn1``,
``layerS.B.convK`` / ``bnK`` / ``downsample_conv`` / ``downsample_bn``).
Unlike the JAX package it strips ``module.`` and ``model.`` before telling
the formats apart, so a checkpoint saved from a wrapped model loads; a
bare torchvision ``downsample.0`` / ``downsample.1`` name matches nothing
on either side.

The reference's Swin checkpoints also hold each block's
``attn.relative_position_index``, a buffer the JAX package recomputes
instead of storing.  ``state_dict_from_jax`` fills it from the index
function, so the port's state dict has every tensor of a reference
checkpoint and both load with ``strict=True``.
"""

from __future__ import annotations

import math
import os
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


def _resnet_name(path) -> str | None:
    """One ResNet tree path (``conv1``/``bn1`` or ``layerS.B/sub/leaf``) →
    its detectron2 name (``stem.conv1.*``, ``res{S+1}.B.conv{k}[.norm].*``),
    or None."""
    mod = path[0]
    if mod in ("conv1", "bn1"):
        return "stem.conv1." + (path[1] if mod == "conv1" else f"norm.{path[1]}")
    m = re.fullmatch(r"layer(\d)\.(\d+)", mod)
    if m:
        stage, block = int(m.group(1)) + 1, m.group(2)
        sub, leaf = path[1], path[2]
        conv = {"downsample_conv": "shortcut", "downsample_bn": "shortcut"}.get(
            sub, re.sub(r"^bn", "conv", sub))
        tail = leaf if sub.endswith("conv") or sub.startswith("conv") else f"norm.{leaf}"
        return f"res{stage}.{block}.{conv}.{tail}"
    return None


# MEGA-family modules whose port names join the JAX path as it is
_JOINED = ("rpn", "predictor", "reduce", "relation", "global_lm", "temporal_attn",
           "init_proposal_boxes", "init_proposal_features", "flownet", "embednet",
           "pixel_attn")


def _torch_name(path, fpn_levels) -> str:
    top = path[0]
    if top == "backbone":
        name = _swin_name(path[1:]) or _resnet_name(path[1:])
        if name is not None:
            return "backbone.bottom_up." + name
    elif top == "detector":
        return "detector." + _torch_name(path[1:], fpn_levels)
    elif top in _JOINED:
        return ".".join(path)
    elif top == "roi_head" and path[1] == "head":
        name = _resnet_name(path[2:])
        if name is not None:
            return "roi_head.head." + name
    elif re.fullmatch(r"head\d+", top):   # DAFA's decoder stages
        return f"heads.{top[4:]}.{_rcnn_head_name(path[1:])}"
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
        m = re.fullmatch(r"local_(attn|norm)(\d+)", mod)
        if m:
            kind = "attention" if m.group(1) == "attn" else "norm"
            return f"head.local_{kind}.{m.group(2)}." + ".".join(path[2:])
    raise KeyError(f"no port name for JAX parameter {'/'.join(path)}")


def state_dict_from_jax(params, fpn_levels=(3, 4, 5)) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (``{"params": ...}`` or the bare tree, leaves
    array-like) of ``DiffusionDetArch``, ``GeneralizedRCNN``, ``DFFArch``,
    ``FGFAArch``, ``RDNArch``, ``MEGAArch`` or ``SparseRCNNDAFA`` → the port's
    state dict (float32 tensors, and each Swin block's int64
    ``relative_position_index``)."""
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


# ------------------------------------------------------------------ MODEL.WEIGHT formats

_C2_SUFFIX = {
    "_w": ("conv", "weight"), "_b": ("conv", "bias"),
    "_bn_s": ("bn", "weight"), "_bn_b": ("bn", "bias"),
    "_bn_rm": ("bn", "running_mean"), "_bn_riv": ("bn", "running_var"),
    "_bn_running_mean": ("bn", "running_mean"),
    "_bn_running_var": ("bn", "running_var"),
}


def c2_to_torch_names(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Caffe2 blob names → torchvision-style names (``res2_0_branch2a_w`` →
    ``layer1.0.conv1.weight``, the reference's ``c2_model_loading.py``).
    Caffe2's FrozenBN stores scale and bias only, so identity running
    statistics are added: the FrozenBN computes the same affine."""
    branch_map = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3",
                  "branch1": "downsample"}
    out: Dict[str, np.ndarray] = {}

    def put_bn_stats(prefix: str, like: np.ndarray):
        out.setdefault(prefix + ".running_mean", np.zeros_like(like))
        out.setdefault(prefix + ".running_var", np.ones_like(like))

    for name, v in state.items():
        v = np.asarray(v)
        suffix = next((x for x in sorted(_C2_SUFFIX, key=len, reverse=True)
                       if name.endswith(x)), None)
        if suffix is None:
            out[name] = v
            continue
        stem_name = name[: -len(suffix)]
        kind, leaf = _C2_SUFFIX[suffix]
        m = re.match(r"res(\d)_(\d+)_(branch\d\w?)$", stem_name)
        if m:
            stage, block, mod = int(m.group(1)), m.group(2), branch_map[m.group(3)]
            if mod == "downsample":
                tgt = f"layer{stage - 1}.{block}." + (
                    "downsample_conv" if kind == "conv" else "downsample_bn")
            else:
                tgt = f"layer{stage - 1}.{block}." + (
                    mod if kind == "conv" else mod.replace("conv", "bn"))
            out[f"{tgt}.{leaf}"] = v
            if kind == "bn":
                put_bn_stats(tgt, v)
            continue
        if stem_name == "conv1":
            tgt = "conv1" if kind == "conv" else "bn1"
            out[f"{tgt}.{leaf}"] = v
            if kind == "bn":
                put_bn_stats(tgt, v)
            continue
        out[name] = v
    return out


def looks_like_c2(names) -> bool:
    return any(re.match(r"res\d_\d+_branch", n) or n in ("conv1_w", "conv1_bn_s")
               for n in names)


def d2_body_to_torchvision(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """detectron2 trunk names (``stem.conv1.*``, ``res2.0.conv1.norm.*``) →
    torchvision-style names (the layout of ``torchvision-R-101.pkl``)."""
    out = {}
    for name, v in state.items():
        n = re.sub(r"^stem\.conv1\.norm\.", "bn1.", name)
        n = re.sub(r"^stem\.conv1\.", "conv1.", n)
        m = re.match(r"^res(\d)\.(\d+)\.(.+)$", n)
        if m:
            rest = m.group(3)
            rest = re.sub(r"^shortcut\.norm\.", "downsample_bn@.", rest)
            rest = re.sub(r"^shortcut\.", "downsample_conv@.", rest)
            rest = re.sub(r"^conv(\d)\.norm\.", r"bn\1.", rest)
            n = f"layer{int(m.group(1)) - 1}.{m.group(2)}.{rest.replace('@.', '.')}"
        out[n] = v
    return out


def _trunk_to_port(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A bare trunk in torchvision-style names → the port's names (the JAX
    package's ``convert_backbone_only``, then its tree paths' names)."""
    out = {}
    for name, v in state.items():
        m = re.match(r"(conv1|bn1)\.(weight|bias|running_mean|running_var)$", name)
        if m:
            out[_torch_name(("backbone", m.group(1), m.group(2)), ())] = v
            continue
        m = re.match(r"(layer\d\.\d+)\.(\w+)\.(weight|bias|running_mean|running_var)$", name)
        if m:
            out[_torch_name(("backbone",) + m.groups(), ())] = v
    return out


def _strip_wrapper_prefixes(state: dict) -> dict:
    """Names without a leading ``module.`` (DistributedDataParallel) and
    then ``model.``."""
    out = {}
    for name, v in state.items():
        for pre in ("module.", "model."):
            if name.startswith(pre):
                name = name[len(pre):]
        out[name] = v
    return out


def load_pretrained(path: str) -> Dict[str, torch.Tensor]:
    """A weight file in any of the formats above → tensors under the port's
    names.  ``.pkl`` files are read with ``pickle`` (latin1, as Caffe2's
    Python 2 pickles need), others with ``torch.load``.  A full model keeps
    its names, less each Swin block's ``attn.relative_position_index``,
    which the model computes.  Caffe2 files keep their arrays under
    ``blobs`` (the reference's ``_load_c2_pickled_weights``); the JAX
    package reads only files without that level."""
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
    else:
        raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict):   # a checkpoint's "model", Caffe2's "blobs", or the names
        raw = raw.get("model", raw.get("blobs", raw))
    state = _strip_wrapper_prefixes({k: t for k, t in raw.items()
                                    if isinstance(t, (torch.Tensor, np.ndarray))})
    if looks_like_c2(state):
        state = c2_to_torch_names(state)
    if any(n.startswith(("stem.", "res2.", "res3.")) for n in state):
        state = d2_body_to_torchvision(state)
    if any(n.startswith(("backbone.", "head.")) for n in state):
        state = {k: v for k, v in state.items()
                 if not k.endswith(".attn.relative_position_index")}
    else:
        state = _trunk_to_port(state)
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            for k, v in state.items()}


def load_weights_into(model: torch.nn.Module, path: str, skip_keys=()) -> int:
    """Merge ``load_pretrained(path)`` into ``model`` where names and shapes
    match, keeping the model's tensors whose name has a part containing one
    of ``skip_keys``; returns the tensors copied, and raises when none is."""
    from .checkpoint import merge_pretrained

    merged, copied = merge_pretrained(model.state_dict(), load_pretrained(path),
                                      skip_keys=skip_keys)
    if copied == 0:
        raise ValueError(f"{path}: no tensor matches a parameter of the model "
                         f"({type(model).__name__})")
    model.load_state_dict(merged, strict=True)
    return copied


def weight_path(weight: str):
    """``MODEL.WEIGHT`` as a local file: None when empty, the path when it
    exists.  Catalog names and URLs are not fetched: they raise, as does a
    path that does not exist."""
    if not weight:
        return None
    if weight.startswith(("catalog://", "http://", "https://")):
        raise FileNotFoundError(
            f"MODEL.WEIGHT {weight!r} names a download, which the port does not "
            f"fetch: download it and pass its path with --pretrained")
    if not os.path.exists(weight):
        raise FileNotFoundError(f"MODEL.WEIGHT {weight!r} does not exist")
    return weight


def load_jax_checkpoint(path: str):
    """A JAX package checkpoint (``utils/checkpoint.py: save_checkpoint``)
    → the port's state dict, or None when ``path`` is not one.  The JAX
    package writes ``model_<step>.pkl``, a pickle of numpy trees with
    ``params``, when ``orbax`` is missing; ``path`` may name that file or
    leave out its ``.pkl``.  An orbax directory needs ``orbax``, which
    imports JAX, so it raises: re-save it as that pickle where JAX runs."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory, which the port does not read: "
            f"re-save it where JAX runs as the JAX package's pickle form, "
            f"pickle.dump(jax.tree.map(np.asarray, load_checkpoint(path)), "
            f"open(path + '.pkl', 'wb'))")
    pkl = path if path.endswith(".pkl") else path + ".pkl"
    if not os.path.isfile(pkl):
        return None
    import pickle
    with open(pkl, "rb") as f:
        payload = pickle.load(f)
    if not (isinstance(payload, dict) and "params" in payload):
        raise ValueError(f"{pkl} holds no 'params' tree: not a JAX package checkpoint")
    return state_dict_from_jax(payload["params"])

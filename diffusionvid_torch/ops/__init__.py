"""Ops of the ported path.  ``roi_align``, ``dynamic_conv`` and
``swin_attention`` hold CUDA kernels (``csrc/``) beside their plain PyTorch versions; the rest is plain
PyTorch, as it was plain ``lax`` code in the JAX package."""

from .dynamic_conv import dynamic_conv_fused, dynamic_conv_ref
from .fps import farthest_point_sample, pairwise_l2_distance
from .memory import FeatureMemory, init_memory, update_erase_memory
from .nms import batched_nms_mask, nms_mask
from .roi_align import fpn_level_assignment, multilevel_roi_align, multilevel_roi_align_ref
from .swin_attention import (
    swin_block_attn, swin_block_attn_ref, swin_block_mlp, swin_block_mlp_ref)

__all__ = ["batched_nms_mask", "dynamic_conv_fused", "dynamic_conv_ref",
           "farthest_point_sample", "FeatureMemory", "fpn_level_assignment",
           "init_memory", "multilevel_roi_align", "multilevel_roi_align_ref",
           "nms_mask", "pairwise_l2_distance", "swin_block_attn", "swin_block_attn_ref",
           "swin_block_mlp", "swin_block_mlp_ref", "update_erase_memory"]

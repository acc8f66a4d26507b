"""Ops of the ported path.  ``roi_align`` and ``dynamic_conv`` hold CUDA
kernels (``csrc/``) beside their plain PyTorch versions; the rest is plain
PyTorch, as it was plain ``lax`` code in the JAX package."""

from .dynamic_conv import dynamic_conv_fused, dynamic_conv_ref
from .fps import farthest_point_sample, pairwise_l2_distance
from .memory import FeatureMemory, init_memory, update_erase_memory
from .nms import batched_nms_mask, nms_mask
from .roi_align import fpn_level_assignment, multilevel_roi_align, multilevel_roi_align_ref

__all__ = ["batched_nms_mask", "dynamic_conv_fused", "dynamic_conv_ref",
           "farthest_point_sample", "FeatureMemory", "fpn_level_assignment",
           "init_memory", "multilevel_roi_align", "multilevel_roi_align_ref",
           "nms_mask", "pairwise_l2_distance", "update_erase_memory"]

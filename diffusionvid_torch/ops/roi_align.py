"""Multilevel ROIAlignV2 forward: kernel K1 and its plain version.

Port of ``diffusionvid_tpu/ops/roi_align.py`` (the gather form, which is
the plain version here) and of the Pallas forward
``ops/roi_align_pallas.py: multilevel_roi_align_mxu`` (the CUDA kernel
``csrc/roi_align_fwd.cu``).  Feature maps are NHWC with channels
contiguous; the output is the flat ``[B, R, p*p, C]`` tile in row-major
(py, px) order that ``DynamicConv``'s out-projection consumes.

Level assignment follows detectron2 (canonical box 224 at level 4).  The
border rule is the CUDA one: a sample is zero if its coordinate is below -1
or above the size, and is clamped otherwise.  The kernel and the plain
version share ``fpn_level_assignment``, computed here in PyTorch, so both
pool every ROI from the same level.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fpn_level_assignment(rois, num_levels: int, min_level: int,
                         canonical_box_size: float = 224.0,
                         canonical_level: int = 4):
    """detectron2 ``assign_boxes_to_levels``: level =
    floor(canonical_level + log2(sqrt(area)/canonical_box_size)), clamped.
    Returns int32 [B, R] in [0, num_levels)."""
    area = ((rois[..., 2] - rois[..., 0]).clamp(min=0)
            * (rois[..., 3] - rois[..., 1]).clamp(min=0))
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_box_size + 1e-8))
    lvl = lvl.clamp(min_level, min_level + num_levels - 1)
    return (lvl - min_level).to(torch.int32)


def _levels(features, rois, spatial_scales):
    if len(features) == 1:
        return torch.zeros(rois.shape[:2], dtype=torch.int32, device=rois.device)
    min_level = int(round(-math.log2(spatial_scales[0])))
    return fpn_level_assignment(rois, len(features), min_level)


def multilevel_roi_align_ref(features: Sequence[torch.Tensor], rois,
                             spatial_scales: Sequence[float],
                             output_size: int = 7, sampling_ratio: int = 2,
                             aligned: bool = True):
    """The plain version: one gather per bilinear corner over the levels
    flattened into one ``[B, sum(Hl*Wl), C]`` buffer, in fp32, cast to the
    features' dtype at the end.  Returns ``[B, R, p*p, C]`` row-major."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    p, sr = output_size, sampling_ratio
    dev = rois.device
    sizes = [(f.shape[1], f.shape[2]) for f in features]
    flat = torch.cat([f.reshape(b, -1, c) for f in features], 1)
    offsets = [0]
    for hl, wl in sizes[:-1]:
        offsets.append(offsets[-1] + hl * wl)

    level = _levels(features, rois, spatial_scales).long()
    scales = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)[level]
    lvl_h = torch.tensor([s[0] for s in sizes], device=dev)[level]
    lvl_w = torch.tensor([s[1] for s in sizes], device=dev)[level]
    lvl_off = torch.tensor(offsets, device=dev)[level]

    half = 0.5 if aligned else 0.0
    rf = rois.float()
    x1 = rf[..., 0] * scales - half
    y1 = rf[..., 1] * scales - half
    x2 = rf[..., 2] * scales - half
    y2 = rf[..., 3] * scales - half
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    # divide by a tensor: PyTorch turns division by a Python number into a
    # multiplication by its reciprocal on CUDA, which moves the sample
    # coordinates by an ulp from the IEEE quotient that JAX and the kernel use
    bin_h = roi_h / torch.full_like(roi_h, p)
    bin_w = roi_w / torch.full_like(roi_w, p)

    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(sr, dtype=torch.float32, device=dev)[None, :] + 0.5)
            / sr).reshape(-1)                                    # [p*sr]
    ys = (y1[..., None] + bin_h[..., None] * grid)[..., :, None]  # [B,R,s,1]
    xs = (x1[..., None] + bin_w[..., None] * grid)[..., None, :]  # [B,R,1,s]
    hh = lvl_h[..., None, None].float()
    ww = lvl_w[..., None, None].float()

    inside = (ys >= -1.0) & (ys <= hh) & (xs >= -1.0) & (xs <= ww)
    yc = torch.minimum(ys.clamp(min=0.0), hh - 1.0)
    xc = torch.minimum(xs.clamp(min=0.0), ww - 1.0)
    y_low, x_low = torch.floor(yc), torch.floor(xc)
    y_high = torch.minimum(y_low + 1.0, hh - 1.0)
    x_high = torch.minimum(x_low + 1.0, ww - 1.0)
    ly, lx = yc - y_low, xc - x_low
    hy, hx = 1.0 - ly, 1.0 - lx

    base = lvl_off[..., None, None]
    wide = lvl_w[..., None, None]
    yl, yh = y_low.long(), y_high.long()
    xl, xh = x_low.long(), x_high.long()

    def corner(yy, xx, w):
        idx = (base + yy * wide + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).float() * w.reshape(b, -1, 1)

    out = (corner(yl, xl, hy * hx) + corner(yl, xh, hy * lx)
           + corner(yh, xl, ly * hx) + corner(yh, xh, ly * lx))
    out = out * inside.reshape(b, -1, 1)
    out = out.reshape(b, r, p, sr, p, sr, c).mean(dim=(3, 5))
    return out.reshape(b, r, p * p, c).to(features[0].dtype)


def _check_kernel_inputs(features, rois, spatial_scales, output_size,
                         sampling_ratio, aligned):
    if len(features) != 3 or len(spatial_scales) != 3:
        raise ValueError("the ROIAlign kernel takes exactly 3 FPN levels")
    if output_size != 7 or sampling_ratio != 2 or not aligned:
        raise ValueError("the ROIAlign kernel is 7x7, sampling ratio 2, aligned")
    dt = features[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the ROIAlign kernel takes float32 or bfloat16, not {dt}")
    b, _, _, c = features[0].shape
    for f in features:
        if f.device != rois.device or f.dtype != dt:
            raise ValueError("feature maps must share the rois' device and one dtype")
        if f.dim() != 4 or f.shape[0] != b or f.shape[3] != c:
            raise ValueError(f"feature map shape {tuple(f.shape)} is not [B, H, W, {c}]")
        if not f.is_contiguous():
            raise ValueError("feature maps must be contiguous NHWC")
    if c % 2 or not 56 <= c <= 2048:
        # one thread per channel pair, and at least 28 threads for the
        # 2 x 14 sample positions each block computes first
        raise ValueError(f"the ROIAlign kernel needs an even channel count in "
                         f"[56, 2048], got {c}")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[0] != b \
            or rois.shape[2] != 4 or not rois.is_contiguous():
        raise ValueError("rois must be contiguous float32 [B, R, 4]")
    if any(f.requires_grad for f in features) or rois.requires_grad:
        raise NotImplementedError(
            "the ROIAlign backward kernel is not ported yet: call under "
            "torch.no_grad() on CUDA")


def multilevel_roi_align(features: Sequence[torch.Tensor], rois,
                         spatial_scales: Sequence[float],
                         output_size: int = 7, sampling_ratio: int = 2,
                         aligned: bool = True):
    """Multilevel ROIAlignV2 → ``[B, R, p*p, C]`` in the features' dtype.

    On CPU tensors this is the plain version.  On CUDA tensors it launches
    kernel K1 (``csrc/roi_align_fwd.cu``) or raises."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_ref(features, rois, spatial_scales,
                                        output_size, sampling_ratio, aligned)
    _check_kernel_inputs(features, rois, spatial_scales, output_size,
                         sampling_ratio, aligned)
    f0, f1, f2 = features
    b, r = rois.shape[:2]
    c = f0.shape[3]
    level = _levels(features, rois, spatial_scales).contiguous()
    out = torch.empty((b, r, output_size * output_size, c), dtype=f0.dtype,
                      device=rois.device)
    if b * r == 0:
        return out
    lib = _build.load("roi_align_fwd")
    fn = lib.roi_align_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(f0.data_ptr(), f1.data_ptr(), f2.data_ptr(),
             f0.shape[1], f0.shape[2], f1.shape[1], f1.shape[2],
             f2.shape[1], f2.shape[2],
             *[float(s) for s in spatial_scales],
             rois.data_ptr(), level.data_ptr(), out.data_ptr(),
             b, r, c, _DTYPE_CODE[f0.dtype], _build.stream_ptr(rois.device))
    _build.check(lib, err, "roi_align_fwd")
    multilevel_roi_align.launches += 1
    return out


multilevel_roi_align.launches = 0

"""Multilevel ROIAlignV2: kernel K1 (forward), kernel K3 (feature gradient)
and their plain versions.

Port of ``diffusionvid_tpu/ops/roi_align.py`` (the gather form, which is
the plain forward here, and the custom VJP ``_pra_bwd``) and of the Pallas
kernels ``ops/roi_align_pallas.py: multilevel_roi_align_mxu`` (the CUDA
kernel ``csrc/roi_align_fwd.cu``) and ``multilevel_roi_align_bwd_mxu``
(``csrc/roi_align_bwd.cu``).  Feature maps are NHWC with channels
contiguous; the output is the flat ``[B, R, p*p, C]`` tile in row-major
(py, px) order that ``DynamicConv``'s out-projection consumes.

Level assignment follows detectron2 (canonical box 224 at level 4).  The
border rule is the CUDA one: a sample is zero if its coordinate is below -1
or above the size, and is clamped otherwise.  The plain versions and K3
assign levels with ``fpn_level_assignment`` in PyTorch; K1 assigns them in
the kernel with the same operations in the same order, and returns them
for K3, so every path pools a ROI from the same level.  The gradient
reaches the features only: the ROI gradient is zero, as in the JAX
package's ``_pra_bwd`` and the reference CUDA backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K3 tiles: the most cells (rows x columns) a block takes, as compiled
_BWD_CELLS = 256


def fpn_level_assignment(rois, num_levels: int, min_level: int,
                         canonical_box_size: float = 224.0,
                         canonical_level: int = 4):
    """detectron2 ``assign_boxes_to_levels``: level =
    floor(canonical_level + log2(sqrt(area)/canonical_box_size)), clamped.
    Returns int32 [B, R] in [0, num_levels).  On CUDA PyTorch divides by
    the Python number as a multiplication by its fp32 reciprocal, as XLA
    does for the JAX package's version; K1 computes the same operations
    (``csrc/roi_align_fwd.cu: roi_level``)."""
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


def _sample_coords(rois, level, sizes, spatial_scales, p: int, sr: int,
                   aligned: bool):
    """Per ROI, the ``p*sr`` sample coordinates along y and x in its level's
    cells, ``[B, R, p*sr]`` each, and its level's height and width
    ``[B, R]``.  The kernels compute the same coordinates with the same
    rounding."""
    dev = rois.device
    level = level.long()
    scales = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)[level]
    lvl_h = torch.tensor([s[0] for s in sizes], device=dev)[level]
    lvl_w = torch.tensor([s[1] for s in sizes], device=dev)[level]
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
    # coordinates by an ulp from the IEEE quotient that JAX and the kernels use
    bin_h = roi_h / torch.full_like(roi_h, p)
    bin_w = roi_w / torch.full_like(roi_w, p)
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(sr, dtype=torch.float32, device=dev)[None, :] + 0.5)
            / sr).reshape(-1)                                    # [p*sr]
    ys = y1[..., None] + bin_h[..., None] * grid
    xs = x1[..., None] + bin_w[..., None] * grid
    return ys, xs, lvl_h, lvl_w


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

    level = _levels(features, rois, spatial_scales)
    ys, xs, lvl_h, lvl_w = _sample_coords(rois, level, sizes, spatial_scales,
                                          p, sr, aligned)
    lvl_off = torch.tensor(offsets, device=dev)[level.long()]
    ys, xs = ys[..., :, None], xs[..., None, :]                 # [B,R,s,1], [B,R,1,s]
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


def _band_params(coords, sizes):
    """Per sample: (lo int64, w_lo, w_hi) with ROIAlign border semantics
    (copy of the JAX package's ``roi_align_pallas._band_params``).
    ``sizes`` broadcasts per ROI.  lo in [0, size-2]; the weights absorb the
    clamping: a sample in the last cell puts its whole weight on slot 1."""
    sz = sizes.float()
    inside = (coords >= -1.0) & (coords <= sz)
    cc = torch.minimum(coords.clamp(min=0.0), sz - 1.0)
    low = torch.floor(cc)
    high = torch.minimum(low + 1.0, sz - 1.0)
    frac = cc - low
    w_low = (1.0 - frac) * inside
    w_high = torch.where(high > low, frac * inside, torch.zeros_like(frac))
    lo = torch.minimum(low, (sz - 2.0).clamp(min=0.0))
    shifted = low > lo
    w0 = torch.where(shifted, torch.zeros_like(w_low), w_low)
    w1 = torch.where(shifted, w_low, w_high)
    return lo.long(), w0, w1


def multilevel_roi_align_bwd_ref(g, rois, feature_shapes, spatial_scales,
                                 out_dtype, output_size: int = 7,
                                 sampling_ratio: int = 2, aligned: bool = True):
    """The plain version of K3: the feature gradient of
    ``multilevel_roi_align`` for a row-major ``[B, R, p*p, C]`` cotangent.
    Every sample adds ``g[bin] * wy * wx / sr^2`` into the two-by-two
    corner cells of its level's band (``_band_params``), in fp32, with one
    ``scatter_add_`` per level and corner.  Returns the per-level
    ``[B, Hl, Wl, C]`` gradients in ``out_dtype``."""
    b, r, _, c = g.shape
    p, sr = output_size, sampling_ratio
    s = p * sr
    sizes = [tuple(int(v) for v in hw) for hw in feature_shapes]
    level = _levels(sizes, rois, spatial_scales)
    ys, xs, lvl_h, lvl_w = _sample_coords(rois, level, sizes, spatial_scales,
                                          p, sr, aligned)
    ylo, wy0, wy1 = _band_params(ys, lvl_h[..., None])
    xlo, wx0, wx1 = _band_params(xs, lvl_w[..., None])
    # the cotangent of every sample, [B, R, s, s, C], with the 1/sr^2 mean
    gs = (g.float().reshape(b, r, p, 1, p, 1, c) / (sr * sr)).expand(
        b, r, p, sr, p, sr, c).reshape(b, r, s, s, c)
    grads = []
    for li, (hl, wl) in enumerate(sizes):
        sel = (level == li).float()[..., None, None]               # [B,R,1,1]
        df = torch.zeros(b, hl * wl, c, dtype=torch.float32, device=g.device)
        for dy, wy in ((0, wy0), (1, wy1)):
            yy = (ylo + dy).clamp(max=hl - 1)[..., :, None]
            for dx, wx in ((0, wx0), (1, wx1)):
                xx = (xlo + dx).clamp(max=wl - 1)[..., None, :]
                w = wy[..., :, None] * wx[..., None, :] * sel          # [B,R,s,s]
                idx = (yy * wl + xx).reshape(b, -1, 1).expand(-1, -1, c)
                df.scatter_add_(1, idx, (gs * w[..., None]).reshape(b, -1, c))
        grads.append(df.reshape(b, hl, wl, c).to(out_dtype))
    return grads


def _check_common(rois, n_levels, b, c, dtype, output_size, sampling_ratio,
                  aligned):
    if n_levels != 3:
        raise ValueError("the ROIAlign kernels take exactly 3 FPN levels")
    if output_size != 7 or sampling_ratio != 2 or not aligned:
        raise ValueError("the ROIAlign kernels are 7x7, sampling ratio 2, aligned")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the ROIAlign kernels take float32 or bfloat16, not {dtype}")
    if c % 2 or not 56 <= c <= 2048:
        # K1: one thread per channel pair, and at least 28 threads for the
        # 2 x 14 sample positions each block computes first
        raise ValueError(f"the ROIAlign kernels need an even channel count in "
                         f"[56, 2048], got {c}")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[0] != b \
            or rois.shape[2] != 4 or not rois.is_contiguous():
        raise ValueError("rois must be contiguous float32 [B, R, 4]")


def _check_kernel_inputs(features, rois, spatial_scales, output_size,
                         sampling_ratio, aligned):
    if len(features) != len(spatial_scales):
        raise ValueError("one spatial scale per feature map")
    dt = features[0].dtype
    b, _, _, c = features[0].shape
    for f in features:
        if f.device != rois.device or f.dtype != dt:
            raise ValueError("feature maps must share the rois' device and one dtype")
        if f.dim() != 4 or f.shape[0] != b or f.shape[3] != c:
            raise ValueError(f"feature map shape {tuple(f.shape)} is not [B, H, W, {c}]")
        if not f.is_contiguous():
            raise ValueError("feature maps must be contiguous NHWC")
        if dt == torch.bfloat16 and f.data_ptr() % 16:
            raise ValueError("bfloat16 feature maps must start on 16 bytes")
    _check_common(rois, len(features), b, c, dt, output_size, sampling_ratio, aligned)
    if dt == torch.bfloat16 and c % K1_LANE_CH:
        # the footprint design reads and writes 16 bytes (8 channels) a lane
        raise ValueError(f"K1 takes bfloat16 maps with a multiple of {K1_LANE_CH} "
                         f"channels, got {c}")


def _check_bwd_inputs(g, rois, feature_shapes, spatial_scales, out_dtype,
                      output_size, sampling_ratio, aligned):
    if len(feature_shapes) != len(spatial_scales):
        raise ValueError("one spatial scale per feature map")
    if g.dim() != 4 or g.shape[:2] != rois.shape[:2] \
            or g.shape[2] != output_size ** 2 or not g.is_contiguous():
        raise ValueError(f"the cotangent must be contiguous [B, R, "
                         f"{output_size ** 2}, C], got {tuple(g.shape)}")
    if g.dtype != out_dtype or g.device != rois.device:
        raise ValueError(f"the cotangent must be {out_dtype} on the rois' device, "
                         f"got {g.dtype} on {g.device}")
    _check_common(rois, len(feature_shapes), g.shape[0], g.shape[3], out_dtype,
                  output_size, sampling_ratio, aligned)


# K1's footprint design (csrc/roi_align_fwd.cu, bf16): one block of 14 warps
# per (frame, ROI) and slice of 256 channels, 8 channels (16 bytes) a lane;
# two buffers of K1_CELLS staged cells of 512 bytes, then the ROI's tables
# (struct Tables: 1,760 bytes)
K1_THREADS = 14 * 32
K1_LANE_CH = 8
K1_SLICE = 32 * K1_LANE_CH
K1_CELL = K1_SLICE * 2
K1_CELLS = 108
K1_TABLES = 1760
# C entry point of each design: (name, argument types after the maps'
# sizes, scales, pointers and B, R, C)
_ENTRIES = {
    "footprint": ("roi_align_fwd_footprint", [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "v1": ("roi_align_fwd", [ctypes.c_int, ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def fwd_plan(b: int, r: int, c: int) -> dict:
    """The footprint design's launch for ``b`` frames of ``r`` ROIs and
    ``c`` channels: a block per (ROI, frame, slice of 256 channels) as
    ``grid``, its ``threads``, the ``cells`` each of its two buffers
    stages (28 at least: one band row of the widest footprint) and its
    shared bytes, which the C entry point checks against its layout.
    Cached (the wrapper asks at every launch): do not modify the dict."""
    return dict(grid=(r, b, -(-c // K1_SLICE)), threads=K1_THREADS, cells=K1_CELLS,
                smem_bytes=2 * K1_CELLS * K1_CELL + K1_TABLES)


# design -> (library, entry name, typed ctypes function), filled at first use
_FNS: dict = {}


def _entry(design: str):
    """The library and the ctypes function of a K1 design, typed once."""
    hit = _FNS.get(design)
    if hit is None:
        lib = _build.load("roi_align_fwd")
        name, args = _ENTRIES[design]
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + args)
        hit = _FNS[design] = (lib, name, fn)
    return hit


def launch_k1(features, rois, spatial_scales, out, level, design: str | None = None):
    """Launch K1 on checked CUDA inputs (``_check_kernel_inputs``) into
    ``out`` ``[B, R, 49, C]`` and ``level`` int32 ``[B, R]``; counts no
    launch.  ``design``: ``"footprint"`` (bf16 only, the default for bf16,
    with ``fwd_plan``) or ``"v1"`` (the first design, the default for
    fp32).  Naming a design is for the benchmark (``utils/k1_bench.py``);
    the wrapper takes the default."""
    f0, f1, f2 = features
    bf16 = f0.dtype == torch.bfloat16
    design = design or ("footprint" if bf16 else "v1")
    if design == "footprint" and not bf16:
        raise TypeError("the footprint design of K1 takes bfloat16")
    lib, name, fn = _entry(design)
    b, r = rois.shape[:2]
    c = f0.shape[3]
    s0, s1, s2 = spatial_scales
    args = (f0.data_ptr(), f1.data_ptr(), f2.data_ptr(), f0.shape[1], f0.shape[2],
            f1.shape[1], f1.shape[2], f2.shape[1], f2.shape[2], s0, s1, s2,
            rois.data_ptr(), level.data_ptr(), out.data_ptr(), b, r, c)
    stream = _build.stream_ptr(rois.device)
    if design == "footprint":
        plan = fwd_plan(b, r, c)
        err = fn(*args, plan["cells"], plan["smem_bytes"], stream)
    else:
        err = fn(*args, _DTYPE_CODE[f0.dtype], stream)
    _build.check(lib, err, name)


def _launch_fwd(features, rois, spatial_scales):
    """K1: the pooled ROIs and the levels the kernel assigned."""
    b, r = rois.shape[:2]
    f0 = features[0]
    out = torch.empty((b, r, 49, f0.shape[3]), dtype=f0.dtype, device=rois.device)
    level = torch.empty((b, r), dtype=torch.int32, device=rois.device)
    if b * r:
        launch_k1(features, rois, spatial_scales, out, level)
        multilevel_roi_align.launches += 1
    return out, level


def roi_footprints(rois, level, feature_shapes, spatial_scales):
    """K1's footprint of each ROI: the number of distinct rows and of
    distinct columns of its level that carry a non-zero band weight
    (``_band_params``), int64 ``[B, R, 2]``.  The footprint design reads
    rows x columns cells a ROI; the first design made 784 taps."""
    ys, xs, lvl_h, lvl_w = _sample_coords(rois, level, feature_shapes, spatial_scales,
                                          7, 2, True)
    counts = []
    for coords, size, n in ((ys, lvl_h, max(h for h, _ in feature_shapes)),
                            (xs, lvl_w, max(w for _, w in feature_shapes))):
        lo, w0, w1 = _band_params(coords, size[..., None])
        hit = torch.zeros((*lo.shape[:-1], n + 1), dtype=torch.bool, device=rois.device)
        hit.scatter_(-1, torch.where(w0 != 0, lo, n), True)     # n: no cell
        hit.scatter_(-1, torch.where(w1 != 0, lo + 1, n), True)
        counts.append(hit[..., :n].sum(-1))
    return torch.stack(counts, -1)


# K3's launch plan (csrc/roi_align_bwd.cu): at most 256 cells (rows x
# columns) and 64 channels a block, clusters of at most 8 blocks (the
# portable limit); a ROI's record is 88 int32 (band parameters and extent)
_BWD_CHANNELS = 64
_BWD_MAX_CLUSTER = 8
_BWD_RECORD = 88
# the blocks a frame's tiles of a level aim at, per channel slice: a level
# with fewer tiles takes longer ROI lists a tile and splits them over more
# blocks (at the flagship train maps p3, p4, p5 take clusters of 2, 4, 8)
_BWD_BLOCKS_A_FRAME = 48


def _bwd_smem(tr: int, tw: int, elt: int, r: int) -> int:
    """Shared bytes of a K3 block (``main_smem``): the fp32 tile, two staged
    ROIs, the column and row tables and the block's share of the list."""
    stage = 49 * _BWD_CHANNELS * elt + _BWD_RECORD * 4
    return tr * tw * _BWD_CHANNELS * 4 + 2 * stage + (tr + tw) * 8 * 4 + (r + 3) // 4 * 16


def bwd_plan(feature_shapes, r: int, elt: int) -> dict:
    """K3's launch for ``r`` ROIs a frame over the per-level maps
    ``feature_shapes``, in a dtype of ``elt`` bytes.  Per level the
    tile (``rows`` x ``cols`` cells, at most ``_BWD_CELLS``, near 16 x 16
    and balanced over the map), ``tiles_x`` and ``tiles``, the ``cluster``
    of blocks that split each tile's ROI list (about
    ``_BWD_BLOCKS_A_FRAME`` blocks over a frame's tiles, at most 8 and at
    most one per 32 ROIs) and ``smem_bytes``; and the ``channels`` of a
    block, and ``tiles_total`` over the levels."""
    levels = []
    for h, w in feature_shapes:
        # about 16 x 16 cells; a map narrower than 16 columns takes taller tiles
        tr = -(-h // -(-h // max(16, _BWD_CELLS // min(w, 16))))
        tw = min(w, _BWD_CELLS // tr)
        tw = -(-w // -(-w // tw))
        nx = -(-w // tw)
        tiles = nx * -(-h // tr)
        cluster = max(1, min(_BWD_MAX_CLUSTER, -(-r // 32), -(-_BWD_BLOCKS_A_FRAME // tiles)))
        levels.append(dict(rows=tr, cols=tw, tiles_x=nx, tiles=tiles, cluster=cluster,
                           smem_bytes=_bwd_smem(tr, tw, elt, r)))
    return dict(channels=_BWD_CHANNELS, levels=levels,
                tiles_total=sum(lv["tiles"] for lv in levels))


def bwd_scratch_words(b: int, r: int, tiles_total: int) -> int:
    """int32 words of K3's scratch (csrc/roi_align_bwd.cu: run): a record a
    ROI, a list of up to ``r`` ROI indices and a count a (frame, tile)."""
    return b * r * _BWD_RECORD + b * tiles_total * r + b * tiles_total


def bwd_scratch_lists(scratch, b: int, r: int, tiles_total: int):
    """The prepass's per-tile lists ``[B, T, R]`` and counts ``[B, T]`` in
    K3's scratch, tiles of all levels in order p3, p4, p5."""
    off = b * r * _BWD_RECORD
    n = b * tiles_total * r
    lists = scratch[off:off + n].view(b, tiles_total, r)
    counts = scratch[off + n:off + n + b * tiles_total].view(b, tiles_total)
    return lists, counts


def roi_extents(rois, level, feature_shapes, spatial_scales):
    """Per ROI the first and last row and column of its level with a
    non-zero band weight, int64 ``[B, R, 4]`` (y0, y1, x0, x1); a ROI with no
    weight on an axis gets an empty extent (y0 > y1, x0 > x1)."""
    ys, xs, lvl_h, lvl_w = _sample_coords(rois, level, feature_shapes, spatial_scales,
                                          7, 2, True)
    big = torch.iinfo(torch.int64).max
    ext = []
    for coords, size in ((ys, lvl_h), (xs, lvl_w)):
        lo, w0, w1 = _band_params(coords, size[..., None])
        first = torch.where(w0 != 0, lo, torch.where(w1 != 0, lo + 1, big)).amin(-1)
        last = torch.where(w1 != 0, lo + 1, torch.where(w0 != 0, lo, -1)).amax(-1)
        ext += [first, last]
    empty = (ext[0] > ext[1]) | (ext[2] > ext[3])
    ext = torch.stack(ext, -1)
    return torch.where(empty[..., None], torch.tensor([big, -1, big, -1], device=ext.device),
                       ext)


def bwd_tile_lists_ref(rois, level, feature_shapes, spatial_scales, plan):
    """The plain version of K3's prepass lists: for each frame and tile (all
    levels' tiles in order), the indices of the ROIs of the tile's level
    whose extent (``roi_extents``) meets the tile, in index order, padded
    with -1, ``[B, T, R]``, and their counts ``[B, T]``."""
    ext = roi_extents(rois, level, feature_shapes, spatial_scales)
    rects, lvls = [], []
    for li, lv in enumerate(plan["levels"]):
        for t in range(lv["tiles"]):
            r0, c0 = (t // lv["tiles_x"]) * lv["rows"], (t % lv["tiles_x"]) * lv["cols"]
            rects.append((r0, r0 + lv["rows"] - 1, c0, c0 + lv["cols"] - 1))
            lvls.append(li)
    rect = torch.tensor(rects, device=rois.device)[None, :, None]        # [1, T, 1, 4]
    e = ext[:, None]                                                     # [B, 1, R, 4]
    hit = ((level.long()[:, None] == torch.tensor(lvls, device=rois.device)[None, :, None])
           & (e[..., 0] <= rect[..., 1]) & (e[..., 1] >= rect[..., 0])
           & (e[..., 2] <= rect[..., 3]) & (e[..., 3] >= rect[..., 2]))   # [B, T, R]
    order = torch.sort((~hit).to(torch.int8), dim=-1, stable=True).indices
    counts = hit.sum(-1)
    pos = torch.arange(hit.shape[-1], device=rois.device)
    lists = torch.where(pos < counts[..., None], order, -1)
    return lists.to(torch.int32), counts.to(torch.int32)


def _launch_bwd(g, rois, level, feature_shapes, spatial_scales, scratch=None):
    """K3: the prepass and one launch a level.  ``scratch`` (int32, at least
    ``bwd_scratch_words``) may be handed in to read the prepass's lists
    after the call."""
    b, r, _, c = g.shape
    grads = [torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
             for h, w in feature_shapes]
    if b == 0:
        return grads
    lib = _build.load("roi_align_bwd")
    plan = bwd_plan(feature_shapes, r, g.element_size())
    words = bwd_scratch_words(b, r, plan["tiles_total"])
    if scratch is None:
        scratch = torch.empty(words, dtype=torch.int32, device=g.device)
    if scratch.dtype != torch.int32 or scratch.numel() < words or not scratch.is_contiguous():
        raise ValueError(f"K3's scratch must be {words} contiguous int32")
    fn = lib.roi_align_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    tiling = [lv[k] for lv in plan["levels"]
              for k in ("rows", "cols", "tiles_x", "tiles", "cluster", "smem_bytes")]
    err = fn(grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
             *[int(v) for hw in feature_shapes for v in hw],
             *[float(s) for s in spatial_scales],
             g.data_ptr(), rois.data_ptr(), level.data_ptr(), scratch.data_ptr(),
             *tiling, plan["channels"], b, r, c, _DTYPE_CODE[g.dtype],
             _build.stream_ptr(g.device))
    _build.check(lib, err, "roi_align_bwd")
    multilevel_roi_align_bwd.launches += 1
    return grads


def multilevel_roi_align_bwd(g, rois, feature_shapes, spatial_scales, out_dtype,
                             output_size: int = 7, sampling_ratio: int = 2,
                             aligned: bool = True):
    """Feature gradient of ``multilevel_roi_align``: a row-major
    ``[B, R, p*p, C]`` cotangent → per-level ``[B, Hl, Wl, C]`` in
    ``out_dtype``, accumulated in fp32.

    On CPU tensors this is the plain version.  On CUDA tensors it launches
    kernel K3 (``csrc/roi_align_bwd.cu``) or raises."""
    if g.device.type == "cpu":
        return multilevel_roi_align_bwd_ref(g, rois, feature_shapes, spatial_scales,
                                            out_dtype, output_size, sampling_ratio,
                                            aligned)
    shapes = [tuple(int(v) for v in hw) for hw in feature_shapes]
    _check_bwd_inputs(g, rois, shapes, spatial_scales, out_dtype, output_size,
                      sampling_ratio, aligned)
    level = _levels(shapes, rois, spatial_scales).contiguous()
    return _launch_bwd(g, rois, level, shapes, spatial_scales)


multilevel_roi_align_bwd.launches = 0


class _RoiAlignFn(torch.autograd.Function):
    """K1 forward, K3 backward; the ROI gradient is zero (``None``), as in
    the JAX package's ``_pra_bwd`` and the reference CUDA backward."""

    @staticmethod
    def forward(ctx, rois, spatial_scales, *features):
        out, level = _launch_fwd(features, rois, spatial_scales)
        ctx.save_for_backward(rois, level)
        ctx.scales = spatial_scales
        ctx.shapes = [(f.shape[1], f.shape[2]) for f in features]
        ctx.dtype = features[0].dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        if not any(ctx.needs_input_grad[2:]):
            return (None,) * len(ctx.needs_input_grad)
        rois, level = ctx.saved_tensors
        grads = _launch_bwd(grad.to(ctx.dtype).contiguous(), rois, level,
                            ctx.shapes, ctx.scales)
        return (None, None, *grads)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois,
                         spatial_scales: Sequence[float],
                         output_size: int = 7, sampling_ratio: int = 2,
                         aligned: bool = True):
    """Multilevel ROIAlignV2 → ``[B, R, p*p, C]`` in the features' dtype.

    On CPU tensors this is the plain version, differentiable by autograd.
    On CUDA tensors it launches kernel K1 (``csrc/roi_align_fwd.cu``), which
    also assigns the levels, and its gradient launches kernel K3
    (``csrc/roi_align_bwd.cu``) on those levels, or it raises."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_ref(features, rois, spatial_scales,
                                        output_size, sampling_ratio, aligned)
    _check_kernel_inputs(features, rois, spatial_scales, output_size,
                         sampling_ratio, aligned)
    return _RoiAlignFn.apply(rois, tuple(spatial_scales), *features)


multilevel_roi_align.launches = 0


def _axis_taps(coords, size):
    """Per sample along one axis: the low and high cells and their
    bilinear weights, zero outside [-1, size] (the CUDA border rule)."""
    sz = size.float()
    inside = (coords >= -1.0) & (coords <= sz)
    # maximum, as jnp.clip: a sample on the border takes half the gradient
    cc = torch.minimum(torch.maximum(coords, coords.new_zeros(())), sz - 1.0)
    low = torch.floor(cc)
    high = torch.minimum(low + 1.0, sz - 1.0)
    frac = cc - low
    return low.long(), high.long(), (1.0 - frac) * inside, frac * inside


def roi_align(features, rois, spatial_scale: float, output_size: int = 14,
              sampling_ratio: int = 2, aligned: bool = True, chunk: int = 32):
    """Single-level ROIAlign → ``[B, R, p, p, C]`` (y-major) in the
    features' dtype: the C4 box head's pooler (the JAX package's
    ``ops/roi_align.py: roi_align``, which is plain ``lax`` there, never a
    Pallas kernel).  ``features`` ``[B, H, W, C]`` NHWC.

    The plain gather on every device, in fp32, taken one axis at a time: the
    bilinear weights and the border mask of a sample are a product of a y
    and an x factor, so each ROI gathers its samples' rows, blends them and
    averages the ``sampling_ratio`` rows of a bin, then does the same along
    x.  The sum is the JAX package's up to the order of the additions.
    ``chunk`` ROIs go at a time: a chunk holds ``chunk * p * sr * W * C``
    fp32 values of blended rows (a MEGA frame pools about 675 ROIs)."""
    b, r = rois.shape[:2]
    hgt, wid, c = features.shape[1:]
    p, sr = output_size, sampling_ratio
    dev = rois.device
    level = torch.zeros(b, r, dtype=torch.int32, device=dev)
    ys, xs, lvl_h, lvl_w = _sample_coords(rois, level, [(hgt, wid)], [spatial_scale], p, sr,
                                          aligned)
    y0, y1, wy0, wy1 = _axis_taps(ys, lvl_h[..., None])
    x0, x1, wx0, wx1 = _axis_taps(xs, lvl_w[..., None])
    frame = torch.arange(b, device=dev)[:, None, None] * hgt
    rows = features.reshape(b * hgt, wid, c)
    y0, y1 = (y0 + frame).reshape(b * r, -1), (y1 + frame).reshape(b * r, -1)
    x0, x1 = x0.reshape(b * r, -1), x1.reshape(b * r, -1)
    wy0, wy1, wx0, wx1 = (t.reshape(b * r, -1) for t in (wy0, wy1, wx0, wx1))
    out = torch.empty(b * r, p, p, c, dtype=features.dtype, device=dev)
    for s in range(0, b * r, chunk):
        e = min(s + chunk, b * r)
        n = e - s
        vert = (rows[y0[s:e]].float() * wy0[s:e, :, None, None]
                + rows[y1[s:e]].float() * wy1[s:e, :, None, None])       # [n, p*sr, W, C]
        vert = vert.view(n, p, sr, wid, c).mean(2)                       # [n, p, W, C]

        def cols(idx):
            return torch.gather(vert, 2, idx[s:e, None, :, None].expand(n, p, p * sr, c))

        horiz = cols(x0) * wx0[s:e, None, :, None] + cols(x1) * wx1[s:e, None, :, None]
        out[s:e] = horiz.view(n, p, p, sr, c).mean(3).to(features.dtype)
    return out.reshape(b, r, p, p, c)

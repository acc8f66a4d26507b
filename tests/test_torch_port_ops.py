"""The port's ops against the JAX package (CPU, plain versions).

Kernel modules: K1's plain version (ROIAlignV2) against the Pallas kernel
``multilevel_roi_align_mxu`` in interpret mode and against the gather form;
K2's plain version (DynamicConv) against ``dynamic_conv_fused`` in interpret
mode, and its gradient against JAX's.  Plain ops: NMS, FPS, the memory
update and top-k selection against their JAX functions, and the Caffe2
goldens of tests/test_nms.py and tests/test_box_ops.py by value.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``); here, meta
tensors check each wrapper's input checks and that it takes the kernel, not
the plain version, for a tensor off the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.engine.postprocess import select_topk_detections as j_topk
from diffusionvid_tpu.ops import fps as j_fps
from diffusionvid_tpu.ops import memory as j_memory
from diffusionvid_tpu.ops import nms as j_nms
from diffusionvid_tpu.ops.dynamic_conv_pallas import dynamic_conv_fused as j_dynconv
from diffusionvid_tpu.ops.roi_align import fpn_level_assignment as j_levels
from diffusionvid_tpu.ops.roi_align import multilevel_roi_align as j_roi_gather
from diffusionvid_tpu.ops.roi_align_pallas import multilevel_roi_align_mxu as j_roi_mxu

from diffusionvid_torch.engine.postprocess import select_topk_detections
from diffusionvid_torch.ops import _build
from diffusionvid_torch.ops import dynamic_conv as dc
from diffusionvid_torch.ops.dynamic_conv import dynamic_conv_fused, dynamic_conv_ref
from diffusionvid_torch.ops.fps import farthest_point_sample, pairwise_l2_distance
from diffusionvid_torch.ops.memory import FeatureMemory, update_erase_memory
from diffusionvid_torch.ops.nms import batched_nms_mask, nms_mask
from diffusionvid_torch.ops import roi_align as ra
from diffusionvid_torch.ops.roi_align import fpn_level_assignment, multilevel_roi_align
from diffusionvid_torch.structures.boxes import (
    clip_to_image, cxcywh_to_xyxy, decode_boxes, pairwise_iou, xyxy_to_cxcywh)
from test_torch_port_weights import rel_err

SCALES = (1 / 8, 1 / 16, 1 / 32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- K1

def _roi_inputs(seed, r, d, sizes=((32, 48), (16, 24), (8, 12))):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(1, h, w, d).astype(np.float32) for h, w in sizes]
    img_w, img_h = sizes[0][1] * 8, sizes[0][0] * 8
    boxes = rng.uniform(-40, max(img_w, img_h), (1, r, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0, 600, (1, r, 2))
    boxes[0, :3, 2] = boxes[0, :3, 0]          # zero width
    boxes[0, 3, :] = [-30, -20, img_w + 25, img_h + 30]   # over every border
    return feats, boxes


def test_roi_align_plain_covers_all_levels():
    _, boxes = _roi_inputs(0, 50, 8)
    lv = fpn_level_assignment(_t(boxes), 3, 3).numpy()
    np.testing.assert_array_equal(lv, np.asarray(j_levels(jnp.asarray(boxes), 3, 3)))
    assert set(lv.ravel().tolist()) == {0, 1, 2}


def test_roi_align_plain_vs_pallas_interpreted():
    from jax.experimental.pallas import tpu as pltpu
    feats, boxes = _roi_inputs(0, 50, 32)
    with pltpu.force_tpu_interpret_mode():
        want = j_roi_mxu([jnp.asarray(f) for f in feats], jnp.asarray(boxes), SCALES,
                         roi_block=25, flat=True)
    got = multilevel_roi_align([_t(f) for f in feats], _t(boxes), SCALES)
    assert got.shape == want.shape == (1, 50, 49, 32)
    assert rel_err(got.numpy(), want) < 1e-5


def _boundary_boxes():
    """Square boxes at the origin and off it whose side sits on each level
    boundary of sqrt(area) (112, 224 and 448 pixels) and one ulp either
    side."""
    sides = [np.nextafter(np.float32(s), np.float32(to))
             for s in (112, 224, 448) for to in (0, s, 1e4)]
    boxes = [[x, y, x + s, y + s] for s in sides for x, y in ((0, 0), (100.25, 50.5))]
    return np.asarray(boxes, np.float32)[None]


def test_roi_align_levels_vs_jax_at_the_boundaries():
    """At every level boundary and one ulp either side the plain level
    assignment agrees with the JAX package's, and both sides of the p3/p4
    and p4/p5 boundaries are taken."""
    boxes = _boundary_boxes()
    lv = fpn_level_assignment(_t(boxes), 3, 3).numpy()
    np.testing.assert_array_equal(lv, np.asarray(j_levels(jnp.asarray(boxes), 3, 3)))
    assert set(lv.ravel().tolist()) == {0, 1, 2}


def _footprints_brute(rois, level, shapes):
    """Distinct rows and columns with a non-zero band weight, ROI by ROI,
    from ``_band_params`` sample by sample."""
    ys, xs, lh, lw = ra._sample_coords(rois, level, shapes, SCALES, 7, 2, True)
    b, r = rois.shape[:2]
    out = np.zeros((b, r, 2), np.int64)
    for i in range(b):
        for j in range(r):
            for a, (coords, size) in enumerate(((ys, lh), (xs, lw))):
                lo, w0, w1 = ra._band_params(coords[i, j], size[i, j])
                cells = {int(l) for l, w in zip(lo, w0) if w != 0}
                cells |= {int(l) + 1 for l, w in zip(lo, w1) if w != 0}
                out[i, j, a] = len(cells)
    return out


@pytest.mark.parametrize("case", ["random", "boundary", "tiny_maps"])
def test_roi_footprints_vs_brute_force(case):
    """K1's footprint function against a brute-force count, on ROIs over
    every border, zero-width ones, and maps of one and two cells."""
    sizes = ((32, 48), (16, 24), (8, 12))
    if case == "boundary":
        boxes = _boundary_boxes()
    else:
        _, boxes = _roi_inputs(2, 60, 8)
        if case == "tiny_maps":
            sizes = ((2, 3), (1, 2), (1, 1))
    rois = _t(boxes)
    level = fpn_level_assignment(rois, 3, 3)
    got = ra.roi_footprints(rois, level, sizes, SCALES)
    np.testing.assert_array_equal(got.numpy(), _footprints_brute(rois, level, sizes))
    assert int(got.max()) <= 28


@pytest.mark.parametrize("r", [50, 37])
def test_roi_align_plain_vs_gather(r):
    """Any R (the Pallas path needs R % 50 == 0; the port does not)."""
    feats, boxes = _roi_inputs(1, r, 16)
    want = np.asarray(j_roi_gather([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                   SCALES)).reshape(1, r, 49, 16)
    got = multilevel_roi_align([_t(f) for f in feats], _t(boxes), SCALES)
    assert rel_err(got.numpy(), want) < 1e-5


# ---------------------------------------------------------------- K2

def _dc_inputs(s=11, p=49, d=64, e=16, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(s, p, d).astype(np.float32), (r.randn(s, e, d) * 0.1).astype(np.float32),
            (r.randn(s, e, d) * 0.1).astype(np.float32),
            (1.0 + 0.1 * r.randn(e)).astype(np.float32), (0.1 * r.randn(e)).astype(np.float32),
            (1.0 + 0.1 * r.randn(d)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)]


def test_dynamic_conv_plain_vs_pallas_fp32():
    args = _dc_inputs()
    want = j_dynconv(*[jnp.asarray(a) for a in args], interpret=True)
    got = dynamic_conv_fused(*[_t(a) for a in args])
    assert rel_err(got.numpy(), want) < 1e-5


def test_dynamic_conv_plain_vs_pallas_bf16():
    """The tolerance of tests/test_dynamic_conv_pallas.py."""
    args = _dc_inputs(s=8)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i < 3 else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [_t(a).to(torch.bfloat16) if i < 3 else _t(a) for i, a in enumerate(args)]
    want = np.asarray(j_dynconv(*jargs, interpret=True), np.float32)
    got = dynamic_conv_fused(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


def test_dynamic_conv_gradient_vs_jax():
    """The kernel's backward recomputes through the plain version; its
    gradients match the JAX custom VJP's."""
    args = _dc_inputs(s=5, p=7, d=32, e=8)

    def loss(*a):
        return jnp.sum(j_dynconv(*a, 1e-5, True) ** 2)

    want = jax.grad(loss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    (dynamic_conv_ref(*targs) ** 2).sum().backward()
    for t, w in zip(targs, want):
        assert rel_err(t.grad.numpy(), w) < 1e-4


# ---------------------------------------------------------------- kernel wrappers
#
# Off the CPU a wrapper validates its inputs and launches its kernel; it never
# falls back to the plain version.  Meta tensors stand in for CUDA tensors, and
# a patched loader stops the wrapper where it would build the kernel.

class _ReachedLaunch(Exception):
    pass


@pytest.fixture
def stop_at_launch(monkeypatch):
    def load(name):
        raise _ReachedLaunch(name)
    monkeypatch.setattr(_build, "load", load)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _k1_args(c=64, r=37, dtype=torch.bfloat16):
    feats = [_meta(2, h, w, c, dtype=dtype) for h, w in ((32, 48), (16, 24), (8, 12))]
    return feats, _meta(2, r, 4), SCALES


def _k2_args(s=3, e=64, dtype=torch.bfloat16):
    return ([_meta(s, 49, 256, dtype=dtype), _meta(s, e, 256, dtype=dtype),
             _meta(s, e, 256, dtype=dtype)]
            + [_meta(n) for n in (e, e, 256, 256)])


class _Library:
    """Stands in for a loaded library: stops at the entry point asked for."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, entry):
        raise _ReachedLaunch(f"{self.name}.{entry}")


@pytest.mark.parametrize("kernel,dtype,entry", [
    ("roi_align_fwd", torch.bfloat16, "roi_align_fwd.roi_align_fwd_footprint"),
    ("roi_align_fwd", torch.float32, "roi_align_fwd.roi_align_fwd$"),
    ("dynamic_conv", torch.bfloat16, "dynamic_conv.dynamic_conv_ring"),
    ("dynamic_conv", torch.float32, "dynamic_conv.dynamic_conv_fwd")],
    ids=["roi_align_fwd", "roi_align_fwd_fp32", "dynamic_conv", "dynamic_conv_fp32"])
def test_wrapper_launches_kernel_off_the_cpu(monkeypatch, kernel, dtype, entry):
    """K1 takes the footprint design in bf16 and the first design in fp32,
    K2 the ring design in bf16 and the first design in fp32: the library's
    entry point each one reaches."""
    monkeypatch.setattr(_build, "load", _Library)
    monkeypatch.setattr(dc, "_FNS", {})
    monkeypatch.setattr(ra, "_FNS", {})
    if kernel == "roi_align_fwd":
        wrapper, args = multilevel_roi_align, _k1_args(dtype=dtype)
    else:
        wrapper, args = dynamic_conv_fused, _k2_args(dtype=dtype)
    before = wrapper.launches
    with pytest.raises(_ReachedLaunch, match=entry):
        wrapper(*args)
    assert wrapper.launches == before


@pytest.mark.parametrize("s", [1, 7, 1200, 1500, 2400])
def test_dynconv_plan_fits_the_card(s):
    """The ring design's plan on a 132-SM card: every proposal taken once,
    the shared bytes the layout's sum within the block's limit, two
    proposals or more in the ring."""
    plan = dc.dynconv_plan(s, 132)
    grid, stages = plan["grid"], plan["stages"]
    assert 1 <= grid <= min(s, 132)
    taken = sorted(p for b in range(grid) for p in range(b, s, grid))
    assert taken == list(range(s))
    per_block = [len(range(b, s, grid)) for b in range(grid)]
    assert (min(per_block), max(per_block)) == plan["per_block"]
    box = 64 * 64 * 2                       # 64 rows of 64 bf16 channels
    slot = (4 + 4) * box + 4 * box          # roi and p1t, then p2e: 4 boxes each
    ln = (64 + 64 + 256 + 256) * 4          # g1, b1, g2, b2 in fp32
    assert plan["smem_bytes"] == stages * slot + ln + 256 <= 232448
    assert stages >= 2


@pytest.mark.parametrize("b,r", [(8, 300), (4, 300), (1, 1), (2, 37)])
def test_fwd_plan_fits_the_card(b, r):
    """K1's footprint plan: every (frame, ROI) taken once a channel slice,
    the shared bytes the layout's sum within the block's limit, two blocks
    an SM, and room in a buffer for one band row of the widest footprint
    (28 columns)."""
    for c in (64, 256, 512):
        plan = ra.fwd_plan(b, r, c)
        gr, gb, gz = plan["grid"]
        assert (gr, gb) == (r, b) and gz * 256 >= c > (gz - 1) * 256
        taken = sorted(y * r + x for y in range(gb) for x in range(gr))   # ROI y * R + x
        assert taken == list(range(b * r))
        assert plan["threads"] == 14 * 32
        assert plan["cells"] >= 28
        # row and column offsets, Wx, the bins' rows and weights, their
        # counts (8), the two counts, the sides' column ranges, side 1's
        # first bin, the level, padding and the 28 samples of 4 words
        # (csrc: Tables)
        tables = 4 * (28 + 28 + 7 * 28 + 7 * 4 + 7 * 4 + 8 + 2 + 4 + 1 + 1 + 4 + 28 * 4)
        assert plan["smem_bytes"] == 2 * plan["cells"] * 512 + tables <= 232448
        assert 2 * (plan["smem_bytes"] + 1024) <= 233472     # two blocks an SM


def _k1_bad(case):
    feats, rois, scales = _k1_args()
    if case == "float16":
        return _k1_args(dtype=torch.float16), {}
    if case == "two_levels":
        return (feats[:2], rois, scales[:2]), {}
    if case == "output_size":
        return (feats, rois, scales), {"output_size": 14}
    if case == "odd_channels":
        return _k1_args(c=63), {}
    if case == "not_contiguous":
        feats[1] = feats[1].transpose(1, 2)
    if case == "mixed_dtypes":
        feats[2] = feats[2].float()
    if case == "rois_float64":
        rois = rois.double()
    if case == "unaligned":                 # p4 2 bytes past a 16-byte boundary
        feats[1] = _meta(2 * 16 * 24 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 24, 64)
    if case == "channels_not_16_bytes":     # even, but 60 bf16 channels are 120 bytes
        return _k1_args(c=60), {}
    return (feats, rois, scales), {}


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("two_levels", ValueError), ("output_size", ValueError),
    ("odd_channels", ValueError), ("not_contiguous", ValueError),
    ("mixed_dtypes", ValueError), ("rois_float64", ValueError),
    ("unaligned", ValueError), ("channels_not_16_bytes", ValueError)])
def test_roi_align_wrapper_rejects(stop_at_launch, case, error):
    args, kw = _k1_bad(case)
    with pytest.raises(error):
        multilevel_roi_align(*args, **kw)


def _k2_bad(case):
    if case == "float16":
        return _k2_args(dtype=torch.float16)
    if case == "dynamic_dim":
        return _k2_args(e=32)
    args = _k2_args()
    if case == "p2e_dtype":
        args[2] = args[2].float()
    if case == "p1t_rows":
        args[1] = _meta(2, 64, 256, dtype=torch.bfloat16)
    if case == "not_contiguous":
        args[0] = _meta(3, 256, 49, dtype=torch.bfloat16).transpose(1, 2)
    if case == "ln_dtype":
        args[5] = args[5].to(torch.bfloat16)
    if case == "ln_shape":
        args[3] = _meta(32)
    if case == "unaligned":                 # roi 2 bytes past a 16-byte boundary
        args[0] = _meta(3 * 49 * 256 + 1, dtype=torch.bfloat16)[1:].view(3, 49, 256)
    return args


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("dynamic_dim", ValueError), ("p2e_dtype", ValueError),
    ("p1t_rows", ValueError), ("not_contiguous", ValueError),
    ("ln_dtype", ValueError), ("ln_shape", ValueError), ("unaligned", ValueError)])
def test_dynamic_conv_wrapper_rejects(stop_at_launch, case, error):
    with pytest.raises(error):
        dynamic_conv_fused(*_k2_bad(case))


# ---------------------------------------------------------------- NMS, goldens

BOXES = np.array([[10, 10, 50, 60], [11, 12, 48, 60], [8, 9, 40, 50],
                  [100, 100, 150, 140], [99, 110, 155, 139]], np.float32)
SCORES = np.array([0.5, 0.7, 0.6, 0.9, 0.8], np.float32)


@pytest.mark.parametrize("thresh,expected", [
    (0.1, [1, 3]), (0.3, [1, 3]), (0.5, [1, 3]), (0.8, [1, 2, 3, 4]),
    (0.9, [0, 1, 2, 3, 4])])
def test_nms_golden_caffe2(thresh, expected):
    keep = nms_mask(_t(BOXES), _t(SCORES), thresh, plus_one=True).numpy()
    np.testing.assert_array_equal(np.nonzero(keep)[0], expected)


def test_nms_valid_mask_and_classes_golden():
    valid = torch.tensor([True, False, True, True, True])
    keep = nms_mask(_t(BOXES), _t(SCORES), 0.5, valid=valid, plus_one=True).numpy()
    np.testing.assert_array_equal(np.nonzero(keep)[0], [2, 3])
    keep = batched_nms_mask(_t(np.tile(BOXES[:2], (2, 1))), torch.tensor([0.5, 0.7, 0.5, 0.7]),
                            torch.tensor([1, 1, 2, 2]), 0.5, plus_one=True).numpy()
    np.testing.assert_array_equal(keep, [False, True, False, True])


def test_nms_random_vs_jax_with_ties():
    """Dense overlaps, tied scores (the JAX order: stable ascending sort,
    reversed) and a batch of frames against per-frame JAX calls."""
    rng = np.random.RandomState(0)
    f, n = 3, 60
    boxes = rng.uniform(0, 80, (f, n, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 60, (f, n, 2))
    scores = np.round(rng.uniform(0, 1, (f, n)), 1).astype(np.float32)
    labels = rng.randint(1, 4, (f, n))
    valid = rng.uniform(size=(f, n)) > 0.1
    got = nms_mask(_t(boxes), _t(scores), 0.5, valid=_t(valid)).numpy()
    got_b = batched_nms_mask(_t(boxes), _t(scores), _t(labels), 0.5, valid=_t(valid)).numpy()
    for i in range(f):
        want = j_nms.nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5,
                              valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i], np.asarray(want))
        want = j_nms.batched_nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                      jnp.asarray(labels[i]), 0.5, valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got_b[i], np.asarray(want))


def test_box_goldens_caffe2():
    bbox = np.array([[175.62031555, 20.91103172, 253.352005, 155.0145874],
                     [169.24636841, 4.85241556, 228.8605957, 105.02092743],
                     [181.77426147, 199.82876587, 192.88427734, 214.0255127],
                     [174.36262512, 186.75761414, 296.19091797, 231.27906799],
                     [22.73153877, 92.02596283, 135.5695343, 208.80291748]], np.float32)
    deltas = np.array([[0.47861834, 0.13992102, 0.14961673, 0.71495209],
                       [0.29915856, -0.35664671, 0.89018666, 0.70815367],
                       [-0.03852064, 0.44466892, 0.49492538, 0.71409376],
                       [0.28052918, 0.02184832, 0.65289006, 1.05060139],
                       [-0.38172557, -0.08533806, -0.60335309, 0.79052375]], np.float32)
    gt = np.array([[206.949539, -30.715202, 297.387665, 244.448486],
                   [143.871216, -83.342888, 290.502289, 121.053398],
                   [177.430283, 198.666245, 196.295273, 228.703079],
                   [152.251892, 145.431564, 387.215454, 274.594238],
                   [5.062420, 11.040955, 66.328903, 269.686218]], np.float32)
    out = decode_boxes(_t(deltas), _t(bbox), weights=(1.0, 1.0, 1.0, 1.0), plus_one=True)
    np.testing.assert_allclose(out.numpy(), gt, atol=1e-3)
    np.testing.assert_allclose(cxcywh_to_xyxy(xyxy_to_cxcywh(_t(bbox))).numpy(), bbox, atol=1e-4)
    a = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    b = torch.tensor([[5.0, 5.0, 15.0, 15.0], [20.0, 20.0, 30.0, 30.0]])
    np.testing.assert_allclose(pairwise_iou(a, b).numpy(), [[25.0 / 175.0, 0.0]], atol=1e-6)
    np.testing.assert_allclose(pairwise_iou(a, b, plus_one=True)[0, 0].item(),
                               36.0 / (121 + 121 - 36), atol=1e-6)
    np.testing.assert_allclose(clip_to_image(torch.tensor([[-5.0, -3.0, 120.0, 90.0]]),
                                             (80, 100)).numpy(), [[0.0, 0.0, 100.0, 80.0]])


# ---------------------------------------------------------------- FPS, memory, top-k

def test_fps_vs_jax():
    feats = np.random.RandomState(1).randn(40, 16).astype(np.float32)
    valid = np.arange(40) % 7 != 3
    want = j_fps.farthest_point_sample(j_fps.pairwise_l2_distance(jnp.asarray(feats)), 12,
                                       valid=jnp.asarray(valid))
    got = farthest_point_sample(pairwise_l2_distance(_t(feats)), 12, valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("count,new_count", [(3, 4), (5, 9), (0, 12)],
                         ids=["fits", "fps", "fps_from_empty"])
def test_update_erase_memory_vs_jax(count, new_count):
    rng = np.random.RandomState(count + new_count)
    cap, d = 10, 8
    mem = np.zeros((cap, d), np.float32)
    mem[:count] = rng.randn(count, d)
    new = rng.randn(12, d).astype(np.float32) * rng.uniform(0.5, 2, (12, 1)).astype(np.float32)
    want = j_memory.update_erase_memory(
        j_memory.FeatureMemory(jnp.asarray(mem), jnp.asarray(count, jnp.int32)),
        jnp.asarray(new), jnp.asarray(new_count, jnp.int32))
    got = update_erase_memory(FeatureMemory(_t(mem), count), _t(new), new_count)
    assert got.count == int(want.count)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats), atol=1e-6)


def test_select_topk_vs_jax_with_ties():
    rng = np.random.RandomState(2)
    logits = np.round(rng.randn(2, 16, 5), 1).astype(np.float32)   # many ties
    boxes = rng.uniform(0, 50, (2, 16, 4)).astype(np.float32)
    got = select_topk_detections(_t(logits), _t(boxes), 20)
    for f in range(2):
        want = j_topk(jnp.asarray(logits[f]), jnp.asarray(boxes[f]), 20)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[f].numpy(), np.asarray(w))

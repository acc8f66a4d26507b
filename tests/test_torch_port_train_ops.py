"""The ROIAlign feature gradient (K3's plain version) against the JAX package.

CPU, float32.  ``multilevel_roi_align_bwd_ref`` is held against the Pallas
kernel ``multilevel_roi_align_bwd_mxu`` in interpret mode and against the
VJP of JAX's gather formulation, over mixed-level, border-crossing and
degenerate ROIs (atol 2e-4, rtol 1e-3, the JAX package's own tolerance for
its kernel).  The CPU autograd gradient of ``multilevel_roi_align`` matches
the plain backward.  Off the CPU (meta tensors stand in for CUDA ones) the
forward goes through the autograd function to K1, the backward to K3, and
neither falls back to a plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionvid_tpu.ops.roi_align import multilevel_roi_align as j_roi_gather
from diffusionvid_tpu.ops.roi_align_pallas import _band_params as j_band_params
from diffusionvid_tpu.ops.roi_align_pallas import multilevel_roi_align_bwd_mxu as j_bwd_mxu

from diffusionvid_torch.ops import _build
from diffusionvid_torch.ops import roi_align as ra
from test_torch_port_ops import _ReachedLaunch, _meta, _roi_inputs, stop_at_launch  # noqa: F401

SCALES = (1 / 8, 1 / 16, 1 / 32)
SIZES = ((32, 48), (16, 24), (8, 12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bwd_inputs(seed, r=25, c=32):
    feats, boxes = _roi_inputs(seed, r, c, SIZES)
    boxes[0, 4] = [100.0, 60.0, 100.0, 60.0]               # zero area
    boxes[0, 5] = [-300.0, -300.0, -200.0, -250.0]         # outside the image
    boxes[0, 6] = [370.0, 10.0, 383.9, 250.0]              # samples in the last column
    g = np.random.RandomState(seed + 100).randn(1, r, 49, c).astype(np.float32)
    return feats, boxes, g


def test_band_params_vs_jax():
    rng = np.random.RandomState(0)
    coords = np.concatenate([rng.uniform(-3, 12, 40), [-1.0, -1.5, 0.0, 7.0, 7.5, 8.0, 8.2,
                                                        2.0]]).astype(np.float32)[None]
    for size in (8.0, 1.0, 2.0):
        sizes = np.full((1, 1), size, np.float32)
        got = ra._band_params(_t(coords), _t(sizes))
        want = j_band_params(jnp.asarray(coords), jnp.asarray(sizes))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bwd_plain_vs_pallas_interpreted():
    from jax.experimental.pallas import tpu as pltpu
    feats, boxes, g = _bwd_inputs(0)
    lv = ra.fpn_level_assignment(_t(boxes), 3, 3).numpy()
    assert set(lv.ravel().tolist()) == {0, 1, 2}
    with pltpu.force_tpu_interpret_mode():
        want = j_bwd_mxu(jnp.asarray(g), jnp.asarray(boxes), SIZES, SCALES, roi_block=25)
    got = ra.multilevel_roi_align_bwd_ref(_t(g), _t(boxes), SIZES, SCALES, torch.float32)
    for lvl, (gr, wr) in enumerate(zip(got, want)):
        assert gr.shape == wr.shape == (1, *SIZES[lvl], 32)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=2e-4, rtol=1e-3,
                                   err_msg=f"level {lvl}")


@pytest.mark.parametrize("seed", [1, 2])
def test_bwd_plain_vs_gather_vjp(seed):
    feats, boxes, g = _bwd_inputs(seed, r=37, c=16)
    _, vjp = jax.vjp(lambda fs: j_roi_gather(list(fs), jnp.asarray(boxes), SCALES),
                     [jnp.asarray(f) for f in feats])
    (want,) = vjp(jnp.asarray(g).reshape(1, 37, 7, 7, 16))
    got = ra.multilevel_roi_align_bwd_ref(_t(g), _t(boxes), SIZES, SCALES, torch.float32)
    for lvl, (gr, wr) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=2e-4, rtol=1e-3,
                                   err_msg=f"level {lvl}")


def test_cpu_autograd_matches_plain_backward():
    """On the CPU the wrapper is the plain forward, differentiated by
    autograd; its feature gradient is the plain backward's, and the ROIs
    get none."""
    feats, boxes, g = _bwd_inputs(3, r=30, c=16)
    fs = [_t(f).requires_grad_() for f in feats]
    rois = _t(boxes)
    out = ra.multilevel_roi_align(fs, rois, SCALES)
    out.backward(_t(g))
    want = ra.multilevel_roi_align_bwd(_t(g), rois, SIZES, SCALES, torch.float32)
    for f, w in zip(fs, want):
        np.testing.assert_allclose(f.grad.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)
    assert rois.grad is None


def test_bwd_plain_casts_to_bfloat16():
    """fp32 accumulation, one cast to the features' dtype at the end."""
    _, boxes, g = _bwd_inputs(4, r=20, c=16)
    gb = _t(g).to(torch.bfloat16)
    got = ra.multilevel_roi_align_bwd_ref(gb, _t(boxes), SIZES, SCALES, torch.bfloat16)
    want = ra.multilevel_roi_align_bwd_ref(gb.float(), _t(boxes), SIZES, SCALES,
                                           torch.float32)
    for gr, wr in zip(got, want):
        assert gr.dtype == torch.bfloat16
        torch.testing.assert_close(gr, wr.to(torch.bfloat16), atol=0, rtol=0)


# ---------------------------------------------------------------- off the CPU

def _k3_args(c=64, r=37, dtype=torch.bfloat16):
    return (_meta(2, r, 49, c, dtype=dtype), _meta(2, r, 4), SIZES, SCALES, dtype)


def test_bwd_wrapper_launches_kernel_off_the_cpu(stop_at_launch):
    before = ra.multilevel_roi_align_bwd.launches
    with pytest.raises(_ReachedLaunch, match="roi_align_bwd"):
        ra.multilevel_roi_align_bwd(*_k3_args())
    assert ra.multilevel_roi_align_bwd.launches == before


def test_forward_with_grad_goes_to_the_kernel(stop_at_launch):
    """Features that need a gradient take the autograd function, whose
    forward is K1 (the wrapper no longer refuses them)."""
    feats = [_meta(2, h, w, 64, dtype=torch.bfloat16).requires_grad_() for h, w in SIZES]
    with pytest.raises(_ReachedLaunch, match="roi_align_fwd"):
        ra.multilevel_roi_align(feats, _meta(2, 37, 4), SCALES)


def test_autograd_backward_is_k3(monkeypatch):
    """The autograd function's backward launches K3 on the levels the
    forward's K1 launch returned and gives the ROIs no gradient."""
    calls = {}

    def fake_fwd(features, rois, scales):
        level = ra._levels(features, rois, scales)
        calls["fwd_level"] = level
        return torch.zeros(rois.shape[0], rois.shape[1], 49, features[0].shape[3],
                           dtype=features[0].dtype), level

    def fake_bwd(g, rois, level, shapes, scales):
        calls["bwd"] = (g.dtype, level, shapes)
        return [torch.full((g.shape[0], h, w, g.shape[3]), 2.0, dtype=g.dtype)
                for h, w in shapes]

    monkeypatch.setattr(ra, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(ra, "_launch_bwd", fake_bwd)
    feats, boxes, _ = _bwd_inputs(5, r=10, c=64)
    fs = [_t(f).requires_grad_() for f in feats]
    rois = _t(boxes).requires_grad_()
    out = ra._RoiAlignFn.apply(rois, SCALES, *fs)
    out.sum().backward()
    assert calls["bwd"][1] is calls["fwd_level"] and calls["bwd"][2] == list(SIZES)
    assert all(float(f.grad.min()) == float(f.grad.max()) == 2.0 for f in fs)
    assert rois.grad is None


@pytest.mark.parametrize("case", ["two_levels", "float16", "cotangent_dtype",
                                  "cotangent_bins", "odd_channels", "rois_float64",
                                  "not_contiguous"])
def test_bwd_wrapper_rejects(stop_at_launch, case):
    g, rois, sizes, scales, dtype = _k3_args()
    if case == "two_levels":
        sizes, scales = sizes[:2], scales[:2]
    if case == "float16":
        g, dtype = g.to(torch.float16), torch.float16
    if case == "cotangent_dtype":
        g = g.float()
    if case == "cotangent_bins":
        g = _meta(2, 37, 36, 64, dtype=dtype)
    if case == "odd_channels":
        g = _meta(2, 37, 49, 63, dtype=dtype)
    if case == "rois_float64":
        rois = rois.double()
    if case == "not_contiguous":
        g = _meta(2, 37, 64, 49, dtype=dtype).transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        ra.multilevel_roi_align_bwd(g, rois, sizes, scales, dtype)


PLAN_SHAPES = [((76, 128), (38, 64), (19, 32)),          # the flagship train maps
               ((1, 1), (3, 300), (257, 2)),
               ((37, 300), (19, 150), (10, 75)),
               ((32, 48), (16, 24), (8, 12))]


@pytest.mark.parametrize("shapes", PLAN_SHAPES)
def test_kernel_tiling_covers_every_map(shapes):
    """K3's plan: tiles of at most 256 cells cover each level exactly, the
    cluster split is within the portable limit of 8 and the shared bytes a
    block fit the H100's 227 KB, for both dtypes and several batch shapes."""
    for r, elt in ((300, 2), (300, 4), (1, 2), (1000, 4)):
        plan = ra.bwd_plan(shapes, r, elt)
        assert plan["tiles_total"] == sum(lv["tiles"] for lv in plan["levels"])
        for (h, w), lv in zip(shapes, plan["levels"]):
            tr, tw, nx, n = lv["rows"], lv["cols"], lv["tiles_x"], lv["tiles"]
            assert tr * tw <= ra._BWD_CELLS and tr >= 1 and tw >= 1
            assert nx * tw >= w and (nx - 1) * tw < w
            assert (n // nx) * tr >= h and (n // nx - 1) * tr < h and n % nx == 0
            assert 1 <= lv["cluster"] <= 8
            assert lv["smem_bytes"] == ra._bwd_smem(tr, tw, elt, r) <= 232_448
    assert _build.sources().count("roi_align_bwd") == 1


def test_bwd_plan_splits_the_coarse_levels():
    """At the flagship train shape every level splits its tiles' ROI lists
    over a cluster, the coarse levels, whose few tiles take the most ROIs
    each, over the largest."""
    plan = ra.bwd_plan(PLAN_SHAPES[0], 300, 2)
    clusters = [lv["cluster"] for lv in plan["levels"]]
    assert 1 < clusters[0] < clusters[1] < clusters[2] == 8


def test_bwd_scratch_layout():
    b, r, t = 3, 41, 17
    words = ra.bwd_scratch_words(b, r, t)
    scratch = torch.arange(words, dtype=torch.int32)
    lists, counts = ra.bwd_scratch_lists(scratch, b, r, t)
    assert lists.shape == (b, t, r) and counts.shape == (b, t)
    assert int(counts[-1, -1]) == words - 1
    assert int(lists[0, 0, 0]) == b * r * ra._BWD_RECORD


def _crowded_boxes(seed, r, sizes=SIZES):
    """Train-like crowded ROIs over the image of ``sizes``: large boxes
    piled around three centres (most on p4 and p5), every 10th the whole
    image, every 7th small (p3)."""
    rng = np.random.RandomState(seed)
    img = np.array([sizes[0][1] * 8, sizes[0][0] * 8], np.float32)
    centres = rng.uniform(0, 1, (3, 2)) * img
    ctr = centres[rng.randint(0, 3, r)] + rng.randn(r, 2) * img * 0.05
    side = rng.uniform(0.6, 2.2, (r, 2)) * img
    side[::7] = rng.uniform(10, 60, (len(side[::7]), 2))
    boxes = np.concatenate([ctr - side / 2, ctr + side / 2], -1)
    boxes[::10] = [0.0, 0.0, img[0], img[1]]
    return boxes[None].astype(np.float32)


def _brute_lists(boxes, level, shapes, plan):
    """Per frame and tile the ROIs whose band weights reach a cell in the
    tile's rows and one in its columns (their extent), by explicit loops."""
    ys, xs, lh, lw = ra._sample_coords(boxes, level, shapes, SCALES, 7, 2, True)
    ylo, wy0, wy1 = ra._band_params(ys, lh[..., None])
    xlo, wx0, wx1 = ra._band_params(xs, lw[..., None])
    b, r = boxes.shape[:2]
    out = []
    for f in range(b):
        ext = []
        for i in range(r):
            axes = []
            for lo, w0, w1 in ((ylo, wy0, wy1), (xlo, wx0, wx1)):
                cells = [int(lo[f, i, k]) for k in range(14) if w0[f, i, k] != 0] + \
                        [int(lo[f, i, k]) + 1 for k in range(14) if w1[f, i, k] != 0]
                axes.append((min(cells), max(cells)) if cells else None)
            ext.append(axes)
        frame = []
        for li, lv in enumerate(plan["levels"]):
            for t in range(lv["tiles"]):
                r0, c0 = (t // lv["tiles_x"]) * lv["rows"], (t % lv["tiles_x"]) * lv["cols"]
                frame.append([i for i in range(r) if int(level[f, i]) == li
                              and ext[i][0] is not None and ext[i][1] is not None
                              and ext[i][0][0] < r0 + lv["rows"] and ext[i][0][1] >= r0
                              and ext[i][1][0] < c0 + lv["cols"] and ext[i][1][1] >= c0])
        out.append(frame)
    return out


@pytest.mark.parametrize("kind", ["spread", "crowded"])
def test_tile_lists_plain_vs_brute_force(kind):
    """``bwd_tile_lists_ref`` (the plain version of K3's prepass lists)
    agrees with a brute-force scan, and every tile in which a ROI's own
    gradient is non-zero lists that ROI."""
    if kind == "spread":
        _, boxes, _ = _bwd_inputs(7, r=40, c=8)
    else:
        boxes = _crowded_boxes(7, 43)
    rois = _t(boxes)
    level = ra._levels(SIZES, rois, SCALES)
    assert set(level.ravel().tolist()) == {0, 1, 2}
    plan = ra.bwd_plan(SIZES, rois.shape[1], 4)
    lists, counts = ra.bwd_tile_lists_ref(rois, level, SIZES, SCALES, plan)
    assert lists.shape == (1, plan["tiles_total"], rois.shape[1])
    want = _brute_lists(rois, level, SIZES, plan)
    for t, ids in enumerate(want[0]):
        assert int(counts[0, t]) == len(ids)
        assert lists[0, t, :len(ids)].tolist() == ids
        assert (lists[0, t, len(ids):] == -1).all()
    # a ROI's gradient with a cotangent of ones is non-zero exactly where its
    # band weights reach; each such cell's tile lists the ROI
    toff = np.cumsum([0] + [lv["tiles"] for lv in plan["levels"]])
    for i in range(rois.shape[1]):
        g = torch.zeros(1, rois.shape[1], 49, 1)
        g[0, i] = 1.0
        grads = ra.multilevel_roi_align_bwd_ref(g, rois, SIZES, SCALES, torch.float32)
        for li, (gr, lv) in enumerate(zip(grads, plan["levels"])):
            for y, x in (gr[0, ..., 0] != 0).nonzero().tolist():
                t = toff[li] + (y // lv["rows"]) * lv["tiles_x"] + x // lv["cols"]
                assert i in lists[0, t, :int(counts[0, t])].tolist()


def test_bwd_plain_vs_pallas_interpreted_crowded():
    """The plain version against the Pallas kernel in interpret mode on a
    crowded, train-like ROI set (long per-tile lists on p4 and p5)."""
    from jax.experimental.pallas import tpu as pltpu
    boxes = _crowded_boxes(3, 50)
    lv = ra.fpn_level_assignment(_t(boxes), 3, 3).numpy()
    counts = [int((lv == i).sum()) for i in range(3)]
    assert min(counts) > 0 and counts[1] + counts[2] > 2 * counts[0]
    g = np.random.RandomState(103).randn(1, 50, 49, 32).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_bwd_mxu(jnp.asarray(g), jnp.asarray(boxes), SIZES, SCALES, roi_block=25)
    got = ra.multilevel_roi_align_bwd_ref(_t(g), _t(boxes), SIZES, SCALES, torch.float32)
    for lvl, (gr, wr) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=2e-4, rtol=1e-3,
                                   err_msg=f"level {lvl}")

"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  1. device   the card's name and power limit (``nvidia-smi``); fails
              without a CUDA device;
  2. build    compiles every ``diffusionvid_torch/csrc/*.cu`` with nvcc;
              then ``ptxas``, K1's, K2's, K4's, K5's and K6's registers and
              spills per kernel, and K7's bf16 kernel on a line of its own;
  3. kernels  each kernel against its plain PyTorch version at the shapes
              of the flagship paths, in bfloat16 and float32, with the
              tolerance stated; times the kernel, the plain version and the
              bound from bytes and flops.  ROIAlign (K1) runs at an R-101
              chunk's 8 frames and, in bf16, a Swin-B chunk's 4 (300 ROIs a
              frame): its levels against ``_levels`` for every ROI, two
              bit-equal launches, its footprint per level against the 784
              taps a ROI of the first design, the bytes its design moves,
              its plan, card time ``kernel_ms``, ``ms`` and host time
              ``host_ms``; then edge cases, checked but not timed (1 and 37
              ROIs, frames on one level, ROIs under one cell, elongated
              boxes, boxes over every border or of zero size, and boxes on
              each level boundary and an ulp or two either side).
              DynamicConv (K2) runs at an
              R-101 chunk's 2,400 proposals and, in bf16, at a Swin-B
              chunk's 1,200, records its design and launch plan, launches
              twice to show that it is deterministic, times its card time
              ``kernel_ms`` and the library chain (bmm, layer_norm, relu,
              bmm, layer_norm, relu) as ``unfused_ms``, and is checked at
              1, 7 and 133 proposals.  The ROIAlign backward (K3) runs
              at the R-101 train shapes (5 frames at 608x1024, 300 ROIs),
              with spread ROIs and with crowded ones (most on p4 and p5,
              some the whole image), and on a wide map; it is launched twice
              to show that it is deterministic, and its prepass's per-tile
              ROI lists are held against their plain version.  The Swin
              kernels run at the four Swin-B stage maps of 608x1024 (4
              frames for K4, K5 and K7, 5 for K6, the train step's), with
              shift 0 and 3 (masked) and the true valid sizes, then at
              Swin-T's widths; their line holds the per-stage numbers, and
              their ``ms`` and ``bound_ms`` are means per launch over one
              backbone pass (stage depths 2, 2, 18, 2).  K6 and K7 also
              time ``F.scaled_dot_product_attention`` over the partitioned
              windows as ``library_ms``; K6 also ``library_full_ms`` (one
              ``F.linear`` for q, k, v plus that call, with the relayouts:
              its whole function), its card time ``kernel_ms`` and its
              launch ``plan`` per stage, launches twice to show that it is
              deterministic, times its backward and checks its autograd
              gradients against the twin's in float32.  K7 records its launch
              ``plan`` per stage, launches twice to show that it is
              deterministic, times its card time ``kernel_ms`` and its host
              time ``host_ms``, and in bf16 is launched with every plan of
              ``window_plans`` on a Swin-T-width map of 216 windows, whose
              window runs and last waves are left partly empty.  K5 records its path
              (fused or wgmma) and plan per stage, launches twice to show
              that it is deterministic, times its card time ``kernel_ms`` and
              the library chain (layer_norm, linear, gelu, linear, add) as
              ``unfused_ms``, and on the wgmma path holds the LN pass's y
              and the fc1 product's hidden map h against their plain
              versions;
  4. tiny     a depth-18 model, then a Swin-T model in each kernel mode
              (v3: K4/K5, v2: K6, v1: K7), on 64x96 frames through the whole
              x1 streaming path, once on the card through the kernels and
              once on the CPU through the plain versions, same weights and
              noise, float32, TF32 off; then the depth-18 model and Swin-T
              in mode v3 through the x4 DDIM ensemble the same way, at a
              renewal threshold that renews some slots and keeps others:
              the renewal masks equal, no best score within 1e-4 of it;
  5. flagship ``configs/vid_R_101_DiffusionVID.yaml`` at full width with
              random weights from ``--seed``, bfloat16: ``start_video`` on
              24 global frames then 3 chunks of 8 frames at 608x1024; checks
              finite outputs and the kernels' launch counts, prints fps,
              peak memory, one chunk's device time by kernel and its NMS's
              host time and passes; then
              ``k1_stream``: K1 on the 4 launches of the last chunk, checked
              in bf16 as in phase 3 and timed, with its footprint per level,
              its inputs saved to ``build/chip_smoke/k1_stream_inputs.pt``;
  6. flagship_swin ``configs/vid_Swin_B_DiffusionVID.yaml`` the same way:
              24 global frames then 6 chunks of 4 frames at 608x1024; then
              ``flagship_swin_v1``, the trunk in mode v1 (K7), 2 chunks,
              with K7's card time in the profiled chunk; then
              ``flagship_x4`` and ``flagship_swin_x4``, both flagships with
              SAMPLE_STEP 4 (the x4 DDIM ensemble, 1,200 detections a frame
              into one NMS): R-101 3 chunks of 8 (66 launches of K1/K2),
              Swin-B 2 chunks of 4 (56 of K1/K2, 192 of K4/K5);
  7. tiny_train one train micro-step of a depth-18 model on 64x96 frames
              (1 + 2 frames, 50 proposals), on the card through K1, K2 and K3
              and on the CPU through the plain versions, same weights, batch
              and draws, float32, TF32 off: losses and every gradient; then
              ``tiny_train_swin``, the same with a Swin-T trunk (K6);
  8. flagship_train the R-101 train step (``engine/train.py``) at full width
              with random weights and random GT from ``--seed``: 5 frames at
              608x1024, bf16, ACCUMULATION_STEPS 2; 2 warm-up optimizer steps,
              then 5 timed ones; checks finite losses, moved parameters and
              4 launches each of K1, K2 and K3 per micro-step, prints ms per
              optimizer step, frames/s, peak memory, one micro-step's
              device time by kernel and host time by operator, and the
              time the criterion takes in a micro-step; then
              ``flagship_train_swin``, the Swin-B train step the same way
              with 3 timed steps and 24 launches of K6 per micro-step;
  9. k3_train K3 on the inputs of the R-101 train step's last micro-step
              (4 launches): checked in bf16 and fp32 as in phase 3, timed,
              with its bound, its ROIs and longest tile list per level and
              its plan.
Then the ``kernels`` line (every kernel with its launches on its flagship
path, error against its plain version, times and bound; K1's with its card
time, host time and card time on the stream's inputs; K1's, K2's, K4's and
K5's with ``x4_launches`` on the x4 streams; K7's with its card time, host
time, card time in a v1 chunk and registers), the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero before that line.  Needs the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and compute rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = dict(frames=8, h=608, w=1024, props=300, c=256)
# Swin-B at 608x1024 over a 4-frame chunk: per stage the valid map, the
# channels, the heads and the blocks
SWIN_B_STAGES = [dict(hw=(152, 256), c=128, heads=4, depth=2),
                 dict(hw=(76, 128), c=256, heads=8, depth=2),
                 dict(hw=(38, 64), c=512, heads=16, depth=18),
                 dict(hw=(19, 32), c=1024, heads=32, depth=2)]
SWIN_FRAMES = 4
# Swin-T's stage maps at 64x96 over 2 frames: the other widths the kernels
# are built for, checked but not timed
SWIN_T_STAGES = [dict(hw=(16, 24), c=96, heads=3), dict(hw=(8, 12), c=192, heads=6),
                 dict(hw=(4, 6), c=384, heads=12), dict(hw=(2, 3), c=768, heads=24)]


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) of an ``nvcc -Xptxas -v`` log: registers,
    spill store bytes and static shared memory."""
    import re
    rows, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            rows[name] = {}
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            rows[name].setdefault("spill_bytes", int(m.group(1)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            rows[name].update(registers=int(m.group(1)),
                              static_smem=int(smem.group(1)) if smem else 0)
    return rows


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernels, iters: int = 20, launches_per_call: int | None = None) -> float:
    """Device time a call of ``fn`` spends in the kernels whose names hold
    one of ``kernels`` (``torch.profiler``): K3's time where its wrapper's
    host side, not the card, sets the pace of back-to-back calls, so that
    ``cuda_time_ms`` would time the host.  With ``launches_per_call``, the
    mean over the kernel events the trace holds times that count: a trace
    that lost some events (seen on the card) then still gives a launch's
    time.  A trace that holds none of them (also seen on the card, for
    any kernel, with the code unchanged) is taken again, up to three
    times; then the call is timed with CUDA events, and a ``profiler``
    line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA and any(k in e.name for k in kernels)]
        if sum(times) > 0:
            if launches_per_call:
                return sum(times) / len(times) * launches_per_call / 1e3
            return sum(times) / iters / 1e3
    emit("profiler", kernels=list(kernels), traces=3, timed_by="cuda events")
    return cuda_time_ms(fn, iters)


# K3's kernels: the prepass and the per-level kernel
K3_KERNELS = ("roi_prepass_kernel", "roi_align_bwd_kernel")
# K6's bf16 kernel
K6_KERNELS = ("attn_qkv_bf16_kernel",)
# K7's bf16 kernel (the same name in the first design)
K7_KERNELS = ("attn_bf16_kernel",)
# K5's bf16 kernels: the fused kernel, or the LN pass and the two products
K5_KERNELS = ("mlp_bf16_kernel", "mlp_ln_kernel", "mlp_gemm_kernel")


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, atol: float, rtol: float, what: str) -> dict:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    bad = err > atol + rtol * want.abs()
    res = {"max_abs_err": float(err.max()),
           "max_rel_err": float(err.max() / want.abs().max().clamp(min=1e-12)),
           "atol": atol, "rtol": rtol, "n_over": int(bad.sum())}
    if res["n_over"]:
        idx = bad.nonzero()[:8]
        emit("mismatch", what=what, index=idx.tolist(),
             got=got[tuple(idx.T)].tolist(), want=want[tuple(idx.T)].tolist())
    require(res["n_over"] == 0, f"{what}: {res['n_over']} elements over "
            f"atol {atol} + rtol {rtol}·|ref| (max abs err {res['max_abs_err']})")
    return res


# ---------------------------------------------------------------- kernels

def flagship_rois(gen, b: int, r: int, h: int, w: int):
    """ROIs over all three levels, crossing the image border, and some
    zero-width or zero-height boxes."""
    side = torch.exp(torch.empty(b, r, 2).uniform_(2.5, 6.9, generator=gen))
    ctr = torch.rand(b, r, 2, generator=gen) * torch.tensor([w * 1.2, h * 1.2]) \
        - torch.tensor([w * 0.1, h * 0.1])
    boxes = torch.cat([ctr - side / 2, ctr + side / 2], -1)
    boxes[:, ::17, 2] = boxes[:, ::17, 0]          # zero width
    boxes[:, 5::23, 3] = boxes[:, 5::23, 1]        # zero height
    return boxes.contiguous()


def host_ms(fn, iters: int = 20) -> float:
    """The median host time to enqueue one call of ``fn`` (no
    synchronisation around the call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


# K1's frames a call: an R-101 chunk (8 frames) and a Swin-B chunk (4), 300
# ROIs each; its kernels: the footprint design (bf16) and the first (fp32)
K1_FRAMES = (FLAGSHIP["frames"], SWIN_FRAMES)
K1_KERNELS = ("roi_footprint_kernel", "roi_align_fwd_kernel")
K1_SCALES = (1 / 8, 1 / 16, 1 / 32)


def k1_maps(gen, dev, dtype, frames: int, h: int = FLAGSHIP["h"], w: int = FLAGSHIP["w"],
            c: int = FLAGSHIP["c"]):
    """p3..p5 of ``frames`` frames at ``h`` x ``w``, NHWC, drawn from ``gen``."""
    return [torch.randn(frames, -(-h // s), -(-w // s), c, generator=gen).to(dev, dtype)
            for s in (8, 16, 32)]


def k1_footprint(feats, rois, scales, level) -> dict:
    """K1's footprint on these inputs (``roi_footprints``): per level the
    ROIs and the mean distinct rows, columns and cells a ROI, against the
    784 taps a ROI the first design made; and ``design_bytes``, what the
    footprint design moves: each ROI's cells once, the output, the ROIs
    and the levels."""
    from diffusionvid_torch.ops import roi_align as ra
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    fp = ra.roi_footprints(rois, level, shapes, scales)
    cells = fp[..., 0] * fp[..., 1]
    per_level = []
    for i in range(3):
        sel = level == i
        n = int(sel.sum())
        per_level.append({"rois": n, "rows": float(fp[..., 0][sel].float().mean()) if n else 0.0,
                          "cols": float(fp[..., 1][sel].float().mean()) if n else 0.0,
                          "cells": float(cells[sel].float().mean()) if n else 0.0})
    c, elt = feats[0].shape[3], feats[0].element_size()
    out_bytes = rois.shape[0] * rois.shape[1] * 49 * c * elt
    return {"footprint_cells": {"levels": per_level, "mean": float(cells.float().mean()),
                                "taps": 784},
            "design_bytes": float(cells.sum()) * c * elt + out_bytes + rois.numel() * 4
            + level.numel() * 4}


def k1_bound(feats, rois) -> tuple[float, str]:
    """K1's bound: one read of the maps and the ROIs, one write of the
    output and the levels; 16 taps (32 flops) an output element."""
    elt = feats[0].element_size()
    out = rois.shape[0] * rois.shape[1] * 49 * feats[0].shape[3]
    nbytes = (sum(t.numel() for t in feats) * elt + rois.numel() * 4
              + rois.shape[0] * rois.shape[1] * 4 + out * elt)
    return bound_ms(nbytes, out * 4 * 4 * 2, feats[0].dtype)


def k1_case(feats, rois, scales=K1_SCALES, what="K1") -> dict:
    """K1 on one set of inputs: the wrapper's output against the plain
    version (fp32: (1e-5, 1e-5); bf16: (1e-5, 2^-6)); the levels the kernel
    wrote against ``_levels`` on the card for every ROI
    (``levels_equal``); a second launch bit-equal in output and levels
    (``deterministic``); the ROIs a level."""
    from diffusionvid_torch.ops import roi_align as ra
    dtype = feats[0].dtype
    got = ra.multilevel_roi_align(feats, rois, scales)
    again, level = ra._launch_fwd(feats, rois, scales)
    want = ra.multilevel_roi_align_ref(feats, rois, scales)
    ref_level = ra._levels(feats, rois, scales)
    torch.cuda.synchronize()
    if not torch.equal(level, ref_level):
        idx = (level != ref_level).nonzero()[:8]
        emit("mismatch", what=f"{what} levels", index=idx.tolist(),
             rois=rois[tuple(idx.T)].tolist(), got=level[tuple(idx.T)].tolist(),
             want=ref_level[tuple(idx.T)].tolist())
    require(torch.equal(level, ref_level), f"{what} {dtype}: levels differ from _levels")
    require(torch.equal(got, again), f"{what} {dtype}: two launches differ")
    # bf16: kernel and plain version both sum in fp32 (in another order) and
    # round once, so an element may differ by one bf16 ulp, 2^-7 relative
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2 ** -6)
    res = compare(got, want, *tol, f"{what} {dtype}")
    res.update(levels_equal=True, deterministic=True,
               rois_per_level=[int((level == i).sum()) for i in range(3)])
    return res


def k1_timing(feats, rois, scales=K1_SCALES, plain: bool = True) -> dict:
    """K1's times on these inputs: ``kernel_ms`` (the card's time in the
    kernel, ``torch.profiler``), ``ms`` (CUDA events around back-to-back
    wrapper calls), ``host_ms`` (the host's time to enqueue a call), the
    plain version's ``plain_ms`` and the bound."""
    from diffusionvid_torch.ops import roi_align as ra
    call = lambda: ra.multilevel_roi_align(feats, rois, scales)  # noqa: E731
    res = dict(zip(("bound_ms", "bound_by"), k1_bound(feats, rois)))
    res.update(kernel_ms=device_ms(call, K1_KERNELS, 20, 1), ms=cuda_time_ms(call),
               host_ms=host_ms(call))
    if plain:
        res["plain_ms"] = cuda_time_ms(
            lambda: ra.multilevel_roi_align_ref(feats, rois, scales), iters=5)
    return res


def boundary_rois():
    """Square boxes, at the origin and off it, whose side sits on each
    level boundary of sqrt(area) (112, 224 and 448 pixels) and one and two
    ulps either side."""
    sides = []
    for s in (112.0, 224.0, 448.0):
        v = torch.tensor(s)
        for k in range(-2, 3):
            x = v
            for _ in range(abs(k)):
                x = torch.nextafter(x, torch.tensor(0.0 if k < 0 else 1e4))
            sides.append(float(x))
    boxes = [[x, y, x + s, y + s] for s in sides for x, y in ((0.0, 0.0), (100.25, 50.5))]
    return torch.tensor(boxes, dtype=torch.float32)[None]


def k1_edge_rois(gen, case: str, h: int, w: int):
    """The edge cases' ROIs, 2 frames each (``boundary``: 1 frame)."""
    if case in ("r1", "r37"):
        return flagship_rois(gen, 2, int(case[1:]), h, w)
    if case == "boundary":
        return boundary_rois()
    r = 64
    ctr = torch.rand(2, r, 2, generator=gen) * torch.tensor([w, h])
    if case == "one_level":       # frame 0 all on p3 (sides 16-100), frame 1 all on p5 (500-900)
        side = torch.empty(2, r, 2)
        side[0].uniform_(16, 100, generator=gen)
        side[1].uniform_(500, 900, generator=gen)
    elif case == "tiny":          # under one p3 cell (8 pixels)
        side = torch.empty(2, r, 2).uniform_(0.25, 7.5, generator=gen)
    elif case == "elongated":     # the wide case: 28 columns spread over about 112
        side = torch.empty(2, r, 2)
        side[..., 0].uniform_(600, 1000, generator=gen)
        side[..., 1].uniform_(20, 60, generator=gen)
        side[:, 1::2] = side[:, 1::2].flip(-1) * torch.tensor([1.0, 0.6])
    else:                         # borders: over every border, outside, zero sizes
        side = torch.empty(2, r, 2).uniform_(40, 400, generator=gen)
        ctr[:, 0::4, 0] = torch.tensor([-20.0, w + 20.0]).repeat(r // 8)
        ctr[:, 1::4, 1] = torch.tensor([-20.0, h + 20.0]).repeat(r // 8)
    boxes = torch.cat([ctr - side / 2, ctr + side / 2], -1)
    if case == "borders":
        boxes[:, 2::8] = torch.tensor([-100.0, -80.0, w + 90.0, h + 70.0])
        boxes[:, 3::8] = torch.tensor([w + 40.0, h + 30.0, w + 300.0, h + 200.0])
        boxes[:, 5::8, 2] = boxes[:, 5::8, 0]        # zero width
        boxes[:, 6::8, 3] = boxes[:, 6::8, 1]        # zero height
        boxes[:, 7::8, 2:] = boxes[:, 7::8, :2]      # zero both
    return boxes.contiguous()


K1_EDGE_CASES = ("r1", "r37", "one_level", "tiny", "elongated", "borders", "boundary")


def kernel_k1(gen, dev, dtype, timing: bool):
    """K1 against its plain version at an R-101 chunk's 8 frames and, in
    bf16, a Swin-B chunk's 4 (300 ``flagship_rois`` a frame), each with its
    levels against ``_levels``, two bit-equal launches, its footprint and,
    with ``timing``, its times; then the edge cases, checked but not
    timed."""
    from diffusionvid_torch.ops import roi_align as ra
    h, w = FLAGSHIP["h"], FLAGSHIP["w"]
    frames = K1_FRAMES if dtype == torch.bfloat16 else K1_FRAMES[:1]
    rows = []
    for f in frames:
        feats = k1_maps(gen, dev, dtype, f)
        rois = flagship_rois(gen, f, FLAGSHIP["props"], h, w).to(dev)
        row = {"frames": f, **k1_case(feats, rois, what=f"K1 {f} frames")}
        require(min(row["rois_per_level"]) > 0, f"K1 test rois miss a level: {row}")
        level = ra._levels(feats, rois, K1_SCALES)
        row.update(k1_footprint(feats, rois, K1_SCALES, level))
        if dtype == torch.bfloat16:
            row["design"] = "footprint"
            row["plan"] = ra.fwd_plan(f, FLAGSHIP["props"], FLAGSHIP["c"])
        else:
            row["design"] = "v1"
        if timing:
            row.update(k1_timing(feats, rois))
        rows.append(row)
        del feats, rois
    res = {k: v for k, v in rows[0].items() if k != "frames"}
    res["sizes"] = rows
    edge = []
    for case in K1_EDGE_CASES:
        feats = k1_maps(gen, dev, dtype, 2 if case != "boundary" else 1)
        rois = k1_edge_rois(gen, case, h, w).to(dev)
        r = k1_case(feats, rois, what=f"K1 edge {case}")
        level = ra._levels(feats, rois, K1_SCALES)
        fp = k1_footprint(feats, rois, K1_SCALES, level)["footprint_cells"]
        edge.append({"case": case, "rois": list(rois.shape[:2]), "max_abs_err": r["max_abs_err"],
                     "rois_per_level": r["rois_per_level"],
                     "mean_cells": fp["mean"], "levels_equal": True, "deterministic": True})
        if case == "boundary":
            require(len([n for n in r["rois_per_level"] if n]) == 3,
                    f"K1 boundary boxes miss a level: {r['rois_per_level']}")
        del feats, rois
    res["edge"] = edge
    res["max_abs_err"] = max([r["max_abs_err"] for r in rows] + [e["max_abs_err"] for e in edge])
    return res


def phase_k1_stream(captured) -> dict:
    """K1 on the inputs of the R-101 x1 stream's last chunk (one launch a
    decoder stage, kept by ``phase_flagship``), in bf16: against its plain
    version with its levels and two bit-equal launches, its footprint
    (the stream's proposals are not spread like phase 3's boxes), times
    and bound.  The inputs go to ``build/chip_smoke/k1_stream_inputs.pt``
    for ``diffusionvid_torch/utils/k1_bench.py``."""
    from diffusionvid_torch.ops import roi_align as ra
    require(len(captured) == 4, f"k1_stream: {len(captured)} K1 launches captured, expected 4")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    maps = {}                 # one copy of the maps the launches share
    for c in captured:
        if id(c["features"]) not in maps:
            maps[id(c["features"])] = [f.cpu() for f in c["features"]]
    torch.save([{"features": maps[id(c["features"])], "rois": c["rois"].cpu(),
                 "scales": c["scales"]} for c in captured], out_dir / "k1_stream_inputs.pt")
    stages = []
    for i, cap in enumerate(captured):
        feats, rois, scales = cap["features"], cap["rois"], cap["scales"]
        require(feats[0].dtype == torch.bfloat16, f"k1_stream: maps are {feats[0].dtype}")
        row = {"stage": i, "rois": list(rois.shape[:2]),
               **k1_case(feats, rois, scales, what=f"k1_stream stage {i}")}
        row.update(k1_footprint(feats, rois, scales, ra._levels(feats, rois, scales)))
        row.update(k1_timing(feats, rois, scales, plain=False))
        stages.append(row)
    res = {k: sum(s[k] for s in stages) / len(stages)
           for k in ("kernel_ms", "ms", "host_ms", "bound_ms")}
    res.update(max_abs_err=max(s["max_abs_err"] for s in stages), levels_equal=True,
               deterministic=True, stages=stages, card=torch.cuda.get_device_name(0))
    emit("k1_stream", **res)
    return res


# K2's proposals a call: an R-101 chunk (8 frames) and a Swin-B chunk (4
# frames) of 300 proposals; and sizes that leave blocks of the ring design
# with one proposal, or with one more than others, checked but not timed
K2_SIZES = (FLAGSHIP["frames"] * FLAGSHIP["props"], SWIN_FRAMES * FLAGSHIP["props"])
K2_EDGE_SIZES = (1, 7, 133)
# K2's kernels: the ring design (bf16) and the first design (fp32)
K2_KERNELS = ("dynconv_ring_kernel", "dynamic_conv_kernel")


def k2_inputs(gen, dev, dtype, s: int):
    """roi [s, 49, 256], p1t and p2e [s, 64, 256] in ``dtype`` and the four
    fp32 LayerNorm vectors, drawn from ``gen``."""
    p, e, d = 49, 64, 256
    roi = torch.randn(s, p, d, generator=gen).to(dev, dtype)
    p1t = (torch.randn(s, e, d, generator=gen) * 0.1).to(dev, dtype)
    p2e = (torch.randn(s, e, d, generator=gen) * 0.1).to(dev, dtype)
    lns = [(1 + 0.1 * torch.randn(e, generator=gen)).to(dev),
           (0.1 * torch.randn(e, generator=gen)).to(dev),
           (1 + 0.1 * torch.randn(d, generator=gen)).to(dev),
           (0.1 * torch.randn(d, generator=gen)).to(dev)]
    return roi, p1t, p2e, lns


def k2_unfused(roi, p1t, p2e, lns):
    """K2's function by library calls, for ``unfused_ms``: ``torch.bmm`` →
    ``F.layer_norm`` → ``relu`` → ``torch.bmm`` → ``F.layer_norm`` →
    ``relu`` in the compute dtype, the LayerNorm vectors cast once
    beforehand.  Returns the call."""
    import torch.nn.functional as F
    g1, b1, g2, b2 = (t.to(roi.dtype) for t in lns)
    p1 = p1t.transpose(1, 2)

    def run():
        x = torch.relu(F.layer_norm(torch.bmm(roi, p1), (64,), g1, b1, 1e-5))
        return torch.relu(F.layer_norm(torch.bmm(x, p2e), (256,), g2, b2, 1e-5))
    return run


def k2_bound(roi, p1t, p2e, lns) -> tuple[float, str]:
    s, p, d = roi.shape
    e = p1t.shape[1]
    nbytes = (2 * roi.numel() + p1t.numel() + p2e.numel()) * roi.element_size() \
        + sum(t.numel() for t in lns) * 4
    return bound_ms(nbytes, 2 * s * (p * d * e) * 2, roi.dtype)


def kernel_k2(gen, dev, dtype, timing: bool):
    """K2 against its plain version at an R-101 chunk's proposals (S =
    2,400), then, in bf16, at a Swin-B chunk's (1,200), each launched twice
    to show that it is deterministic and, with ``timing``, timed (``ms``,
    the card's ``kernel_ms``, ``plain_ms``, the library chain's
    ``unfused_ms``) beside its bound; then at the edge sizes."""
    from diffusionvid_torch.ops.dynamic_conv import (
        dynamic_conv_fused, dynamic_conv_ref, dynconv_plan)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # bf16: the tolerance of tests/test_dynamic_conv_pallas.py (three
    # roundings to bf16 whose fp32 inputs differ in summation order)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 3e-2)
    sizes = K2_SIZES if dtype == torch.bfloat16 else K2_SIZES[:1]
    rows = []
    for s in sizes:
        roi, p1t, p2e, lns = k2_inputs(gen, dev, dtype, s)
        got = dynamic_conv_fused(roi, p1t, p2e, *lns)
        want = dynamic_conv_ref(roi, p1t, p2e, *lns)
        torch.cuda.synchronize()
        row = compare(got, want, *tol, f"K2 {dtype} S={s}")
        row.update(s=s, design="ring" if dtype == torch.bfloat16 else "v1")
        require(torch.equal(dynamic_conv_fused(roi, p1t, p2e, *lns), got),
                f"K2 {dtype} S={s}: two launches differ")
        row["deterministic"] = True
        if dtype == torch.bfloat16:
            row["plan"] = dynconv_plan(s, sms)
        if dtype == torch.float32:
            # the autograd.Function's backward recomputes through the plain version
            args = [t[:64].clone().requires_grad_() for t in (roi, p1t, p2e)] \
                + [t.clone().requires_grad_() for t in lns]
            ref = [a.detach().clone().requires_grad_() for a in args]
            (dynamic_conv_fused(*args) ** 2).sum().backward()
            (dynamic_conv_ref(*ref) ** 2).sum().backward()
            row["grad_max_rel_err"] = max(
                float((a.grad - r.grad).abs().max() / r.grad.abs().max())
                for a, r in zip(args, ref))
            require(row["grad_max_rel_err"] < 1e-4,
                    f"K2 backward: rel err {row['grad_max_rel_err']} over 1e-4")
        if timing:
            call = (roi, p1t, p2e, *lns)
            row["bound_ms"], row["bound_by"] = k2_bound(roi, p1t, p2e, lns)
            row["ms"] = cuda_time_ms(lambda: dynamic_conv_fused(*call))
            row["kernel_ms"] = device_ms(lambda: dynamic_conv_fused(*call), K2_KERNELS, 20, 1)
            row["plain_ms"] = cuda_time_ms(lambda: dynamic_conv_ref(*call))
            row["unfused_ms"] = cuda_time_ms(k2_unfused(roi, p1t, p2e, lns))
        rows.append(row)
        del roi, p1t, p2e, lns, got, want
    res = {k: v for k, v in rows[0].items() if k != "s"}
    res["sizes"] = rows
    edge = []
    for s in K2_EDGE_SIZES:
        roi, p1t, p2e, lns = k2_inputs(gen, dev, dtype, s)
        got = dynamic_conv_fused(roi, p1t, p2e, *lns)
        r = compare(got, dynamic_conv_ref(roi, p1t, p2e, *lns), *tol, f"K2 {dtype} S={s}")
        edge.append({"s": s, "max_abs_err": r["max_abs_err"]})
    res["edge_sizes"] = edge
    res["max_abs_err"] = max([r["max_abs_err"] for r in rows] + [r["max_abs_err"] for r in edge])
    return res


TRAIN = dict(frames=5, h=608, w=1024, props=300, c=256)


def crowded_rois(gen, b: int, r: int, h: int, w: int):
    """Large ROIs piled around three centres a frame, most on p4 and p5:
    sides of 0.3 to 1.2 times the image's, every 10th ROI the whole image,
    every 29th a small box (p3).  Long per-tile lists on the coarse levels,
    which the cluster split and its cross-rank sum take."""
    size = torch.tensor([w, h], dtype=torch.float32)
    centres = torch.rand(b, 3, 2, generator=gen) * size
    pick = torch.randint(0, 3, (b, r), generator=gen)
    ctr = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn(b, r, 2, generator=gen) * size * 0.05
    side = (0.3 + 0.9 * torch.rand(b, r, 2, generator=gen)) * size
    side[:, 3::29] = 40 + 110 * torch.rand(b, len(range(3, r, 29)), 2, generator=gen)
    boxes = torch.cat([ctr - side / 2, ctr + side / 2], -1)
    boxes[:, ::10] = torch.tensor([0.0, 0.0, w, h])
    return boxes.contiguous()


def k3_lists(plan, counts) -> list:
    """The longest per-tile ROI list of each level."""
    out, t = [], 0
    for lv in plan["levels"]:
        out.append(int(counts[:, t:t + lv["tiles"]].max()))
        t += lv["tiles"]
    return out


def k3_case(dtype, g, rois, shapes, scales=(1 / 8, 1 / 16, 1 / 32), what="K3"):
    """K3 on one set of inputs against its plain version (fp32: (1e-4,
    1e-4); bf16: (1e-4, 2^-6)); a second launch must give bit-equal maps and
    its prepass lists must equal ``bwd_tile_lists_ref``.  Returns the
    check's numbers and the kernel's maps."""
    from diffusionvid_torch.ops import roi_align as ra
    b, r, _, c = g.shape
    lv = ra._levels(shapes, rois, scales).contiguous()
    counts = [int((lv == i).sum()) for i in range(3)]
    plan = ra.bwd_plan(shapes, r, g.element_size())
    scratch = torch.empty(ra.bwd_scratch_words(b, r, plan["tiles_total"]), dtype=torch.int32,
                          device=g.device)
    got = ra.multilevel_roi_align_bwd(g, rois, shapes, scales, dtype)
    again = ra._launch_bwd(g, rois, lv, shapes, scales, scratch)
    want = ra.multilevel_roi_align_bwd_ref(g, rois, shapes, scales, dtype)
    lists, n = ra.bwd_scratch_lists(scratch, b, r, plan["tiles_total"])
    ref_lists, ref_n = ra.bwd_tile_lists_ref(rois, lv, shapes, scales, plan)
    torch.cuda.synchronize()
    require(torch.equal(n, ref_n), f"{what}: prepass list lengths differ from the plain version")
    valid = torch.arange(r, device=g.device) < n[..., None]
    require(torch.equal(torch.where(valid, lists, -1), ref_lists),
            f"{what}: prepass lists differ from the plain version")
    # fp32: the same fp32 sums in another order.  bf16: both sum in fp32 in
    # another order and round once to bf16, so an element may differ by one
    # bf16 step (up to 2^-7 relative); 2^-6 leaves a margin
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-4, 2 ** -6)
    res = {"rois_per_level": counts, "longest_list": k3_lists(plan, ref_n),
           "max_abs_err": 0.0, "atol": tol[0], "rtol": tol[1]}
    for i, (a, b2, ref) in enumerate(zip(got, again, want)):
        require(tuple(a.shape) == (b, *shapes[i], c) and a.dtype == dtype,
                f"{what} level {i}: {tuple(a.shape)} {a.dtype}")
        require(torch.equal(a, b2), f"{what} {dtype} level {i}: two launches differ")
        err = compare(a, ref, *tol, f"{what} {dtype} {shapes[0]} C={c} level {i}")
        res["max_abs_err"] = max(res["max_abs_err"], err["max_abs_err"])
    res["deterministic"] = True
    res["plan"] = [[lv_["rows"], lv_["cols"], lv_["tiles"], lv_["cluster"]]
                   for lv_ in plan["levels"]]
    return res, got


def k3_bound(g, rois, shapes, scales, got) -> tuple[float, str, float]:
    """K3's bound on these inputs: one read of g, the rois and levels, one
    write of the maps; two flops per channel for each corner contribution
    this run's ROIs make, on the fp32 cores whatever the maps' dtype."""
    from diffusionvid_torch.ops import roi_align as ra
    lv = ra._levels(shapes, rois, scales)
    ys, xs, lh, lw = ra._sample_coords(rois, lv, shapes, scales, 7, 2, True)
    _, wy0, wy1 = ra._band_params(ys, lh[..., None])
    _, wx0, wx1 = ra._band_params(xs, lw[..., None])
    ny = (wy0 != 0).sum(-1) + (wy1 != 0).sum(-1)
    nx = (wx0 != 0).sum(-1) + (wx1 != 0).sum(-1)
    flops = 2 * g.shape[3] * float((ny * nx).sum())
    elt = g.element_size()
    nbytes = (g.numel() * elt + rois.numel() * 4 + lv.numel() * 4
              + sum(t.numel() for t in got) * elt)
    return (*bound_ms(nbytes, flops, torch.float32), flops / 1e9)


def kernel_k3(gen, dev, dtype, timing: bool):
    """K3 at the R-101 train shapes (``flagship_rois``), on maps wider than
    one tile (296 x 2400: p3 is 37 x 300) with a channel count that leaves
    a partial 64-channel slice, with 58 channels, and at the train shapes
    with crowded ROIs (``crowded_rois``), against its plain version."""
    from diffusionvid_torch.ops import roi_align as ra
    f, c, h, w, r = TRAIN["frames"], TRAIN["c"], TRAIN["h"], TRAIN["w"], TRAIN["props"]
    scales = (1 / 8, 1 / 16, 1 / 32)

    def case(f, r, c, h, w, rois_fn):
        shapes = [(-(-h // s), -(-w // s)) for s in (8, 16, 32)]
        rois = rois_fn(gen, f, r, h, w).to(dev)
        g = torch.randn(f, r, 49, c, generator=gen).to(dev, dtype)
        return g, rois, shapes

    g, rois, shapes = case(f, r, c, h, w, flagship_rois)
    res, got = k3_case(dtype, g, rois, shapes)
    require(min(res["rois_per_level"]) > 0, f"K3 test rois miss a level: {res['rois_per_level']}")
    res["wide"], _ = k3_case(dtype, *case(2, 120, 200, 296, 2400, flagship_rois), what="K3 wide")
    # 58 channels: rows that do not start on 16 bytes (4-byte copies), one
    # partial slice
    res["narrow"], _ = k3_case(dtype, *case(1, 40, 58, 304, 512, flagship_rois),
                               what="K3 narrow")
    crowd = case(f, r, c, h, w, crowded_rois)
    res["crowded"], crowd_got = k3_case(dtype, *crowd, what="K3 crowded")
    require(min(res["crowded"]["rois_per_level"]) > 0,
            f"K3 crowded rois miss a level: {res['crowded']['rois_per_level']}")
    if timing:
        res["bound_ms"], res["bound_by"], res["gflop"] = k3_bound(g, rois, shapes, scales, got)
        # ms: the card's time in K3's kernels; event_ms: CUDA events around
        # back-to-back wrapper calls, which the wrapper's host side paces
        call = lambda: ra.multilevel_roi_align_bwd(g, rois, shapes, scales, dtype)  # noqa: E731
        res["ms"] = device_ms(call, K3_KERNELS)
        res["event_ms"] = cuda_time_ms(call)
        res["plain_ms"] = cuda_time_ms(
            lambda: ra.multilevel_roi_align_bwd_ref(g, rois, shapes, scales, dtype),
            iters=3, warmup=1)
        cg_, cr, cs = crowd
        cres = res["crowded"]
        cres["bound_ms"], cres["bound_by"], cres["gflop"] = k3_bound(cg_, cr, cs, scales,
                                                                     crowd_got)
        call = lambda: ra.multilevel_roi_align_bwd(cg_, cr, cs, scales, dtype)  # noqa: E731
        cres["ms"] = device_ms(call, K3_KERNELS)
        cres["event_ms"] = cuda_time_ms(call)
    return res


def phase_k3_train(captured) -> dict:
    """K3 on the inputs of the last R-101 train micro-step (one set a
    decoder stage, kept by ``phase_flagship_train``): in bf16, and in fp32
    on the same cotangent, against its plain version with two bit-equal
    launches; then its time a launch, its bound, the ROIs a level and the
    longest tile list a level of each stage, and the plan (``ms`` the
    card's time in K3's kernels, ``event_ms`` CUDA events around
    back-to-back wrapper calls).  The inputs go
    to ``build/chip_smoke/k3_train_inputs.pt`` for
    ``diffusionvid_torch/utils/k3_bench.py``."""
    from diffusionvid_torch.ops import roi_align as ra
    require(len(captured) == 4, f"k3_train: {len(captured)} K3 launches captured, expected 4")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save([{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in c.items()}
                for c in captured], out_dir / "k3_train_inputs.pt")
    stages, worst = [], {"bfloat16": 0.0, "float32": 0.0}
    for i, cap in enumerate(captured):
        g, rois, shapes, scales = cap["g"], cap["rois"], cap["shapes"], cap["scales"]
        row = {"stage": i}
        for dtype in (torch.bfloat16, torch.float32):
            gd = g.to(dtype)
            res, got = k3_case(dtype, gd, rois, shapes, scales, what=f"k3_train stage {i}")
            key = str(dtype).split(".")[1]
            worst[key] = max(worst[key], res["max_abs_err"])
            if dtype == torch.bfloat16:
                row.update(rois_per_level=res["rois_per_level"],
                           longest_list=res["longest_list"], plan=res["plan"])
                row["bound_ms"], row["bound_by"], row["gflop"] = k3_bound(gd, rois, shapes,
                                                                          scales, got)
                call = lambda: ra.multilevel_roi_align_bwd(  # noqa: E731
                    gd, rois, shapes, scales, dtype)
                row["ms"] = device_ms(call, K3_KERNELS)
                row["event_ms"] = cuda_time_ms(call)
        stages.append(row)
    res = {"ms": sum(s["ms"] for s in stages) / len(stages),
           "event_ms": sum(s["event_ms"] for s in stages) / len(stages),
           "bound_ms": sum(s["bound_ms"] for s in stages) / len(stages),
           "max_abs_err": worst, "deterministic": True, "stages": stages,
           "card": torch.cuda.get_device_name(0)}
    emit("k3_train", **res)
    return res


def _swin_inputs(gen, dev, dtype, st, frames):
    """One stage's residual map (random over the pad region too) and
    half-block weights; the matrices already in ``dtype``."""
    h, w = st["hw"]
    c, heads = st["c"], st["heads"]
    hp, wp = -(-h // 7) * 7, -(-w // 7) * 7

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    x = rn(frames, hp, wp, c).to(dev, dtype)
    attn = [1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(3 * c, c, scale=c ** -0.5),
            rn(3 * c, scale=0.1), rn(heads, 49, 49, scale=0.5), rn(c, c, scale=c ** -0.5),
            rn(c, scale=0.1)]
    mlp = [1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(4 * c, c, scale=c ** -0.5),
           rn(4 * c, scale=0.1), rn(c, 4 * c, scale=(4 * c) ** -0.5), rn(c, scale=0.1)]
    attn = [t.to(dev, dtype if t.dim() == 2 else torch.float32) for t in attn]
    mlp = [t.to(dev, dtype if t.dim() == 2 else torch.float32) for t in mlp]
    return x, attn, mlp, (hp, wp)


def _unfused_attn_half(x, attn, mask, heads: int, hw):
    """The v1 branch's attention half (``SwinBlock.forward`` with
    ``kernel_mode`` v1) at K4's shapes: LN1 in fp32, the pad zeroed, the
    qkv linears, K7, the proj linear and the residual, without the rolls,
    which v3 makes too: K4's yardstick on the same inputs."""
    import torch.nn.functional as F
    from diffusionvid_torch.ops.window_attention import window_attention
    ln_g, ln_b, wqkv, bqkv, bias, wproj, bproj = attn
    _, hp, wp, c = x.shape
    (h, w), dt = hw, x.dtype
    y = F.layer_norm(x.float(), (c,), ln_g, ln_b, 1e-5).to(dt)
    if (hp, wp) != (h, w):
        y = F.pad(y[:, :h, :w], (0, 0, 0, wp - w, 0, hp - h))
    q, k, v = (F.linear(y, wqkv[i * c:(i + 1) * c], bqkv[i * c:(i + 1) * c].to(dt))
               for i in range(3))
    return x + F.linear(window_attention(q, k, v, bias, mask, 7), wproj, bproj.to(dt))


def k5_unfused(x, mlp):
    """K5's function by library calls, for ``unfused_ms``: ``F.layer_norm``
    → ``F.linear`` → ``F.gelu`` → ``F.linear`` → ``+ x`` in the compute
    dtype, the weights cast once beforehand.  Returns the call."""
    import torch.nn.functional as F
    ln_g, ln_b, w1, b1, w2, b2 = (t.to(x.dtype) for t in mlp)
    c = x.shape[-1]
    return lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(x, (c,), ln_g, ln_b, 1e-5),
                                                w1, b1)), w2, b2)


def k5_hidden_check(x, mlp, tol, what: str) -> dict:
    """The wgmma path's first two launches on their own: the LN pass's y
    against ``swin_mlp_ln_ref`` and the fc1 product's h against
    ``swin_mlp_fc1_ref`` of that y, so that a fault shows in the launch
    where it happens."""
    from diffusionvid_torch.ops.swin_attention import (
        launch_mlp, swin_mlp_fc1_ref, swin_mlp_ln_ref)
    ln_g, ln_b, w1, b1, w2, b2 = mlp
    y, h = launch_mlp(x, ln_g, ln_b, w1, b1, w2, b2, torch.empty_like(x))
    torch.cuda.synchronize()
    res = {}
    for key, got, want in (("y", y, swin_mlp_ln_ref(x, ln_g, ln_b).reshape(y.shape)),
                           ("h", h, swin_mlp_fc1_ref(y, w1, b1))):
        r = compare(got, want, *tol, f"{what} {key}")
        r["mean_abs_err"] = float((got.float() - want.float()).abs().mean())
        require(r["mean_abs_err"] < MEAN_ERR[x.dtype],
                f"{what} {key}: mean abs err {r['mean_abs_err']} over {MEAN_ERR[x.dtype]}")
        res[key] = r
    return res


def _pass_means(rows, keys):
    """Means per launch over one backbone pass: each row weighted by the
    blocks of the pass it stands for."""
    total = sum(r["blocks"] for r in rows)
    return {k: sum(r[k] * r["blocks"] for r in rows) / total for k in keys}


def _swin_check(name, gen, dev, dtype, timing: bool):
    """K4 or K5 at the four Swin-B stage maps, then at Swin-T's, against
    the plain version; K4 with shift 0 and 3.  Returns the worst error, the
    per-stage rows and, with ``timing``, the means of ms, plain ms and
    bound over one Swin-B pass."""
    from diffusionvid_torch.models.swin import shift_attn_mask
    from diffusionvid_torch.ops.swin_attention import (
        attn_plan, mlp_plan, swin_block_attn, swin_block_attn_ref, swin_block_mlp,
        swin_block_mlp_ref)
    mlp_k = name == "swin_block_mlp"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # fp32: the same fp32 sums in another order, over up to 4096 terms.
    # bf16: TOLERANCE_BF16 below.
    tol = (1e-4, 1e-4) if dtype == torch.float32 else TOLERANCE_BF16[name]
    elt = torch.tensor([], dtype=dtype).element_size()
    rows, worst = [], 0.0
    stages = [(st, SWIN_FRAMES) for st in SWIN_B_STAGES] + [(st, 2) for st in SWIN_T_STAGES]
    for s, (st, frames) in enumerate(stages):
        timed = timing and s < len(SWIN_B_STAGES)
        x, attn, mlp, (hp, wp) = _swin_inputs(gen, dev, dtype, st, frames)
        c, heads = st["c"], st["heads"]
        m = x.numel() // c
        shifts = (0, 3) if name == "swin_block_attn" else (0,)
        for shift in shifts:
            if name == "swin_block_attn":
                mask = None
                if shift:
                    mask = torch.from_numpy(shift_attn_mask(hp, wp, 7, shift)).to(dev).reshape(
                        hp // 7, wp // 7, 49, 49)
                args = (x, *attn[:5], mask, *attn[5:], 7, heads, st["hw"], shift)
                fn, ref = swin_block_attn, swin_block_attn_ref
                flops = 2 * m * c * 4 * c + 4 * m * 49 * c
                nbytes = (2 * x.numel() + 4 * c * c) * elt + (6 * c + heads * 2401) * 4 \
                    + (0 if mask is None else mask.numel() * 4)
            else:
                args = (x, *mlp)
                fn, ref = swin_block_mlp, swin_block_mlp_ref
                flops = 16 * m * c * c
                nbytes = (2 * x.numel() + 8 * c * c) * elt + 7 * c * 4
            got = fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            what = f"{name} {dtype} stage {s} shift {shift}"
            res = compare(got, want, *tol, what)
            res["mean_abs_err"] = float((got.float() - want.float()).abs().mean())
            require(res["mean_abs_err"] < MEAN_ERR[dtype],
                    f"{what}: mean abs err {res['mean_abs_err']} over {MEAN_ERR[dtype]}")
            res.update(stage=s, shape=list(x.shape), shift=shift)
            if name == "swin_block_attn" and dtype == torch.bfloat16:
                res["plan"] = attn_plan(c, frames, hp, wp)   # blocks, ring, shared bytes
            plan = None
            if mlp_k:
                require(torch.equal(fn(*args), got), f"{what}: two launches differ")
                res["deterministic"] = True
                if dtype == torch.bfloat16:
                    plan = mlp_plan(c, m, sms)
                    res.update(path=plan["path"], plan=plan)
                    if plan["path"] == "wgmma":
                        res["hidden"] = k5_hidden_check(x, mlp, tol, what)
            worst = max(worst, res["max_abs_err"])
            del got, want
            if timed:
                # half of a stage's blocks shift, the other half do not
                res["blocks"] = st["depth"] / len(shifts)
                res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype)
                res["bound_ms_bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
                res["gflop"] = flops / 1e9
                res["ms"] = cuda_time_ms(lambda: fn(*args), iters=10)
                res["plain_ms"] = cuda_time_ms(lambda: ref(*args), iters=3, warmup=1)
                if name == "swin_block_attn":
                    res["unfused_ms"] = cuda_time_ms(
                        lambda: _unfused_attn_half(x, attn, mask, heads, st["hw"]), iters=10)
                if mlp_k:
                    res["kernel_ms"] = device_ms(lambda: fn(*args), K5_KERNELS, 10,
                                                 3 if plan["path"] == "wgmma" else 1)
                    res["unfused_ms"] = cuda_time_ms(k5_unfused(x, mlp), iters=10)
                    if plan["path"] == "wgmma":
                        # the design's own floor: y and h written and read once more
                        res["design_bound_ms_bytes"] = (
                            nbytes + 2 * 5 * m * c * elt) / HBM_BYTES_PER_S * 1e3
            rows.append(res)
        del x, attn, mlp
        torch.cuda.empty_cache()
    out = {"max_abs_err": worst, "atol": tol[0], "rtol": tol[1], "stages": rows}
    if timing:
        keys = ("ms", "plain_ms", "bound_ms", "bound_ms_bytes", "unfused_ms") + (
            ("kernel_ms",) if mlp_k else ())
        out.update(_pass_means([r for r in rows if "blocks" in r], keys))
        out["bound_by"] = ("bytes" if out["bound_ms_bytes"] >= out["bound_ms"]
                           else "operations")
    return out


def _sdpa_mask(bias, mask, nw: int, heads: int, dtype):
    """The relative-position bias and the SW-MSA mask as one ``attn_mask``
    [1, nW·h, 49, 49] for windows laid out [B, nW·h, 49, dh]."""
    am = bias.float()[None].expand(nw, -1, -1, -1)
    if mask is not None:
        am = am + mask.reshape(nw, 1, 49, 49)
    return am.reshape(1, nw * heads, 49, 49).to(dtype)


def _sdpa_ms(q, k, v, bias, mask, heads: int) -> float:
    """``F.scaled_dot_product_attention`` over the partitioned windows of
    the maps q, k, v, the relative-position bias and the SW-MSA mask as its
    ``attn_mask``: the attention core without the relayouts and without the
    scores' round trip."""
    import torch.nn.functional as F
    from diffusionvid_torch.ops.swin_attention import _partition
    b, hp, wp, c = q.shape
    nw = (hp // 7) * (wp // 7)

    def part(t):
        return (_partition(t, 7).view(b, nw, 49, heads, c // heads).permute(0, 1, 3, 2, 4)
                .reshape(b, nw * heads, 49, c // heads).contiguous())

    qp, kp, vp = part(q), part(k), part(v)
    am = _sdpa_mask(bias, mask, nw, heads, q.dtype)
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(qp, kp, vp, attn_mask=am),
                        iters=10)


def k6_library(x, wqkv, bqkv, bias, mask, heads: int):
    """K6's whole function by library calls, for ``library_full_ms``: one
    ``F.linear(x, wqkv, bqkv)`` over the map, q, k, v partitioned into
    windows and heads, ``F.scaled_dot_product_attention`` with bias and mask
    as its ``attn_mask`` (built once, as in ``_sdpa_ms``), and the output
    put back in map layout.  Returns the call, without its scores' round
    trip."""
    import torch.nn.functional as F
    from diffusionvid_torch.ops.swin_attention import _partition, _reverse
    b, hp, wp, c = x.shape
    nw, dh = (hp // 7) * (wp // 7), c // heads
    bq = bqkv.to(x.dtype)
    am = _sdpa_mask(bias, mask, nw, heads, x.dtype)

    def run():
        qkv = _partition(F.linear(x, wqkv, bq), 7).view(b, nw, 49, 3, heads, dh)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).reshape(3, b, nw * heads, 49, dh)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        o = o.view(b, nw, heads, 49, dh).transpose(2, 3).reshape(b * nw, 49, c)
        return _reverse(o, 7, b, hp, wp)
    return run


def _k6_grads(x, wqkv, bqkv, bias, mask, heads: int) -> float:
    """``WindowAttentionQKVFn``'s gradients for x, wqkv, bqkv and bias on
    the card against ``torch.autograd.grad`` of the twin; the worst relative
    error in norm."""
    from diffusionvid_torch.ops import window_attention as wa
    ins = [t.detach().clone().requires_grad_() for t in (x, wqkv, bqkv, bias)]
    out = wa.WindowAttentionQKVFn.apply(*ins, mask, 7, heads)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, ins, g)
    ref = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(wa.window_attention_qkv_einsum(*ref, mask, 7, heads), ref, g)
    return max(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
               for a, b in zip(got, want))


def _k6_backward_ms(x, wqkv, bqkv, bias, mask, heads: int) -> float:
    """The backward of one ``WindowAttentionQKVFn`` launch: the twin's
    recompute and its gradients."""
    from diffusionvid_torch.ops import window_attention as wa
    ins = [t.detach().clone().requires_grad_() for t in (x, wqkv, bqkv, bias)]
    out = wa.WindowAttentionQKVFn.apply(*ins, mask, 7, heads)
    g = torch.randn_like(out)
    return cuda_time_ms(lambda: torch.autograd.grad(out, ins, g, retain_graph=True),
                        iters=3, warmup=1)


def _window_check(name, gen, dev, dtype, timing: bool):
    """K6 (``window_attn_qkv``, on 5-frame maps, the train step's) or K7
    (``window_attn``, 4-frame maps, the v1 stream's) at the four Swin-B stage
    maps, then at Swin-T's, with shift 0 and 3, against the plain version,
    launched twice (bit-equal), with the bf16 launch plan.  With ``timing``,
    per Swin-B stage also the card time ``kernel_ms``, the plain version's
    time, the bound, ``library_ms`` (``_sdpa_ms``) and, for K6, ``bwd_ms``
    (``_k6_backward_ms``), for K7 ``host_ms``, and their means over one
    backbone pass.  K6 in fp32 also checks its autograd gradients at stage
    1, shift 3; K7 in bf16 runs ``k7_every_plan``."""
    from diffusionvid_torch.models.swin import shift_attn_mask
    from diffusionvid_torch.ops import window_attention as wa
    qkv = name == "window_attn_qkv"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tol = (1e-4, 1e-4) if dtype == torch.float32 else TOLERANCE_BF16[name]
    elt = torch.tensor([], dtype=dtype).element_size()
    rows, worst, extra = [], 0.0, {}
    frames_b = TRAIN["frames"] if qkv else SWIN_FRAMES
    stages = [(st, frames_b) for st in SWIN_B_STAGES] + [(st, 2) for st in SWIN_T_STAGES]
    for s, (st, frames) in enumerate(stages):
        timed = timing and s < len(SWIN_B_STAGES)
        x, attn, _, (hp, wp) = _swin_inputs(gen, dev, dtype, st, frames)
        c, heads = st["c"], st["heads"]
        wqkv, bqkv, bias = attn[2], attn[3], attn[4]
        m = x.numel() // c
        if qkv:
            q, k, v = (torch.nn.functional.linear(x, wqkv[i * c:(i + 1) * c]) for i in range(3))
        else:
            q, k, v = x, *(torch.randn(x.shape, generator=gen).to(dev, dtype) for _ in range(2))
        for shift in (0, 3):
            mask = None
            if shift:
                mask = torch.from_numpy(shift_attn_mask(hp, wp, 7, shift)).to(dev).reshape(
                    hp // 7, wp // 7, 49, 49)
            if qkv:
                args = (x, wqkv, bqkv, bias, mask, 7, heads)
                fn, ref = wa.window_attention_qkv, wa.window_attention_qkv_ref
                flops = 6 * m * c * c + 4 * m * 49 * c
                nbytes = (2 * x.numel() + 3 * c * c) * elt + (3 * c + heads * 2401) * 4
            else:
                args = (q, k, v, bias, mask, 7)
                fn, ref = wa.window_attention, wa.window_attention_ref
                flops = 4 * m * 49 * c
                nbytes = 4 * x.numel() * elt + heads * 2401 * 4
            nbytes += 0 if mask is None else mask.numel() * 4
            got = fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            what = f"{name} {dtype} stage {s} shift {shift}"
            res = compare(got, want, *tol, what)
            res["mean_abs_err"] = float((got.float() - want.float()).abs().mean())
            require(res["mean_abs_err"] < MEAN_ERR[dtype],
                    f"{what}: mean abs err {res['mean_abs_err']} over {MEAN_ERR[dtype]}")
            res.update(stage=s, shape=list(x.shape), shift=shift)
            require(torch.equal(fn(*args), got), f"{what}: two launches differ")
            res["deterministic"] = True
            if dtype == torch.bfloat16:
                res["plan"] = (wa.qkv_plan if qkv else wa.window_plan)(c, frames, hp, wp, sms)
            worst = max(worst, res["max_abs_err"])
            del got, want
            if timed:
                res["blocks"] = st["depth"] / 2
                res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype)
                res["bound_ms_bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
                res["gflop"] = flops / 1e9
                res["ms"] = cuda_time_ms(lambda: fn(*args), iters=10)
                res["plain_ms"] = cuda_time_ms(lambda: ref(*args), iters=3, warmup=1)
                res["library_ms"] = _sdpa_ms(q, k, v, bias, mask, heads)
                res["kernel_ms"] = device_ms(lambda: fn(*args),
                                             K6_KERNELS if qkv else K7_KERNELS, 10, 1)
                if qkv:
                    res["library_full_ms"] = cuda_time_ms(
                        k6_library(x, wqkv, bqkv, bias, mask, heads), iters=10)
                    res["bwd_ms"] = _k6_backward_ms(x, wqkv, bqkv, bias, mask, heads)
                else:
                    res["host_ms"] = host_ms(lambda: fn(*args))
            if qkv and dtype == torch.float32 and s == 1 and shift:
                extra["grad_max_rel_err"] = _k6_grads(x, wqkv, bqkv, bias, mask, heads)
                extra["grad_stage"] = s
                require(extra["grad_max_rel_err"] < 1e-4,
                        f"K6 backward: rel err {extra['grad_max_rel_err']} over 1e-4")
            rows.append(res)
            torch.cuda.empty_cache()
        del x, attn, q, k, v
        torch.cuda.empty_cache()
    if not qkv and dtype == torch.bfloat16:
        extra["plans"] = k7_every_plan(gen, dev, tol)
        worst = max(worst, extra["plans"]["max_abs_err"])
    out = {"max_abs_err": worst, "atol": tol[0], "rtol": tol[1], "stages": rows, **extra}
    if timing:
        keys = ("ms", "plain_ms", "bound_ms", "bound_ms_bytes", "library_ms", "kernel_ms") + (
            ("library_full_ms", "bwd_ms") if qkv else ("host_ms",))
        out.update(_pass_means([r for r in rows if "blocks" in r], keys))
        out["bound_by"] = ("bytes" if out["bound_ms_bytes"] >= out["bound_ms"]
                           else "operations")
    return out


# K7's edge map: Swin-T's 12 heads (C = 384) over 3 maps of 56 x 63 (216
# windows), launched with every plan of window_plans: partial window runs,
# last waves partly empty, every head group (up to 12, one block an SM)
K7_EDGE = dict(c=384, frames=3, hp=56, wp=63)


def k7_every_plan(gen, dev, tol) -> dict:
    """K7 in bf16 at ``K7_EDGE`` with shift 0 and 3, launched with each plan
    of ``window_plans`` on this card's SMs (``launch_window``), against the
    plain version: the worst error and how many plans left a window run or
    the last wave partly empty."""
    from diffusionvid_torch.models.swin import shift_attn_mask
    from diffusionvid_torch.ops import window_attention as wa
    c, b, hp, wp = K7_EDGE["c"], K7_EDGE["frames"], K7_EDGE["hp"], K7_EDGE["wp"]
    heads, windows = c // 32, b * (hp // 7) * (wp // 7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q, k, v = (torch.randn(b, hp, wp, c, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    bias = (torch.randn(heads, 49, 49, generator=gen) * 0.5).to(dev)
    plans, worst = wa.window_plans(c, b, hp, wp, sms), 0.0
    for shift in (0, 3):
        mask = None
        if shift:
            mask = torch.from_numpy(shift_attn_mask(hp, wp, 7, shift)).to(dev).reshape(
                hp // 7, wp // 7, 49, 49)
        want = wa.window_attention_ref(q, k, v, bias, mask, 7)
        for plan in plans:
            out = torch.full_like(q, float("nan"))
            wa.launch_window(q, k, v, bias, mask, out, plan)
            torch.cuda.synchronize()
            what = (f"window_attn bf16 edge shift {shift} group {plan['group']} "
                    f"wpb {plan['wpb']}")
            res = compare(out, want, *tol, what)
            mean = float((out.float() - want.float()).abs().mean())
            require(mean < MEAN_ERR[torch.bfloat16], f"{what}: mean abs err {mean}")
            worst = max(worst, res["max_abs_err"])
    return {"shape": [b, hp, wp, c], "windows": windows, "plans": len(plans),
            "groups": sorted({p["group"] for p in plans}),
            "partial_runs": sum(windows % p["wpb"] != 0 for p in plans),
            "partial_waves": sum(p["blocks"] % (sms * p["blocks_per_sm"]) != 0 for p in plans),
            "max_abs_err": worst}


# bf16 kernel vs plain version on the card, same inputs: both round at the
# same points, but their fp32 sums run in other orders, so an intermediate
# next to a bf16 rounding boundary (an LN output, a score, a probability, a
# hidden activation) may round the other way and carry a one-step change
# downstream.  The output, of magnitude up to about 6, then differs by one
# or two bf16 steps (2^-5 at 4 to 8) at a few elements: 6e-2 abs + 2^-6 rel
# allows two.  The mean error over a map stays far below one step (about
# 1e-5 measured); a mean bound of 1e-3 catches an error that is small but
# everywhere, as a misplaced bias would be.
TOLERANCE_BF16 = {"swin_block_attn": (6e-2, 2 ** -6), "swin_block_mlp": (6e-2, 2 ** -6),
                  "window_attn_qkv": (6e-2, 2 ** -6), "window_attn": (6e-2, 2 ** -6)}
MEAN_ERR = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


KERNELS = {
    "roi_align_fwd": dict(
        route="cuda", source="diffusionvid_torch/csrc/roi_align_fwd.cu",
        replaces="diffusionvid_tpu/ops/roi_align_pallas.py:518", check=kernel_k1),
    "dynamic_conv": dict(
        route="cuda", source="diffusionvid_torch/csrc/dynamic_conv.cu",
        replaces="diffusionvid_tpu/ops/dynamic_conv_pallas.py:148", check=kernel_k2),
    "roi_align_bwd": dict(
        route="cuda", source="diffusionvid_torch/csrc/roi_align_bwd.cu",
        replaces="diffusionvid_tpu/ops/roi_align_pallas.py:762", check=kernel_k3),
    "swin_block_attn": dict(
        route="cuda", source="diffusionvid_torch/csrc/swin_block_attn.cu",
        replaces="diffusionvid_tpu/ops/swin_attention_pallas.py:372",
        check=functools.partial(_swin_check, "swin_block_attn")),
    "swin_block_mlp": dict(
        route="cuda", source="diffusionvid_torch/csrc/swin_block_mlp.cu",
        replaces="diffusionvid_tpu/ops/swin_attention_pallas.py:424",
        check=functools.partial(_swin_check, "swin_block_mlp")),
    "window_attn_qkv": dict(
        route="cuda", source="diffusionvid_torch/csrc/window_attn_qkv.cu",
        replaces="diffusionvid_tpu/ops/swin_attention_pallas.py:186",
        check=functools.partial(_window_check, "window_attn_qkv")),
    "window_attn": dict(
        route="cuda", source="diffusionvid_torch/csrc/window_attn_qkv.cu",
        replaces="diffusionvid_tpu/ops/swin_attention_pallas.py:471",
        check=functools.partial(_window_check, "window_attn")),
}
# the Swin kernels each trunk mode runs
SWIN_MODE_KERNELS = {"v3": ("swin_block_attn", "swin_block_mlp"), "v2": ("window_attn_qkv",),
                     "v1": ("window_attn",)}


def launch_counters():
    from diffusionvid_torch.ops.dynamic_conv import dynamic_conv_fused
    from diffusionvid_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_bwd
    from diffusionvid_torch.ops.swin_attention import swin_block_attn, swin_block_mlp
    from diffusionvid_torch.ops.window_attention import window_attention, window_attention_qkv
    return {"roi_align_fwd": multilevel_roi_align,
            "dynamic_conv": dynamic_conv_fused,
            "roi_align_bwd": multilevel_roi_align_bwd,
            "swin_block_attn": swin_block_attn,
            "swin_block_mlp": swin_block_mlp,
            "window_attn_qkv": window_attention_qkv,
            "window_attn": window_attention}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in launch_counters().items()}


def phase_kernels(seed: int) -> dict:
    """bf16 (the main path's dtype) is timed; fp32 is checked."""
    dev = torch.device("cuda")
    rows = {}
    for name, spec in KERNELS.items():
        rows[name] = {}
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator().manual_seed(seed)
            res = spec["check"](gen, dev, dtype, timing=dtype == torch.bfloat16)
            rows[name][str(dtype).split(".")[1]] = res
            emit("kernels", kernel=name, dtype=str(dtype), **res)
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- model paths

def _run_stream(det, noise, gframes, chunks, whwh):
    """start_video + process_chunk over ``chunks``, with ``noise`` (a list
    of CPU tensors) as the proposal noise in call order."""
    draws = iter(noise)
    det.noise = lambda state, shape: next(draws).to(det.device).reshape(shape)
    state = det.start_video(0, gframes, whwh)
    outs = []
    for c in chunks:
        state, dets = det.process_chunk(state, c, whwh)
        outs.append(dets)
    return state, outs


def _tiny_model(kind: str, gen, props: int):
    """A small fp32 model: depth-18 ResNet or Swin-T, 5 classes."""
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    kw = dict(num_classes=5, num_proposals=props, num_heads=1, num_heads_local=1,
              compute_dtype=torch.float32)
    if kind == "swin":
        kw.update(backbone_type="swin", swin_size="T", fpn_in=("swin1", "swin2", "swin3"))
    model = DiffusionDetArch(depth=18, **kw)
    model.reset_parameters(gen)
    with torch.no_grad():   # varied LayerNorm affines and biases: proposal
        for name, p in model.named_parameters():   # features of unequal norm
            if p.dim() == 1 and (name.startswith("head.") or kind == "swin"):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
            if name.endswith("relative_position_bias_table"):
                p.mul_(25.0)
    return model.eval()


RENEWAL_MARGIN = 1e-4


@contextlib.contextmanager
def best_scores(model):
    """Yield a list that gets the best class score of every slot at each
    DDIM step of ``model`` (its ``full_forward_test`` calls), on the CPU."""
    out, inner = [], model.full_forward_test

    def run(*args):
        res = inner(*args)
        out.append(torch.sigmoid(res[0]).amax(-1).cpu().double())
        return res

    model.full_forward_test = run
    try:
        yield out
    finally:
        del model.full_forward_test


def _renewal_stats(best, steps: int, thresh: float):
    """(least distance of a best score from ``thresh``, steps whose renewal
    mask is mixed) over the steps that renew: all but a chunk's last."""
    renew = [b for i, b in enumerate(best) if i % steps != steps - 1]
    margin = min(float((b - thresh).abs().min()) for b in renew)
    return margin, sum(0 < int((b > thresh).sum()) < b.numel() for b in renew)


def pick_renewal_thresh(run, steps: int) -> float:
    """A renewal threshold for an xN run, from ``run(thresh)``, the best
    scores of the plain run at ``thresh``: with random weights they sit
    near the 0.01 prior, so the default 0.5 would renew every slot.  Tries
    the midpoints of the widest gaps between the first step's best scores
    (which do not depend on the threshold) and takes the first at which
    some renewing step's mask is mixed and no best score of a renewing step
    lies within 3 * RENEWAL_MARGIN of it."""
    first = torch.sort(run(0.5)[0].flatten()).values
    for i in torch.argsort(first[1:] - first[:-1], descending=True)[:16].tolist():
        thresh = float(first[i] + first[i + 1]) / 2
        margin, mixed = _renewal_stats(run(thresh), steps, thresh)
        if margin > 3 * RENEWAL_MARGIN and mixed:
            return thresh
    raise SmokeFailure("no renewal threshold with mixed masks and a margin")


def _renewal_check(c_best, p_best, steps: int, thresh: float, what: str) -> dict:
    """Card and CPU renew the same slots in every step that renews (all
    but a chunk's last), no best score lies within RENEWAL_MARGIN of the
    threshold there, and some such step's mask is mixed."""
    require(len(c_best) == len(p_best) and len(p_best) % steps == 0,
            f"{what}: {len(c_best)} and {len(p_best)} DDIM steps")
    for i in range(len(p_best)):
        if i % steps != steps - 1:
            require(torch.equal(c_best[i] > thresh, p_best[i] > thresh),
                    f"{what}: renewal masks differ at step call {i}")
    margin, mixed = min(_renewal_stats(c_best, steps, thresh),
                        _renewal_stats(p_best, steps, thresh))
    require(margin > RENEWAL_MARGIN,
            f"{what}: a best score within {margin} of the renewal threshold {thresh}")
    require(mixed > 0, f"{what}: no step renewed some slots and kept others")
    return {"renewal_thresh": thresh, "renewal_margin": margin, "mixed_steps": mixed,
            "renewing_steps": len(p_best) // steps * (steps - 1)}


def phase_tiny(seed: int, kind: str, swin_kernel: str = "v3", sample_step: int = 1):
    """A depth-18 (``kind`` "resnet") or Swin-T ("swin") model, its trunk in
    mode ``swin_kernel``, 16 proposals, 64x96 frames, float32, TF32 off: the
    card (kernels) against the CPU (plain versions), same weights and
    noise.  With ``sample_step`` > 1 the xN ensemble at a renewal
    threshold picked on the CPU run (``pick_renewal_thresh``): the
    renewal masks too."""
    import copy

    from diffusionvid_torch.engine.streaming import StreamingDetector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    h, w, props = 64, 96, 16
    cpu = _tiny_model(kind, gen, props)
    if kind == "swin":
        cpu.backbone.bottom_up.kernel_mode = swin_kernel
    card = copy.deepcopy(cpu).cuda()
    kw = dict(infer_batch=2, mem_size=64, mem_dis_size=32, num_proposals=props,
              detections_per_img=props, sample_step=sample_step)
    gframes = torch.rand(4, h, w, 3, generator=gen) * 255
    chunks = [torch.rand(2, h, w, 3, generator=gen) * 255 for _ in range(2)]
    whwh = torch.tensor([w, h, w, h], dtype=torch.float32)
    # 2 global chunks' draws, then a chunk's: 1 at x1; 2 at xN, then 2 a step
    per_chunk = 1 if sample_step == 1 else 2 * sample_step
    noise = [torch.randn(2, props, 4, generator=gen) for _ in range(2 + 2 * per_chunk)]

    def stream(model, thresh):
        with best_scores(model) as best:
            det = StreamingDetector(model, score_renewal_thresh=thresh, **kw)
            return *_run_stream(det, noise, gframes, chunks, whwh), best

    thresh = 0.5
    if sample_step > 1:
        thresh = pick_renewal_thresh(lambda th: stream(cpu, th)[2], sample_step)
    reset_launches()
    c_state, c_out, c_best = stream(card, thresh)
    torch.cuda.synchronize()
    used = read_launches()
    path = ["roi_align_fwd", "dynamic_conv"] + (
        list(SWIN_MODE_KERNELS[swin_kernel]) if kind == "swin" else [])
    require(all((used[k] > 0) == (k in path) for k in used),
            f"tiny {kind} {swin_kernel}: card run launched {used}, expected exactly {path}")
    p_state, p_out, p_best = stream(cpu, thresh)
    require(c_state.mem.count == p_state.mem.count
            and c_state.mem_dis.count == p_state.mem_dis.count, "memory counts differ")
    res = {"backbone": kind, "sample_step": sample_step, "rtol": 1e-3, "launches": used}
    if kind == "swin":
        res["swin_kernel"] = swin_kernel
    if sample_step > 1:
        res.update(_renewal_check(c_best, p_best, sample_step, thresh,
                                  f"tiny {kind} x{sample_step}"))
    errs = {"scores": 0.0, "boxes": 0.0, "memory": 0.0}
    for cd, pd in zip(c_out, p_out):
        require(tuple(cd.boxes.shape) == tuple(pd.boxes.shape) == (2, sample_step * props, 4),
                f"tiny {kind}: boxes shape {tuple(cd.boxes.shape)}")
        for key in ("scores", "boxes"):
            g, r = getattr(cd, key).cpu().double(), getattr(pd, key).double()
            errs[key] = max(errs[key], float((g - r).abs().max() / r.abs().max()))
        require(torch.equal(cd.labels.cpu(), pd.labels), f"tiny {kind}: labels differ")
        require(torch.equal(cd.valid.cpu(), pd.valid), f"tiny {kind}: NMS keep masks differ")
    for cm, pm in ((c_state.mem, p_state.mem), (c_state.mem_dis, p_state.mem_dis)):
        errs["memory"] = max(errs["memory"], float(
            (cm.feats.cpu() - pm.feats).abs().max() / pm.feats.abs().max()))
    res.update({f"max_rel_err_{k}": v for k, v in errs.items()})
    emit("tiny", **res)
    require(max(errs.values()) < res["rtol"], f"tiny {kind}: card vs CPU over rtol: {errs}")


@contextlib.contextmanager
def capture_k1(keep: list):
    """Append the inputs of every K1 launch (``roi_align._launch_fwd``) to
    ``keep``: copies of the maps, one for the launches that share them, and
    of the ROIs."""
    from diffusionvid_torch.ops import roi_align as ra
    inner, maps = ra._launch_fwd, {}

    def launch(features, rois, spatial_scales):
        key = tuple(f.data_ptr() for f in features)
        if key not in maps:
            maps[key] = [f.clone() for f in features]
        keep.append(dict(features=maps[key], rois=rois.clone(), scales=tuple(spatial_scales)))
        return inner(features, rois, spatial_scales)

    ra._launch_fwd = launch
    try:
        yield
    finally:
        ra._launch_fwd = inner


def phase_flagship(seed: int, config: str, n_chunks: int, phase: str,
                   swin_kernel: str = "v3", keep_k1: list | None = None,
                   sample_step: int | None = None) -> dict:
    """A flagship config at full width, bf16: 24 global frames, then
    ``n_chunks`` chunks of INFER_BATCH frames at 608x1024; a Swin trunk in
    mode ``swin_kernel``; ``sample_step`` set on the config over its
    SAMPLE_STEP (4: the x4 DDIM ensemble).  A first pass warms up; the
    launch counts and times are of the second.  With ``keep_k1``, the K1
    inputs of the first pass's last chunk (the second's are the same) are
    appended to it.  Returns the phase's line."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.streaming import StreamingDetector
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch

    cfg = load_config(str(ROOT / "configs" / config))
    if sample_step is not None:
        cfg.MODEL.DiffusionDet.SAMPLE_STEP = sample_step
    steps = cfg.MODEL.DiffusionDet.SAMPLE_STEP
    t0 = time.perf_counter()
    model = DiffusionDetArch.from_config(cfg, seed=seed, swin_kernel=swin_kernel)
    mega = cfg.MODEL.VID.MEGA
    det = StreamingDetector(
        model, infer_batch=cfg.INPUT.INFER_BATCH, sample_step=steps,
        mem_size=mega.MEMORY_MANAGEMENT_SIZE_TEST, mem_dis_size=150,
        num_proposals=cfg.MODEL.DiffusionDet.NUM_PROPOSALS,
        use_nms=cfg.MODEL.DiffusionDet.USE_NMS,
        detections_per_img=cfg.TEST.DETECTIONS_PER_IMG,
        stop_update_after_init=mega.GLOBAL.STOP_UPDATE_AFTER_INIT_TEST)
    build_s = time.perf_counter() - t0
    f, h, w = cfg.INPUT.INFER_BATCH, FLAGSHIP["h"], FLAGSHIP["w"]
    n_global = mega.GLOBAL.SIZE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gframes = torch.rand(n_global, h, w, 3, generator=gen, device="cuda") * 255
    chunks = [torch.rand(f, h, w, 3, generator=gen, device="cuda") * 255
              for _ in range(n_chunks)]
    whwh = torch.tensor([w, h, w, h], dtype=torch.float32, device="cuda")

    def drive(keep=None):
        state = det.start_video(seed, gframes, whwh)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        outs = []
        for i, c in enumerate(chunks):
            last = keep is not None and i == len(chunks) - 1
            with capture_k1(keep) if last else contextlib.nullcontext():
                state, dets = det.process_chunk(state, c, whwh)
            outs.append(dets)
        torch.cuda.synchronize()
        return state, outs, t_start

    drive(keep_k1)                            # warm-up: allocator, cuDNN plans
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, outs, t_chunks = drive()
    t1 = time.perf_counter()
    launches = read_launches()

    passes = n_chunks + -(-n_global // f)     # backbone passes
    # decoder stages a chunk: the extract pass's shared stages, then the
    # conditioned ones (x1) or the whole stack at every DDIM step (xN)
    shared, cond = len(model.head.head_series), len(model.head.head_series_cond)
    per_chunk = shared + (cond if steps == 1 else steps * (shared + cond))
    want = {"roi_align_fwd": n_chunks * per_chunk + -(-n_global // f) * shared}
    want["dynamic_conv"] = want["roi_align_fwd"]
    if model.backbone_type == "swin":
        blocks = sum(len(layer.blocks) for layer in model.backbone.bottom_up.layers)
        want.update({k: blocks * passes for k in SWIN_MODE_KERNELS[swin_kernel]})
    for name, n in launches.items():
        require(n == want.get(name, 0),
                f"{phase}: {name} launched {n} times, expected {want.get(name, 0)}")
    require(state.mem.count == det.mem_size and state.mem_dis.count == det.mem_dis_size,
            f"{phase}: memory not filled ({state.mem.count}, {state.mem_dis.count})")
    require(bool(torch.isfinite(state.mem.feats).all()), f"{phase}: non-finite memory")
    for dets in outs:
        require(tuple(dets.boxes.shape) == (f, steps * det.detections_per_img, 4),
                f"{phase}: boxes shape {tuple(dets.boxes.shape)}")
        for key in ("boxes", "scores"):
            require(bool(torch.isfinite(getattr(dets, key)).all()),
                    f"{phase}: non-finite {key}")
        require(int(dets.labels.min()) >= 1
                and int(dets.labels.max()) <= cfg.MODEL.DiffusionDet.NUM_CLASSES,
                f"{phase}: labels out of range")
        require(int(dets.valid.sum()) > 0, f"{phase}: NMS kept nothing")
    res = {"config": f"configs/{config}", "dtype": "bfloat16", "sample_step": steps,
           "swin_kernel": swin_kernel if model.backbone_type == "swin" else None,
           "frames": [n_global, n_chunks * f], "hw": [h, w],
           "launches": launches, "expected_launches": want,
           "model_build_s": build_s, "start_video_s": t_chunks - t0,
           "chunks_s": t1 - t_chunks, "fps": n_chunks * f / (t1 - t_chunks),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kept_per_frame": float(outs[-1].valid.sum(-1).float().mean()),
           "card": torch.cuda.get_device_name(0)}
    # v1: K7's card time in the profiled chunk (its 24 launches of one pass)
    res.update(profile_chunk(det, state, chunks[0], whwh, phase,
                             K7_KERNELS if swin_kernel == "v1" else ()))
    if swin_kernel == "v1":
        res["k7_chunk_kernel_ms"] = res.pop("kernels_ms")
    emit(phase, **res)
    del det, model, state, outs
    torch.cuda.empty_cache()
    return res


# the device kernels of each wrapper on the streaming path, by name; K4's
# and K7's bf16 kernels share a name, so the Swin entries go by trunk mode
CHUNK_KERNELS = {"roi_align_fwd": ("roi_footprint_kernel", "roi_align_fwd_kernel"),
                 "dynamic_conv": ("dynamic_conv_kernel", "dynconv_ring_kernel")}
SWIN_CHUNK_KERNELS = {"v3": {"swin_block_attn": ("attn_bf16_kernel",),
                             "swin_block_mlp": K5_KERNELS},
                      "v2": {"window_attn_qkv": K6_KERNELS}, "v1": {"window_attn": K7_KERNELS}}


@contextlib.contextmanager
def timed_postprocess(out: dict):
    """Host time of a chunk's post-processing, from a synchronised start
    (the class-aware NMS syncs the host once a fixed-point pass), into
    ``out["nms_host_ms"]``, and the passes of its NMS into
    ``out["nms_iterations"]``."""
    from diffusionvid_torch.engine import streaming
    from diffusionvid_torch.ops.nms import nms_mask
    inner = {k: getattr(streaming, k) for k in ("postprocess_frame", "postprocess_ensemble")}

    def timed(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dets = fn(*args, **kw)
            torch.cuda.synchronize()
            out["nms_host_ms"] = (time.perf_counter() - t0) * 1e3
            out["nms_iterations"] = nms_mask.iterations
            return dets
        return run

    for k, fn in inner.items():
        setattr(streaming, k, timed(fn))
    try:
        yield
    finally:
        for k, fn in inner.items():
            setattr(streaming, k, fn)


def profile_chunk(det, state, frames, whwh, phase: str, kernels=()) -> dict:
    """Device time of one chunk by kernel name (``torch.profiler``), with
    ``path_kernels_ms``, the device time of each wrapper's kernels on the
    path, and the host time and passes of its NMS; the full table goes to
    ``build/chip_smoke/<phase>_chunk_profile.txt``."""
    by_kernel = dict(CHUNK_KERNELS)
    if det.model.backbone_type == "swin":
        by_kernel.update(SWIN_CHUNK_KERNELS[det.model.backbone.bottom_up.kernel_mode])
    nms = {}
    with timed_postprocess(nms):
        res = profile_device(lambda: det.process_chunk(state, frames, whwh),
                             f"{phase}_chunk", kernels, by_kernel=by_kernel)
    res["profiled_chunk_wall_ms"] = res.pop("profiled_wall_ms")
    res.update(nms)
    return res


def profile_device(run, name: str, kernels=(), by_kernel: dict | None = None) -> dict:
    """Device time of ``run()`` by kernel name (``torch.profiler``), its
    share of the wall time, the device operations launched and the host
    operators that took the most host time; with ``kernels``, also
    ``kernels_ms``, the device time of the kernels whose names hold one of
    them, and with ``by_kernel`` (name: such a tuple) ``path_kernels_ms``,
    that time by name where it is not 0.  The full table goes to
    ``build/chip_smoke/<name>_profile.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}_profile.txt").write_text(
        averages.table(sort_by="self_device_time_total", row_limit=60))
    res = {"profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
           "device_ops": sum(e.count for e in events),
           "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
           "top_host_ms": {f"{e.key[:40]} x{e.count}": e.self_cpu_time_total / 1e3
                           for e in host}}

    def kernels_ms(names):
        return sum(e.self_device_time_total for e in events
                   if any(k in e.key for k in names)) / 1e3

    if kernels:
        res["kernels_ms"] = kernels_ms(kernels)
    if by_kernel:
        res["path_kernels_ms"] = {k: ms for k, names in by_kernel.items()
                                  if (ms := kernels_ms(names)) > 0}
    return res


# ---------------------------------------------------------------- train paths

TRAIN_KERNELS = ("roi_align_fwd", "dynamic_conv", "roi_align_bwd")


def train_launches(model, micro_steps: int) -> dict:
    """The launches ``micro_steps`` train micro-steps make: K1, K2 and K3 once
    per decoder stage; with a Swin trunk, K6 once per block (a forward that
    needs a gradient takes the v2 branch) and none of K4, K5, K7."""
    stages = len(model.head.head_series) + len(model.head.head_series_cond)
    want = {k: stages * micro_steps for k in TRAIN_KERNELS}
    if model.backbone_type == "swin":
        blocks = sum(len(layer.blocks) for layer in model.backbone.bottom_up.layers)
        want["window_attn_qkv"] = blocks * micro_steps
    return want


def train_batch(gen, samples: int, frames: int, slots: int, h: int, w: int,
                num_classes: int, device):
    """Random frames in 0..255 and 1 to 8 random GT boxes per frame, padded
    to ``slots`` GT slots."""
    from diffusionvid_torch.engine.train import TrainBatch
    images = torch.rand(samples, frames, h, w, 3, generator=gen) * 255
    n = torch.randint(1, 9, (samples, frames), generator=gen)
    valid = torch.arange(slots)[None, None, :] < n[..., None]
    size = torch.tensor([w, h], dtype=torch.float32)
    wh = 8 + torch.rand(samples, frames, slots, 2, generator=gen) * size * 0.5
    xy = torch.rand(samples, frames, slots, 2, generator=gen) * (size - wh)
    boxes = torch.cat([xy, xy + wh], -1) * valid[..., None]
    labels = torch.randint(1, num_classes + 1, (samples, frames, slots), generator=gen) * valid
    whwh = torch.tensor([[w, h, w, h]], dtype=torch.float32).repeat(samples, 1)
    return TrainBatch(*[t.to(device) for t in (images, boxes, labels, valid, whwh)])


def conditioned_train_model(gen, images, **arch):
    """A float32 ``DiffusionDetArch(**arch)`` with random weights from
    ``gen``, set up so that two implementations' gradients compare well:
    every ReLU sits far from its kink.  A unit whose input lies within the
    two sides' forward difference (about 1e-6 relative) of zero takes its
    gradient on one side only, and so does a max-pool window whose two
    largest inputs are that close; with random weights a gradient is a sum
    of millions of terms of either sign, so one such unit moves it by about
    1e-3 of its norm.  So the convolutions are rescaled to fan-in variance;
    every FrozenBN takes the mean and variance of its input on ``images``
    as running statistics and a bias of about +3, so its ReLU input is
    about N(3, 0.5) (N(3, 1) at the stem, whose max-pool needs the spread);
    the head's LayerNorms before a ReLU, and the FFN's first layer, put
    their units at about +3; the box deltas are scaled down so that no box
    reaches the delta clamp; the other head 1-D parameters are perturbed.
    Used by ``phase_tiny_train`` and by the CPU tests against JAX."""
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.models.resnet import FrozenBatchNorm2d
    model = DiffusionDetArch(**arch, compute_dtype=torch.float32)
    model.reset_parameters(gen)
    relu_ln = ("inst_interact.norm1.", "inst_interact.norm2.", "inst_interact.norm3.",
               "cls_module.1.", "reg_module.1.", "reg_module.4.", "reg_module.7.")
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 4:
                p.mul_((p.shape[0] / p.shape[1]) ** 0.5)
            elif name.startswith("backbone.") and name.endswith("norm.weight"):
                p.copy_((1.0 if ".stem." in name else 0.5) + 0.05 * noise)
            elif name.startswith("backbone.") and name.endswith("norm.bias"):
                p.copy_(3.0 + 0.1 * noise)
            elif any(k in name for k in relu_ln):
                p.copy_((3.0 if name.endswith("bias") else 0.5) + 0.05 * noise)
            elif name.endswith("linear1.bias"):
                p.fill_(3.0)
            elif name.endswith(("linear1.weight", "bboxes_delta.weight")):
                p.mul_(0.3 if "linear1" in name else 0.05)
            elif p.dim() == 1 and name.startswith("head."):
                p.add_(0.2 * noise)

    def calibrate(mod, args):
        mod.running_mean.copy_(args[0].mean((0, 2, 3)))
        mod.running_var.copy_(args[0].var((0, 2, 3)))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, FrozenBatchNorm2d)]
    with torch.no_grad():
        model.extract_features(images)
    for hook in hooks:
        hook.remove()
    return model


SWIN_T_ARCH = dict(backbone_type="swin", swin_size="T", fpn_in=("swin1", "swin2", "swin3"))


def phase_tiny_train(seed: int, kind: str = "resnet"):
    """One train micro-step of a depth-18 (``kind`` "resnet") or Swin-T
    ("swin") model, 50 proposals, 1 + 2 frames at 64x96, float32, TF32 off:
    on the card (K1, K2, K3, and K6 for the Swin trunk) against the CPU
    (plain versions), same weights, batch and draws.  Losses to 1e-4 and
    every gradient to 1e-3 relative in norm, the tolerances the CPU tests
    hold against JAX."""
    import copy

    from diffusionvid_torch.engine.train import TrainBatch, draw_train_randoms, make_loss_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    h, w, props, frames = 64, 96, 50, 3
    batch = train_batch(gen, 1, frames, 6, h, w, 5, "cpu")
    cpu = conditioned_train_model(gen, batch.images[0], depth=18, num_classes=5,
                                  num_proposals=props, num_heads=1, num_heads_local=1,
                                  **(SWIN_T_ARCH if kind == "swin" else {}))
    card = copy.deepcopy(cpu).cuda()
    draws = draw_train_randoms(gen, 1, frames, props)

    def step(model, dev):
        total, losses = make_loss_fn(model, frames - 1)(
            TrainBatch(*[t.to(dev) for t in batch]), type(draws)(*[t.to(dev) for t in draws]))
        total.backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                 for n, p in model.named_parameters()}
        return {"total_loss": total.detach().cpu(),
                **{k: v.detach().cpu() for k, v in losses.items()}}, grads

    reset_launches()
    c_losses, c_grads = step(card, "cuda")
    torch.cuda.synchronize()
    used = read_launches()
    want = train_launches(card, 1)
    phase = "tiny_train" if kind == "resnet" else f"tiny_train_{kind}"
    require(used == {k: want.get(k, 0) for k in used},
            f"{phase}: launches {used}, expected {want}")
    p_losses, p_grads = step(cpu, "cpu")
    loss_err = max(float((c_losses[k] - v).abs() / v.abs().clamp(min=1e-12))
                   for k, v in p_losses.items())
    grad_err, worst = 0.0, ""
    for name, g in p_grads.items():
        e = float(torch.linalg.vector_norm(c_grads[name] - g)
                  / torch.linalg.vector_norm(g).clamp(min=1e-12))
        if e > grad_err:
            grad_err, worst = e, name
    emit(phase, launches=used, loss_rtol=1e-4, grad_rtol=1e-3,
         max_rel_err_loss=loss_err, max_rel_err_grad=grad_err, worst_grad=worst,
         total_loss=float(p_losses["total_loss"]))
    require(all(bool(torch.isfinite(v)) for v in c_losses.values()), f"{phase}: non-finite loss")
    require(loss_err < 1e-4 and grad_err < 1e-3,
            f"{phase}: card vs CPU over tolerance: loss {loss_err}, grad {grad_err} ({worst})")


def criterion_ms(micro) -> float:
    """Wall ms that the set criterion's forward (simOTA with its repair
    loop, the losses) takes in one micro-step, host and device, each call
    between two synchronizes."""
    from diffusionvid_torch.engine import train
    inner, spent = train.set_criterion, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    train.set_criterion = timed
    try:
        micro()
    finally:
        train.set_criterion = inner
    return sum(spent) * 1e3


def phase_flagship_train(seed: int, config: str, phase: str, timed_steps: int,
                         keep_k3: list | None = None) -> dict:
    """A flagship's train step at full width, bf16: ``config`` with random
    weights, 1 + REF_NUM_GLOBAL frames at 608x1024 with 1 to 8 random GT
    boxes each, ACCUMULATION_STEPS micro-steps per optimizer step.  Two
    warm-up optimizer steps, then ``timed_steps`` timed ones, whose launch
    counts are read.  With ``keep_k3``, the K3 inputs of the last
    micro-step (the criterion's timing run) are appended to it."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.train import (
        draw_train_randoms, iteration_generator, make_train_step, optimizer_from_config,
        param_group)
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch

    cfg = load_config(str(ROOT / "configs" / config))
    t0 = time.perf_counter()
    model = DiffusionDetArch.from_config(cfg, seed=seed)
    opt = optimizer_from_config(model, cfg)
    build_s = time.perf_counter() - t0
    num_global = cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    frames, accum = 1 + num_global, cfg.SOLVER.ACCUMULATION_STEPS
    h, w, props = TRAIN["h"], TRAIN["w"], cfg.MODEL.DiffusionDet.NUM_PROPOSALS
    gen = torch.Generator().manual_seed(seed)
    batches = [train_batch(gen, 1, frames, cfg.TPU.MAX_GT_BOXES, h, w,
                           cfg.MODEL.DiffusionDet.NUM_CLASSES, "cuda") for _ in range(accum)]
    step = make_train_step(model, opt, num_global)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = {"it": 0, "metrics": []}

    def micro():
        it = state["it"]
        draws = draw_train_randoms(iteration_generator(seed, it), 1, frames, props,
                                   p_uncond=model.head.p_uncond, device="cuda")
        state["metrics"].append(step(batches[it % accum], draws))
        state["it"] = it + 1

    for _ in range(2 * accum):                # warm-up: allocator, cuDNN plans
        micro()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(timed_steps * accum):
        micro()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()

    micro_steps = timed_steps * accum
    want = train_launches(model, micro_steps)
    for name, n in launches.items():
        require(n == want.get(name, 0),
                f"{phase}: {name} launched {n} times, expected {want.get(name, 0)}")
    last = {k: float(v) for k, v in state["metrics"][-1].items()}
    require(all(torch.isfinite(v).all() for m in state["metrics"] for v in m.values()),
            f"{phase}: non-finite loss")
    moved = {g: 0 for g in ("main", "bias", "backbone", "backbone_bias", "frozen")}
    for n, p in model.named_parameters():
        moved[param_group(n)] += int(not torch.equal(p.detach(), start[n]))
    require(moved["frozen"] == 0 and all(moved[g] > 0 for g in moved if g != "frozen"),
            f"{phase}: parameters moved per group {moved}")
    require(opt.count == 2 + timed_steps, f"{phase}: {opt.count} optimizer steps")
    res = {"config": f"configs/{config}", "dtype": "bfloat16",
           "frames": frames, "hw": [h, w], "accumulation_steps": accum,
           "timed_optimizer_steps": timed_steps, "launches": launches,
           "expected_launches": want, "model_build_s": build_s,
           "ms_per_optimizer_step": dt / timed_steps * 1e3,
           "ms_per_micro_step": dt / micro_steps * 1e3,
           "trained_frames_per_s": micro_steps * frames / dt,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": last, "params_moved": moved, "lr_main": opt.lr("main"),
           "card": torch.cuda.get_device_name(0)}
    res.update({f"micro_step_{k}": v
                for k, v in profile_device(micro, f"{phase}_micro_step").items()})
    from diffusionvid_torch.ops import roi_align as ra
    inner = ra._launch_bwd

    def keep(g, rois, level, shapes, scales, scratch=None):
        keep_k3.append(dict(g=g.clone(), rois=rois.clone(), shapes=[tuple(s) for s in shapes],
                            scales=tuple(scales)))
        return inner(g, rois, level, shapes, scales, scratch)

    if keep_k3 is not None:
        ra._launch_bwd = keep
    try:
        res["criterion_ms_per_micro_step"] = criterion_ms(micro)
    finally:
        ra._launch_bwd = inner
    emit(phase, **res)
    del model, opt, step, state, start, batches
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from diffusionvid_torch.ops import _build   # fails here without the repository
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in reports.items()})
    # empty when this checkout had built K1's, K2's, K4's, K5's or K6's library before
    for source in ("roi_align_fwd", "dynamic_conv", "swin_block_attn", "swin_block_mlp",
                   "window_attn_qkv"):
        emit("ptxas", source=source, report=ptxas_report(reports.get(source, "")))
    # K7's bf16 kernel, in window_attn_qkv.cu beside K6
    k7_ptxas = {k: v for k, v in ptxas_report(reports.get("window_attn_qkv", "")).items()
                if K7_KERNELS[0] in k}
    emit("ptxas", source="window_attn_qkv", kernel="K7", report=k7_ptxas)

    kernel_rows = phase_kernels(args.seed)
    phase_tiny(args.seed, "resnet")
    for mode in SWIN_MODE_KERNELS:
        phase_tiny(args.seed, "swin", mode)
    phase_tiny(args.seed, "resnet", sample_step=4)
    phase_tiny(args.seed, "swin", "v3", sample_step=4)
    k1_inputs = []
    launches = phase_flagship(args.seed, "vid_R_101_DiffusionVID.yaml", 3, "flagship",
                              keep_k1=k1_inputs)["launches"]
    k1_stream = phase_k1_stream(k1_inputs)
    del k1_inputs
    swin = phase_flagship(args.seed, "vid_Swin_B_DiffusionVID.yaml", 6, "flagship_swin")
    for name in ("swin_block_attn", "swin_block_mlp"):
        launches[name] = swin["launches"][name]
    v1 = phase_flagship(args.seed, "vid_Swin_B_DiffusionVID.yaml", 2, "flagship_swin_v1", "v1")
    launches["window_attn"], v1_k7_ms = v1["launches"]["window_attn"], v1["k7_chunk_kernel_ms"]
    x4 = phase_flagship(args.seed, "vid_R_101_DiffusionVID.yaml", 3, "flagship_x4",
                        sample_step=4)["launches"]
    swin_x4 = phase_flagship(args.seed, "vid_Swin_B_DiffusionVID.yaml", 2, "flagship_swin_x4",
                             sample_step=4)["launches"]
    x4_launches = {k: x4[k] for k in ("roi_align_fwd", "dynamic_conv")}
    x4_launches.update({k: swin_x4[k] for k in ("swin_block_attn", "swin_block_mlp")})
    phase_tiny_train(args.seed)
    phase_tiny_train(args.seed, "swin")
    k3_inputs = []
    launches["roi_align_bwd"] = phase_flagship_train(
        args.seed, "vid_R_101_DiffusionVID.yaml", "flagship_train", 5,
        keep_k3=k3_inputs)["roi_align_bwd"]
    k3_train = phase_k3_train(k3_inputs)
    del k3_inputs
    launches["window_attn_qkv"] = phase_flagship_train(
        args.seed, "vid_Swin_B_DiffusionVID.yaml", "flagship_train_swin", 3)["window_attn_qkv"]

    line = []
    for name, spec in KERNELS.items():
        bf = kernel_rows[name]["bfloat16"]
        line.append({"name": name, "route": spec["route"], "source": spec["source"],
                     "replaces": spec["replaces"], "launches": launches[name],
                     "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
                     "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
                     "bound_by": bf["bound_by"], "library_ms": bf.get("library_ms")})
        if name == "roi_align_fwd":
            line[-1].update(kernel_ms=bf["kernel_ms"], host_ms=bf["host_ms"],
                            stream_kernel_ms=k1_stream["kernel_ms"])
        if name == "roi_align_bwd":
            line[-1]["train_ms"] = k3_train["ms"]
        if name == "window_attn_qkv":
            line[-1].update(kernel_ms=bf["kernel_ms"], library_full_ms=bf["library_full_ms"])
        if name == "window_attn":
            line[-1].update(kernel_ms=bf["kernel_ms"], host_ms=bf["host_ms"],
                            v1_chunk_kernel_ms=v1_k7_ms, ptxas=k7_ptxas)
        if name in ("dynamic_conv", "swin_block_mlp"):
            line[-1].update(kernel_ms=bf["kernel_ms"], unfused_ms=bf["unfused_ms"])
        if name in x4_launches:   # on the R-101 (K1, K2) and Swin-B (K4, K5) x4 streams
            line[-1]["x4_launches"] = x4_launches[name]
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
              backbone pass (stage depths 2, 2, 18, 2).  K4 and K5 also run
              at the four Swin-L-22k-384 stage maps (window 12, C 192 to
              1536; K4 with shift 0 and 6) and at L-22k's stage 3 (C = 1536
              at window 7), bf16 and fp32, where K4 takes its staged design
              (its qkv and o maps held against their plain versions too);
              their ``swin_l`` holds the means over one Swin-L-22k-384
              pass, and K4's staged rows its card time ``kernel_ms``.  K6 (5
              frames) and K7 (4) run at those maps too, with shift 0 and 6,
              where they take their staged design (K6's qkv map held against
              its plain version too), with their ``swin_l`` means; K6's fp32
              gradients are also checked at window 12 (stage 3).  K6 and K7 also
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
              the renewal masks equal, no best score within 1e-4 of it; then
              a window-12 Swin (``TINY_W12``, C 128 to 1024) in each mode at
              x1 the same way (v3: K4's staged design, K5; v2: K6's, v1:
              K7's staged design);
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
              Swin-B 2 chunks of 4 (56 of K1/K2, 192 of K4/K5); then
              ``flagship_swin_l``, the Swin-B config with ``MODEL.SWIN.SIZE
              L-22k-384`` (window 12, C up to 1536), 3 chunks of 4 (216
              launches of K4/K5), and ``flagship_swin_l_cli``, the port's
              test CLI with that override on one rendered video of 16
              frames at 600x1000 (192 launches of K4/K5)
              (``phase_flagship_swin_l``); then ``flagship_swin_l_v2`` and
              ``flagship_swin_l_v1``, the same config in modes v2 and v1, 2
              chunks of 4 (192 launches of K6 / K7, none of K4/K5), with
              K6's / K7's card time in the profiled chunk;
  7. tiny_train one train micro-step of a depth-18 model on 64x96 frames
              (1 + 2 frames, 50 proposals), on the card through K1, K2 and K3
              and on the CPU through the plain versions, same weights, batch
              and draws, float32, TF32 off: losses and every gradient; then
              ``tiny_train_swin`` and ``tiny_train_swin_w12``, the same with
              a Swin-T and a window-12 trunk (``TINY_W12``; K6);
  8. flagship_train the R-101 train step (``engine/train.py``) at full width
              with random weights and random GT from ``--seed``: 5 frames at
              608x1024, bf16, ACCUMULATION_STEPS 2; 2 warm-up optimizer steps,
              then 5 timed ones; checks finite losses, moved parameters and
              4 launches each of K1, K2 and K3 per micro-step, prints ms per
              optimizer step, frames/s, peak memory, one micro-step's
              device time by kernel and host time by operator, and the
              time the criterion takes in a micro-step; then
              ``flagship_train_swin``, the Swin-B train step the same way
              with 3 timed steps and 24 launches of K6 per micro-step, and
              ``flagship_train_swin_l``, the Swin-B config with
              ``MODEL.SWIN.SIZE L-22k-384`` (K6's staged design), one
              warm-up and 2 timed steps; both with K6's backward time in a
              micro-step;
  9. k3_train K3 on the inputs of the R-101 train step's last micro-step
              (4 launches): checked in bf16 and fp32 as in phase 3, timed,
              with its bound, its ROIs and longest tile list per level and
              its plan.
  10. flagship_eval dataset evaluation through the port's ``run_inference``
              (after phase 6's x4 phases): ``configs/vid_R_101_DiffusionVID.yaml``
              over 2 generated videos of 43 frames at 600x1000, frames
              rendered from their annotations (no image decoder on the
              card's machine): x1 with seq-NMS (33 launches of K1 and of K2
              a video; fps, time in ``process_chunk`` and in the host
              conversion, seq-NMS and ``evaluate_vid`` ms, peak memory, AP50
              of random weights; ``predictions.pkl`` re-evaluated), 2 shards
              merged against it, x4 on one video (123 launches, 1,200 rows
              a frame), and the test CLI with a tiny model on the card
              against the CPU (``phase_flagship_eval``).  seq-NMS and the
              matching run in the host library ``csrc/vidkit.cpp``; on the
              run's own seq-NMS inputs and predictions both are run again
              through the library and through the Python paths, which must
              give equal keep masks, rescored scores, match flags and
              ignored shares, each path timed (``vidkit_check``).
  10b. mega_family_tiny the MEGA family's ``base``, ``rdn``, ``mega`` (with
              its stage rings) and ``dafa`` at depth 18 on 64x96 frames,
              card against CPU (selections equal, values within 1e-3; DAFA
              alone launches K1 and K2); then ``mega_family``, the four R-101
              configs (``vid_R_101_C4_1x``, ``RDN/..._RDN_base_1x``,
              ``MEGA/..._MEGA_1x``, ``MEGA/..._DAFA_1x``) at full width, bf16,
              through ``run_inference_video_arch`` on one rendered video of 12
              frames at 600x1000: fps, peak memory, the memories' fill, the
              K1/K2 launches (DAFA: 78), one frame's device time and idle
              share, its NMS calls and the C4 pooler's ms and peak; then
              ``mega_family_kernels``, K1 and K2 on DAFA's own inputs (the
              extract pass and one frame), checked and timed
              (``phase_mega_family``).
  10c. mega_family_rest_tiny the rest of the MEGA family (``MEGA_REST``):
              DFF (keys at frames 0 and 4), FGFA, MEGA on ResNeXt (the X-101
              config narrowed to 8 groups of 8), ``base`` with
              ``TEST.BBOX_AUG`` (h-flip and two scales, each flipped too) and
              MEGA on the pixel paths (160x240 frames) at depth 18, card
              against CPU (labels equal, values within 1e-3, memories'
              fills equal, no launch of K1–K7); then ``mega_family_rest``,
              the five at full width, bf16 (``DFF/..._DFF_1x``,
              ``FGFA/..._FGFA_1x``, ``MEGA/vid_X_101_C4_MEGA_1x``,
              ``vid_R_101_C4_1x`` with ``BBOX_AUG`` at scales 400 and 800,
              max 2000, and ``MEGA/..._MEGA_1x`` with ``ATTENTION.ENABLE``
              off and both pixel flags), through ``run_inference_video_arch``
              with the CLI's options on one rendered video of 12 frames at
              600x1000: fps, peak memory, the memories' and pixel caches'
              fill, DFF's key passes, no launch of K1–K7, the middle frame's
              device busy ms and idle share, FlowNetS's ms a pair
              (``phase_mega_family_rest``).
  10d. mega_family_train_tiny one train step of each of the MEGA family's
              methods (``MEGA_TRAIN``: ``base``, DFF, FGFA, RDN with its
              advanced stage, MEGA, MEGA on the pixel path, DAFA) at depth 18
              on 64x96 frames, card against CPU, same weights (conditioned),
              sample and draws, fp32, TF32 off: losses (1e-4) and every
              gradient (1e-3 of its norm); DAFA launches K1, K2 and K3 12
              times each, the C4 methods none; then ``mega_family_train``,
              the seven at full width (R-101 configs, bf16, one sample at
              600x1000 in the method's frame layout, the RPN and predictor
              at the reference's inits and the FrozenBN statistics taken
              from the sample): one warm-up and 2
              timed optimizer steps, ms per optimizer step, peak memory, the
              losses under the JAX package's names, one micro-step profiled,
              DAFA's 12 launches each of K1/K2/K3 a micro-step (required);
              ``mega_family_train_kernels``, K1, K2 and K3 on DAFA's
              captured inputs (the current frame's and the global frames'
              passes), bf16 and fp32, timed with their bound; and
              ``mega_family_train_cli``, the train CLI on DAFA and MEGA at
              full width from rendered frames on disk, 4 iterations
              (BATCH_REUSE_STEPS 2, a checkpoint at 2), then resumed from 2:
              bit-equal to the uninterrupted run under PyTorch's
              deterministic algorithms (``phase_mega_family_train*``).
  11. flagship_train_cli training from files on disk through the port's
              train CLI (``tools/train_net.main``, after phase 8's Swin-B
              step): the R-101 config at full width with the SSD
              augmentation, 8 iterations (BATCH_REUSE_STEPS 2,
              ACCUMULATION_STEPS 2), ``MODEL.WEIGHT`` a detectron2-style
              trunk ``.pkl``, a checkpoint at 4 and 8, validation at 8;
              then resumed from 4 in a second directory.  Frames rendered
              from the annotations of 2 videos at 720x1280, 8 DET stills
              (two portrait) and a val video at 600x1000.  Prints the
              tensors loaded, ``sample_ms`` (a 5-frame sample's build),
              ``wait_ms`` (blocked on the prefetcher), ``micro_step_ms``,
              ms per optimizer step, trained frames/s, peak memory, K1/K2/K3
              launches (4 a micro-step, plus validation's K1/K2, required),
              the buckets, the checkpoints, ``metrics.jsonl`` purged at the
              resume, and the resumed run against the uninterrupted one
              (``phase_flagship_train_cli``); then
              ``flagship_train_swin_l_cli``, the train CLI on the Swin-B
              config with ``MODEL.SWIN.SIZE L-22k-384`` over the same files,
              2 iterations: 24 launches of K6 and 4 each of K1/K2/K3 an
              iteration, finite losses, its checkpoint.
  12. flagship_local_attn the local temporal attention (ATTENTION.ENABLE,
              STAGE 2) on the R-101 config at full width: streaming, 24
              global frames then 2 chunks of 8 (17 launches of K1 and of
              K2); the train step on samples of 1 + 2 local + 4 global
              frames, one warm-up and 2 timed optimizer steps (16 launches
              each of K1, K2 and K3); then the tiny model with
              GLOBAL.ENABLE off, card against CPU as in phase 4
              (``phase_flagship_local_attn``).
  13. flagship_train_ddp the R-101 train step data parallel: 2 ``gloo``
              ranks on the one card, spawned and joined here, 2 optimizer
              steps of a 2-sample batch, one sample a rank, each step's
              losses (1e-4) and averaged gradient (1e-3 of its norm)
              against one process on both samples from the same
              parameters; then ``run_inference`` with the ranks as shards,
              gathered, against phase 10's predictions; then a 1-rank
              ``nccl`` group against one process.  Prints ms per optimizer
              step of each and a rank's time to its start and its first
              step (``phase_flagship_train_ddp``).
  14. still_image_tiny the still-image detectors at depth 18 on 64x96,
              card against CPU, fp32, TF32 off: ``GeneralizedRCNN`` with the
              mask and keypoint heads (32 wide; labels equal, boxes,
              scores, masks and heatmaps within 1e-3), RetinaNet (the
              same), ``mask_loss`` / ``keypoint_loss`` through both heads
              and RetinaNet's ``train_loss`` (values within 1e-4 in fp32,
              every gradient within 1e-3 of its norm in float64); then
              ``still_image`` at full width, bf16: the mask config
              (R-50 C4, 81 classes, 300 detection slots) and with
              ``KEYPOINT_ON``, ms an image, the heads' card ms, peak
              memory; ``vid_R_101_C4_1x`` through ``run_inference_still``
              over rendered COCO-, VOC- and Cityscapes-layout sets of 8
              images at 600x1000 (two portrait), images/s, the
              evaluator's ms; RetinaNet (R-50 FPN, 81 classes) over the
              COCO set; the test CLI on a tiny COCO set, card against CPU.
              No path launches K1–K7 (``phase_still_image*``).
Then the ``kernels`` line (every kernel with its launches on its flagship
path, error against its plain version, times and bound; K1's with its card
time, host time and card time on the stream's inputs; K1's, K2's, K4's and
K5's with ``x4_launches`` on the x4 streams, K4's and K5's with
``swin_l_launches`` on the Swin-L-22k-384 stream and ``swin_l_ms``,
``swin_l_kernel_ms``, ``swin_l_plain_ms``, ``swin_l_bound_ms`` and
``swin_l_bound_by`` over one Swin-L-22k-384 pass; K1's and K2's with
``eval_launches`` in phase 10's x1 run and ``dafa_launches`` in phase
10b's DAFA run; K1's, K2's and K3's with
``train_cli_launches`` in phase 11's first run; K1's and K2's with
``local_attn_launches`` and K1's, K2's and K3's with
``local_attn_train_launches`` (phase 12), ``ddp_rank_launches`` (a
rank's first optimizer step, phase 13) and ``mega_train_launches`` (DAFA's
full-width train micro-step, phase 10d); K7's with its card time, host
time, card time in a v1 chunk and registers; K6's and K7's with the
``swin_l_*`` means over one Swin-L-22k-384 pass and ``swin_l_launches``,
K6's in the Swin-L train step (also ``swin_l_v2_launches``,
``swin_l_cli_launches``, ``swin_l_bwd_ms``), K7's in its v1 stream), the
card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero before that line.  Needs the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
# Swin-L-22k-384 (window 12) at 608x1024 over a 4-frame chunk, the stage
# maps of phase 6's flagship_swin_l, and L-22k's stage 3 (C = 1536 at
# window 7): K4's staged design and K5 at C = 1536
SWIN_L_STAGES = [dict(hw=(152, 256), c=192, heads=6, depth=2, window=12),
                 dict(hw=(76, 128), c=384, heads=12, depth=2, window=12),
                 dict(hw=(38, 64), c=768, heads=24, depth=18, window=12),
                 dict(hw=(19, 32), c=1536, heads=48, depth=2, window=12)]
SWIN_L7_STAGE3 = dict(hw=(19, 32), c=1536, heads=48, depth=2, window=7)
# a window-12 Swin for phase 4 (the tiny phases): widths K5 is built for,
# multiples of 64 for K4's staged design
TINY_W12 = dict(embed_dim=128, depths=(2, 2, 2, 2), num_heads=(4, 8, 16, 32), window=12)


class SmokeFailure(RuntimeError):
    pass


T_START = time.perf_counter()


def emit(phase: str, **kw):
    """A phase's line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T_START, **kw}),
          flush=True)


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
# K6's bf16 kernel, and its staged design's product and window attention
K6_KERNELS = ("attn_qkv_bf16_kernel",)
K6_STAGED_KERNELS = ("qkv_gemm_kernel", "qkv_win_kernel")
# K7's bf16 kernel (the same name in the first design), and its staged
# design's window attention
K7_KERNELS = ("attn_bf16_kernel",)
K7_STAGED_KERNELS = ("win_attn_kernel",)
# K5's bf16 kernels: the fused kernel, or the LN pass and the two products
K5_KERNELS = ("mlp_bf16_kernel", "mlp_ln_kernel", "mlp_gemm_kernel")
# K4's bf16 kernels: the fused design's (the name K7's bf16 kernel has too),
# or the staged design's LN pass, products and window attention
K4_STAGED_KERNELS = ("attn_ln_kernel", "attn_gemm_kernel", "attn_win_kernel")


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
    """One stage's residual map (random over the pad region too), padded
    to its window's (7 unless ``st["window"]``) multiples, and half-block
    weights; the matrices already in ``dtype``."""
    h, w = st["hw"]
    c, heads, win = st["c"], st["heads"], st.get("window", 7)
    hp, wp = -(-h // win) * win, -(-w // win) * win

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    x = rn(frames, hp, wp, c).to(dev, dtype)
    attn = [1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(3 * c, c, scale=c ** -0.5),
            rn(3 * c, scale=0.1), rn(heads, win * win, win * win, scale=0.5),
            rn(c, c, scale=c ** -0.5),
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
    return _maps_agree((("y", y, swin_mlp_ln_ref(x, ln_g, ln_b).reshape(y.shape)),
                        ("h", h, swin_mlp_fc1_ref(y, w1, b1))), tol, what)


def _maps_agree(maps, tol, what: str) -> dict:
    """``compare`` of each (key, kernel's map, plain map), and its mean
    error under ``MEAN_ERR``."""
    res = {}
    for key, got, want in maps:
        r = compare(got, want, *tol, f"{what} {key}")
        r["mean_abs_err"] = float((got.float() - want.float()).abs().mean())
        require(r["mean_abs_err"] < MEAN_ERR[got.dtype],
                f"{what} {key}: mean abs err {r['mean_abs_err']} over {MEAN_ERR[got.dtype]}")
        res[key] = r
    return res


def k4_staged_check(x, attn, mask, heads: int, hw, shift: int, window: int, tol,
                    what: str) -> dict:
    """The staged design's launches on their own: its qkv map against the
    plain qkv product of the plain LN pass, and its o map against the plain
    attention over the kernel's own qkv, so that a fault shows in the
    launch where it happens."""
    from diffusionvid_torch.ops.swin_attention import (
        _mm, launch_attn_staged, swin_attn_core_ref, swin_attn_ln_ref)
    ln_g, ln_b, wqkv, bqkv, bias, wproj, bproj = attn
    o, qkv = launch_attn_staged(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj,
                                torch.empty_like(x), window, heads, hw, shift)
    torch.cuda.synchronize()
    return _maps_agree(
        (("qkv", qkv, _mm(swin_attn_ln_ref(x, ln_g, ln_b, hw, shift), wqkv, bqkv)),
         ("o", o, swin_attn_core_ref(qkv, bias, mask, window, heads))), tol, what)


def _pass_means(rows, keys):
    """Means per launch over one backbone pass: each row weighted by the
    blocks of the pass it stands for."""
    total = sum(r["blocks"] for r in rows)
    return {k: sum(r[k] * r["blocks"] for r in rows) / total for k in keys}


def _swin_check(name, gen, dev, dtype, timing: bool):
    """K4 or K5 at the four Swin-B stage maps, at Swin-T's, at the four
    Swin-L-22k-384 stage maps (window 12) and at L-22k's stage 3 (C = 1536,
    window 7), against the plain version; K4 with shift 0 and half its
    window.  Returns the worst error, the per-stage rows and, with
    ``timing``, the means of ms, plain ms and bound over one Swin-B pass,
    and under ``swin_l`` over one Swin-L-22k-384 pass."""
    from diffusionvid_torch.models.swin import shift_attn_mask
    from diffusionvid_torch.ops.swin_attention import (
        attn_plan, launch_attn_staged, mlp_plan, swin_block_attn, swin_block_attn_ref,
        swin_block_mlp, swin_block_mlp_ref)
    mlp_k = name == "swin_block_mlp"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # fp32: the same fp32 sums in another order, over up to 6144 terms.
    # bf16: TOLERANCE_BF16 below.
    tol = (1e-4, 1e-4) if dtype == torch.float32 else TOLERANCE_BF16[name]
    elt = torch.tensor([], dtype=dtype).element_size()
    rows, worst = [], 0.0
    stages = ([(st, SWIN_FRAMES, "B") for st in SWIN_B_STAGES]
              + [(st, 2, "T") for st in SWIN_T_STAGES]
              + [(st, SWIN_FRAMES, "L-22k-384") for st in SWIN_L_STAGES]
              + [(SWIN_L7_STAGE3, SWIN_FRAMES, "L-22k")])
    for s, (st, frames, size) in enumerate(stages):
        timed = timing and size != "T"
        x, attn, mlp, (hp, wp) = _swin_inputs(gen, dev, dtype, st, frames)
        c, heads, win = st["c"], st["heads"], st.get("window", 7)
        n = win * win
        m = x.numel() // c
        shifts = (0, win // 2) if name == "swin_block_attn" else (0,)
        for shift in shifts:
            plan = None
            if name == "swin_block_attn":
                mask = None
                if shift:
                    mask = torch.from_numpy(shift_attn_mask(hp, wp, win, shift)).to(dev).reshape(
                        hp // win, wp // win, n, n)
                args = (x, *attn[:5], mask, *attn[5:], win, heads, st["hw"], shift)
                fn, ref = swin_block_attn, swin_block_attn_ref
                flops = 2 * m * c * 4 * c + 4 * m * n * c
                nbytes = (2 * x.numel() + 4 * c * c) * elt + (6 * c + heads * n * n) * 4 \
                    + (0 if mask is None else mask.numel() * 4)
                plan = attn_plan(c, frames, hp, wp, win, sms)
            else:
                args = (x, *mlp)
                fn, ref = swin_block_mlp, swin_block_mlp_ref
                flops = 16 * m * c * c
                nbytes = (2 * x.numel() + 8 * c * c) * elt + 7 * c * 4
            got = fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            what = f"{name} {dtype} stage {s} ({size}) shift {shift}"
            res = compare(got, want, *tol, what)
            res["mean_abs_err"] = float((got.float() - want.float()).abs().mean())
            require(res["mean_abs_err"] < MEAN_ERR[dtype],
                    f"{what}: mean abs err {res['mean_abs_err']} over {MEAN_ERR[dtype]}")
            res.update(stage=s, size=size, window=win, shape=list(x.shape), shift=shift)
            staged = plan is not None and plan["path"] == "staged"
            # at Swin-B's maps the staged design also runs beside the fused
            # one (launch_attn_staged, no launch counted), to weigh the two
            beside = name == "swin_block_attn" and dtype == torch.bfloat16 and size == "B"
            if name == "swin_block_attn" and dtype == torch.bfloat16:
                res["plan"] = plan   # blocks, ring, shared bytes; or the products' plans
                if staged or beside:
                    res["hidden"] = k4_staged_check(x, attn, mask, heads, st["hw"], shift, win,
                                                    tol, what)
                if beside:
                    staged_out = torch.empty_like(x)
                    run_staged = functools.partial(
                        launch_attn_staged, *args[:9], staged_out, win, heads, st["hw"], shift)
                    run_staged()
                    res["staged"] = compare(staged_out, want, *tol, f"{what} staged design")
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
                if name == "swin_block_attn" and size == "B":
                    res["unfused_ms"] = cuda_time_ms(
                        lambda: _unfused_attn_half(x, attn, mask, heads, st["hw"]), iters=10)
                if staged:
                    res["kernel_ms"] = device_ms(lambda: fn(*args), K4_STAGED_KERNELS, 10, 4)
                if beside:
                    res["staged_ms"] = cuda_time_ms(run_staged, iters=10)
                    res["staged_kernel_ms"] = device_ms(run_staged, K4_STAGED_KERNELS, 10, 4)
                    # the design's own floor: y, qkv and o written and read, x read twice
                    res["design_bound_ms_bytes"] = (
                        nbytes + 22 * m * c) / HBM_BYTES_PER_S * 1e3
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
            ("kernel_ms",) if mlp_k else ("staged_ms", "staged_kernel_ms"))
        out.update(_pass_means([r for r in rows if r["size"] == "B"], keys))
        out["bound_by"] = ("bytes" if out["bound_ms_bytes"] >= out["bound_ms"]
                           else "operations")
        keys = ("ms", "plain_ms", "bound_ms", "bound_ms_bytes", "kernel_ms")
        out["swin_l"] = _pass_means([r for r in rows if r["size"] == "L-22k-384"], keys)
        out["swin_l"]["bound_by"] = ("bytes" if out["swin_l"]["bound_ms_bytes"]
                                     >= out["swin_l"]["bound_ms"] else "operations")
    return out


def _sdpa_mask(bias, mask, nw: int, heads: int, dtype):
    """The relative-position bias and the SW-MSA mask as one ``attn_mask``
    [1, nW·h, w², w²] for windows laid out [B, nW·h, w², dh]."""
    n = bias.shape[-1]
    am = bias.float()[None].expand(nw, -1, -1, -1)
    if mask is not None:
        am = am + mask.reshape(nw, 1, n, n)
    return am.reshape(1, nw * heads, n, n).to(dtype)


def _sdpa_ms(q, k, v, bias, mask, heads: int, window: int) -> float:
    """``F.scaled_dot_product_attention`` over the partitioned windows of
    the maps q, k, v, the relative-position bias and the SW-MSA mask as its
    ``attn_mask``: the attention core without the relayouts and without the
    scores' round trip."""
    import torch.nn.functional as F
    from diffusionvid_torch.ops.swin_attention import _partition
    b, hp, wp, c = q.shape
    nw, n = (hp // window) * (wp // window), window * window

    def part(t):
        return (_partition(t, window).view(b, nw, n, heads, c // heads).permute(0, 1, 3, 2, 4)
                .reshape(b, nw * heads, n, c // heads).contiguous())

    qp, kp, vp = part(q), part(k), part(v)
    am = _sdpa_mask(bias, mask, nw, heads, q.dtype)
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(qp, kp, vp, attn_mask=am),
                        iters=10)


def k6_library(x, wqkv, bqkv, bias, mask, heads: int, window: int):
    """K6's whole function by library calls, for ``library_full_ms``: one
    ``F.linear(x, wqkv, bqkv)`` over the map, q, k, v partitioned into
    windows and heads, ``F.scaled_dot_product_attention`` with bias and mask
    as its ``attn_mask`` (built once, as in ``_sdpa_ms``), and the output
    put back in map layout.  Returns the call, without its scores' round
    trip."""
    import torch.nn.functional as F
    from diffusionvid_torch.ops.swin_attention import _partition, _reverse
    b, hp, wp, c = x.shape
    nw, dh, n = (hp // window) * (wp // window), c // heads, window * window
    bq = bqkv.to(x.dtype)
    am = _sdpa_mask(bias, mask, nw, heads, x.dtype)

    def run():
        qkv = _partition(F.linear(x, wqkv, bq), window).view(b, nw, n, 3, heads, dh)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).reshape(3, b, nw * heads, n, dh)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        o = o.view(b, nw, heads, n, dh).transpose(2, 3).reshape(b * nw, n, c)
        return _reverse(o, window, b, hp, wp)
    return run


def _k6_grads(x, wqkv, bqkv, bias, mask, heads: int, window: int) -> float:
    """``WindowAttentionQKVFn``'s gradients for x, wqkv, bqkv and bias on
    the card against ``torch.autograd.grad`` of the twin; the worst relative
    error in norm."""
    from diffusionvid_torch.ops import window_attention as wa
    ins = [t.detach().clone().requires_grad_() for t in (x, wqkv, bqkv, bias)]
    out = wa.WindowAttentionQKVFn.apply(*ins, mask, window, heads)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, ins, g)
    ref = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(wa.window_attention_qkv_einsum(*ref, mask, window, heads), ref, g)
    return max(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
               for a, b in zip(got, want))


def _k6_backward_ms(x, wqkv, bqkv, bias, mask, heads: int, window: int) -> tuple[float, float]:
    """The backward of one ``WindowAttentionQKVFn`` launch, the twin's
    recompute and its gradients: its ms, and the GiB it allocates at its
    peak above what the inputs, the output and its cotangent hold."""
    from diffusionvid_torch.ops import window_attention as wa
    ins = [t.detach().clone().requires_grad_() for t in (x, wqkv, bqkv, bias)]
    out = wa.WindowAttentionQKVFn.apply(*ins, mask, window, heads)
    g = torch.randn_like(out)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: torch.autograd.grad(out, ins, g, retain_graph=True),
                      iters=3, warmup=1)
    return ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def k6_staged_check(x, wqkv, bqkv, bias, mask, heads: int, window: int, tol, what: str) -> dict:
    """K6's staged design's launches on their own: its qkv map against the
    plain qkv product, and its output against the plain window attention
    over the kernel's own qkv map, so that a fault shows in the launch where
    it happens."""
    from diffusionvid_torch.ops.swin_attention import _mm, swin_attn_core_ref
    from diffusionvid_torch.ops.window_attention import launch_qkv_staged
    out = torch.empty_like(x)
    qkv = launch_qkv_staged(x, wqkv, bqkv, bias, mask, out, window, heads)
    torch.cuda.synchronize()
    return _maps_agree((("qkv", qkv, _mm(x, wqkv, bqkv)),
                        ("o", out, swin_attn_core_ref(qkv, bias, mask, window, heads))),
                       tol, what)


def _window_check(name, gen, dev, dtype, timing: bool):
    """K6 (``window_attn_qkv``, on 5-frame maps, the train step's) or K7
    (``window_attn``, 4-frame maps, the v1 stream's) at the four Swin-B stage
    maps, at Swin-T's, at the four Swin-L-22k-384 stage maps (window 12)
    and at L-22k's stage 3 (C = 1536, window 7), with shift 0 and half the
    window, against the plain version, launched twice (bit-equal), with the
    bf16 launch plan (at Swin-L's maps the staged design; K6's qkv and
    output maps also checked on their own, ``k6_staged_check``).  With
    ``timing``, per Swin-B and Swin-L stage also the card time
    ``kernel_ms``, the plain version's time, the bound, ``library_ms``
    (``_sdpa_ms``) and, for K6, ``library_full_ms`` and ``bwd_ms``
    (``_k6_backward_ms``), for K7 ``host_ms``, and their means over one
    Swin-B backbone pass and, under ``swin_l``, one Swin-L-22k-384 pass.
    K6 in fp32 also checks its autograd gradients at Swin-B's stage 1,
    shift 3, and at Swin-L-22k-384's stage 3, shift 6 (window 12, C =
    1536); K7 in bf16 runs ``k7_every_plan``."""
    from diffusionvid_torch.models.swin import shift_attn_mask
    from diffusionvid_torch.ops import window_attention as wa
    qkv = name == "window_attn_qkv"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tol = (1e-4, 1e-4) if dtype == torch.float32 else TOLERANCE_BF16[name]
    elt = torch.tensor([], dtype=dtype).element_size()
    rows, worst, extra = [], 0.0, {}
    frames_b = TRAIN["frames"] if qkv else SWIN_FRAMES
    stages = ([(st, frames_b, "B") for st in SWIN_B_STAGES]
              + [(st, 2, "T") for st in SWIN_T_STAGES]
              + [(st, frames_b, "L-22k-384") for st in SWIN_L_STAGES]
              + [(SWIN_L7_STAGE3, frames_b, "L-22k")])
    grad_at = {("B", 1), ("L-22k-384", 3)}   # (size, stage): K6's fp32 gradient checks
    for s, (st, frames, size) in enumerate(stages):
        timed = timing and size != "T"
        x, attn, _, (hp, wp) = _swin_inputs(gen, dev, dtype, st, frames)
        c, heads, win = st["c"], st["heads"], st.get("window", 7)
        n = win * win
        stage = s % 4 if size != "L-22k" else 3
        path = wa.window_path(c, win)
        wqkv, bqkv, bias = attn[2], attn[3], attn[4]
        m = x.numel() // c
        if qkv:
            q, k, v = (torch.nn.functional.linear(x, wqkv[i * c:(i + 1) * c]) for i in range(3))
        else:
            q, k, v = x, *(torch.randn(x.shape, generator=gen).to(dev, dtype) for _ in range(2))
        for shift in (0, win // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shift_attn_mask(hp, wp, win, shift)).to(dev).reshape(
                    hp // win, wp // win, n, n)
            if qkv:
                args = (x, wqkv, bqkv, bias, mask, win, heads)
                fn, ref = wa.window_attention_qkv, wa.window_attention_qkv_ref
                flops = 6 * m * c * c + 4 * m * n * c
                nbytes = (2 * x.numel() + 3 * c * c) * elt + (3 * c + heads * n * n) * 4
            else:
                args = (q, k, v, bias, mask, win)
                fn, ref = wa.window_attention, wa.window_attention_ref
                flops = 4 * m * n * c
                nbytes = 4 * x.numel() * elt + heads * n * n * 4
            nbytes += 0 if mask is None else mask.numel() * 4
            got = fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            what = f"{name} {dtype} stage {stage} ({size}) shift {shift}"
            res = compare(got, want, *tol, what)
            res["mean_abs_err"] = float((got.float() - want.float()).abs().mean())
            require(res["mean_abs_err"] < MEAN_ERR[dtype],
                    f"{what}: mean abs err {res['mean_abs_err']} over {MEAN_ERR[dtype]}")
            res.update(stage=stage, size=size, window=win, path=path, shape=list(x.shape),
                       shift=shift)
            require(torch.equal(fn(*args), got), f"{what}: two launches differ")
            res["deterministic"] = True
            if dtype == torch.bfloat16:
                if path == "staged":   # K6: the qkv product's plan; K7: one attention launch
                    plan = wa.staged_plan(c, frames, hp, wp, win, sms)
                    res["plan"] = dict(path=path, attn_blocks=plan["attn_blocks"],
                                       **({"qkv": plan["qkv"]} if qkv else {}))
                    if qkv:
                        res["hidden"] = k6_staged_check(x, wqkv, bqkv, bias, mask, heads, win,
                                                        tol, what)
                else:
                    res["plan"] = (wa.qkv_plan if qkv else wa.window_plan)(c, frames, hp, wp,
                                                                          sms)
            worst = max(worst, res["max_abs_err"])
            del got, want
            if timed:
                res["blocks"] = st["depth"] / 2
                res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype)
                res["bound_ms_bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
                res["gflop"] = flops / 1e9
                res["ms"] = cuda_time_ms(lambda: fn(*args), iters=10)
                res["plain_ms"] = cuda_time_ms(lambda: ref(*args), iters=3, warmup=1)
                res["library_ms"] = _sdpa_ms(q, k, v, bias, mask, heads, win)
                kernels = (K6_KERNELS if qkv else K7_KERNELS) if path == "fused" else (
                    K6_STAGED_KERNELS if qkv else K7_STAGED_KERNELS)
                res["kernel_ms"] = device_ms(lambda: fn(*args), kernels, 10, len(kernels))
                if qkv:
                    res["library_full_ms"] = cuda_time_ms(
                        k6_library(x, wqkv, bqkv, bias, mask, heads, win), iters=10)
                    res["bwd_ms"], res["bwd_peak_gib"] = _k6_backward_ms(
                        x, wqkv, bqkv, bias, mask, heads, win)
                else:
                    res["host_ms"] = host_ms(lambda: fn(*args))
            if qkv and dtype == torch.float32 and (size, stage) in grad_at and shift:
                err = _k6_grads(x, wqkv, bqkv, bias, mask, heads, win)
                key = "grad_max_rel_err" + ("_w12" if win == 12 else "")
                extra[key] = err
                extra["grad_stages"] = extra.get("grad_stages", []) + [f"{size} {stage}"]
                require(err < 1e-4, f"K6 backward ({size} stage {stage}): rel err {err} "
                        "over 1e-4")
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
        def means(size):
            res = _pass_means([r for r in rows if r["size"] == size], keys)
            res["bound_by"] = "bytes" if res["bound_ms_bytes"] >= res["bound_ms"] else "operations"
            return res

        out.update(means("B"))
        out["swin_l"] = means("L-22k-384")
        if qkv:   # the backward's largest allocation at a Swin-L stage (stage 0's scores)
            out["swin_l"]["bwd_peak_gib"] = max(r["bwd_peak_gib"] for r in rows
                                                if r["size"] == "L-22k-384" and "blocks" in r)
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


def _tiny_model(kind: str, gen, props: int, **arch):
    """A small fp32 model: depth-18 ResNet or Swin-T, 5 classes; ``arch``
    over the other settings (the local attention's stages, GLOBAL.ENABLE,
    another ``swin_size``)."""
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    kw = dict(num_classes=5, num_proposals=props, num_heads=1, num_heads_local=1,
              compute_dtype=torch.float32)
    if kind == "swin":
        kw.update(backbone_type="swin", swin_size="T", fpn_in=("swin1", "swin2", "swin3"))
    kw.update(arch)
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


def phase_tiny(seed: int, kind: str, swin_kernel: str = "v3", sample_step: int = 1,
               **arch):
    """A depth-18 (``kind`` "resnet") or Swin-T ("swin"; ``swin_size`` in
    ``arch`` for another size) model, its trunk in
    mode ``swin_kernel``, 16 proposals, 64x96 frames, float32, TF32 off: the
    card (kernels) against the CPU (plain versions), same weights and
    noise.  With ``sample_step`` > 1 the xN ensemble at a renewal
    threshold picked on the CPU run (``pick_renewal_thresh``): the
    renewal masks too.  ``arch`` goes to the model (``local_stages``,
    ``global_enable``)."""
    import copy

    from diffusionvid_torch.engine.streaming import StreamingDetector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    h, w, props = 64, 96, 16
    cpu = _tiny_model(kind, gen, props, **arch)
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
    res = {"backbone": kind, "sample_step": sample_step, "rtol": 1e-3, "launches": used,
           **arch}
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
    ``keep``: copies of the maps, one for the launches that share them (a
    slice of the first frames starts where its maps do: the key holds the
    shape), and of the ROIs."""
    from diffusionvid_torch.ops import roi_align as ra
    inner, maps = ra._launch_fwd, {}

    def launch(features, rois, spatial_scales):
        key = tuple((f.data_ptr(), tuple(f.shape)) for f in features)
        if key not in maps:
            maps[key] = [f.clone() for f in features]
        keep.append(dict(features=maps[key], rois=rois.clone(), scales=tuple(spatial_scales)))
        return inner(features, rois, spatial_scales)

    ra._launch_fwd = launch
    try:
        yield
    finally:
        ra._launch_fwd = inner


@contextlib.contextmanager
def capture_k2(keep: list):
    """Append copies of the inputs of every K2 launch
    (``dynamic_conv._launch``) to ``keep``."""
    from diffusionvid_torch.ops import dynamic_conv as dc
    inner = dc._launch

    def launch(*args):
        keep.append(dict(args=[t.detach().clone() for t in args[:7]], eps=args[7]))
        return inner(*args)

    dc._launch = launch
    try:
        yield
    finally:
        dc._launch = inner


@contextlib.contextmanager
def capture_k3(keep: list):
    """Append copies of the inputs of every K3 launch
    (``roi_align._launch_bwd``) to ``keep``."""
    from diffusionvid_torch.ops import roi_align as ra
    inner = ra._launch_bwd

    def launch(g, rois, level, shapes, scales, scratch=None):
        keep.append(dict(g=g.clone(), rois=rois.clone(), shapes=[tuple(s) for s in shapes],
                         scales=tuple(scales)))
        return inner(g, rois, level, shapes, scales, scratch)

    ra._launch_bwd = launch
    try:
        yield
    finally:
        ra._launch_bwd = inner


CAPTURES = {"k1": capture_k1, "k2": capture_k2, "k3": capture_k3}


def phase_flagship(seed: int, config: str, n_chunks: int, phase: str,
                   swin_kernel: str = "v3", keep_k1: list | None = None,
                   sample_step: int | None = None, opts=()) -> dict:
    """A flagship config at full width, bf16: 24 global frames, then
    ``n_chunks`` chunks of INFER_BATCH frames at 608x1024; a Swin trunk in
    mode ``swin_kernel``; ``sample_step`` set on the config over its
    SAMPLE_STEP (4: the x4 DDIM ensemble).  A first pass warms up; the
    launch counts and times are of the second.  With ``keep_k1``, the K1
    inputs of the first pass's last chunk (the second's are the same) are
    appended to it.  ``opts``: config overrides, ``KEY VALUE`` pairs.
    Returns the phase's line."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.streaming import StreamingDetector
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch

    cfg = load_config(str(ROOT / "configs" / config), list(opts))
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
    res = {"config": f"configs/{config}", "opts": list(opts), "dtype": "bfloat16",
           "sample_step": steps, "local_stages": model.local_stages,
           "swin_kernel": swin_kernel if model.backbone_type == "swin" else None,
           "frames": [n_global, n_chunks * f], "hw": [h, w],
           "launches": launches, "expected_launches": want,
           "model_build_s": build_s, "start_video_s": t_chunks - t0,
           "chunks_s": t1 - t_chunks, "fps": n_chunks * f / (t1 - t_chunks),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kept_per_frame": float(outs[-1].valid.sum(-1).float().mean()),
           "card": torch.cuda.get_device_name(0)}
    # v1 / v2: K7's / K6's card time in the profiled chunk (its 24 launches
    # of one pass)
    window_kernels = {"v1": ("k7", K7_KERNELS + K7_STAGED_KERNELS),
                      "v2": ("k6", K6_KERNELS + K6_STAGED_KERNELS)}.get(swin_kernel)
    res.update(profile_chunk(det, state, chunks[0], whwh, phase,
                             window_kernels[1] if window_kernels else ()))
    if window_kernels:
        res[f"{window_kernels[0]}_chunk_kernel_ms"] = res.pop("kernels_ms")
    emit(phase, **res)
    del det, model, state, outs
    torch.cuda.empty_cache()
    return res


def register_tiny_w12():
    """Register ``TINY_W12`` as the port's Swin size ``w12-tiny``."""
    from diffusionvid_torch.models import swin
    swin.SWIN_SIZES.setdefault("w12-tiny", TINY_W12)


SWIN_L_OPTS = ("MODEL.SWIN.SIZE", "L-22k-384")
SWIN_L_CLI_FRAMES = 16


def phase_flagship_swin_l(seed: int) -> dict:
    """DiffusionVID with the Swin-L-22k-384 trunk (window 12, C up to 1536:
    K4's staged design, K5 at C = 1536), ``configs/vid_Swin_B_DiffusionVID.yaml``
    with ``MODEL.SWIN.SIZE L-22k-384``: the stream as ``phase_flagship``
    runs it (24 global frames, 3 chunks of 4 at 608x1024, bf16; 216
    launches each of K4 and K5); then the port's test CLI
    (``tools/test_net.main``) with the same override on the card over one
    rendered video of ``SWIN_L_CLI_FRAMES`` frames at 600x1000: predictions
    for every frame, finite, and 24 launches of K4 and K5 a backbone pass."""
    import shutil

    from diffusionvid_torch.data.vid_dataset import VIDDataset
    from diffusionvid_torch.tools import test_net

    res = phase_flagship(seed, "vid_Swin_B_DiffusionVID.yaml", 3, "flagship_swin_l",
                         opts=SWIN_L_OPTS)
    work = ROOT / "build" / "chip_smoke" / "swin_l_cli"
    shutil.rmtree(work, ignore_errors=True)
    f = SWIN_L_CLI_FRAMES
    write_eval_dataset(work / "data", 1, f, EVAL_HW, seed)
    load_image, VIDDataset.load_image = VIDDataset.load_image, rendered_vid().load_image
    reset_launches()
    t0 = time.perf_counter()
    try:
        results = test_net.main([
            "--config-file", str(ROOT / "configs" / "vid_Swin_B_DiffusionVID.yaml"),
            "--data-dir", str(work / "data"), "--output-dir", str(work / "out"),
            *SWIN_L_OPTS])
    finally:
        VIDDataset.load_image = load_image
    wall = time.perf_counter() - t0
    launches = read_launches()
    with open(work / "out" / "predictions.pkl", "rb") as fh:
        preds = pickle.load(fh)
    # 24 blocks a pass: the global frames' chunks of 4, then the video's
    passes = -(-min(24, f) // 4) + -(-f // 4)
    want = {"swin_block_attn": 24 * passes, "swin_block_mlp": 24 * passes}
    require(all(launches[k] == want.get(k, 0) for k in launches if k not in
                ("roi_align_fwd", "dynamic_conv")) and launches["roi_align_fwd"] > 0,
            f"flagship_swin_l cli: launches {launches}, expected K4/K5 {want}")
    require(len(preds) == f and all(np.isfinite(np.asarray(p[k], np.float64)).all()
                                    for p in preds for k in ("scores", "boxes")),
            "flagship_swin_l cli: predictions")
    cli = {"frames": f, "hw": list(EVAL_HW), "launches": launches, "expected": want,
           "run_s": wall, "ap50_random_weights": results["ap50"],
           "detections_per_frame": sum(len(p["scores"]) for p in preds) / f,
           "card": torch.cuda.get_device_name(0)}
    emit("flagship_swin_l_cli", **cli)
    shutil.rmtree(work, ignore_errors=True)
    res["cli"] = cli
    return res


# the device kernels of each wrapper on the streaming path, by name; K4's
# and K7's bf16 kernels share a name, so the Swin entries go by trunk mode
CHUNK_KERNELS = {"roi_align_fwd": ("roi_footprint_kernel", "roi_align_fwd_kernel"),
                 "dynamic_conv": ("dynamic_conv_kernel", "dynconv_ring_kernel")}
SWIN_CHUNK_KERNELS = {"v3": {"swin_block_attn": ("attn_bf16_kernel",) + K4_STAGED_KERNELS,
                             "swin_block_mlp": K5_KERNELS},
                      "v2": {"window_attn_qkv": K6_KERNELS + K6_STAGED_KERNELS},
                      "v1": {"window_attn": K7_KERNELS + K7_STAGED_KERNELS}}


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


# ---------------------------------------------------------------- dataset evaluation

# the flagship eval's dataset: 2 videos of 43 frames at 600x1000, so the
# resize scale is 1.0 and the bucket 608x1024; 24 global frames (3 chunks)
# and 6 chunks of 8 a video, the last with 3 valid frames
EVAL_VIDEOS, EVAL_FRAMES, EVAL_HW = 2, 43, (600, 1000)


def write_eval_dataset(root: Path, videos: int, frames: int, hw, seed: int,
                       classes: int = 30) -> Path:
    """An ILSVRC-layout dataset under ``root``: the catalog's
    ``VID_val_videos`` index (4 columns) and one annotation XML a frame,
    with one or two boxes a video moving at a constant speed (from a seeded
    RandomState) and every tenth frame empty.  No image files: the frames
    are rendered from the annotations (``RenderedVID``)."""
    import shutil

    from diffusionvid_torch.data.catalog import DATASETS
    from diffusionvid_torch.data.vid_dataset import VID_WNIDS

    shutil.rmtree(root, ignore_errors=True)
    _, anno_dir, index = DATASETS["VID_val_videos"]
    rng = np.random.RandomState(seed)
    h, w = hw
    lines, n = [], 0
    for v in range(videos):
        vdir = f"val/vid_{v:04d}"
        (root / anno_dir / vdir).mkdir(parents=True)
        objs = []
        for _ in range(rng.randint(1, 3)):
            size = rng.uniform(0.2, 0.5, 2) * (w, h)
            start = rng.uniform(0, 1, 2) * ((w, h) - size)
            speed = rng.uniform(-1, 1, 2) * (w, h) / (2 * frames)
            objs.append((VID_WNIDS[rng.randint(1, classes + 1)], size, start, speed))
        for f in range(frames):
            boxes = []
            for wnid, size, start, speed in objs if f % 10 != 9 else ():
                x1, y1 = np.clip(start + speed * f, 0, (w, h) - size)
                boxes.append((wnid, (x1, y1, x1 + size[0], y1 + size[1])))
            write_anno(root / anno_dir / vdir / f"{f:06d}.xml", hw, boxes)
            n += 1
            lines.append(f"{vdir} {n} {f} {frames}")
    (root / index).parent.mkdir(parents=True, exist_ok=True)
    (root / index).write_text("\n".join(lines) + "\n")
    return root


def write_anno(path: Path, hw, boxes):
    """One ILSVRC annotation XML: the image size and (wnid, xyxy) objects."""
    import xml.etree.ElementTree as ET

    ann = ET.Element("annotation")
    sz = ET.SubElement(ann, "size")
    ET.SubElement(sz, "height").text = str(hw[0])
    ET.SubElement(sz, "width").text = str(hw[1])
    for wnid, box in boxes:
        o = ET.SubElement(ann, "object")
        ET.SubElement(o, "name").text = wnid
        bb = ET.SubElement(o, "bndbox")
        for k, val in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bb, k).text = str(int(val))
    ET.ElementTree(ann).write(path)


def render_frame(anno) -> np.ndarray:
    """A uint8 RGB frame: a grey ramp with each box filled in its class's
    color."""
    h, w = anno.height, anno.width
    img = np.empty((h, w, 3), np.uint8)
    img[:] = (np.arange(w, dtype=np.uint32) * 96 // w + 32).astype(np.uint8)[None, :, None]
    for (x1, y1, x2, y2), label in zip(anno.boxes.astype(int), anno.labels):
        img[y1:y2 + 1, x1:x2 + 1] = ((label * 53) % 256, (label * 97) % 256, (label * 151) % 256)
    return img


def rendered_vid():
    """The port's ``VIDDataset`` with ``load_image`` alone replaced: the card's
    machine has no image decoder (no ``cv2``, no ``PIL``), so each frame is
    rendered from its annotation XML instead of decoded from a JPEG."""
    from diffusionvid_torch.data.vid_dataset import VIDDataset, parse_vid_xml

    class RenderedVID(VIDDataset):
        def load_image(self, path: str, dtype=np.float32) -> np.ndarray:
            name = str(Path(path).relative_to(self.img_dir).with_suffix(""))
            img = render_frame(parse_vid_xml(self._anno_tmpl % name))
            return img if dtype == np.uint8 else img.astype(dtype)

    return RenderedVID


def open_eval_dataset(root: Path):
    """``VID_val_videos`` under ``root`` through the catalog's paths, its
    frames rendered (``rendered_vid``)."""
    from diffusionvid_torch.data.catalog import DATASETS
    img_dir, anno_dir, index = DATASETS["VID_val_videos"]
    return rendered_vid()(
        "VID_val_videos", str(root), str(root / img_dir), str(root / anno_dir),
        str(root / index), is_train=False)


@contextlib.contextmanager
def eval_probes(out: dict):
    """Host-clock probes on ``run_inference``'s path, into ``out``: time
    inside ``StreamingDetector.start_video`` and ``process_chunk`` (the
    enqueue, and the NMS's host syncs), inside ``_chunk_to_numpy`` (the
    copy to the host, which waits for the card, and the conversion), each
    ``seq_nms_video`` call (with its input, the video's predictions before
    seq-NMS) and ``evaluate_vid``; the time the last prediction was made,
    and the detection rows of every chunk."""
    from diffusionvid_torch.engine import inference
    from diffusionvid_torch.engine.streaming import StreamingDetector

    out.update(start_video_s=0.0, process_chunk_s=0.0, host_convert_s=0.0, seq_nms_ms=[],
               raw_videos=[], evaluate_ms=[], rows=set(), t_last=None)
    saved = [(StreamingDetector, "start_video"), (StreamingDetector, "process_chunk"),
             (inference, "_chunk_to_numpy"), (inference, "seq_nms_video"),
             (inference, "evaluate_vid")]
    inner = {name: getattr(obj, name) for obj, name in saved}

    def timed(name, key, after=None):
        def run(*args, **kw):
            t0 = time.perf_counter()
            res = inner[name](*args, **kw)
            t1 = time.perf_counter()
            if isinstance(out[key], list):
                out[key].append((t1 - t0) * 1e3)
            else:
                out[key] += t1 - t0
            if after:
                after(args, res, t1)
            return res
        return run

    def chunk_rows(args, res, t1):
        out["rows"].add(int(res[1].boxes.shape[-2]))

    def converted(args, res, t1):
        out["t_last"] = t1

    def seq_nms_input(args, res, t1):
        out["raw_videos"].append(args[0])

    StreamingDetector.start_video = timed("start_video", "start_video_s")
    StreamingDetector.process_chunk = timed("process_chunk", "process_chunk_s", chunk_rows)
    inference._chunk_to_numpy = timed("_chunk_to_numpy", "host_convert_s", converted)
    inference.seq_nms_video = timed("seq_nms_video", "seq_nms_ms", seq_nms_input)
    inference.evaluate_vid = timed("evaluate_vid", "evaluate_ms")
    try:
        yield
    finally:
        for obj, name in saved:
            setattr(obj, name, inner[name])


@contextlib.contextmanager
def cpu_noise():
    """``StreamingDetector.noise`` from a CPU generator seeded as the video
    state's own generator, moved to the model's device: a card run and a
    CPU run of the same video draw the same noise."""
    from diffusionvid_torch.engine.streaming import StreamingDetector
    inner, gens = StreamingDetector.noise, {}

    def noise(self, state, shape):
        key = id(state.rng)
        if key not in gens:   # keeps the state's generator, so its id stays unique
            gens[key] = (state.rng, torch.Generator().manual_seed(state.rng.initial_seed()))
        return torch.randn(shape, generator=gens[key][1]).to(self.device)

    StreamingDetector.noise = noise
    try:
        yield
    finally:
        StreamingDetector.noise = inner


def eval_launches(model, ds, sample_cfg, sample_step: int, videos: int) -> dict:
    """K1's and K2's launches over ``videos`` videos: per global chunk the
    shared stages; per chunk the shared and the conditioned stages (x1) or
    the shared stages and every DDIM step's whole stack (xN)."""
    shared, cond = len(model.head.head_series), len(model.head.head_series_cond)
    per_chunk = shared + (cond if sample_step == 1 else sample_step * (shared + cond))
    f = sample_cfg.infer_batch
    n = 0
    for s in ds.video_starts()[:videos]:
        seg = ds.frame_seg_len[s]
        n += -(-min(sample_cfg.global_size, seg) // f) * shared + -(-seg // f) * per_chunk
    return {"roi_align_fwd": n, "dynamic_conv": n}


def predictions_agree(got, want, rtol: float, what: str) -> dict:
    """Frame by frame: equal counts and labels, boxes and scores within
    ``rtol`` relative (to the frame's largest value).  Returns the largest
    relative errors."""
    require(len(got) == len(want), f"{what}: {len(got)} frames against {len(want)}")
    errs = {"boxes": 0.0, "scores": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        require(len(g["labels"]) == len(w["labels"])
                and np.array_equal(np.asarray(g["labels"]), np.asarray(w["labels"])),
                f"{what}: frame {i}: labels differ ({len(g['labels'])} against "
                f"{len(w['labels'])} detections)")
        for k in errs:
            if len(w[k]):
                a, b = np.asarray(g[k], np.float64), np.asarray(w[k], np.float64)
                errs[k] = max(errs[k], float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)))
    require(max(errs.values()) < rtol, f"{what}: max relative error {errs} over {rtol}")
    return {f"max_rel_err_{k}": v for k, v in errs.items()}


def vidkit_check(raw_videos, preds, gts) -> dict:
    """The host library ``csrc/vidkit.cpp`` against the Python paths on
    ``flagship_eval``'s own data: seq-NMS of every captured video (its
    input, the predictions before seq-NMS) through both chain searches,
    with equal outputs (the boxes, scores and labels kept: equal keep masks
    and rescored scores) equal to the run's own, and the evaluator's
    matching over the run's predictions through both, with equal match
    flags and ignored shares.  Times both paths."""
    from diffusionvid_torch.engine.seq_nms import seq_nms_video
    from diffusionvid_torch.evaluation.vid_eval import match_predictions
    from diffusionvid_torch.native import library_path

    ms = {"native": [], "python": []}
    native_out = []
    for v, video in enumerate(raw_videos):
        runs = {}
        for path in ms:
            t0 = time.perf_counter()
            runs[path] = seq_nms_video(video, native=path == "native")
            ms[path].append((time.perf_counter() - t0) * 1e3)
        for f, (a, b) in enumerate(zip(runs["native"], runs["python"])):
            require(all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                        for k in ("boxes", "scores", "labels")),
                    f"flagship_eval: seq-NMS through vidkit and Python differ, video {v} "
                    f"frame {f}")
        native_out += runs["native"]
    require(len(native_out) == len(preds) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(native_out, preds)
        for k in ("boxes", "scores", "labels")),
        "flagship_eval: seq-NMS again differs from the run's")
    match_ms, matched = {}, {}
    for path in ms:
        t0 = time.perf_counter()
        matched[path] = match_predictions(gts, preds, native=path == "native")
        match_ms[path] = (time.perf_counter() - t0) * 1e3
    for a, b, what in zip(matched["native"], matched["python"],
                          ("positives", "scores", "match", "pred_ignore")):
        require(dict(a) == dict(b), f"flagship_eval: the matching's {what} differ between "
                                    "vidkit and Python")
    _, _, match, _ = matched["native"]
    return {"library": str(library_path().relative_to(ROOT)),
            "seq_nms_ms_per_video": ms, "match_ms": match_ms,
            "predictions_matched": sum(map(sum, match.values())),
            "predictions": sum(map(len, match.values())), "equal": True}


def phase_flagship_eval(seed: int) -> dict:
    """Dataset evaluation through the port's own path: ``run_inference``,
    seq-NMS, ``evaluate_vid``, ``predictions.pkl``, the shard merge and the
    test CLI, on the card with random weights from ``seed``.

    The frames are rendered in numpy from each frame's annotation by a
    subclass of the port's ``VIDDataset`` that replaces ``load_image``
    alone: the card's machine has no image decoder (no ``cv2``, no
    ``PIL``), so no JPEG is decoded; everything else (the index, the XML
    annotations, resize and bucket, the prefetch threads, chunking, the
    card, the host conversion, seq-NMS, evaluation) is the port's code.
    The fps therefore excludes JPEG decode.

    (a) ``configs/vid_R_101_DiffusionVID.yaml`` at x1 with seq-NMS over 2
        videos of 43 frames at 600x1000 (timed; 33 launches of K1 and of
        K2 a video); ``predictions.pkl`` re-evaluated by
        ``inference_no_model``;
    (b) the same as 2 shards without seq-NMS, merged by
        ``merge_shard_predictions``: equal to (a)'s predictions before
        seq-NMS (1e-4 relative; run first, it also warms up);
    (c) the same config with ``MODEL.DiffusionDet.SAMPLE_STEP 4`` through
        ``merge_from_list`` on one video: 123 launches, 1,200 rows a frame;
    (d) the test CLI (``tools/test_net.main``) with a tiny fp32 model (phase
        4's depth-18 model, loaded by ``--checkpoint``) on 2 rendered videos
        at 64x96, on the card and on the CPU, the same noise drawn on the
        CPU: the predictions agree within phase 4's 1e-3, the AP50s are
        equal."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.inference import inference_no_model, run_inference
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.tools.test_net import (
        detector_args, merge_shard_predictions, sample_config)

    work = ROOT / "build" / "chip_smoke" / "eval"
    cfg = load_config(str(ROOT / "configs" / "vid_R_101_DiffusionVID.yaml"))
    t0 = time.perf_counter()
    model = DiffusionDetArch.from_config(cfg, seed=seed)
    build_s = time.perf_counter() - t0
    ds = open_eval_dataset(write_eval_dataset(work / "data", EVAL_VIDEOS, EVAL_FRAMES,
                                              EVAL_HW, seed))
    frames = len(ds)
    scfg, dargs = sample_config(cfg), detector_args(cfg)

    # (b) two shards without seq-NMS, merged; also the warm-up
    shard_dir = work / "shards"
    for k in range(2):
        run_inference(model, ds, scfg, **dargs, output_dir=str(shard_dir), seed=seed,
                      shard=k, num_shards=2)
    merged = merge_shard_predictions(str(shard_dir), 2)
    require(merged is not None, "flagship_eval: a shard's predictions are missing")

    # (a) x1 with seq-NMS, timed
    probes = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with eval_probes(probes):
        t_run = time.perf_counter()
        preds, gts, results = run_inference(model, ds, scfg, **dargs,
                                            output_dir=str(work / "x1"), seed=seed,
                                            use_seq_nms=True)
        t_end = time.perf_counter()
    launches = read_launches()
    want = eval_launches(model, ds, scfg, 1, EVAL_VIDEOS)
    for name, n in launches.items():
        require(n == want.get(name, 0), f"flagship_eval: {name} launched {n} times, "
                                        f"expected {want.get(name, 0)}")
    require(len(preds) == frames == len(gts), f"flagship_eval: {len(preds)} predictions "
                                              f"for {frames} frames")
    h, w = EVAL_HW
    for p in preds:
        require(all(np.isfinite(p[k]).all() for k in ("boxes", "scores")),
                "flagship_eval: non-finite predictions")
        if len(p["boxes"]):
            require(p["boxes"].min() >= 0 and p["boxes"][:, 0::2].max() <= w
                    and p["boxes"][:, 1::2].max() <= h,
                    "flagship_eval: boxes outside the original image")
    raw = [p for video in probes["raw_videos"] for p in video]
    require(len(probes["seq_nms_ms"]) == EVAL_VIDEOS and len(raw) == frames,
            "flagship_eval: seq-NMS did not run once a video")
    again = inference_no_model(str(work / "x1" / "predictions.pkl"), ds)
    require(again["ap50"] == results["ap50"] or (np.isnan(again["ap50"])
                                                 and np.isnan(results["ap50"])),
            f"flagship_eval: predictions.pkl re-evaluates to {again['ap50']}, "
            f"not {results['ap50']}")
    shards = predictions_agree(merged, raw, 1e-4, "flagship_eval: 2 shards merged against x1")
    vidkit = vidkit_check(probes["raw_videos"], preds, gts)
    with open(work / "raw_predictions.pkl", "wb") as f:   # phase 12 holds its gather to it
        pickle.dump(raw, f)
    res = {"config": "configs/vid_R_101_DiffusionVID.yaml",
           "dtype": str(model.compute_dtype).split(".")[1], "videos": EVAL_VIDEOS, "frames": frames, "hw": list(EVAL_HW),
           "global_frames_per_video": scfg.global_size, "infer_batch": scfg.infer_batch,
           "launches": launches, "expected_launches": want, "model_build_s": build_s,
           "fps": frames / (probes["t_last"] - t_run), "run_inference_s": t_end - t_run,
           "start_video_s": probes["start_video_s"],
           "process_chunk_s": probes["process_chunk_s"],
           "host_convert_s": probes["host_convert_s"],
           "seq_nms_ms_per_video": probes["seq_nms_ms"],
           "evaluate_vid_ms": probes["evaluate_ms"][0],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "detections_per_frame": sum(len(p["scores"]) for p in raw) / frames,
           "after_seq_nms_per_frame": sum(len(p["scores"]) for p in preds) / frames,
           "ap50_random_weights": results["ap50"], "reevaluated_ap50": again["ap50"],
           "shards": {"num_shards": 2, "frames": len(merged), **shards, "rtol": 1e-4},
           "vidkit": vidkit}

    # (c) x4 on one video
    cfg4 = load_config(str(ROOT / "configs" / "vid_R_101_DiffusionVID.yaml"))
    cfg4.merge_from_list(["MODEL.DiffusionDet.SAMPLE_STEP", "4"])
    probes4 = {}
    reset_launches()
    with eval_probes(probes4):
        t_run = time.perf_counter()
        preds4, _, results4 = run_inference(model, ds, scfg, **detector_args(cfg4),
                                            seed=seed, max_videos=1)
    launches4 = read_launches()
    want4 = eval_launches(model, ds, scfg, 4, 1)
    for name, n in launches4.items():
        require(n == want4.get(name, 0), f"flagship_eval x4: {name} launched {n} times, "
                                         f"expected {want4.get(name, 0)}")
    rows = 4 * cfg.TEST.DETECTIONS_PER_IMG
    require(probes4["rows"] == {rows}, f"flagship_eval x4: {probes4['rows']} rows a frame, "
                                       f"not {rows}")
    require(len(preds4) == EVAL_FRAMES, f"flagship_eval x4: {len(preds4)} predictions")
    res["x4"] = {"sample_step": 4, "videos": 1, "launches": launches4,
                 "expected_launches": want4, "rows_per_frame": rows,
                 "fps": EVAL_FRAMES / (probes4["t_last"] - t_run),
                 "detections_per_frame": sum(len(p["scores"]) for p in preds4) / EVAL_FRAMES,
                 "ap50_random_weights": results4["ap50"]}
    del model, preds, raw, merged, preds4
    torch.cuda.empty_cache()

    res["cli_card_vs_cpu"] = tiny_cli_card_vs_cpu(seed, work / "tiny")
    res["nvidia_smi"] = nvidia_smi_line()
    emit("flagship_eval", **res)
    return res


def tiny_cli_card_vs_cpu(seed: int, work: Path) -> dict:
    """(d) of ``phase_flagship_eval``: ``tools/test_net.main`` with phase
    4's depth-18 model (``--checkpoint``), on the card and on the CPU."""
    import shutil

    from diffusionvid_torch.data.vid_dataset import VIDDataset
    from diffusionvid_torch.tools import test_net
    from diffusionvid_torch.utils.checkpoint import save_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    props = 16
    write_eval_dataset(work / "data", 2, 11, (64, 96), seed, classes=5)
    model = _tiny_model("resnet", torch.Generator().manual_seed(seed), props)
    ckpt = save_checkpoint(str(work / "ckpt"), 0, model.state_dict())
    opts = ["MODEL.RESNETS.DEPTH", "18", "MODEL.DiffusionDet.NUM_CLASSES", "5",
            "MODEL.DiffusionDet.NUM_PROPOSALS", str(props), "MODEL.DiffusionDet.NUM_HEADS", "1",
            "MODEL.DiffusionDet.NUM_HEADS_LOCAL", "1", "TPU.COMPUTE_DTYPE", "float32",
            "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "INPUT.INFER_BATCH", "2",
            "MODEL.VID.MEGA.GLOBAL.SIZE", "4", "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "64"]
    out = {}
    load_image, VIDDataset.load_image = VIDDataset.load_image, rendered_vid().load_image
    try:
        for dev in ("cuda", "cpu"):
            reset_launches()
            with cpu_noise():
                results = test_net.main([
                    "--config-file", str(ROOT / "configs" / "vid_R_101_DiffusionVID.yaml"),
                    "--checkpoint", ckpt, "--data-dir", str(work / "data"),
                    "--output-dir", str(work / dev), "--seq-nms", "--device", dev, *opts])
            with open(work / dev / "predictions.pkl", "rb") as f:
                out[dev] = (pickle.load(f), results["ap50"], read_launches())
    finally:
        VIDDataset.load_image = load_image
        shutil.rmtree(work / "ckpt")   # 170 MB of fp32 weights
    (card, card_ap, card_launches), (cpu, cpu_ap, cpu_launches) = out["cuda"], out["cpu"]
    require(card_launches["roi_align_fwd"] > 0 and card_launches["dynamic_conv"] > 0
            and not any(cpu_launches.values()),
            f"flagship_eval cli: card launches {card_launches}, CPU {cpu_launches}")
    agree = predictions_agree(card, cpu, 1e-3, "flagship_eval cli: card against CPU")
    require(card_ap == cpu_ap or (np.isnan(card_ap) and np.isnan(cpu_ap)),
            f"flagship_eval cli: AP50 {card_ap} on the card, {cpu_ap} on the CPU")
    return {"frames": len(card), "hw": [64, 96], "launches": card_launches, **agree,
            "rtol": 1e-3, "ap50_random_weights": card_ap, "ap50_cpu": cpu_ap,
            "detections_per_frame": sum(len(p["scores"]) for p in card) / len(card)}


# ---------------------------------------------------------------- the MEGA family

MEGA_FAMILY = {"base": "vid_R_101_C4_1x.yaml", "rdn": "RDN/vid_R_101_C4_RDN_base_1x.yaml",
               "mega": "MEGA/vid_R_101_C4_MEGA_1x.yaml", "dafa": "MEGA/vid_R_101_C4_DAFA_1x.yaml"}
# the tiny models: depth 18, fp32, 5 classes, 100 boxes before the RPN's NMS,
# 8 current proposals and 8 a reference frame (MEGA 25: its stage rings push
# 75 rows a frame), 16 memory slots and 2 ring frames; DAFA 16 proposals
MEGA_TINY_OPTS = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32",
                  "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "5", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100",
                  "MODEL.RPN.POST_NMS_TOP_N_TEST", "8", "MODEL.VID.RPN.REF_POST_NMS_TOP_N",
                  "8", "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "16",
                  "MODEL.VID.MEGA.MEMORY.SIZE", "2", "MODEL.DiffusionDet.NUM_PROPOSALS", "16",
                  "MODEL.DiffusionDet.NUM_CLASSES", "5"]
MEGA_TINY_RINGS = ["MODEL.VID.RPN.REF_POST_NMS_TOP_N", "25"]
# the full-width run: one rendered video of 12 frames at 600x1000
MEGA_VIDEO = dict(frames=12, hw=(600, 1000))
DAFA_STAGES = 6


def condition_mega_family(model, gen):
    """Weights at a scale where the trunk's maps, the attention and the
    logits are O(1) and the scores spread, so that no selection breaks a
    near-tie (the conditioning of ``tests/test_torch_port_rcnn.py``):
    convolutions at variance 1/fan-in, the relation's value weights x3 and
    geometry weights x30, the head's biases and norms perturbed, DAFA's
    class biases near zero; FlowNetS's flow layer x8, so that the flows
    reach a few feature pixels (``tests/test_torch_port_flow.py``)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                p.mul_(torch.rsqrt(p.var() * p[0].numel()))
            elif name.endswith("Wv_weight"):
                p.sub_(p.mean(1, keepdim=True)).mul_(3.0)
            elif name.endswith("Wg_weight"):
                p.mul_(30.0)
            if name.startswith("flownet.Convolution5."):    # flows past the map's border
                p.mul_(8.0)
            elif name.endswith("class_logits.bias"):
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
            elif p.dim() == 1 and "backbone" not in name and (
                    name.endswith("bias") or name.startswith("heads.")):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model


def _mega_drive(model, method: str, gframes, frames, hw):
    """prime_state, then every frame through detect_frame: (BoxArrays, the
    last state)."""
    from diffusionvid_torch.engine.inference_mega import detect_frame, prime_state
    dev = next(model.parameters()).device
    gframes, frames = gframes.to(dev), frames.to(dev)
    whwh = torch.tensor([hw[1], hw[0], hw[1], hw[0]], dtype=torch.float32, device=dev)
    with torch.no_grad():
        state = prime_state(model, method, gframes, whwh, hw)
        outs = []
        for f in range(frames.shape[0]):
            dets, state = detect_frame(model, method, frames, f, state, whwh, hw)
            outs.append(dets)
    return outs, state


def _memory_fill(state) -> dict:
    if state is None:
        return {}
    res = {"global_memory": [state.mem.count, state.mem.feats.shape[0]]}
    if getattr(state, "stage_count", None) is not None:
        res["stage_rings"] = list(state.stage_count)
    return res


def phase_mega_family_tiny(seed: int) -> dict:
    """The four methods' tiny models (``MEGA_TINY_OPTS`` over each config)
    on the card against the port on the CPU, same weights and frames, TF32
    off: 3 global frames, then 6 frames at 64x96.  Selections equal
    (valid masks, labels, memory fills), scores and boxes within the tiny
    phases' 1e-3; DAFA launches K1 and K2 (fp32 designs) and only it."""
    import copy

    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.models.detectors import build_detection_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    h, w = 64, 96
    gframes = torch.rand(3, h, w, 3, generator=gen) * 255
    frames = torch.rand(6, h, w, 3, generator=gen) * 255
    rows = {}
    for method, config in MEGA_FAMILY.items():
        cfg = load_config(str(ROOT / "configs" / config),
                          MEGA_TINY_OPTS + (MEGA_TINY_RINGS if method == "mega" else []))
        cpu = condition_mega_family(build_detection_model(cfg, device="cpu", seed=seed), gen)
        card = copy.deepcopy(cpu).cuda()
        reset_launches()
        c_out, c_state = _mega_drive(card, method, gframes, frames, (float(h), float(w)))
        torch.cuda.synchronize()
        used = read_launches()
        p_out, p_state = _mega_drive(cpu, method, gframes, frames, (float(h), float(w)))
        path = ("roi_align_fwd", "dynamic_conv") if method == "dafa" else ()
        require(all((used[k] > 0) == (k in path) for k in used),
                f"mega_family_tiny {method}: card launched {used}, expected exactly {path}")
        require(_memory_fill(c_state) == _memory_fill(p_state),
                f"mega_family_tiny {method}: memory fills differ")
        errs = {"scores": 0.0, "boxes": 0.0}
        kept = 0
        for cd, pd in zip(c_out, p_out):
            v = pd.valid
            require(torch.equal(cd.valid.cpu(), v), f"mega_family_tiny {method}: valid masks differ")
            require(torch.equal(cd.labels.cpu()[v], pd.labels[v]),
                    f"mega_family_tiny {method}: labels differ")
            kept += int(v.sum())
            for key in ("scores", "boxes"):
                g, r = getattr(cd, key).cpu().double()[v], getattr(pd, key).double()[v]
                if r.numel():
                    errs[key] = max(errs[key], float((g - r).abs().max() / r.abs().max()))
        require(kept > 0, f"mega_family_tiny {method}: no detection")
        require(max(errs.values()) < 1e-3, f"mega_family_tiny {method}: card vs CPU {errs}")
        rows[method] = {"config": f"configs/{config}", "launches": used, "kept": kept,
                        "rtol": 1e-3, **{f"max_rel_err_{k}": v for k, v in errs.items()},
                        **_memory_fill(c_state)}
        del cpu, card
    emit("mega_family_tiny", frames=[3, 6], hw=[h, w], methods=rows)
    return rows


@contextlib.contextmanager
def mega_probes(out: dict):
    """Into ``out``: the state after the last frame, the video's frames on
    the card, ``whwh`` and ``image_hw`` (``detect_frame``'s arguments), and
    the global frames (``prime_state``'s)."""
    from diffusionvid_torch.engine import inference_mega as im
    inner_detect, inner_prime = im.detect_frame, im.prime_state

    def detect(model, method, frames, f, state, whwh, image_hw, *args, **kw):
        dets, state = inner_detect(model, method, frames, f, state, whwh, image_hw, *args, **kw)
        out.update(state=state, frames=frames, whwh=whwh, image_hw=image_hw)
        return dets, state

    def prime(model, method, global_frames, *args):
        out["global_frames"] = global_frames
        return inner_prime(model, method, global_frames, *args)

    im.detect_frame, im.prime_state = detect, prime
    try:
        yield
    finally:
        im.detect_frame, im.prime_state = inner_detect, inner_prime


@contextlib.contextmanager
def frame_breakdown(out: dict):
    """Host-clock probes of one frame, each from a synchronised start: every
    ``nms_select`` call (its candidates and ms) and the C4 pooler's
    (``roi_align``) ms and its peak above the memory in use."""
    from diffusionvid_torch.models import box_head, rpn
    inner_nms = {m: m.nms_select for m in (rpn, box_head)}
    inner_pool = box_head.roi_align
    out.update(nms=[], pooler_ms=0.0, pooler_peak_gib=0.0)

    def timed_nms(fn):
        def run(boxes, scores, k, thr, valid=None, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(boxes, scores, k, thr, valid=valid, **kw)
            torch.cuda.synchronize()
            out["nms"].append({"candidates": int(boxes.shape[0]), "k": k,
                               "ms": (time.perf_counter() - t0) * 1e3})
            return res
        return run

    def pool(*args, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = inner_pool(*args, **kw)
        torch.cuda.synchronize()
        out["pooler_ms"] += (time.perf_counter() - t0) * 1e3
        out["pooler_peak_gib"] = max(out["pooler_peak_gib"],
                                     (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        return res

    for m, fn in inner_nms.items():
        m.nms_select = timed_nms(fn)
    box_head.roi_align = pool
    try:
        yield
    finally:
        for m, fn in inner_nms.items():
            m.nms_select = fn
        box_head.roi_align = inner_pool


def dafa_kernel_checks(k1_keep: list, k2_keep: list) -> dict:
    """K1 and K2 on DAFA's own inputs (one video's extract pass over 4
    global frames and one frame, captured from the port's path): every
    launch against its plain version (``k1_case``; K2 at the bf16
    tolerance of phase 3), and one launch of each batch timed: ms, the
    card's ``kernel_ms``, ``host_ms`` (K1), ``plain_ms``, the bound, and
    K2's library chain ``unfused_ms``."""
    from diffusionvid_torch.ops.dynamic_conv import dynamic_conv_fused, dynamic_conv_ref
    require(len(k1_keep) == len(k2_keep) == 2 * DAFA_STAGES,
            f"mega_family: captured {len(k1_keep)} K1 and {len(k2_keep)} K2 launches, "
            f"expected {2 * DAFA_STAGES} each")
    k1 = []
    for i, cap in enumerate(k1_keep):
        feats, rois, scales = cap["features"], cap["rois"], cap["scales"]
        row = {"frames": int(rois.shape[0]), "rois": int(rois.shape[1]),
               **k1_case(feats, rois, scales, what=f"mega_family K1 launch {i}")}
        if i % DAFA_STAGES == DAFA_STAGES - 1:
            row.update(k1_timing(feats, rois, scales))
        k1.append(row)
    k2 = []
    for i, cap in enumerate(k2_keep):
        args = cap["args"]
        got = dynamic_conv_fused(*args)
        row = {"s": int(args[0].shape[0]),
               **compare(got, dynamic_conv_ref(*args), 3e-2, 3e-2, f"mega_family K2 launch {i}")}
        if i % DAFA_STAGES == DAFA_STAGES - 1:
            roi, p1t, p2e, lns = args[0], args[1], args[2], list(args[3:7])
            row["bound_ms"], row["bound_by"] = k2_bound(roi, p1t, p2e, lns)
            row["ms"] = cuda_time_ms(lambda: dynamic_conv_fused(*args))
            row["kernel_ms"] = device_ms(lambda: dynamic_conv_fused(*args), K2_KERNELS, 20, 1)
            row["plain_ms"] = cuda_time_ms(lambda: dynamic_conv_ref(*args))
            row["unfused_ms"] = cuda_time_ms(k2_unfused(roi, p1t, p2e, lns))
        k2.append(row)
    timed = lambda rows: [r for r in rows if "ms" in r]  # noqa: E731
    return {"k1": {"max_abs_err": max(r["max_abs_err"] for r in k1), "launches": len(k1),
                   "timed": timed(k1)},
            "k2": {"max_abs_err": max(r["max_abs_err"] for r in k2), "launches": len(k2),
                   "timed": timed(k2)},
            "dtype": str(k1_keep[0]["features"][0].dtype)}


def phase_mega_family(seed: int) -> dict:
    """The four MEGA-family configs at full width (R-101, bf16, random
    weights from ``seed``), each through ``run_inference_video_arch`` on
    one rendered video of 12 frames at 600x1000 (a warm-up pass, then the
    timed one): fps, peak memory, the global memory's and the stage rings'
    fill, the K1/K2 launches (DAFA: 6 a frame and 6 for the extract pass,
    the others none).  Then one frame profiled (device busy, idle share)
    and one probed (every NMS call's candidates and host ms, the C4
    pooler's ms and peak).  Last, K1 and K2 on DAFA's own inputs
    (``dafa_kernel_checks``).  Returns DAFA's launches."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine import inference_mega as im
    from diffusionvid_torch.models.detectors import build_detection_model
    from diffusionvid_torch.tools.test_net import sample_config

    work = ROOT / "build" / "chip_smoke" / "mega_family"
    n, (h, w) = MEGA_VIDEO["frames"], MEGA_VIDEO["hw"]
    ds = open_eval_dataset(write_eval_dataset(work / "data", 1, n, (h, w), seed))
    res = {"frames": n, "hw": [h, w], "card": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(), "methods": {}}
    dafa_launches, kernels = None, None
    for method, config in MEGA_FAMILY.items():
        cfg = load_config(str(ROOT / "configs" / config))
        t0 = time.perf_counter()
        model = build_detection_model(cfg, seed=seed)
        build_s = time.perf_counter() - t0
        scfg = sample_config(cfg)

        def run():
            return im.run_inference_video_arch(model, ds, scfg, method=method, seed=seed)

        run()                                   # warm-up: allocator, cuDNN plans
        probe = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with mega_probes(probe):
            t0 = time.perf_counter()
            preds, gts, results = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k: (DAFA_STAGES * (n + 1) if method == "dafa" and k in
                    ("roi_align_fwd", "dynamic_conv") else 0) for k in launches}
        require(launches == want, f"mega_family {method}: launches {launches}, expected {want}")
        require(len(preds) == n == len(gts), f"mega_family {method}: {len(preds)} predictions")
        for p in preds:
            require(all(np.isfinite(p[k]).all() for k in ("boxes", "scores")),
                    f"mega_family {method}: non-finite predictions")
            if len(p["boxes"]):
                require(p["boxes"].min() >= 0 and p["boxes"][:, 0::2].max() <= w
                        and p["boxes"][:, 1::2].max() <= h,
                        f"mega_family {method}: boxes outside the image")
                ncls = (cfg.MODEL.DiffusionDet.NUM_CLASSES if method == "dafa"
                        else cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1)
                require(p["labels"].min() >= 1 and p["labels"].max() <= ncls,
                        f"mega_family {method}: labels out of range")
        fill = _memory_fill(probe["state"])
        if method in ("mega", "dafa"):
            require(fill["global_memory"][0] > 0, f"mega_family {method}: empty memory")
        if method == "mega":
            require(fill["stage_rings"] == [75 * n] * cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE,
                    f"mega_family mega: stage rings {fill['stage_rings']}")

        # the middle frame, profiled and then probed, after priming the state
        frames, whwh, hw = probe["frames"], probe["whwh"], probe["image_hw"]
        with torch.no_grad():
            state = im.prime_state(model, method, probe["global_frames"], whwh, hw)

            def frame():
                return im.detect_frame(model, method, frames, n // 2, state, whwh, hw)

            prof = profile_device(frame, f"mega_family_{method}_frame")
            breakdown = {}
            with frame_breakdown(breakdown):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame()
                torch.cuda.synchronize()
                probed_ms = (time.perf_counter() - t0) * 1e3
        row = {"config": f"configs/{config}", "dtype": str(model.compute_dtype).split(".")[1],
               "frames": n, "hw": [h, w], "model_build_s": build_s, "fps": n / wall,
               "run_s": wall, "peak_mem_gib": peak,
               "launches": launches, **fill,
               "detections_per_frame": sum(len(p["scores"]) for p in preds) / n,
               "ap50_random_weights": results["ap50"],
               "frame_wall_ms": prof["profiled_wall_ms"],
               "frame_device_busy_ms": prof["device_busy_ms"],
               "frame_device_idle_share": prof["device_idle_share"],
               "frame_device_ops": prof["device_ops"], "frame_top_device_ms": prof["top_device_ms"],
               "frame_top_host_ms": prof["top_host_ms"],
               "probed_frame_ms": probed_ms, "nms_calls": len(breakdown["nms"]),
               "nms_host_ms": sum(c["ms"] for c in breakdown["nms"]),
               "nms": breakdown["nms"], "pooler_ms": breakdown["pooler_ms"],
               "pooler_peak_gib": breakdown["pooler_peak_gib"]}
        if method == "dafa":
            dafa_launches = launches
            k1_keep, k2_keep = [], []
            with torch.no_grad(), capture_k1(k1_keep), capture_k2(k2_keep):
                state = im.prime_state(model, method, probe["global_frames"], whwh, hw)
                im.detect_frame(model, method, frames, n - 1, state, whwh, hw)
            kernels = dafa_kernel_checks(k1_keep, k2_keep)
            del k1_keep, k2_keep
        res["methods"][method] = row
        emit("mega_family", method=method, **row, card=res["card"])
        del model, state, frames, probe
        torch.cuda.empty_cache()
    emit("mega_family_kernels", **kernels, card=res["card"])
    res["kernels"] = kernels
    return {"launches": dafa_launches, **res}


# ---------------------------------------------------------------- the rest of the MEGA family

# the five paths of the MEGA family's rest: (config, overrides, method); the
# tiny runs add MEGA_TINY_OPTS and REST_TINY
MEGA_REST = {
    "dff": ("DFF/vid_R_101_C4_DFF_1x.yaml", [], "dff"),
    "fgfa": ("FGFA/vid_R_101_C4_FGFA_1x.yaml", [], "fgfa"),
    "mega_x101": ("MEGA/vid_X_101_C4_MEGA_1x.yaml", [], "mega"),
    "base_bbox_aug": ("vid_R_101_C4_1x.yaml",
                      ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
                       "TEST.BBOX_AUG.SCALES", "(400, 800)", "TEST.BBOX_AUG.MAX_SIZE", "2000",
                       "TEST.BBOX_AUG.SCALE_H_FLIP", "True"], "base"),
    "mega_pixel": ("MEGA/vid_R_101_C4_MEGA_1x.yaml",
                   ["MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE", "False",
                    "MODEL.VID.MEGA.LOCAL.PIXEL_ATTEND", "True",
                    "MODEL.VID.MEGA.GLOBAL.PIXEL_ATTEND", "True"], "mega"),
}
# at depth 18: DFF's keys at frames 0 and 4; the X-101 trunk narrowed to 8
# groups of 8 and its rings fed 25 rows a frame; the scales of 64x96 frames;
# the pixel path on 160x240 frames (a res4 map of 150 pixels: its memories
# keep 100 of a frame), its pixel cache at 200 rows
REST_TINY = {
    "dff": ["MODEL.VID.DFF.KEY_FRAME_DURATION", "4"],
    "mega_x101": ["MODEL.RESNETS.NUM_GROUPS", "8", "MODEL.RESNETS.WIDTH_PER_GROUP", "8"]
    + MEGA_TINY_RINGS,
    "base_bbox_aug": ["TEST.BBOX_AUG.SCALES", "(48, 80)", "TEST.BBOX_AUG.MAX_SIZE", "160"],
    "mega_pixel": ["MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_PIXEL_TEST", "200"],
}


def _rest_drive(model, cfg, method: str, gframes, frames) -> tuple:
    """``prime_state``, then every frame through ``detect_frame`` with the
    CLI's options (and ``bbox_aug_frame`` with ``TEST.BBOX_AUG``): the
    frames' detections above 0.05 as host dicts, and the last state."""
    from diffusionvid_torch.engine import inference_mega as im
    from diffusionvid_torch.tools.test_net import video_arch_args
    kw = video_arch_args(cfg)
    aug = {k[len("bbox_aug_"):]: v for k, v in kw.items() if k.startswith("bbox_aug_")}
    frame_kw = dict(key_frame_duration=kw["key_frame_duration"],
                    pixel_offsets=im.local_pixel_frame_offsets(
                        interval=kw["all_frame_interval"], key_location=kw["key_frame_location"]))
    dev = next(model.parameters()).device
    h, w = frames.shape[1:3]
    hw = (float(h), float(w))
    whwh = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    dev_frames = frames.to(dev)
    outs = []
    with torch.no_grad():
        state = im.prime_state(model, method, gframes.to(dev), whwh, hw)
        for f in range(frames.shape[0]):
            dets, state = im.detect_frame(model, method, dev_frames, f, state, whwh, hw,
                                          **frame_kw)
            if kw["use_bbox_aug"]:
                outs.append(im.bbox_aug_frame(model, frames[f].numpy(), dets, (h, w), 1.0,
                                              **aug))
            else:
                outs.append(im._to_numpy(dets, 1.0))
    return outs, state


def _rest_fill(state) -> dict:
    """The memories' fill after a run: MEGA's box memory and rings, and on
    the pixel path its caches (``ext``, the ring of pixels in confident
    detections, and ``gpix``, the global frames' FPS pixel cache)."""
    from diffusionvid_torch.engine.inference_mega import PixelVideoState
    if isinstance(state, PixelVideoState):
        p = state.pixel
        return {**_memory_fill(state.box), "ext": [p.ext.count, p.ext.feats.shape[0]],
                "gpix": [p.gpix.count, p.gpix.feats.shape[0]],
                "last_high": int(p.last_high_valid.sum()), "irr": int(p.irr_valid.sum())}
    if hasattr(state, "mem"):
        return _memory_fill(state)
    return {}


def phase_mega_family_rest_tiny(seed: int) -> dict:
    """The five paths of ``MEGA_REST`` at depth 18 (``MEGA_TINY_OPTS`` and
    ``REST_TINY``) on the card against the port on the CPU, same weights
    and frames, TF32 off: 3 global frames, then 6 frames of random pixels
    at 64x96 (the pixel path 160x240).  Frame by frame the labels equal and
    the scores and boxes within the tiny phases' 1e-3, the memories' fills
    equal; no path launches K1–K7."""
    import copy

    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.models.detectors import build_detection_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    rows = {}
    for name, (config, opts, method) in MEGA_REST.items():
        h, w = (160, 240) if name == "mega_pixel" else (64, 96)
        gframes = (torch.rand(3, h, w, 3, generator=gen) * 255).to(torch.uint8)
        frames = (torch.rand(6, h, w, 3, generator=gen) * 255).to(torch.uint8)
        cfg = load_config(str(ROOT / "configs" / config),
                          opts + MEGA_TINY_OPTS + REST_TINY.get(name, []))
        cpu = condition_mega_family(build_detection_model(cfg, device="cpu", seed=seed), gen)
        card = copy.deepcopy(cpu).cuda()
        reset_launches()
        c_out, c_state = _rest_drive(card, cfg, method, gframes, frames)
        torch.cuda.synchronize()
        used = read_launches()
        p_out, p_state = _rest_drive(cpu, cfg, method, gframes, frames)
        require(not any(used.values()), f"mega_family_rest_tiny {name}: launched {used}")
        require(_rest_fill(c_state) == _rest_fill(p_state),
                f"mega_family_rest_tiny {name}: memory fills differ: {_rest_fill(c_state)} "
                f"vs {_rest_fill(p_state)}")
        errs = {"scores": 0.0, "boxes": 0.0}
        kept = 0
        for f, (cd, pd) in enumerate(zip(c_out, p_out)):
            require(np.array_equal(cd["labels"], pd["labels"]),
                    f"mega_family_rest_tiny {name} frame {f}: labels differ")
            kept += len(pd["labels"])
            for key in ("scores", "boxes"):
                if len(pd[key]):
                    g, r = cd[key].astype(np.float64), pd[key].astype(np.float64)
                    errs[key] = max(errs[key], float(np.abs(g - r).max() / np.abs(r).max()))
        require(kept > 0, f"mega_family_rest_tiny {name}: no detection")
        require(max(errs.values()) < 1e-3, f"mega_family_rest_tiny {name}: card vs CPU {errs}")
        rows[name] = {"config": f"configs/{config}", "method": method, "hw": [h, w],
                      "launches": used, "kept": kept, "rtol": 1e-3,
                      **{f"max_rel_err_{k}": v for k, v in errs.items()}, **_rest_fill(c_state)}
        del cpu, card
    emit("mega_family_rest_tiny", frames=[3, 6], paths=rows)
    return rows


def _flownet_ms(model, method: str, frames) -> float:
    """FlowNetS's card ms a (current, reference) pair at the video's size:
    DFF's one pair with the scale map, FGFA's five-frame window and the
    current frame (6 pairs) in one call."""
    from diffusionvid_torch.models.video_archs import _image_pair
    n = 1 if method == "dff" else 6
    pair = _image_pair(frames[6:7].expand(n, *frames.shape[1:]), frames[:n])
    with torch.no_grad():
        return cuda_time_ms(lambda: model.flownet(pair), iters=10) / n


def phase_mega_family_rest(seed: int) -> dict:
    """The five paths of ``MEGA_REST`` at full width (bf16, random weights
    from ``seed``), each through ``run_inference_video_arch`` with the CLI's
    options on one rendered video of 12 frames at 600x1000 (a warm-up pass,
    then the timed one): fps, peak memory, no launch of K1–K7, the
    memories' fill (the pixel path's ``ext`` and ``gpix``), DFF's keys;
    then the middle frame profiled (device busy ms, idle share), and
    FlowNetS's ms a pair (DFF, FGFA)."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine import inference_mega as im
    from diffusionvid_torch.models.detectors import build_detection_model
    from diffusionvid_torch.tools.test_net import sample_config, video_arch_args

    work = ROOT / "build" / "chip_smoke" / "mega_family_rest"
    n, (h, w) = MEGA_VIDEO["frames"], MEGA_VIDEO["hw"]
    ds = open_eval_dataset(write_eval_dataset(work / "data", 1, n, (h, w), seed))
    res = {"frames": n, "hw": [h, w], "card": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(), "paths": {}}
    for name, (config, opts, method) in MEGA_REST.items():
        cfg = load_config(str(ROOT / "configs" / config), opts)
        t0 = time.perf_counter()
        model = build_detection_model(cfg, seed=seed)
        build_s = time.perf_counter() - t0
        scfg, kw = sample_config(cfg), video_arch_args(cfg)
        keys = []
        inner_key = getattr(model, "key_features", None)
        if inner_key is not None:    # DFF: which frames ran the trunk

            def key_features(images, inner=inner_key):
                keys.append(len(keys))
                return inner(images)

            model.key_features = key_features

        def run():
            return im.run_inference_video_arch(model, ds, scfg, method=method, seed=seed, **kw)

        run()                                   # warm-up: allocator, cuDNN plans
        keys.clear()
        probe = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with mega_probes(probe):
            t0 = time.perf_counter()
            preds, gts, results = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(not any(launches.values()), f"mega_family_rest {name}: launched {launches}")
        require(len(preds) == n == len(gts), f"mega_family_rest {name}: {len(preds)} predictions")
        for p in preds:
            require(all(np.isfinite(p[k]).all() for k in ("boxes", "scores")),
                    f"mega_family_rest {name}: non-finite predictions")
            if len(p["boxes"]):
                require(p["boxes"].min() >= -1 and p["boxes"][:, 0::2].max() <= w
                        and p["boxes"][:, 1::2].max() <= h,
                        f"mega_family_rest {name}: boxes outside the image")
                require(p["labels"].min() >= 1
                        and p["labels"].max() <= cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1,
                        f"mega_family_rest {name}: labels out of range")
        fill = _rest_fill(probe["state"])
        if method == "mega":
            require(fill["global_memory"][0] > 0, f"mega_family_rest {name}: empty memory")
        if name == "mega_pixel":
            require(fill["gpix"][0] > 0 and fill["irr"] > 0,
                    f"mega_family_rest {name}: pixel caches {fill}")
        if name == "mega_x101":
            require(fill["stage_rings"] == [75 * n] * cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE,
                    f"mega_family_rest {name}: stage rings {fill['stage_rings']}")
        key_passes = len(keys)
        if method == "dff":
            require(key_passes == 2, f"mega_family_rest dff: {key_passes} key passes, expected 2")

        frames, whwh, hw = probe["frames"], probe["whwh"], probe["image_hw"]
        frame_kw = dict(key_frame_duration=kw["key_frame_duration"],
                        pixel_offsets=im.local_pixel_frame_offsets(
                            interval=kw["all_frame_interval"],
                            key_location=kw["key_frame_location"]))
        host_frame = frames[n // 2].cpu().numpy()
        aug = {k[len("bbox_aug_"):]: v for k, v in kw.items() if k.startswith("bbox_aug_")}
        with torch.no_grad():
            state = im.prime_state(model, method, probe["global_frames"], whwh, hw)
            if method == "dff":     # the middle frame warps frame 0's map
                state = im.KeyFrame(0, model.key_features(frames[:1]))

            def frame():
                dets, _ = im.detect_frame(model, method, frames, n // 2, state, whwh, hw,
                                          **frame_kw)
                if kw["use_bbox_aug"]:
                    im.bbox_aug_frame(model, host_frame, dets, (int(hw[0]), int(hw[1])), 1.0,
                                      **aug)

            prof = profile_device(frame, f"mega_family_rest_{name}_frame")
            flow_ms = _flownet_ms(model, method, frames) if method in ("dff", "fgfa") else None
        row = {"config": f"configs/{config}", "overrides": opts, "method": method,
               "dtype": str(model.compute_dtype).split(".")[1], "frames": n, "hw": [h, w],
               "model_build_s": build_s, "fps": n / wall, "run_s": wall, "peak_mem_gib": peak,
               "launches": launches, **fill,
               "detections_per_frame": sum(len(p["scores"]) for p in preds) / n,
               "ap50_random_weights": results["ap50"],
               "frame_wall_ms": prof["profiled_wall_ms"],
               "frame_device_busy_ms": prof["device_busy_ms"],
               "frame_device_idle_share": prof["device_idle_share"],
               "frame_device_ops": prof["device_ops"],
               "frame_top_device_ms": prof["top_device_ms"],
               "frame_top_host_ms": prof["top_host_ms"]}
        if method == "dff":
            row["key_passes"] = key_passes
        if flow_ms is not None:
            row["flownet_ms_per_pair"] = flow_ms
        if kw["use_bbox_aug"]:
            row["passes_per_frame"] = 1 + 1 + 2 * len(kw["bbox_aug_scales"])
        res["paths"][name] = row
        emit("mega_family_rest", path=name, **row, card=res["card"])
        del model, state, frames, probe
        torch.cuda.empty_cache()
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
    model = DiffusionDetArch(**arch, compute_dtype=torch.float32)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 4:
                p.mul_((p.shape[0] / p.shape[1]) ** 0.5)
            elif not _condition_trunk_norm(name, p, noise):
                _condition_head(name, p, noise, "head.")
    with _calibrated_norms(model), torch.no_grad():
        model.extract_features(images)
    return model


# the RCNNHead layers whose output a ReLU takes after a LayerNorm
_RELU_LN = ("inst_interact.norm1.", "inst_interact.norm2.", "inst_interact.norm3.",
            "cls_module.1.", "reg_module.1.", "reg_module.4.", "reg_module.7.")


def _condition_trunk_norm(name: str, p, noise) -> bool:
    """A trunk FrozenBN's scale 0.5 (1 at the stem) and bias +3; whether
    ``name`` is one."""
    if "bottom_up." not in name and "roi_head." not in name:
        return False
    if name.endswith("norm.weight"):
        p.copy_((1.0 if ".stem." in name else 0.5) + 0.05 * noise)
    elif name.endswith("norm.bias"):
        p.copy_(3.0 + 0.1 * noise)
    else:
        return False
    return True


def _condition_head(name: str, p, noise, prefix: str):
    """The RCNNHead's ReLU LayerNorms and FFN at about +3, its box deltas
    scaled down, its other 1-D parameters under ``prefix`` perturbed."""
    if any(k in name for k in _RELU_LN):
        p.copy_((3.0 if name.endswith("bias") else 0.5) + 0.05 * noise)
    elif name.endswith("linear1.bias"):
        p.fill_(3.0)
    elif name.endswith(("linear1.weight", "bboxes_delta.weight")):
        p.mul_(0.3 if "linear1" in name else 0.05)
    elif p.dim() == 1 and name.startswith(prefix):
        p.add_(0.2 * noise)


@contextlib.contextmanager
def _calibrated_norms(model, offset: float = 0.0, floor: float = 0.0):
    """While open, each FrozenBN takes the mean and variance of its input
    at its first call as its running statistics, the mean lowered by
    ``offset`` standard deviations, the variance at least ``floor`` times
    the channels' median."""
    from diffusionvid_torch.models.resnet import FrozenBatchNorm2d

    def calibrate(mod, args):
        var = args[0].var((0, 2, 3))
        mod.running_mean.copy_(args[0].mean((0, 2, 3)) - offset * var.sqrt())
        mod.running_var.copy_(var.clamp(min=floor * float(var.median())))
        handles.pop(id(mod)).remove()

    handles = {id(m): m.register_forward_pre_hook(calibrate) for m in model.modules()
               if isinstance(m, FrozenBatchNorm2d)}
    try:
        yield
    finally:
        for h in handles.values():
            h.remove()


def _relu_inputs(model) -> list:
    """The MEGA family's layers whose output a ReLU (FlowNetS: a leaky
    one) takes, outside the trunks: the RPN's conv, ``reduce``, the
    relation's FCs, FlowNetS's encoder and deconvolutions, EmbedNet's first
    two convs."""
    from diffusionvid_torch.models.flownet import Deconv
    out = []
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if (name.endswith("rpn.conv") or name == "reduce" or name.startswith("relation.fc")
                or name in ("embednet.embed_conv1", "embednet.embed_conv2")
                or (name.startswith("flownet.") and isinstance(m, Deconv)
                    and leaf.startswith("deconv"))
                or (name.startswith("flownet.") and leaf.startswith("conv"))):
            out.append(m)
    return out


def conditioned_method_model(model, gen, run):
    """A float32 MEGA-family model (``base``, ``dff``, ``fgfa``, ``rdn``,
    ``mega``, ``dafa``) set up, in place, so that two implementations' train
    gradients compare well: no ReLU input near its kink and no selection
    near a tie (``conditioned_train_model``'s reason).  ``run()`` is a
    train forward of the model, the calibration pass; returns the model.

    - The convolutions at fan-in variance.
    - The trunks' and the res5 head's FrozenBN: scale 0.5 (1 at the stem),
      bias +3, the statistics of their inputs on the pass, the mean half a
      deviation low (with the exact mean a normalised map sums to zero, and
      the gradient of a scale whose output is mean-pooled, the res5 head's
      last block, cancels to noise) and the variance at least a tenth of
      the median channel's (on the small test maps some channels of the
      res5 head hardly vary, and the gradient of their variance, by the
      -3/2 power, is a difference of nearly equal numbers).
    - The relation: value weights x3; query and key weights blind to their
      inputs' common part and x0.25 (an affinity's gradient sums to zero
      over the references, and a sharp softmax or keys sharing most of
      their value leave a difference of nearly equal numbers); geometric
      weights x10 and bias +3 (``relu(emb . Wg + b)`` stays positive and
      varies over the references, which is all its bias's gradient is).
    - The RPN's convolutions blind to their inputs' constant part, so that
      each frame's content ranks its anchors, and its deltas zero, so that
      every proposal is an anchor clipped to the image, the same box to the
      last bit on both sides: the position embedding multiplies two sides'
      box differences by 100 over the distance of two boxes, and two
      frames' proposals are often a fraction of a pixel apart (their
      gradient still reaches the deltas).
    - DAFA's decoder as DiffusionVID's, its learned boxes spread over the
      image (its init, all the image, makes the first stage's boxes nearly
      equal and simOTA's match among them a toss-up).
    - The other ReLU inputs (``_relu_inputs``) shifted by a bias so that
      each unit's least value on the pass is 1."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 4:
                p.mul_(torch.rsqrt(p.var() * p[0].numel()))
                if ".rpn." in name or name.startswith("rpn."):
                    # blind to its input's constant part: each frame's own
                    # content ranks its anchors
                    p.sub_(p.mean((1, 2, 3), keepdim=True))
                if name.endswith("rpn.bbox_pred.weight"):
                    p.zero_()
            elif name.endswith("rpn.bbox_pred.bias"):
                p.zero_()
            elif _condition_trunk_norm(name, p, noise):
                pass
            elif name.endswith("Wv_weight"):
                p.sub_(p.mean(1, keepdim=True)).mul_(3.0)
            elif name.endswith(("Wq.weight", "Wk.weight")):
                # blind to the features' common part, affinities of a few units
                p.sub_(p.mean(1, keepdim=True)).mul_(0.25)
            elif name.endswith("Wg_weight"):
                p.mul_(10.0)
            elif name.endswith("Wg_bias"):
                p.copy_(3.0 + 0.1 * noise)
            elif name.endswith("class_logits.bias"):
                p.copy_(0.2 * noise)
            elif name == "init_proposal_boxes":    # distinct boxes, not all the image
                u = torch.rand(p.shape, generator=gen)
                p.copy_(torch.cat([0.25 + 0.5 * u[:, :2], 0.15 + 0.4 * u[:, 2:]], 1))
            elif name.startswith("heads."):
                _condition_head(name, p, noise, "heads.")
            elif p.dim() == 1 and "backbone" not in name and name.endswith("bias"):
                p.add_(0.2 * noise)

    def lift(mod, args, out):
        dims = [d for d in range(out.dim()) if d != (1 if out.dim() == 4 else out.dim() - 1)]
        shift = (1.0 - out.float().amin(dim=dims)).clamp(min=0.0)
        mod.bias.add_(shift)
        handles.pop(id(mod)).remove()
        view = (1, -1, 1, 1) if out.dim() == 4 else (-1,)
        return out + shift.view(view).to(out.dtype)

    handles = {id(m): m.register_forward_hook(lift) for m in _relu_inputs(model)}
    try:
        with _calibrated_norms(model, offset=0.5, floor=0.1), torch.no_grad():
            run()
    finally:
        for h in handles.values():
            h.remove()
    return model


SWIN_T_ARCH = dict(backbone_type="swin", swin_size="T", fpn_in=("swin1", "swin2", "swin3"))


def phase_tiny_train(seed: int, kind: str = "resnet", swin_size: str = "T"):
    """One train micro-step of a depth-18 (``kind`` "resnet") or Swin model
    ("swin", of size ``swin_size``: Swin-T, or ``w12-tiny``, window 12),
    50 proposals, 1 + 2 frames at 64x96, float32, TF32 off: on the card
    (K1, K2, K3, and K6 for the Swin trunk) against the CPU (plain
    versions), same weights, batch and draws.  Losses to 1e-4 and every
    gradient to 1e-3 relative in norm, the tolerances the CPU tests hold
    against JAX."""
    import copy

    from diffusionvid_torch.engine.train import TrainBatch, draw_train_randoms, make_loss_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    h, w, props, frames = 64, 96, 50, 3
    batch = train_batch(gen, 1, frames, 6, h, w, 5, "cpu")
    cpu = conditioned_train_model(gen, batch.images[0], depth=18, num_classes=5,
                                  num_proposals=props, num_heads=1, num_heads_local=1,
                                  **(dict(SWIN_T_ARCH, swin_size=swin_size) if kind == "swin"
                                     else {}))
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
    phase = "tiny_train" if kind == "resnet" else f"tiny_train_{kind}" + (
        "_w12" if swin_size == "w12-tiny" else "")
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


def k6_backward_ms(micro) -> tuple[float, int]:
    """Wall ms that K6's backward (``WindowAttentionQKVFn.backward``: the
    twin's recompute and its gradients) takes in one micro-step, each call
    between two synchronizes, and its calls."""
    from diffusionvid_torch.ops.window_attention import WindowAttentionQKVFn
    inner, spent = WindowAttentionQKVFn.backward, []

    def timed(ctx, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = inner(ctx, g)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return grads

    WindowAttentionQKVFn.backward = staticmethod(timed)
    try:
        micro()
    finally:
        WindowAttentionQKVFn.backward = staticmethod(inner)
    return sum(spent) * 1e3, len(spent)


def phase_flagship_train(seed: int, config: str, phase: str, timed_steps: int,
                         keep: dict | None = None, opts=(), warmup_steps: int = 2) -> dict:
    """A flagship's train step at full width, bf16: ``config`` (with the
    ``KEY VALUE`` overrides ``opts``) with random weights, 1 + REF_NUM_LOCAL
    (with the local attention) + REF_NUM_GLOBAL frames at 608x1024 with 1
    to 8 random GT boxes each, ACCUMULATION_STEPS micro-steps per optimizer
    step.  ``warmup_steps`` warm-up optimizer steps, then ``timed_steps``
    timed ones, whose launch counts are read.  ``keep`` maps some of "k1",
    "k2" and "k3" to lists: the inputs of those kernels' launches in the
    last micro-step (the criterion's timing run) are appended to them."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.train import (
        draw_train_randoms, iteration_generator, make_train_step, optimizer_from_config,
        param_group)
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch

    cfg = load_config(str(ROOT / "configs" / config), list(opts))
    t0 = time.perf_counter()
    model = DiffusionDetArch.from_config(cfg, seed=seed)
    opt = optimizer_from_config(model, cfg)
    build_s = time.perf_counter() - t0
    num_global = cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    num_local = cfg.MODEL.VID.MEGA.REF_NUM_LOCAL if model.local_stages else 0
    frames, accum = 1 + num_local + num_global, cfg.SOLVER.ACCUMULATION_STEPS
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

    for _ in range(warmup_steps * accum):     # warm-up: allocator, cuDNN plans
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
    require(opt.count == warmup_steps + timed_steps, f"{phase}: {opt.count} optimizer steps")
    res = {"config": f"configs/{config}", "opts": list(opts), "dtype": "bfloat16",
           "local_stages": model.local_stages, "warmup_optimizer_steps": warmup_steps,
           "frames": frames, "hw": [h, w], "accumulation_steps": accum,
           "timed_optimizer_steps": timed_steps, "launches": launches,
           "expected_launches": want, "decoder_stages": want["roi_align_fwd"] // micro_steps,
           "model_build_s": build_s,
           "ms_per_optimizer_step": dt / timed_steps * 1e3,
           "ms_per_micro_step": dt / micro_steps * 1e3,
           "trained_frames_per_s": micro_steps * frames / dt,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": last, "params_moved": moved, "lr_main": opt.lr("main"),
           "card": torch.cuda.get_device_name(0)}
    res.update({f"micro_step_{k}": v
                for k, v in profile_device(micro, f"{phase}_micro_step").items()})
    with contextlib.ExitStack() as stack:
        for k, into in (keep or {}).items():
            stack.enter_context(CAPTURES[k](into))
        res["criterion_ms_per_micro_step"] = criterion_ms(micro)
    if model.backbone_type == "swin":
        res["k6_backward_ms_per_micro_step"], calls = k6_backward_ms(micro)
        require(calls == want["window_attn_qkv"] // micro_steps,
                f"{phase}: {calls} K6 backward calls in a micro-step")
    emit(phase, **res)
    del model, opt, step, state, start, batches
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- the train CLI

# the train CLI's data: VID_train_15frames lists every second frame of 2
# videos of 24 frames at 720x1280 (ImageNet-VID lists 15 a video); DET
# stills at 375x500, the third and the sixth portrait (500x375), so that
# the sampler's first four batches (seed 0, 32 indices, DET first) hold
# both buckets; a val video of 32 frames at 600x1000
TRAIN_VIDEOS, TRAIN_VIDEO_FRAMES, TRAIN_HW = 2, 24, (720, 1280)
DET_HWS = [(500, 375) if i in (2, 5) else (375, 500) for i in range(8)]
VAL_FRAMES, VAL_HW = 32, (600, 1000)
CLI_ITERS, CLI_RESUME_AT = 8, 4


def write_train_dataset(root: Path, seed: int) -> Path:
    """``VID_val_videos`` as ``write_eval_dataset`` writes it, then the
    ``VID_train_15frames`` and ``DET_train_30classes`` indexes and their
    annotations: one or two boxes a frame (a video's moving at a constant
    speed), every frame annotated.  No image files (``rendered_vid``)."""
    from diffusionvid_torch.data.catalog import DATASETS
    from diffusionvid_torch.data.vid_dataset import VID_WNIDS

    write_eval_dataset(root, 1, VAL_FRAMES, VAL_HW, seed)
    rng = np.random.RandomState(seed + 1)

    def objects(hw, n):
        h, w = hw
        size = rng.uniform(0.2, 0.5, (n, 2)) * (w, h)
        start = rng.uniform(0, 1, (n, 2)) * ((w, h) - size)
        return size, start, rng.uniform(-1, 1, (n, 2)) * (w, h) / 48, rng.randint(1, 31, n)

    _, anno_dir, index = DATASETS["VID_train_15frames"]
    h, w = TRAIN_HW
    lines = []
    for v in range(TRAIN_VIDEOS):
        vdir = f"train/vid_{v:04d}"
        (root / anno_dir / vdir).mkdir(parents=True)
        size, start, speed, labels = objects(TRAIN_HW, rng.randint(1, 3))
        for f in range(TRAIN_VIDEO_FRAMES):
            xy = np.clip(start + speed * f, 0, (w, h) - size)
            write_anno(root / anno_dir / vdir / f"{f:06d}.xml", TRAIN_HW,
                       [(VID_WNIDS[k], (*p, *(p + s))) for k, p, s in zip(labels, xy, size)])
            if f % 2 == 0:
                lines.append(f"{vdir} {len(lines) + 1} {f} {TRAIN_VIDEO_FRAMES}")
    (root / index).parent.mkdir(parents=True, exist_ok=True)
    (root / index).write_text("\n".join(lines) + "\n")

    _, anno_dir, index = DATASETS["DET_train_30classes"]
    (root / anno_dir / "train").mkdir(parents=True)
    lines = []
    for i, hw in enumerate(DET_HWS):
        size, start, _, labels = objects(hw, rng.randint(1, 3))
        write_anno(root / anno_dir / "train" / f"det_{i:04d}.xml", hw,
                   [(VID_WNIDS[k], (*p, *(p + s))) for k, p, s in zip(labels, start, size)])
        lines.append(f"train/det_{i:04d} {i + 1}")
    (root / index).write_text("\n".join(lines) + "\n")
    return root


def write_trunk_pkl(cfg, seed: int, path: Path) -> int:
    """A detectron2-style trunk ``.pkl`` (``stem.*``, ``res2.*`` names,
    numpy arrays, as ``torchvision-R-101.pkl`` ships) from the config's
    ResNet with random weights from ``seed``; returns its tensor count."""
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    state = DiffusionDetArch.from_config(cfg, device="cpu", seed=seed).state_dict()
    trunk = {k[len("backbone.bottom_up."):]: v.numpy() for k, v in state.items()
             if k.startswith("backbone.bottom_up.")}
    with open(path, "wb") as f:
        pickle.dump({"model": trunk, "__author__": "chip_smoke", "matching_heuristics": True}, f)
    return len(trunk)


@contextlib.contextmanager
def train_cli_probes(out: dict):
    """Host-clock probes on the train CLI's path, into ``out``: each
    sample's build (ms, bucket, frames; in the prefetch thread), each wait
    on the prefetcher for a batch, each ``collate`` (stack, host to card)
    with a fingerprint of the samples it took (the current frame's sums), each micro-step between two
    synchronizes, each validation (with its model, dataset and sample
    config, and its results)."""
    from diffusionvid_torch.data import prefetch, sampling
    from diffusionvid_torch.engine import train
    from diffusionvid_torch.tools import train_net

    for key in ("samples", "wait_ms", "collate_ms", "step_ms", "fingerprints", "validations"):
        out[key] = []
    saved = [(sampling, "build_train_sample_method"), (prefetch.PrefetchIterator, "__next__"),
             (train_net, "collate"), (train, "make_train_step"), (train_net, "run_inference")]
    inner = {name: getattr(obj, name) for obj, name in saved}

    def build(*args, **kw):
        t0 = time.perf_counter()
        smp = inner["build_train_sample_method"](*args, **kw)
        out["samples"].append(((time.perf_counter() - t0) * 1e3, smp["bucket"],
                               smp["images"].shape[0]))
        return smp

    def wait(self):
        t0 = time.perf_counter()
        item = inner["__next__"](self)
        if isinstance(item, list):   # a train batch, not validation's videos or chunks
            out["wait_ms"].append((time.perf_counter() - t0) * 1e3)
        return item

    def collate(samples, device):
        t0 = time.perf_counter()
        batch = inner["collate"](samples, device)
        out["collate_ms"].append((time.perf_counter() - t0) * 1e3)
        out["fingerprints"].append([(s["bucket"], float(s["images"][0].sum(dtype=np.float64)),
                                     float(s["gt_boxes"][0].sum(dtype=np.float64)))
                                    for s in samples])
        return batch

    def make_train_step(model, opt, num_global, **kw):
        step = inner["make_train_step"](model, opt, num_global, **kw)
        out["model"] = model

        def timed(batch, draws):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch, draws)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            return metrics
        return timed

    def validate(model, ds, sample_cfg, **kw):
        t0 = time.perf_counter()
        res = inner["run_inference"](model, ds, sample_cfg, **kw)
        out["validations"].append({"ms": (time.perf_counter() - t0) * 1e3, "ds": ds,
                                   "sample_cfg": sample_cfg, "results": res[2]})
        return res

    sampling.build_train_sample_method = build
    prefetch.PrefetchIterator.__next__ = wait
    train_net.collate = collate
    train.make_train_step = make_train_step
    train_net.run_inference = validate
    try:
        yield
    finally:
        for obj, name in saved:
            setattr(obj, name, inner[name])


def _records(out_dir: Path) -> list:
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(ln) for ln in f]


def phase_flagship_train_cli(seed: int) -> dict:
    """Training from files on disk through the port's train CLI
    (``tools/train_net.main``, on the card as a user runs it):
    ``configs/vid_R_101_DiffusionVID.yaml`` at full width with
    ``INPUT.TRANSFORM`` (the SSD augmentation), ``SOLVER.MAX_ITER`` 8,
    ``BATCH_REUSE_STEPS`` 2, the config's ``ACCUMULATION_STEPS`` 2,
    checkpoints every 4 iterations, validation at 8 through
    ``run_inference``, and ``MODEL.WEIGHT`` a detectron2-style trunk
    ``.pkl`` of a seeded R-101 (the loader and the class-head skip); then
    the same run resumed from its iteration-4 checkpoint in a second
    directory.  The data are ``write_train_dataset``'s, frames rendered
    from their annotations (``rendered_vid``: the card's machine has no
    image decoder), so ``sample_ms`` excludes JPEG decode.  The CLI logs
    every iteration here (``LOG_PERIOD`` 1) so that ``metrics.jsonl``
    shows the purge at the resume.

    Checks: the trunk's tensors loaded, finite losses, 4 launches of K1, K2
    and K3 a micro-step plus validation's K1/K2, the batches' buckets as
    the sampler orders them (both seen), the checkpoint files, the resumed
    run's batches equal to the uninterrupted run's last four, its
    ``metrics.jsonl`` purged at step 4, its last losses and parameters
    against the uninterrupted run's (not bit-exact on the card: cuDNN's
    weight gradients reorder sums)."""
    import shutil

    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.data import (ConcatDataset, aspect_ratio_group_ids, frame_bucket,
                                         get_dataset, grouped_batches)
    from diffusionvid_torch.data.vid_dataset import VIDDataset
    from diffusionvid_torch.engine.train import param_group
    from diffusionvid_torch.tools import train_net
    from diffusionvid_torch.utils.checkpoint import load_checkpoint

    work = ROOT / "build" / "chip_smoke" / "train_cli"
    config = ROOT / "configs" / "vid_R_101_DiffusionVID.yaml"
    cfg = load_config(str(config))
    data = write_train_dataset(work / "data", seed)
    pkl = work / "R-101-trunk.pkl"
    trunk_tensors = write_trunk_pkl(cfg, seed + 1, pkl)
    runs = [work / "run", work / "resumed"]
    for d in runs:
        shutil.rmtree(d, ignore_errors=True)
    opts = ["INPUT.TRANSFORM", "True", "SOLVER.MAX_ITER", str(CLI_ITERS),
            "SOLVER.BATCH_REUSE_STEPS", "2", "SOLVER.CHECKPOINT_PERIOD", str(CLI_RESUME_AT),
            "SOLVER.TEST_PERIOD", str(CLI_ITERS), "MODEL.WEIGHT", str(pkl)]

    load_image, VIDDataset.load_image = VIDDataset.load_image, rendered_vid().load_image
    log_period, train_net.LOG_PERIOD = train_net.LOG_PERIOD, 1
    probes, results, launches = [{}, {}], [], []
    try:
        for i, out_dir in enumerate(runs):
            if i:   # resume from the first run's iteration-4 checkpoint
                out_dir.mkdir(parents=True)
                ckpt = out_dir / f"model_{CLI_RESUME_AT:07d}.pth"
                shutil.copy(runs[0] / ckpt.name, ckpt)
                shutil.copy(runs[0] / "metrics.jsonl", out_dir / "metrics.jsonl")
                (out_dir / "last_checkpoint").write_text(str(ckpt))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with train_cli_probes(probes[i]):
                t0 = time.perf_counter()
                results.append(train_net.main(
                    ["--config-file", str(config), "--data-dir", str(data), "--seed", str(seed),
                     "--resume", *opts, "OUTPUT_DIR", str(out_dir)]))
                probes[i]["run_s"] = time.perf_counter() - t0
            launches.append(read_launches())
            probes[i]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        VIDDataset.load_image = load_image
        train_net.LOG_PERIOD = log_period

    run, resumed = results
    p = probes[0]
    model = p.pop("model")
    probes[1].pop("model")
    require(run["pretrained_tensors"] == trunk_tensors,
            f"flagship_train_cli: {run['pretrained_tensors']} tensors loaded of the trunk's "
            f"{trunk_tensors}")
    require(resumed["start_iter"] == CLI_RESUME_AT and run["start_iter"] == 0,
            f"flagship_train_cli: runs started at {run['start_iter']} and {resumed['start_iter']}")
    for i, (res, probe) in enumerate(zip(results, probes)):
        iters = CLI_ITERS - res["start_iter"]
        val = probe["validations"]
        require(len(val) == 1 and len(probe["step_ms"]) == iters,
                f"flagship_train_cli run {i}: {len(probe['step_ms'])} micro-steps, "
                f"{len(val)} validations")
        want = train_launches(model, iters)
        for name, n in eval_launches(model, val[0]["ds"], val[0]["sample_cfg"], 1, 1).items():
            want[name] += n
        for name, n in launches[i].items():
            require(n == want.get(name, 0), f"flagship_train_cli run {i}: {name} launched {n} "
                                            f"times, expected {want.get(name, 0)}")
        recs = _records(runs[i])
        steps = [r["step"] for r in recs if "Train/total_loss" in r]
        require(steps == list(range(1, CLI_ITERS + 1))
                and all(np.isfinite(v) for r in recs for v in r.values()),
                f"flagship_train_cli run {i}: metrics.jsonl steps {steps} (purged at "
                f"{CLI_RESUME_AT} on resume), or a non-finite value")
        require(all(np.isfinite(v) for v in res["metrics"].values()),
                f"flagship_train_cli run {i}: non-finite loss {res['metrics']}")
    for name in (f"model_{CLI_RESUME_AT:07d}.pth", f"model_{CLI_ITERS:07d}.pth", "config.yml",
                 "log.txt", "last_checkpoint"):
        require((runs[0] / name).exists(), f"flagship_train_cli: no {name}")
    require(run["checkpoint"] == str(runs[0] / f"model_{CLI_ITERS:07d}.pth")
            and resumed["checkpoint"] == str(runs[1] / f"model_{CLI_ITERS:07d}.pth"),
            f"flagship_train_cli: last checkpoints {run['checkpoint']}, {resumed['checkpoint']}")

    # the batches: buckets in the sampler's order; the resumed run's are the
    # uninterrupted run's last four
    ds = ConcatDataset([get_dataset(n, is_train=True, data_dir=str(data))
                        for n in cfg.DATASETS.TRAIN])
    order = grouped_batches(aspect_ratio_group_ids(ds), 1, seed=0)
    sizes = (max(cfg.INPUT.MIN_SIZE_TRAIN), cfg.INPUT.MAX_SIZE_TRAIN)
    want_buckets = [list(frame_bucket(ds.annos[i].height, ds.annos[i].width, *sizes))
                    for _ in range(0, CLI_ITERS, 2) for i in next(order)]
    seen = [list(f[0][0]) for f in p["fingerprints"][::2]]
    require(seen == want_buckets and len({tuple(b) for b in seen}) == 2,
            f"flagship_train_cli: batch buckets {seen}, the sampler's {want_buckets}")
    require(probes[1]["fingerprints"] == p["fingerprints"][CLI_RESUME_AT:],
            "flagship_train_cli: the resumed run's batches differ from the run's")

    end = [load_checkpoint(str(d / f"model_{CLI_ITERS:07d}.pth"))["model"] for d in runs]
    start = load_checkpoint(str(runs[0] / f"model_{CLI_RESUME_AT:07d}.pth"))["model"]
    param_diff = max(float((end[0][k].float() - end[1][k].float()).abs().max()) for k in end[0])
    moved = {g: 0 for g in ("main", "bias", "backbone", "backbone_bias")}
    for k, v in end[0].items():
        g = param_group(k)
        if g in moved:
            moved[g] += int(not torch.equal(v, start[k]))
    loss_diff = max(abs(run["metrics"][k] - resumed["metrics"][k])
                    / max(abs(run["metrics"][k]), 1e-12) for k in run["metrics"])
    require(all(moved.values()), f"flagship_train_cli: parameters moved per group {moved}")
    require(param_diff < 1e-3 and loss_diff < 5e-2,
            f"flagship_train_cli: resumed against uninterrupted: parameters {param_diff}, "
            f"losses {loss_diff} relative")

    frames = 1 + cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    step_ms, accum = p["step_ms"], cfg.SOLVER.ACCUMULATION_STEPS
    loop_s = (sum(p["wait_ms"]) + sum(p["collate_ms"]) + sum(step_ms)) / 1e3
    train_samples = [s for s in p["samples"] if s[2] == frames]
    val = p["validations"][0]
    res = {"config": "configs/vid_R_101_DiffusionVID.yaml",
           "dtype": str(model.compute_dtype).split(".")[1], "iterations": CLI_ITERS, "resumed_at": CLI_RESUME_AT, "batch_reuse_steps": 2,
           "accumulation_steps": accum, "frames_per_sample": frames,
           "dataset": {"vid_videos": TRAIN_VIDEOS, "vid_hw": list(TRAIN_HW),
                       "vid_listed": len(ds.datasets[1]), "det_stills": len(DET_HWS),
                       "val_frames": VAL_FRAMES, "val_hw": list(VAL_HW)},
           "pretrained_tensors": run["pretrained_tensors"], "launches": launches[0],
           "resumed_launches": launches[1],
           "sample_ms": [s[0] for s in train_samples],
           "sample_ms_median": statistics.median(s[0] for s in train_samples),
           "wait_ms": p["wait_ms"], "collate_ms_median": statistics.median(p["collate_ms"]),
           "micro_step_ms": step_ms, "micro_step_ms_median": statistics.median(step_ms),
           "ms_per_optimizer_step": sum(step_ms) / (len(step_ms) / accum),
           # the first optimizer step holds cuDNN's and the allocator's warm-up
           "steady_ms_per_optimizer_step": sum(step_ms[accum:]) / (len(step_ms) / accum - 1),
           "trained_frames_per_s": len(step_ms) * frames / loop_s,
           # frames a second one producer thread can feed: a sample every
           # BATCH_REUSE_STEPS iterations
           "host_feed_frames_per_s": 2 * frames / statistics.median(s[0] for s in train_samples)
           * 1e3,
           "loop_s": loop_s, "run_s": p["run_s"], "validation_ms": val["ms"],
           "peak_mem_gib": p["peak_mem_gib"], "losses": run["metrics"],
           "resumed_losses": resumed["metrics"], "resumed_max_rel_loss_diff": loss_diff,
           "resumed_max_abs_param_diff": param_diff, "params_moved": moved,
           "buckets": seen, "metrics_steps_after_resume": [r["step"] for r in _records(runs[1])],
           "checkpoints": sorted(f.name for f in runs[0].glob("model_*.pth")),
           "val_ap50_random_weights": val["results"]["ap50"] if val["results"] else None,
           "card": torch.cuda.get_device_name(0)}
    for d in runs:    # about 0.7 GB of weights and optimizer state a checkpoint
        shutil.rmtree(d)
    del model, end, start
    torch.cuda.empty_cache()
    emit("flagship_train_cli", **res)
    return launches[0]


SWIN_L_TRAIN_CLI_ITERS = 2


def phase_flagship_train_swin_l_cli(seed: int) -> dict:
    """The port's train CLI (``tools/train_net.main``, on the card) on
    ``configs/vid_Swin_B_DiffusionVID.yaml`` with ``MODEL.SWIN.SIZE
    L-22k-384`` (window 12, C up to 1536: K6's staged design under grad),
    random weights, ``SWIN_L_TRAIN_CLI_ITERS`` iterations over phase 11's
    rendered files (``write_train_dataset``), no validation: finite losses,
    its last checkpoint, and the launches of that many micro-steps (24 of
    K6, 4 each of K1, K2 and K3 a micro-step)."""
    import shutil

    from diffusionvid_torch.data.vid_dataset import VIDDataset
    from diffusionvid_torch.tools import train_net

    work = ROOT / "build" / "chip_smoke" / "train_cli"
    data, out_dir = work / "data", work / "swin_l"
    if not data.exists():
        write_train_dataset(data, seed)
    shutil.rmtree(out_dir, ignore_errors=True)
    iters = SWIN_L_TRAIN_CLI_ITERS
    opts = ["SOLVER.MAX_ITER", str(iters), "SOLVER.CHECKPOINT_PERIOD", str(iters),
            "SOLVER.TEST_PERIOD", "0", "MODEL.WEIGHT", "''", *SWIN_L_OPTS]
    load_image, VIDDataset.load_image = VIDDataset.load_image, rendered_vid().load_image
    probe = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        with train_cli_probes(probe):
            t0 = time.perf_counter()
            run = train_net.main(
                ["--config-file", str(ROOT / "configs" / "vid_Swin_B_DiffusionVID.yaml"),
                 "--data-dir", str(data), "--seed", str(seed), *opts, "OUTPUT_DIR", str(out_dir)])
            run_s = time.perf_counter() - t0
    finally:
        VIDDataset.load_image = load_image
    launches = read_launches()
    model = probe.pop("model")
    want = train_launches(model, iters)
    require(launches == {k: want.get(k, 0) for k in launches},
            f"flagship_train_swin_l_cli: launches {launches}, expected {want}")
    require(all(np.isfinite(v) for v in run["metrics"].values()),
            f"flagship_train_swin_l_cli: non-finite loss {run['metrics']}")
    require(run["checkpoint"] == str(out_dir / f"model_{iters:07d}.pth"),
            f"flagship_train_swin_l_cli: last checkpoint {run['checkpoint']}")
    res = {"config": "configs/vid_Swin_B_DiffusionVID.yaml", "opts": list(SWIN_L_OPTS),
           "dtype": str(model.compute_dtype).split(".")[1], "iterations": iters,
           "window": model.backbone.bottom_up.window, "launches": launches,
           "expected_launches": want, "run_s": run_s, "micro_step_ms": probe["step_ms"],
           "sample_ms": [smp[0] for smp in probe["samples"]],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": run["metrics"], "card": torch.cuda.get_device_name(0)}
    shutil.rmtree(out_dir)   # the weights and optimizer state of Swin-L
    del model
    torch.cuda.empty_cache()
    emit("flagship_train_swin_l_cli", **res)
    return launches


# ---------------------------------------------------------------- the MEGA family's training

# the six methods' train configs, and MEGA on the pixel path (its local
# pixel attention replaces the box relation: ATTENTION.ENABLE off)
MEGA_TRAIN = {
    "base": ("vid_R_101_C4_1x.yaml", []),
    "dff": ("DFF/vid_R_101_C4_DFF_1x.yaml", []),
    "fgfa": ("FGFA/vid_R_101_C4_FGFA_1x.yaml", []),
    "rdn": ("RDN/vid_R_101_C4_RDN_1x.yaml", []),
    "mega": ("MEGA/vid_R_101_C4_MEGA_1x.yaml", []),
    "mega_pixel": ("MEGA/vid_R_101_C4_MEGA_1x.yaml",
                   ["MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE", "False",
                    "MODEL.VID.MEGA.LOCAL.PIXEL_ATTEND", "True"]),
    "dafa": ("MEGA/vid_R_101_C4_DAFA_1x.yaml", []),
}
# the tiny train models: depth 18, fp32, 5 classes, 100 boxes before the
# RPN's NMS, 16 current proposals and 10 a reference frame (RDN's advanced
# stage distils 0.2 of them), 1 memory and 2 global frames, DAFA 16
# proposals into a 64-slot memory (no FPS: near-equal rows of two frames
# would make its pick, and the gradient's path, a toss-up); the pixel path
# 4 local frames (its 100 irrelevant pixels need 100 pixels: 5 maps of 4x6)
TRAIN_TINY_OPTS = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32",
                   "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "6", "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "100",
                   "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "16", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100",
                   "MODEL.RPN.POST_NMS_TOP_N_TEST", "8", "MODEL.VID.RPN.REF_POST_NMS_TOP_N", "10",
                   "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "64",
                   "MODEL.VID.MEGA.REF_NUM_MEM", "1", "MODEL.VID.MEGA.REF_NUM_GLOBAL", "2",
                   "MODEL.DiffusionDet.NUM_PROPOSALS", "16",
                   "MODEL.DiffusionDet.NUM_CLASSES", "5"]
TRAIN_TINY_PIXEL = ["MODEL.VID.MEGA.REF_NUM_LOCAL", "4"]
# the full-width train step: a sample's frames at 600x1000
MEGA_TRAIN_HW = (600, 1000)


def method_model(method: str, opts=(), device="cuda", seed: int = 0):
    """The config of ``method`` (``MEGA_TRAIN``) with ``opts``, its
    ``MethodSampleSpec`` and model."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.data.sampling import MethodSampleSpec
    from diffusionvid_torch.models.detectors import build_detection_model
    config, extra = MEGA_TRAIN[method]
    cfg = load_config(str(ROOT / "configs" / config), [*extra, *opts])
    return cfg, MethodSampleSpec.from_config(cfg), build_detection_model(cfg, device=device,
                                                                         seed=seed)


def fg_classes(cfg, method: str) -> int:
    """The foreground classes of the method's model."""
    return (cfg.MODEL.DiffusionDet.NUM_CLASSES if method == "dafa"
            else cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1)


def calibrate_on_sample(model, spec, batch, seed: int):
    """A start that trains at full width in bf16, the stand-in for a
    pretrained trunk: the C4 RPN's convolutions at normal(0.01) and the
    Fast R-CNN predictor's at normal(0.01) (classes) and normal(0.001)
    (deltas), biases zero, the reference's initializers (rpn/rpn.py:69-106,
    roi_box_predictors.py), where the port's and the JAX package's He and
    xavier inits give logits of 1e3 and deltas of 1e3 on R-101's maps; then
    the FrozenBN statistics taken from one no-grad train forward on
    ``batch`` (``_calibrated_norms``, each variance at least a tenth of the
    median channel's), where the init's identity statistics grow R-101's
    activations through its 33 blocks to losses of 1e5."""
    from diffusionvid_torch.engine.train import iteration_generator
    from diffusionvid_torch.engine.train_methods import (
        draw_method_randoms, make_method_loss_fn)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = {"rpn.conv.weight": 0.01, "rpn.cls_logits.weight": 0.01,
                   "rpn.bbox_pred.weight": 0.01, "predictor.cls_score.weight": 0.01,
                   "predictor.bbox_pred.weight": 0.001}.get(name.split("detector.")[-1])
            if std is not None:
                p.copy_(std * torch.randn(p.shape, generator=gen))
            elif name.split("detector.")[-1].startswith(("rpn.", "predictor.")):
                p.zero_()
    draws = draw_method_randoms(iteration_generator(seed, -1), 1)
    with _calibrated_norms(model, floor=0.1), torch.no_grad():
        make_method_loss_fn(model, spec)(batch, draws)


def dafa_train_launches(micro_steps: int, stages: int = DAFA_STAGES) -> dict:
    """DAFA's launches of K1, K2 and K3 in ``micro_steps`` train
    micro-steps: each decoder stage once on the current frame and once on
    the global frames (``extract_topk``, under gradient), and its backward
    (K3) for both passes; nothing else."""
    return {k: 2 * stages * micro_steps for k in TRAIN_KERNELS}


@contextlib.contextmanager
def boxes_without_pooling_gradient():
    """While open, the decoder's ROIAlign on the CPU takes its boxes
    detached: K1's gradient (K3) is the features' only, as the JAX
    package's kernel's is (``ROADMAP.md`` §C deviation 8), while the plain
    version differentiates the boxes too.  DAFA's learned proposal boxes
    reach its first stage's pooling; no other box that the pooling sees is
    a parameter's function."""
    from diffusionvid_torch.models import heads
    inner = heads.multilevel_roi_align

    def pool(features, rois, *args, **kw):
        return inner(features, rois.detach(), *args, **kw)

    heads.multilevel_roi_align = pool
    try:
        yield
    finally:
        heads.multilevel_roi_align = inner


def phase_mega_family_train_tiny(seed: int) -> dict:
    """One train step of each of the MEGA family's methods (``MEGA_TRAIN``)
    at depth 18 on 64x96 frames (``TRAIN_TINY_OPTS``), on the card against
    the port on the CPU: the same weights (conditioned on the CPU,
    ``conditioned_method_model``), sample and draws, float32, TF32 off,
    through ``engine/train_methods.make_method_loss_fn``.  Losses within
    1e-4 relative, every gradient within 1e-3 of its norm (phase 13's
    tolerances); DAFA launches K1, K2 and K3 (``dafa_train_launches``), no
    C4 method launches any of K1–K7."""
    import copy

    from diffusionvid_torch.engine.train_methods import (
        draw_method_randoms, make_method_loss_fn)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = 64, 96
    rows = {}
    for method in MEGA_TRAIN:
        gen = torch.Generator().manual_seed(seed)
        opts = TRAIN_TINY_OPTS + (TRAIN_TINY_PIXEL if method == "mega_pixel" else [])
        cfg, spec, cpu = method_model(method, opts, device="cpu", seed=seed)
        frames = 1 + spec.num_local + spec.num_mem + spec.num_global
        classes = fg_classes(cfg, method)
        batch = train_batch(gen, 1, frames, 6, h, w, classes, "cpu")
        draws = draw_method_randoms(gen, 1)
        conditioned_method_model(cpu, gen, lambda: make_method_loss_fn(cpu, spec)(batch, draws))
        card = copy.deepcopy(cpu).cuda()

        def step(model, dev):
            total, losses = make_method_loss_fn(model, spec)(
                type(batch)(*[t.to(dev) for t in batch]), draws)
            total.backward()
            grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                     for n, p in model.named_parameters()}
            return {"total_loss": total.detach().cpu(),
                    **{k: v.detach().cpu() for k, v in losses.items()}}, grads

        reset_launches()
        c_losses, c_grads = step(card, "cuda")
        torch.cuda.synchronize()
        used = read_launches()
        want = dafa_train_launches(1, len(card.heads)) if method == "dafa" else {}
        require(used == {k: want.get(k, 0) for k in used},
                f"mega_family_train_tiny {method}: launches {used}, expected {want}")
        with boxes_without_pooling_gradient():
            p_losses, p_grads = step(cpu, "cpu")
        require(sorted(c_losses) == sorted(p_losses),
                f"mega_family_train_tiny {method}: loss names differ")
        loss_err = max(float((c_losses[k] - v).abs() / v.abs().clamp(min=1e-12))
                       for k, v in p_losses.items())
        grad_err, worst = 0.0, ""
        for name, g in p_grads.items():
            e = float(torch.linalg.vector_norm(c_grads[name] - g)
                      / torch.linalg.vector_norm(g).clamp(min=1e-12))
            if e > grad_err:
                grad_err, worst = e, name
        require(all(bool(torch.isfinite(v)) for v in c_losses.values()),
                f"mega_family_train_tiny {method}: non-finite loss")
        require(loss_err < 1e-4 and grad_err < 1e-3,
                f"mega_family_train_tiny {method}: card vs CPU over tolerance: loss {loss_err}, "
                f"grad {grad_err} ({worst})")
        rows[method] = {"config": f"configs/{MEGA_TRAIN[method][0]}", "frames": frames,
                        "launches": used, "max_rel_err_loss": loss_err,
                        "max_rel_err_grad": grad_err, "worst_grad": worst,
                        "losses": sorted(p_losses),
                        "total_loss": float(p_losses["total_loss"])}
        del cpu, card
    emit("mega_family_train_tiny", hw=[h, w], loss_rtol=1e-4, grad_rtol=1e-3, methods=rows)
    return rows


def phase_mega_family_train(seed: int, keep: dict) -> dict:
    """The seven train steps of ``MEGA_TRAIN`` at full width: the R-101
    configs with random weights from ``seed``, in their dtype (bfloat16),
    one sample of the method's frames at 600x1000 with 1 to 8 random GT
    boxes each, the FrozenBN statistics taken from it
    (``calibrate_on_sample``), through ``engine/train.make_train_step``
    with the method's loss and draws.  One warm-up and 2 timed optimizer steps each (the
    configs' ACCUMULATION_STEPS 1): ms per optimizer step, peak memory,
    finite losses under the JAX package's names, parameters moved; DAFA's
    K1/K2/K3 launches a micro-step as ``dafa_train_launches`` counts them,
    none for the C4 methods; one micro-step profiled (device busy, idle
    share, top kernels).  DAFA's last micro-step's K1, K2 and K3 inputs are
    appended to ``keep``'s lists.  Returns DAFA's launches a micro-step."""
    from diffusionvid_torch.engine.train import (
        iteration_generator, make_train_step, optimizer_from_config)
    from diffusionvid_torch.engine.train_methods import (
        draw_method_randoms, make_method_loss_fn)

    h, w = MEGA_TRAIN_HW
    res = {"hw": [h, w], "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
           "methods": {}}
    dafa = None
    for method in MEGA_TRAIN:
        t0 = time.perf_counter()
        cfg, spec, model = method_model(method, seed=seed)
        opt = optimizer_from_config(model, cfg)
        build_s = time.perf_counter() - t0
        frames = 1 + spec.num_local + spec.num_mem + spec.num_global
        classes = fg_classes(cfg, method)
        gen = torch.Generator().manual_seed(seed)
        batch = train_batch(gen, 1, frames, cfg.TPU.MAX_GT_BOXES, h, w, classes, "cuda")
        calibrate_on_sample(model, spec, batch, seed)
        step = make_train_step(model, opt, loss_fn=make_method_loss_fn(model, spec))
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = {"it": 0, "metrics": []}

        def micro():
            draws = draw_method_randoms(iteration_generator(seed, state["it"]), 1)
            state["metrics"].append(step(batch, draws))
            state["it"] += 1

        micro()                               # warm-up: allocator, cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(2):
            micro()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        want = dafa_train_launches(2, len(model.heads)) if method == "dafa" else {}
        require(launches == {k: want.get(k, 0) for k in launches},
                f"mega_family_train {method}: launches {launches}, expected {want}")
        require(all(torch.isfinite(v).all() for m in state["metrics"] for v in m.values()),
                f"mega_family_train {method}: non-finite loss")
        moved = sum(int(not torch.equal(p.detach(), start[n]))
                    for n, p in model.named_parameters())
        require(moved > 0 and opt.count == 3, f"mega_family_train {method}: {moved} tensors "
                f"moved in {opt.count} optimizer steps")
        row = {"config": f"configs/{MEGA_TRAIN[method][0]}", "opts": MEGA_TRAIN[method][1],
               "dtype": str(model.compute_dtype).split(".")[1], "frames": frames,
               "layout": [spec.num_local, spec.num_mem, spec.num_global],
               "model_build_s": build_s, "warmup_optimizer_steps": 1,
               "timed_optimizer_steps": 2, "ms_per_optimizer_step": dt / 2 * 1e3,
               "trained_frames_per_s": 2 * frames / dt,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches,
               "losses": {k: float(v) for k, v in state["metrics"][-1].items()},
               "tensors_moved": moved}
        row.update({f"micro_step_{k}": v
                    for k, v in profile_device(micro, f"mega_family_train_{method}").items()})
        if method == "dafa":
            dafa = {k: n // 2 for k, n in launches.items()}
            with contextlib.ExitStack() as stack:
                for k, into in keep.items():
                    stack.enter_context(CAPTURES[k](into))
                micro()
        res["methods"][method] = row
        emit("mega_family_train", method=method, **row, card=res["card"])
        del model, opt, step, state, start, batch
        torch.cuda.empty_cache()
    res["dafa_launches_per_micro_step"] = dafa
    return res


def phase_mega_family_train_kernels(keep: dict) -> dict:
    """K1, K2 and K3 on the inputs of DAFA's full-width train micro-step
    (``keep``: each stage's launch on the current frame and on the global
    frames' ``extract_topk`` pass, and their backward), in bf16 as captured
    and in fp32 on the same inputs, each against its plain version at the
    tolerances of ``k1_case``, ``kernel_k2`` and ``k3_case``, with two
    bit-equal launches; then the last stage of each pass timed in bf16
    (``ms``, the card's ``kernel_ms``, the plain version's ``plain_ms``)
    beside its bound."""
    from diffusionvid_torch.ops import roi_align as ra
    from diffusionvid_torch.ops.dynamic_conv import dynamic_conv_fused, dynamic_conv_ref
    stages = DAFA_STAGES
    for k, caps in keep.items():
        require(len(caps) == 2 * stages, f"mega_family_train_kernels: {len(caps)} {k} launches "
                                         f"kept, expected {2 * stages}")
    rows = {"k1": [], "k2": [], "k3": []}
    worst = {k: {"bfloat16": 0.0, "float32": 0.0} for k in rows}
    for i, c in enumerate(keep["k1"]):
        frames = int(c["rois"].shape[0])
        row = {"launch": i, "frames": frames, "rois": int(c["rois"].shape[1])}
        for dtype in (torch.bfloat16, torch.float32):
            feats = [f.to(dtype) for f in c["features"]]   # captured in bf16
            r = k1_case(feats, c["rois"], c["scales"],
                        what=f"mega_family_train K1 launch {i}")
            worst["k1"][str(dtype).split(".")[1]] = max(
                worst["k1"][str(dtype).split(".")[1]], r["max_abs_err"])
            row.setdefault("rois_per_level", r["rois_per_level"])
        if i % stages == stages - 1:
            row.update(k1_timing([f.to(torch.bfloat16) for f in c["features"]], c["rois"],
                                 c["scales"]))
        rows["k1"].append(row)
    for i, c in enumerate(keep["k2"]):
        row = {"launch": i, "s": int(c["args"][0].shape[0])}
        for dtype in (torch.bfloat16, torch.float32):
            args = c["args"] if dtype == torch.bfloat16 else [t.float() for t in c["args"]]
            tol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 3e-2)
            got = dynamic_conv_fused(*args, eps=c["eps"])
            r = compare(got, dynamic_conv_ref(*args, eps=c["eps"]), *tol,
                        f"mega_family_train K2 launch {i} {dtype}")
            require(torch.equal(dynamic_conv_fused(*args, eps=c["eps"]), got),
                    f"mega_family_train K2 launch {i} {dtype}: two launches differ")
            key = str(dtype).split(".")[1]
            worst["k2"][key] = max(worst["k2"][key], r["max_abs_err"])
        if i % stages == stages - 1:
            args = c["args"]
            call = lambda: dynamic_conv_fused(*args, eps=c["eps"])  # noqa: E731
            row["bound_ms"], row["bound_by"] = k2_bound(args[0], args[1], args[2], args[3:7])
            row.update(ms=cuda_time_ms(call), kernel_ms=device_ms(call, K2_KERNELS, 20, 1),
                       plain_ms=cuda_time_ms(lambda: dynamic_conv_ref(*args, eps=c["eps"])))
        rows["k2"].append(row)
    for i, c in enumerate(keep["k3"]):
        row = {"launch": i, "frames": int(c["rois"].shape[0])}
        for dtype in (torch.bfloat16, torch.float32):
            g = c["g"].to(dtype)
            r, got = k3_case(dtype, g, c["rois"], c["shapes"], c["scales"],
                             what=f"mega_family_train K3 launch {i}")
            key = str(dtype).split(".")[1]
            worst["k3"][key] = max(worst["k3"][key], r["max_abs_err"])
            if dtype == torch.bfloat16:
                row["rois_per_level"] = r["rois_per_level"]
                if i % stages == stages - 1:
                    row["bound_ms"], row["bound_by"], row["gflop"] = k3_bound(
                        g, c["rois"], c["shapes"], c["scales"], got)
                    call = lambda: ra.multilevel_roi_align_bwd(  # noqa: E731
                        g, c["rois"], c["shapes"], c["scales"], dtype)
                    row.update(ms=device_ms(call, K3_KERNELS), event_ms=cuda_time_ms(call),
                               plain_ms=cuda_time_ms(lambda: ra.multilevel_roi_align_bwd_ref(
                                   g, c["rois"], c["shapes"], c["scales"], dtype), iters=3,
                                   warmup=1))
        rows["k3"].append(row)
    passes = {k: sorted({r["frames"] for r in v if "frames" in r}) for k, v in rows.items()}
    require(len(passes["k1"]) == 2 and len(passes["k3"]) == 2,
            f"mega_family_train_kernels: the passes' frames {passes}, expected two counts")
    res = {"max_abs_err": worst, "passes_frames": passes, "deterministic": True,
           "timed": {k: [r for r in v if "bound_ms" in r] for k, v in rows.items()},
           "card": torch.cuda.get_device_name(0)}
    emit("mega_family_train_kernels", **res)
    return res


def phase_mega_family_train_cli(seed: int) -> dict:
    """The train CLI (``tools/train_net.main``, on the card) on DAFA and on
    MEGA at full width from rendered frames on disk (``write_train_dataset``,
    as phase 11), ``SOLVER.MAX_ITER`` 4, ``BATCH_REUSE_STEPS`` 2 (the reuse
    swap draws a global frame), a checkpoint every 2 iterations, no
    validation, started (``--resume``) from an iteration-0 checkpoint of the
    config's model with its FrozenBN statistics from a sample of the
    dataset's last video frame (``calibrate_on_sample``: random R-101
    statistics overflow, and a full
    model file loads into no MEGA, as in the JAX package: ``ROADMAP.md``
    §C 5) and a fresh optimizer; then the same run resumed from its
    iteration-2 checkpoint in
    a second directory, which must end bit-equal to the uninterrupted one
    (parameters and last losses).  Both runs use PyTorch's deterministic
    algorithms (cuDNN's included; ``CUBLAS_WORKSPACE_CONFIG`` is set at the
    script's start), which make the card's sums repeat.  Prints ms per
    iteration, peak memory, the losses and DAFA's launches."""
    import shutil

    from diffusionvid_torch.data import ConcatDataset, get_dataset
    from diffusionvid_torch.data.vid_dataset import VIDDataset
    from diffusionvid_torch.engine.train import optimizer_from_config
    from diffusionvid_torch.tools import train_net
    from diffusionvid_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    work = ROOT / "build" / "chip_smoke" / "mega_train_cli"
    shutil.rmtree(work, ignore_errors=True)
    data = write_train_dataset(work / "data", seed)
    load_image, VIDDataset.load_image = VIDDataset.load_image, rendered_vid().load_image
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    rows = {}
    try:
        for method in ("dafa", "mega"):
            config = ROOT / "configs" / MEGA_TRAIN[method][0]
            runs = [work / method / "run", work / method / "resumed"]
            cfg, spec, model = method_model(method, seed=seed)
            ds = ConcatDataset([get_dataset(n, is_train=True, data_dir=str(data))
                                for n in cfg.DATASETS.TRAIN])
            smp = ds.sample(len(ds) - 1, np.random.RandomState(seed),
                            train_net.train_sample_config(cfg), spec)
            calibrate_on_sample(model, spec, train_net.collate([smp], "cuda"), seed)
            save_checkpoint(str(runs[0]), 0, {k: v.cpu() for k, v in model.state_dict().items()},
                            optimizer_from_config(model, cfg).state_dict())
            del model
            torch.cuda.empty_cache()
            opts = ["SOLVER.MAX_ITER", "4", "SOLVER.BATCH_REUSE_STEPS", "2",
                    "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.TEST_PERIOD", "0",
                    "MODEL.WEIGHT", "''"]
            results, launches, times, peaks = [], [], [], []
            for i, out_dir in enumerate(runs):
                out_dir.mkdir(parents=True, exist_ok=True)
                if i:
                    ckpt = out_dir / "model_0000002.pth"
                    shutil.copy(runs[0] / ckpt.name, ckpt)
                    (out_dir / "last_checkpoint").write_text(str(ckpt))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                results.append(train_net.main(
                    ["--config-file", str(config), "--data-dir", str(data), "--seed", str(seed),
                     "--resume", *opts, "OUTPUT_DIR", str(out_dir)]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                launches.append(read_launches())
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            run, resumed = results
            require(run["start_iter"] == 0 and resumed["start_iter"] == 2,
                    f"mega_family_train_cli {method}: runs started at {run['start_iter']} and "
                    f"{resumed['start_iter']}")
            require(all(np.isfinite(v) for v in run["metrics"].values()),
                    f"mega_family_train_cli {method}: non-finite loss {run['metrics']}")
            end = [load_checkpoint(str(d / "model_0000004.pth"))["model"] for d in runs]
            differ = [k for k in end[0] if not torch.equal(end[0][k], end[1][k])]
            require(not differ and run["metrics"] == resumed["metrics"],
                    f"mega_family_train_cli {method}: the resumed run differs from the "
                    f"uninterrupted one in {len(differ)} tensors ({differ[:3]}), losses "
                    f"{run['metrics']} against {resumed['metrics']}")
            want = dafa_train_launches(1) if method == "dafa" else {}
            require(all(launches[i] == {k: 4 * want.get(k, 0) - 2 * i * want.get(k, 0)
                                        for k in launches[i]} for i in (0, 1)),
                    f"mega_family_train_cli {method}: launches {launches}, an iteration "
                    f"{want}")
            rows[method] = {"config": f"configs/{MEGA_TRAIN[method][0]}", "iterations": 4,
                            "resumed_at": 2, "batch_reuse_steps": 2, "run_s": times[0],
                            "resumed_run_s": times[1], "ms_per_iteration": times[0] / 4 * 1e3,
                            "peak_mem_gib": peaks[0], "launches": launches[0],
                            "resumed_launches": launches[1], "losses": run["metrics"],
                            "resumed_bit_equal": True}
            emit("mega_family_train_cli", method=method, **rows[method],
                 card=torch.cuda.get_device_name(0))
            shutil.rmtree(work / method)
    finally:
        VIDDataset.load_image = load_image
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det[:2]
        torch.use_deterministic_algorithms(det[2])
    return rows


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- the local attention

LOCAL_ATTN_OPTS = ("MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE", "True",
                   "MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE", "2")


def phase_flagship_local_attn(seed: int) -> dict:
    """The local temporal attention (ATTENTION.ENABLE, STAGE 2) on the
    R-101 flagship at full width and depth: streaming (``phase_flagship``:
    24 global frames, then 2 chunks of 8, K1 and K2), then the train step
    (``phase_flagship_train``: samples of 1 + 2 local + 4 global frames,
    the conditioned stage and the losses on the first 3; one warm-up and 2
    timed optimizer steps of ACCUMULATION_STEPS 2, K1, K2 and K3), with K1,
    K2 and K3 held against their plain versions on one micro-step's inputs
    (``train_kernels``: the shared stages' 7 frames, the conditioned
    stage's 3), then the tiny model with GLOBAL.ENABLE off (the local chain conditions the
    stage) on the card against the CPU (``phase_tiny``)."""
    config = "vid_R_101_DiffusionVID.yaml"
    stream = phase_flagship(seed, config, 2, "flagship_local_attn", opts=LOCAL_ATTN_OPTS)
    keep = {"k1": [], "k2": [], "k3": []}
    train = phase_flagship_train(seed, config, "flagship_local_attn_train", 2, keep=keep,
                                 opts=LOCAL_ATTN_OPTS, warmup_steps=1)
    train_kernels("flagship_local_attn_kernels", keep, train["decoder_stages"])
    del keep
    phase_tiny(seed, "resnet", local_stages=2, global_enable=False)
    return {"stream": stream["launches"], "train": train["launches"]}


def train_kernels(phase: str, keep: dict, stages: int) -> dict:
    """K1, K2 and K3 on the inputs of one train micro-step's launches
    (``keep``, one set a decoder stage, kept by ``phase_flagship_train``),
    each against its plain version at the tolerances of ``k1_case``,
    ``kernel_k2`` (bf16: 3e-2) and ``k3_case``, with two bit-equal
    launches."""
    from diffusionvid_torch.ops.dynamic_conv import dynamic_conv_fused, dynamic_conv_ref
    for k, caps in keep.items():
        require(len(caps) == stages, f"{phase}: {len(caps)} {k} launches kept, expected {stages}")
    rows = []
    for i, (c1, c2, c3) in enumerate(zip(keep["k1"], keep["k2"], keep["k3"])):
        k1 = k1_case(c1["features"], c1["rois"], c1["scales"], what=f"{phase} K1 stage {i}")
        args = c2["args"]
        got = dynamic_conv_fused(*args, eps=c2["eps"])
        k2 = compare(got, dynamic_conv_ref(*args, eps=c2["eps"]), 3e-2, 3e-2,
                     f"{phase} K2 stage {i}")
        require(torch.equal(dynamic_conv_fused(*args, eps=c2["eps"]), got),
                f"{phase} K2 stage {i}: two launches differ")
        k3, _ = k3_case(c3["g"].dtype, c3["g"], c3["rois"], c3["shapes"], c3["scales"],
                        what=f"{phase} K3 stage {i}")
        rows.append({"stage": i, "rois": list(c1["rois"].shape[:2]),
                     "dtype": str(args[0].dtype).split(".")[1],
                     "k1_max_abs_err": k1["max_abs_err"], "k1_max_rel_err": k1["max_rel_err"],
                     "k1_rois_per_level": k1["rois_per_level"],
                     "k2_proposals": args[0].shape[0], "k2_max_abs_err": k2["max_abs_err"],
                     "k2_max_rel_err": k2["max_rel_err"], "k3_max_abs_err": k3["max_abs_err"],
                     "k3_rois_per_level": k3["rois_per_level"]})
    frames = sorted({r["rois"][0] for r in rows})
    res = {"stages": rows, "frames": frames, "card": torch.cuda.get_device_name(0)}
    emit(phase, **res)
    # the shared stages see every frame, the conditioned stage the local ones
    require(len(frames) == 2, f"{phase}: the stages' frames {frames}, expected two counts")
    return res


# ---------------------------------------------------------------- still images

STILL_TINY_HW = (64, 96)
# the still-image sets: 8 images each at 600x1000, two of them portrait
STILL_IMAGES = [(600, 1000)] * 6 + [(1000, 600)] * 2
STILL_SETS = {"coco": "coco_val", "voc": "voc_test", "cityscapes": "cityscapes_val"}


def still_boxes(rng, hw, n: int):
    """``n`` boxes inside an image of ``hw``, 10–45% of its sides."""
    h, w = hw
    size = rng.uniform(0.1, 0.45, (n, 2)) * (w, h)
    start = rng.uniform(0, 1, (n, 2)) * ((w, h) - size)
    return np.concatenate([start, start + size], 1).round()


def write_still_sets(root: Path, images, seed: int, write_images: bool = False) -> Path:
    """The three still-image layouts under ``root``: a COCO instances JSON of 80
    categories (objects of the first 3), a VOC ``test`` split of its first 3
    classes and a Cityscapes ``val`` split of person, car and bicycle, each
    box a polygon's extent; 1 to 3 objects an image.  The images are
    rendered from the annotations (``render_frame``): by ``rendered_still``
    when they are read, or with ``write_images`` into image files by
    ``cv2`` (the CPU commands of the README)."""
    import shutil
    import xml.etree.ElementTree as ET

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(seed)
    objs = [(hw, rng.randint(1, 4, rng.randint(1, 4)), still_boxes(rng, hw, 3))
            for hw in images]
    files = []
    coco = root / "coco" / "annotations"
    coco.mkdir(parents=True)
    anns = [{"id": 3 * i + j, "image_id": i, "category_id": int(c),
             "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "iscrowd": 0}
            for i, (_, labels, boxes) in enumerate(objs)
            for j, (c, b) in enumerate(zip(labels, boxes))]
    files += [root / "coco" / "val" / f"{i:012d}.jpg" for i in range(len(objs))]
    (coco / "instances_val.json").write_text(json.dumps({
        "images": [{"id": i, "file_name": f"{i:012d}.jpg", "height": hw[0], "width": hw[1]}
                   for i, (hw, _, _) in enumerate(objs)],
        "annotations": anns, "categories": [{"id": c, "name": f"c{c}"} for c in range(1, 81)]}))
    voc = root / "voc"
    (voc / "Annotations").mkdir(parents=True)
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    from diffusionvid_torch.data.coco_voc import VOC_CLASSES
    for i, (hw, labels, boxes) in enumerate(objs):
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "height").text = str(hw[0])
        ET.SubElement(size, "width").text = str(hw[1])
        for c, b in zip(labels, boxes):
            o = ET.SubElement(ann, "object")
            ET.SubElement(o, "name").text = VOC_CLASSES[c]
            bb = ET.SubElement(o, "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"), b + 1):
                ET.SubElement(bb, k).text = str(int(v))
        ET.ElementTree(ann).write(voc / "Annotations" / f"{i:06d}.xml")
    (voc / "ImageSets" / "Main" / "test.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(len(objs))))
    files += [voc / "JPEGImages" / f"{i:06d}.jpg" for i in range(len(objs))]
    city = root / "cityscapes" / "gtFine" / "val" / "city"
    city.mkdir(parents=True)
    names = {1: "person", 2: "car", 3: "bicycle"}
    for i, (hw, labels, boxes) in enumerate(objs):
        (city / f"city_{i:06d}_000019_gtFine_polygons.json").write_text(json.dumps({
            "imgHeight": hw[0], "imgWidth": hw[1], "objects": [
                {"label": names[c], "polygon": [[b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                                                [b[0], b[3]]]}
                for c, b in zip(labels, boxes)]}))
    files += [root / "cityscapes" / "leftImg8bit" / "val" / "city" /
              f"city_{i:06d}_000019_leftImg8bit.png" for i in range(len(objs))]
    if write_images:
        import cv2

        from diffusionvid_torch.data.vid_dataset import FrameAnno
        for k, path in enumerate(files):
            hw, labels, boxes = objs[k % len(objs)]
            anno = FrameAnno(boxes[:len(labels)].astype(np.float32), labels, *hw)
            path.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(path), render_frame(anno)[:, :, ::-1])
    return root


@contextlib.contextmanager
def rendered_still():
    """The still-image datasets' ``load_image`` replaced by a frame rendered
    from the image's annotation (the card's machine has no image decoder)."""
    from diffusionvid_torch.data.coco_voc import StillDataset

    def load_image(self, path):
        index = {self.image_path(i): i for i in range(len(self))}
        return render_frame(self.annos[index[path]]).astype(np.float32)

    orig, StillDataset.load_image = StillDataset.load_image, load_image
    try:
        yield
    finally:
        StillDataset.load_image = orig


def _rel(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-12))


def _tiny_heads_model(gen):
    """The depth-18 ``GeneralizedRCNN`` of 5 classes with both heads, 32
    channels wide, conditioned (``condition_mega_family``, the heads' convs
    x2 so that the masks spread over (0, 1))."""
    from diffusionvid_torch.models.mask_keypoint import KeypointHead, MaskHead
    from diffusionvid_torch.models.rcnn import GeneralizedRCNN
    model = GeneralizedRCNN(depth=18, num_classes=5, pre_nms_test=100, post_nms_test=8,
                            mask_on=True, keypoint_on=True)
    model.mask_head = MaskHead(1024, 5, (32, 32))
    model.kp_head = KeypointHead(1024, 17, (32, 32))
    model.reset_parameters(gen)
    condition_mega_family(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("mask_head.", "kp_head.")) and p.dim() == 4:
                p.mul_(2.0)
    return model.eval()


def _tiny_retinanet(gen):
    """The depth-18 RetinaNet of 4 classes, conditioned, its class logits'
    bias raised by 2.5 so that scores above 0.05 spread over the anchors."""
    from diffusionvid_torch.models.retinanet import RetinaNet
    model = RetinaNet(depth=18, num_classes=4)
    model.reset_parameters(gen)
    condition_mega_family(model, gen)
    with torch.no_grad():
        model.head.cls_logits.bias.add_(2.5)
    return model.eval()


def _grads_err(card, cpu, floor: float = 1e-4) -> tuple[float, str]:
    """The largest |card - CPU| / |CPU| over the parameters' gradients, the
    denominator at least ``floor`` x the largest gradient norm: a gradient
    that is 0 in exact arithmetic (the keypoint logits' bias, which the
    log-softmax over positions does not see) holds rounding alone."""
    grads = [(n, pc.grad.cpu(), pp.grad)
             for (n, pc), (_, pp) in zip(card.named_parameters(), cpu.named_parameters())
             if pp.grad is not None]
    top = max(float(torch.linalg.vector_norm(g)) for _, _, g in grads)
    worst, name = 0.0, ""
    for n, gc, gp in grads:
        e = float(torch.linalg.vector_norm(gc - gp)) / max(float(torch.linalg.vector_norm(gp)),
                                                           floor * top, 1e-30)
        if e > worst:
            worst, name = e, n
    return worst, name


def phase_still_image_tiny(seed: int) -> dict:
    """The still-image path at depth 18 on 64x96, card against CPU, same
    weights and inputs, fp32, TF32 off: ``GeneralizedRCNN`` with both heads
    (labels and valid masks equal; boxes, scores, masks and heatmaps within
    1e-3), RetinaNet (its detections as those), then ``mask_loss`` and
    ``keypoint_loss`` through both heads and RetinaNet's ``train_loss``:
    values within 1e-4 in fp32, and in float64 every gradient within 1e-3
    of its norm, or of 1e-4 of the largest gradient norm where that is more
    (``_grads_err``; fp32's gradient errors are printed beside).  No launch
    of K1–K7."""
    import copy

    from diffusionvid_torch.models.mask_keypoint import keypoint_loss, mask_loss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    h, w = STILL_TINY_HW
    hw = (float(h), float(w))
    images = torch.rand(2, h, w, 3, generator=gen) * 255
    res = {"hw": [h, w], "rtol": 1e-3, "loss_rtol": 1e-4, "grad_rtol": 1e-3,
           "grad_floor": 1e-4}
    reset_launches()

    cpu = _tiny_heads_model(gen)
    card = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        c_out, p_out = card(images.cuda(), hw), cpu(images, hw)
    cd, pd = c_out["dets"], p_out["dets"]
    for k in ("valid", "labels"):
        require(torch.equal(getattr(cd, k).cpu(), getattr(pd, k)),
                f"still_image_tiny rcnn: {k} differ")
    require(int(pd.valid.sum()) > 0, "still_image_tiny rcnn: no detection")
    errs = {k: _rel(getattr(cd, k), getattr(pd, k)) for k in ("boxes", "scores")}
    errs.update({k: _rel(c_out[k], p_out[k]) for k in ("masks", "keypoints")})
    require(max(errs.values()) < 1e-3, f"still_image_tiny rcnn: card vs CPU {errs}")
    res["rcnn"] = {"detections": int(pd.valid.sum()), "slots": int(pd.valid.numel()),
                   **{f"max_rel_err_{k}": v for k, v in errs.items()}}

    # the heads' losses: GT boxes jittered into proposals, random masks and keypoints
    boxes = torch.tensor([[[4, 6, 40, 50], [30, 10, 90, 60], [0, 0, 95, 63], [50, 5, 70, 20]]] * 2,
                         dtype=torch.float32) + torch.rand(2, 4, 4, generator=gen) * 4
    labels = torch.tensor([[1, 2, 0, 4], [3, 0, 2, 1]])
    valid = torch.tensor([[True, True, True, False], [True, True, True, True]])
    gt_boxes = boxes[:, :3] + torch.rand(2, 3, 4, generator=gen) * 3
    gt_masks = (torch.rand(2, 3, h, w, generator=gen) > 0.5).float()
    gt_valid = torch.tensor([[True, True, False], [True, True, True]])
    gt_labels = torch.tensor([[1, 2, 3], [4, 1, 2]])
    kps = torch.cat([boxes[:, :, None, :2] + torch.rand(2, 4, 17, 2, generator=gen) * 40,
                     torch.randint(0, 3, (2, 4, 17, 1), generator=gen).float()], -1)

    def heads_loss(model, dev):
        dt = next(model.parameters()).dtype
        feat = model.features(images.to(dev, dt)).permute(0, 2, 3, 1)
        b = boxes.to(dev, dt)
        lm = mask_loss(model.mask_head(feat, 1 / 16, b), b, labels.to(dev), valid.to(dev),
                       gt_masks.to(dev, dt), gt_boxes.to(dev, dt), None, gt_valid.to(dev))
        lk = keypoint_loss(model.kp_head(feat, 1 / 16, b), b, kps.to(dev, dt), valid.to(dev))
        (lm + lk).backward()
        return {"mask_loss": lm.item(), "keypoint_loss": lk.item()}

    def retina_loss(model, dev):
        dt = next(model.parameters()).dtype
        out = model.train_loss(images.to(dev, dt), gt_boxes.to(dev, dt), gt_labels.to(dev),
                               gt_valid.to(dev))
        sum(out.values()).backward()
        return {k: v.item() for k, v in out.items()}

    cpu_r = _tiny_retinanet(gen)
    card_r = copy.deepcopy(cpu_r).cuda()
    with torch.no_grad():
        cr, pr = card_r(images.cuda(), hw), cpu_r(images, hw)
    for k in ("valid", "labels"):
        require(torch.equal(getattr(cr, k).cpu(), getattr(pr, k)),
                f"still_image_tiny retinanet: {k} differ")
    require(int(pr.valid.sum()) > 0, "still_image_tiny retinanet: no detection")
    errs = {k: _rel(getattr(cr, k), getattr(pr, k)) for k in ("boxes", "scores")}
    require(max(errs.values()) < 1e-3, f"still_image_tiny retinanet: card vs CPU {errs}")
    res["retinanet"] = {"detections": int(pr.valid.sum()),
                        **{f"max_rel_err_{k}": v for k, v in errs.items()}}

    def to64(model):
        model = copy.deepcopy(model).double()
        model.zero_grad(set_to_none=True)
        model.compute_dtype = torch.float64
        return model

    # in fp32 the trunk's gradients differ by rounding alone (RetinaNet's by
    # 2.5e-3 of their norm at res2, the heads' by 7.8e-4 at res3, where
    # float64 on both sides agrees to 4e-8): the losses are held in fp32,
    # the gradients in float64
    cases = (("heads_losses", heads_loss, card, cpu, False),
             ("heads_losses_float64", heads_loss, to64(cpu), to64(cpu), True),
             ("retinanet_losses", retina_loss, card_r, cpu_r, False),
             ("retinanet_losses_float64", retina_loss, to64(cpu_r), to64(cpu_r), True))
    for name, fn, c_model, p_model, gate_grads in cases:
        c_l, p_l = fn(c_model.cuda(), "cuda"), fn(p_model, "cpu")
        loss_err = max(abs(c_l[k] - v) / max(abs(v), 1e-12) for k, v in p_l.items())
        grad_err, worst = _grads_err(c_model, p_model)
        require(all(np.isfinite(list(c_l.values()))) and loss_err < 1e-4
                and (grad_err < 1e-3 or not gate_grads),
                f"still_image_tiny {name}: loss {loss_err}, grad {grad_err} ({worst})")
        res[name] = {"losses": p_l, "max_rel_err_loss": loss_err, "max_rel_err_grad": grad_err,
                     "worst_grad": worst, "grads_held": gate_grads}
    torch.cuda.synchronize()
    res["launches"] = read_launches()
    require(not any(res["launches"].values()), f"still_image_tiny: launched {res['launches']}")
    emit("still_image_tiny", **res)
    return res


def _still_frames(images, seed: int):
    """Rendered frames of ``images`` (h, w) padded into their buckets, on
    the card, with their content (h, w)."""
    from diffusionvid_torch.data.transforms import frame_bucket, pad_to
    from diffusionvid_torch.data.vid_dataset import FrameAnno
    rng = np.random.RandomState(seed)
    out = []
    for hw in images:
        anno = FrameAnno(still_boxes(rng, hw, 3).astype(np.float32),
                         rng.randint(1, 81, 3).astype(np.int32), *hw)
        frame = pad_to(render_frame(anno).astype(np.float32), frame_bucket(*hw))
        out.append((torch.from_numpy(frame[None]).cuda(), (float(hw[0]), float(hw[1]))))
    return out


def still_heads_run(seed: int, name: str, opts) -> dict:
    """(a) of ``phase_still_image``: a config's model forward, image by
    image, on the rendered frames: ms an image (a warm-up pass, then two
    timed), the mask and keypoint heads' card ms on the last image's 300
    detection slots, peak memory, no launch of K1–K7."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.models.detectors import build_detection_model

    cfg = load_config(str(ROOT / "configs" / "e2e_mask_rcnn_R_50_C4_1x.yaml"), opts)
    model = build_detection_model(cfg, seed=seed)
    frames = _still_frames(STILL_IMAGES[:2] + STILL_IMAGES[-2:], seed)
    with torch.no_grad():
        for x, hw in frames:
            model(x, hw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(2):
            outs = [model(x, hw) for x, hw in frames]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = outs[-1]
        d = out["dets"].boxes.shape[1]
        require(tuple(out["masks"].shape) == (1, d, 28, 28)
                and bool(torch.isfinite(out["masks"]).all())
                and float(out["masks"].min()) >= 0 and float(out["masks"].max()) <= 1,
                f"still_image {name}: masks {tuple(out['masks'].shape)}")
        feat = model.features(frames[-1][0]).permute(0, 2, 3, 1)
        boxes = out["dets"].boxes
        row = {"config": "configs/e2e_mask_rcnn_R_50_C4_1x.yaml", "overrides": opts,
               "dtype": str(model.compute_dtype).split(".")[1], "images": len(frames),
               "ms_per_image": wall * 1e3 / (2 * len(frames)), "peak_mem_gib": peak,
               "detection_slots": d, "detections_per_image": float(
                   sum(int(o["dets"].valid.sum()) for o in outs) / len(outs)),
               "mask_head_ms": cuda_time_ms(lambda: model.mask_head(feat, 1 / 16, boxes),
                                            iters=5, warmup=1),
               "launches": launches}
        if model.kp_head is not None:
            require(tuple(out["keypoints"].shape) == (1, d, 56, 56, 17)
                    and bool(torch.isfinite(out["keypoints"]).all()),
                    f"still_image {name}: keypoints {tuple(out['keypoints'].shape)}")
            row["keypoint_head_ms"] = cuda_time_ms(
                lambda: model.kp_head(feat, 1 / 16, boxes), iters=5, warmup=1)
    require(not any(launches.values()), f"still_image {name}: launched {launches}")
    del model, frames, outs, out, feat
    torch.cuda.empty_cache()
    return row


def still_dataset_run(seed: int, name: str, config: str, opts, root: Path, kinds,
                      classes_key: str | None = None) -> dict:
    """(b) and (c) of ``phase_still_image``: ``run_inference_still`` with
    the config's model over each rendered set of ``kinds`` (a warm-up pass
    of 2 images, then the set timed), the model's classes set to the set's
    through ``classes_key`` (the VOC evaluator takes no label past the
    dataset's classes, in the JAX package neither): images/s, the
    evaluator's ms, peak memory, AP50 of random weights, no launch of
    K1–K7."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.data.catalog import get_dataset
    from diffusionvid_torch.data.coco_voc import evaluate_still
    from diffusionvid_torch.engine.inference_still import run_inference_still
    from diffusionvid_torch.evaluation.coco_eval import evaluate_coco
    from diffusionvid_torch.models.detectors import build_detection_model

    rows = {}
    with rendered_still():
        for kind in kinds:
            ds = get_dataset(STILL_SETS[kind], is_train=False, data_dir=str(root))
            extra = [classes_key, str(len(ds.classes))] if classes_key else []
            cfg = load_config(str(ROOT / "configs" / config), opts + extra)
            t0 = time.perf_counter()
            model = build_detection_model(cfg, seed=seed)
            build_s = time.perf_counter() - t0
            run_inference_still(model, ds, evaluator=kind, max_images=2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            preds, gts, results = run_inference_still(model, ds, evaluator=kind)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            require(not any(launches.values()), f"still_image {name} {kind}: launched {launches}")
            require(len(preds) == len(gts) == len(ds) and all(
                np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all() for p in preds),
                f"still_image {name} {kind}: predictions")
            t1 = time.perf_counter()
            if kind == "voc":
                evaluate_still(ds, preds)
            else:
                evaluate_coco(gts, preds, len(ds.classes) - 1)
            rows[kind] = {"overrides": opts + extra, "dtype": cfg.TPU.COMPUTE_DTYPE,
                          "model_build_s": build_s, "images": len(ds),
                          "images_per_s": len(ds) / wall, "run_s": wall,
                          "evaluator_ms": (time.perf_counter() - t1) * 1e3,
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "detections_per_image": sum(len(p["scores"]) for p in preds) / len(ds),
                          "ap50_random_weights": results["ap50"], "launches": launches}
            del model
            torch.cuda.empty_cache()
    return {"config": f"configs/{config}", "sets": rows}


def still_cli_card_vs_cpu(seed: int, work: Path) -> dict:
    """(d) of ``phase_still_image``: ``tools/test_net.main`` on a rendered
    COCO-layout set of 3 images at 64x96 with a depth-18 ``base`` model by
    ``--checkpoint`` (conditioned), on the card and on the CPU: labels
    equal, scores and boxes within 1e-3, the same AP50."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.models.detectors import build_detection_model
    from diffusionvid_torch.tools import test_net
    from diffusionvid_torch.utils.checkpoint import save_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    write_still_sets(work / "data", [STILL_TINY_HW] * 3, seed)
    config = str(ROOT / "configs" / "vid_R_101_C4_1x.yaml")
    opts = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "5", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100",
            "MODEL.RPN.POST_NMS_TOP_N_TEST", "8", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "DATASETS.TEST", "('coco_val',)"]
    model = build_detection_model(load_config(config, opts), device="cpu", seed=seed)
    condition_mega_family(model, torch.Generator().manual_seed(seed))
    ckpt = save_checkpoint(str(work / "ckpt"), 0, model.state_dict())
    out = {}
    with rendered_still():
        for dev in ("cuda", "cpu"):
            reset_launches()
            results = test_net.main(["--config-file", config, "--checkpoint", ckpt,
                                     "--data-dir", str(work / "data"), "--output-dir",
                                     str(work / dev), "--device", dev, *opts])
            with open(work / dev / "predictions.pkl", "rb") as f:
                out[dev] = (pickle.load(f), results["ap50"], read_launches())
    (card, card_ap, card_launches), (cpu, cpu_ap, _) = out["cuda"], out["cpu"]
    require(not any(card_launches.values()), f"still_image cli: launched {card_launches}")
    agree = predictions_agree(card, cpu, 1e-3, "still_image cli: card against CPU")
    require(card_ap == cpu_ap or (np.isnan(card_ap) and np.isnan(cpu_ap)),
            f"still_image cli: AP50 {card_ap} on the card, {cpu_ap} on the CPU")
    return {"images": len(card), "hw": list(STILL_TINY_HW), "launches": card_launches, **agree,
            "rtol": 1e-3, "ap50": card_ap, "ap50_cpu": cpu_ap}


def phase_still_image(seed: int) -> dict:
    """Phase 14 at full width, bf16, random weights from ``seed``:
    (a) ``configs/e2e_mask_rcnn_R_50_C4_1x.yaml`` (R-50 C4, 81 classes, the
    mask head on its 300 detection slots), and with ``KEYPOINT_ON``, through
    the model's forward on rendered 600x1000 frames (two portrait); (b)
    ``configs/vid_R_101_C4_1x.yaml`` (``base``) through
    ``run_inference_still`` over rendered COCO-, VOC- and Cityscapes-layout
    sets of 8 images; (c) RetinaNet (``vid_R_50_C4_1x`` with
    ``MODEL.RETINANET_ON``: R-50 FPN, 81 classes) over the COCO set; (d)
    the test CLI on a tiny COCO set, card against CPU.  No path launches
    K1–K7."""
    work = ROOT / "build" / "chip_smoke" / "still_image"
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line()}
    res = {}
    for name, opts in (("mask", []), ("mask_keypoint", ["MODEL.KEYPOINT_ON", "True"])):
        res[name] = still_heads_run(seed, name, opts)
        emit("still_image", path=name, **res[name], **card)
    root = write_still_sets(work / "data", STILL_IMAGES, seed)
    res["base"] = still_dataset_run(seed, "base", "vid_R_101_C4_1x.yaml", [], root,
                                    ("coco", "voc", "cityscapes"),
                                    "MODEL.ROI_BOX_HEAD.NUM_CLASSES")
    emit("still_image", path="base", **res["base"], **card)
    res["retinanet"] = still_dataset_run(seed, "retinanet", "vid_R_50_C4_1x.yaml",
                                         ["MODEL.RETINANET_ON", "True"], root, ("coco",))
    emit("still_image", path="retinanet", **res["retinanet"], **card)
    res["cli"] = still_cli_card_vs_cpu(seed, work / "cli")
    emit("still_image", path="cli_card_vs_cpu", **res["cli"], **card)
    return res


# ---------------------------------------------------------------- data parallelism

DDP_WORLD, DDP_STEPS = 2, 2


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _captured_update(opt, into: list):
    """Keep every gradient that reaches ``opt``'s update (before the clip)."""
    inner = opt._update

    def update(grads):
        into.append([g.detach().clone() for g in grads])
        inner(grads)

    opt._update = update


def _grad_err(got: list, want: list, names: list) -> tuple[float, str]:
    """The largest |got - want| / |want| over the tensors, and its name."""
    worst, name = 0.0, ""
    for g, w, n in zip(got, want, names):
        e = float(torch.linalg.vector_norm((g - w).float())
                  / torch.linalg.vector_norm(w.float()).clamp(min=1e-12))
        if e > worst:
            worst, name = e, n
    return worst, name


def _loss_err(got: list, want: list) -> float:
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for g, w in zip(got, want) for k in w)


def _ddp_setup(seed: int):
    """The R-101 flagship config, its 2-sample micro-batches of 1 + 4
    frames (ACCUMULATION_STEPS of them) on the card, and the draws of each
    optimizer step's micro-steps for both samples, as ``train_loop`` draws
    them."""
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.train import draw_train_randoms, iteration_generator

    cfg = load_config(str(ROOT / "configs" / "vid_R_101_DiffusionVID.yaml"))
    frames = 1 + cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    accum = cfg.SOLVER.ACCUMULATION_STEPS
    gen = torch.Generator().manual_seed(seed)
    batches = [train_batch(gen, DDP_WORLD, frames, cfg.TPU.MAX_GT_BOXES, TRAIN["h"], TRAIN["w"],
                           cfg.MODEL.DiffusionDet.NUM_CLASSES, "cuda") for _ in range(accum)]
    draws = [[draw_train_randoms(iteration_generator(seed, k * accum + m), DDP_WORLD, frames,
                                 cfg.MODEL.DiffusionDet.NUM_PROPOSALS, device="cuda")
              for m in range(accum)] for k in range(DDP_STEPS)]
    return cfg, batches, draws


def _rows(x, r: int):
    return type(x)(*(t[r:r + 1] for t in x))


def _ddp_rank(rank: int, world: int, port: int, seed: int, out_path: str,
              t_spawn: float) -> None:
    """A rank of ``phase_flagship_train_ddp``, joined as ``torchrun`` joins
    (the environment, then ``parallel.dist.initialize``), both ranks on
    card 0 over ``gloo``.  (1) DDP_STEPS optimizer steps of the R-101 train
    step, sample ``rank`` of each 2-sample micro-batch; after each, rank 0
    runs the same optimizer step in one process on both samples from the
    parameters the step started from (no collective), and holds the losses
    and the gradient that reaches the update against the ranks'.  (2) ``run_inference`` over
    ``flagship_eval``'s videos, the ranks as the shards, gathered.  Rank 0
    writes the results to ``out_path``."""
    t_enter = time.time()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from diffusionvid_torch.parallel import dist
    require(dist.initialize(backend="gloo"), "flagship_train_ddp: no process group")
    try:
        out = _ddp_train(seed, rank, t_enter)
        out["rank_start_s"] = t_enter - t_spawn
        out["first_step_s"] = out.pop("first_step_at") - t_spawn
        out.update(_ddp_inference(seed, rank))
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy()


def _ddp_train(seed: int, rank: int, t_enter: float) -> dict:
    from diffusionvid_torch.engine.train import (
        make_train_step, optimizer_from_config, wrap_data_parallel)
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.parallel import dist

    cfg, batches, draws = _ddp_setup(seed)
    num_global = cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    model = DiffusionDetArch.from_config(cfg, seed=seed)
    names = [n for n, _ in model.named_parameters()]
    opt = optimizer_from_config(model, cfg)
    grads = []
    _captured_update(opt, grads)
    ddp = wrap_data_parallel(model)
    step = make_train_step(ddp, opt, num_global)
    if rank == 0:
        ref = DiffusionDetArch.from_config(cfg, seed=seed)
        ref_opt = optimizer_from_config(ref, cfg)
        ref_grads = []
        _captured_update(ref_opt, ref_grads)
        ref_step = make_train_step(ref, ref_opt, num_global)
    out = {"steps": [], "first_step_at": None}
    for k in range(DDP_STEPS):
        row = {}
        before = {n: t.clone() for n, t in model.state_dict().items()}
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [{n: float(v) for n, v in
                   dist.all_reduce_mean(step(_rows(b, rank), _rows(d, rank))).items()}
                  for b, d in zip(batches, draws[k])]
        torch.cuda.synchronize()
        row["ddp_ms"] = (time.perf_counter() - t0) * 1e3
        row["launches"] = read_launches()
        if out["first_step_at"] is None:
            out["first_step_at"] = time.time()
        if rank == 0:    # one process, both samples, from the same parameters
            ref.load_state_dict(before)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref_losses = [{n: float(v) for n, v in ref_step(b, d).items()}
                          for b, d in zip(batches, draws[k])]
            torch.cuda.synchronize()
            row["single_ms"] = (time.perf_counter() - t0) * 1e3
            row["max_rel_err_loss"] = _loss_err(losses, ref_losses)
            row["max_rel_err_grad"], row["worst_grad"] = _grad_err(grads[k], ref_grads[k], names)
            row["total_loss"] = losses[-1]["total_loss"]
        out["steps"].append(row)
        del before
    require(opt.count == DDP_STEPS, f"flagship_train_ddp: {opt.count} optimizer steps")
    out["expected_launches"] = train_launches(model, cfg.SOLVER.ACCUMULATION_STEPS)
    out["find_unused_parameters"] = ddp.find_unused_parameters
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del ddp, model, opt, step, grads
    if rank == 0:
        del ref, ref_opt, ref_step, ref_grads
    torch.cuda.empty_cache()
    return out


def _ddp_inference(seed: int, rank: int) -> dict:
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.engine.inference import run_inference
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.tools.test_net import detector_args, sample_config

    cfg = load_config(str(ROOT / "configs" / "vid_R_101_DiffusionVID.yaml"))
    model = DiffusionDetArch.from_config(cfg, seed=seed)
    ds = open_eval_dataset(ROOT / "build" / "chip_smoke" / "eval" / "data")
    t0 = time.perf_counter()
    preds, _, results = run_inference(model, ds, sample_config(cfg), **detector_args(cfg),
                                      seed=seed)
    return {"inference": {"predictions": preds if rank == 0 else None,
                          "run_inference_s": time.perf_counter() - t0,
                          "ap50": None if results is None else results["ap50"]}}


def _nccl_one_rank(seed: int) -> dict:
    """The same DDP_STEPS optimizer steps in a 1-rank ``nccl`` group (the
    backend users run) on both samples and in one process without a group,
    from the same parameters: the first step's losses and gradient
    compared, every step timed."""
    from diffusionvid_torch.engine.train import (
        make_train_step, optimizer_from_config, wrap_data_parallel)
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.parallel import dist

    cfg, batches, draws = _ddp_setup(seed)
    num_global = cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    res, losses, grads = {}, {}, {}
    for kind in ("single", "nccl"):
        model = DiffusionDetArch.from_config(cfg, seed=seed)
        opt = optimizer_from_config(model, cfg)
        grads[kind] = []
        _captured_update(opt, grads[kind])
        if kind == "nccl":
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
            t0 = time.perf_counter()
            require(dist.initialize(), "flagship_train_ddp: no nccl group")
            res["nccl_init_s"] = time.perf_counter() - t0
            res["backend"] = torch.distributed.get_backend()
        try:
            step = make_train_step(wrap_data_parallel(model), opt, num_global)
            res[f"{kind}_ms"] = []
            for k in range(DDP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                done = [{n: float(v) for n, v in step(b, d).items()}
                        for b, d in zip(batches, draws[k])]
                torch.cuda.synchronize()
                res[f"{kind}_ms"].append((time.perf_counter() - t0) * 1e3)
                losses.setdefault(kind, done)
        finally:
            if kind == "nccl":
                dist.destroy()
                for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
                    os.environ.pop(var, None)
        names = [n for n, _ in model.named_parameters()]
        del model, opt, step
        torch.cuda.empty_cache()
    res["max_rel_err_loss"] = _loss_err(losses["nccl"], losses["single"])
    res["max_rel_err_grad"], res["worst_grad"] = _grad_err(grads["nccl"][0], grads["single"][0],
                                                           names)
    return res


def phase_flagship_train_ddp(seed: int) -> dict:
    """Data parallelism over ``torch.distributed`` on the card: the R-101
    flagship train step at full width, bf16, 1 + 4 frames a sample,
    ACCUMULATION_STEPS 2.  (a) 2 ``gloo`` ranks on the one card (``nccl``
    takes one rank a device), spawned here: DDP_STEPS optimizer steps, one
    sample of each 2-sample micro-batch a rank, the losses to 1e-4 and
    every gradient that reaches the update to 1e-3 relative in norm
    against one process on both samples (``phase_tiny_train``'s
    tolerances), cuDNN deterministic; then ``run_inference`` over
    ``flagship_eval``'s 2 videos with the ranks as the shards, gathered,
    against that phase's predictions before seq-NMS (1e-4 relative, as its
    shards).  (b) one optimizer step in a 1-rank ``nccl`` group against one
    process.  Prints each side's ms per optimizer step and a rank's time
    from the spawn to its start and to its first step."""
    import torch.multiprocessing as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out_path = ROOT / "build" / "chip_smoke" / "ddp_rank0.pkl"
        out_path.unlink(missing_ok=True)
        t_spawn = time.time()
        mp.start_processes(_ddp_rank, args=(DDP_WORLD, _free_port(), seed, str(out_path),
                                            t_spawn),
                           nprocs=DDP_WORLD, join=True, start_method="spawn")
        ranks_s = time.time() - t_spawn
        with open(out_path, "rb") as f:
            out = pickle.load(f)
        nccl = _nccl_one_rank(seed)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with open(ROOT / "build" / "chip_smoke" / "eval" / "raw_predictions.pkl", "rb") as f:
        raw = pickle.load(f)
    gathered = predictions_agree(out["inference"].pop("predictions"), raw, 1e-4,
                                 "flagship_train_ddp: gathered run_inference against one process")
    want = out["expected_launches"]
    res = {"config": "configs/vid_R_101_DiffusionVID.yaml", "dtype": "bfloat16",
           "ranks": DDP_WORLD, "backend": "gloo", "card": torch.cuda.get_device_name(0),
           "expected_launches_per_step": want,
           "loss_rtol": 1e-4, "grad_rtol": 1e-3, "steps": out["steps"],
           "find_unused_parameters": out["find_unused_parameters"],
           "rank_start_s": out["rank_start_s"], "first_step_s": out["first_step_s"],
           "ranks_wall_s": ranks_s, "rank0_peak_mem_gib": out["peak_mem_gib"],
           "inference": {**out["inference"], **gathered, "rtol": 1e-4},
           "nccl_one_rank": nccl, "nvidia_smi": nvidia_smi_line()}
    emit("flagship_train_ddp", **res)
    for k, row in enumerate(out["steps"]):
        require(row["max_rel_err_loss"] < 1e-4 and row["max_rel_err_grad"] < 1e-3,
                f"flagship_train_ddp: step {k}: 2 ranks against one process: loss "
                f"{row['max_rel_err_loss']}, grad {row['max_rel_err_grad']} ({row['worst_grad']})")
        require(row["launches"] == {n: want.get(n, 0) for n in row["launches"]},
                f"flagship_train_ddp: step {k} launched {row['launches']}, expected {want}")
    require(nccl["backend"] == "nccl" and nccl["max_rel_err_loss"] < 1e-4
            and nccl["max_rel_err_grad"] < 1e-3,
            f"flagship_train_ddp: 1-rank nccl against one process: {nccl}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS repeats its sums only with this workspace (read when it starts):
    # phase 10d's resumed train runs must equal the uninterrupted ones
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    register_tiny_w12()
    for mode in SWIN_MODE_KERNELS:
        phase_tiny(args.seed, "swin", mode, swin_size="w12-tiny")
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
    swin_l = phase_flagship_swin_l(args.seed)["launches"]
    swin_l_modes = {mode: phase_flagship(args.seed, "vid_Swin_B_DiffusionVID.yaml", 2,
                                         f"flagship_swin_l_{mode}", mode, opts=SWIN_L_OPTS)
                    for mode in ("v2", "v1")}
    eval_counts = phase_flagship_eval(args.seed)["launches"]
    phase_mega_family_tiny(args.seed)
    dafa_counts = phase_mega_family(args.seed)["launches"]
    phase_mega_family_rest_tiny(args.seed)
    phase_mega_family_rest(args.seed)
    phase_mega_family_train_tiny(args.seed)
    mega_keep = {"k1": [], "k2": [], "k3": []}
    mega_train = phase_mega_family_train(args.seed, mega_keep)
    phase_mega_family_train_kernels(mega_keep)
    del mega_keep
    phase_mega_family_train_cli(args.seed)
    phase_tiny_train(args.seed)
    phase_tiny_train(args.seed, "swin")
    phase_tiny_train(args.seed, "swin", "w12-tiny")
    k3_inputs = []
    launches["roi_align_bwd"] = phase_flagship_train(
        args.seed, "vid_R_101_DiffusionVID.yaml", "flagship_train", 5,
        keep={"k3": k3_inputs})["launches"]["roi_align_bwd"]
    k3_train = phase_k3_train(k3_inputs)
    del k3_inputs
    launches["window_attn_qkv"] = phase_flagship_train(
        args.seed, "vid_Swin_B_DiffusionVID.yaml", "flagship_train_swin",
        3)["launches"]["window_attn_qkv"]
    swin_l_train = phase_flagship_train(
        args.seed, "vid_Swin_B_DiffusionVID.yaml", "flagship_train_swin_l", 2, opts=SWIN_L_OPTS,
        warmup_steps=1)
    train_cli = phase_flagship_train_cli(args.seed)
    swin_l_cli = phase_flagship_train_swin_l_cli(args.seed)
    local_attn = phase_flagship_local_attn(args.seed)
    ddp = phase_flagship_train_ddp(args.seed)
    phase_still_image_tiny(args.seed)
    phase_still_image(args.seed)

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
            # the Swin-L-22k-384 train step (phase 8), its v2 stream (phase 6)
            # and its train CLI run (after phase 11)
            line[-1].update(swin_l_launches=swin_l_train["launches"][name],
                            swin_l_v2_launches=swin_l_modes["v2"]["launches"][name],
                            swin_l_cli_launches=swin_l_cli[name],
                            swin_l_bwd_ms=bf["swin_l"]["bwd_ms"],
                            swin_l_bwd_peak_gib=bf["swin_l"]["bwd_peak_gib"],
                            swin_l_library_full_ms=bf["swin_l"]["library_full_ms"])
        if name == "window_attn":
            line[-1].update(kernel_ms=bf["kernel_ms"], host_ms=bf["host_ms"],
                            v1_chunk_kernel_ms=v1_k7_ms, ptxas=k7_ptxas,
                            swin_l_launches=swin_l_modes["v1"]["launches"][name])
        if name in ("window_attn_qkv", "window_attn"):   # over one Swin-L-22k-384 pass
            line[-1].update({f"swin_l_{k}": bf["swin_l"][k] for k in
                             ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")})
        if name in ("dynamic_conv", "swin_block_mlp"):
            line[-1].update(kernel_ms=bf["kernel_ms"], unfused_ms=bf["unfused_ms"])
        if name in x4_launches:   # on the R-101 (K1, K2) and Swin-B (K4, K5) x4 streams
            line[-1]["x4_launches"] = x4_launches[name]
        if name in ("swin_block_attn", "swin_block_mlp"):   # the Swin-L-22k-384 stream
            line[-1]["swin_l_launches"] = swin_l[name]
            line[-1].update({f"swin_l_{k}": bf["swin_l"][k]
                             for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")})
        if name in ("roi_align_fwd", "dynamic_conv"):   # run_inference, R-101 x1
            line[-1]["eval_launches"] = eval_counts[name]
            line[-1]["dafa_launches"] = dafa_counts[name]   # DAFA, run_inference_video_arch
        if name in TRAIN_KERNELS:   # the train CLI's uninterrupted run
            line[-1]["train_cli_launches"] = train_cli[name]
        if name in ("roi_align_fwd", "dynamic_conv"):   # R-101 with the local attention
            line[-1]["local_attn_launches"] = local_attn["stream"][name]
        if name in TRAIN_KERNELS:   # its train step; a DDP rank's first optimizer step
            line[-1]["local_attn_train_launches"] = local_attn["train"][name]
            line[-1]["ddp_rank_launches"] = ddp["steps"][0]["launches"][name]
            # DAFA's full-width train step, a micro-step (phase 10d)
            line[-1]["mega_train_launches"] = mega_train["dafa_launches_per_micro_step"][name]
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

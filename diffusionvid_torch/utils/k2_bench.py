"""Time kernel K2 (DynamicConv) of a checkout on a CUDA card, and K1 beside it.

    python diffusionvid_torch/utils/k2_bench.py [--root DIR] [--seed N] [--iters N]
                                                [--designs]

Imports ``diffusionvid_torch`` from ``--root`` (default: the checkout this
file is in), so that two checkouts of the repository are timed on the same
inputs by one script, each in its own process; run it as a file, not with
``-m``.  Time a parent in the same call, in turns parent, change, change,
parent:

    git archive <parent> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
      python diffusionvid_torch/utils/k2_bench.py --root $r; done

The inputs are ``chip_smoke.py``'s phase 3 K2 inputs in bfloat16, drawn from
``--seed``: the proposals of an R-101 chunk (S = 2,400: 8 frames of 300) and
of a Swin-B chunk (S = 1,200: 4 frames).  K1 (ROIAlign) runs on phase 3's
K1 inputs for the same frames, which give those proposals their
features.  Each number is the median over ``--iters`` (at least 50)
launches: ``ms`` (CUDA events around each wrapper call), ``kernel_ms`` (the
card's time in the kernel, ``torch.profiler``), ``host_ms`` (the host's time
to enqueue a call, no synchronisation); K2 also with its library chain
``unfused_ms`` (``chip_smoke.k2_unfused``), its bound and, for a package
that has ``dynconv_plan``, its plan.  With ``--designs`` (a package that has
``launch_dynconv``), also both designs of K2 in bf16 on the same inputs,
the ring and the first (v1), each with its error against the plain version
and its kernel time.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
K1_KERNELS = ("roi_align_fwd_kernel",)


def event_ms(fn, iters: int) -> dict:
    """Medians over ``iters`` calls of ``fn``: ``ms`` (CUDA events around
    each call) and ``host_ms`` (the host's time to enqueue a call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    host = []
    for start, end in ev:
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
    torch.cuda.synchronize()
    return {"ms": statistics.median(s.elapsed_time(e) for s, e in ev),
            "host_ms": statistics.median(host)}


def kernel_ms(fn, kernels, iters: int) -> float:
    """The median over ``iters`` calls of ``fn`` (one launch each) of the
    card's time in the kernel whose name holds one of ``kernels``
    (``torch.profiler``).  A trace that holds no such event (seen on the
    card) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e.device_time_total / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(k in e.name for k in kernels)]
        if dev:
            return statistics.median(dev)
    raise RuntimeError(f"no device time in kernels {kernels} in three traces")


def medians(fn, kernels, iters: int) -> dict:
    return {**event_ms(fn, iters), "kernel_ms": kernel_ms(fn, kernels, iters)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--designs", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.iters < 50:
        ap.error("--iters must be at least 50")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs        # input generators and bounds of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    import diffusionvid_torch
    from diffusionvid_torch.ops import _build
    from diffusionvid_torch.ops import dynamic_conv as dc
    from diffusionvid_torch.ops import roi_align as ra
    root = Path(diffusionvid_torch.__file__).resolve().parents[1]
    if root != Path(args.root).resolve():
        raise RuntimeError(f"imported diffusionvid_torch from {root}, not {args.root}")

    dev, dtype = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = _build.build_all(["dynamic_conv", "roi_align_fwd"])
    res = {"root": args.root, "nvidia_smi": cs.nvidia_smi_line(), "sms": sms,
           "iters": args.iters, "ptxas": cs.ptxas_report(report.get("dynamic_conv", "")),
           "sizes": []}
    h, w, c, props = (cs.FLAGSHIP[k] for k in ("h", "w", "c", "props"))
    scales = (1 / 8, 1 / 16, 1 / 32)
    for s in cs.K2_SIZES:
        frames = s // props
        gen = torch.Generator().manual_seed(args.seed)
        roi, p1t, p2e, lns = cs.k2_inputs(gen, dev, dtype, s)
        call = (roi, p1t, p2e, *lns)
        want = dc.dynamic_conv_ref(*call)
        err = cs.compare(dc.dynamic_conv_fused(*call), want, 3e-2, 3e-2, f"K2 S={s}")
        bound, by = cs.k2_bound(roi, p1t, p2e, lns)
        row = {"s": s, "max_abs_err": err["max_abs_err"], "bound_ms": bound, "bound_by": by,
               **medians(lambda: dc.dynamic_conv_fused(*call), cs.K2_KERNELS, args.iters),
               "unfused_ms": event_ms(cs.k2_unfused(roi, p1t, p2e, lns), args.iters)["ms"]}
        if hasattr(dc, "dynconv_plan"):
            row["plan"] = dc.dynconv_plan(s, sms)
        if args.designs and hasattr(dc, "launch_dynconv"):
            out = torch.empty_like(roi)
            row["designs"] = {}
            for design in ("ring", "v1"):
                def launch(design=design):
                    dc.launch_dynconv(*call, out, design=design)
                launch()
                torch.cuda.synchronize()
                row["designs"][design] = {
                    "max_abs_err": float((out.float() - want.float()).abs().max()),
                    "kernel_ms": kernel_ms(launch, cs.K2_KERNELS, args.iters)}
            del out
        del roi, p1t, p2e, lns, call, want
        # K1 on the flagship maps of the same frames, at 300 ROIs a frame
        gen = torch.Generator().manual_seed(args.seed)
        feats = [torch.randn(frames, -(-h // st), -(-w // st), c, generator=gen).to(dev, dtype)
                 for st in (8, 16, 32)]
        rois = cs.flagship_rois(gen, frames, props, h, w).to(dev)
        row["k1"] = medians(lambda: ra.multilevel_roi_align(feats, rois, scales), K1_KERNELS,
                            args.iters)
        res["sizes"].append(row)
        del feats, rois
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

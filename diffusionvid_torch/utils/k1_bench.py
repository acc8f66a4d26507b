"""Time kernel K1 (multilevel ROIAlign forward) of a checkout on a CUDA card.

    python diffusionvid_torch/utils/k1_bench.py [--root DIR] [--seed N] [--iters N]
                                                [--designs] [--stream-inputs FILE]

Imports ``diffusionvid_torch`` from ``--root`` (default: the checkout this
file is in), so that two checkouts of the repository are timed on the same
inputs by one script, each in its own process; run it as a file, not with
``-m``.  Time a parent in the same call, in turns parent, change, change,
parent:

    git archive <parent> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
      python diffusionvid_torch/utils/k1_bench.py --root $r; done

The inputs are ``chip_smoke.py``'s phase 3 K1 inputs in bfloat16, drawn from
``--seed``: p3..p5 of an R-101 chunk (8 frames at 608x1024) and of a Swin-B
chunk (4 frames), 300 ``flagship_rois`` a frame; with ``--stream-inputs``
also the four launches of the R-101 x1 stream's last chunk that
``chip_smoke.py`` saves to ``build/chip_smoke/k1_stream_inputs.pt``.  Each
number is the median over ``--iters`` (at least 50) wrapper calls: ``ms``
(CUDA events around each call), ``kernel_ms`` (the card's time in the
kernel, ``torch.profiler``), ``host_ms`` (the host's time to enqueue a
call); beside them the bound and the error against the plain version.
With ``--designs`` (a package that has ``launch_k1``), also both designs in
bf16 on the same inputs, the footprint design and the first (v1), each with
its error and its kernel time.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]


def k1_row(ra, cs, feats, rois, scales, iters: int, designs: bool) -> dict:
    """K1's numbers on one set of inputs."""
    from k2_bench import kernel_ms, medians
    want = ra.multilevel_roi_align_ref(feats, rois, scales)
    got = ra.multilevel_roi_align(feats, rois, scales)
    bound, by = cs.k1_bound(feats, rois)
    row = {"rois": list(rois.shape[:2]),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "bound_ms": bound, "bound_by": by,
           **medians(lambda: ra.multilevel_roi_align(feats, rois, scales), cs.K1_KERNELS,
                     iters)}
    if designs and hasattr(ra, "launch_k1"):
        out = torch.empty_like(got)
        level = torch.empty(rois.shape[:2], dtype=torch.int32, device=rois.device)
        row["designs"] = {}
        for design in ("footprint", "v1"):
            def launch(design=design):
                ra.launch_k1(feats, rois, scales, out, level, design=design)
            launch()
            torch.cuda.synchronize()
            row["designs"][design] = {
                "max_abs_err": float((out.float() - want.float()).abs().max()),
                "kernel_ms": kernel_ms(launch, cs.K1_KERNELS, iters)}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--stream-inputs", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.iters < 50:
        ap.error("--iters must be at least 50")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(__file__).resolve().parent))   # k2_bench's timers
    import chip_smoke as cs        # input generators and bounds of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    import diffusionvid_torch
    from diffusionvid_torch.ops import _build
    from diffusionvid_torch.ops import roi_align as ra
    root = Path(diffusionvid_torch.__file__).resolve().parents[1]
    if root != Path(args.root).resolve():
        raise RuntimeError(f"imported diffusionvid_torch from {root}, not {args.root}")

    dev, dtype = torch.device("cuda"), torch.bfloat16
    report = _build.build_all(["roi_align_fwd"])
    res = {"root": args.root, "nvidia_smi": cs.nvidia_smi_line(), "iters": args.iters,
           "ptxas": cs.ptxas_report(report.get("roi_align_fwd", "")), "sizes": []}
    gen = torch.Generator().manual_seed(args.seed)   # phase 3's draws, in its order
    for frames in cs.K1_FRAMES:
        feats = cs.k1_maps(gen, dev, dtype, frames)
        rois = cs.flagship_rois(gen, frames, cs.FLAGSHIP["props"], cs.FLAGSHIP["h"],
                                cs.FLAGSHIP["w"]).to(dev)
        res["sizes"].append({"frames": frames, **k1_row(ra, cs, feats, rois, cs.K1_SCALES,
                                                         args.iters, args.designs)})
        del feats, rois
    if args.stream_inputs:
        res["stream"] = []
        for i, cap in enumerate(torch.load(args.stream_inputs)):
            feats = [f.to(dev) for f in cap["features"]]
            rois = cap["rois"].to(dev)
            res["stream"].append({"stage": i, **k1_row(ra, cs, feats, rois, cap["scales"],
                                                        args.iters, args.designs)})
        res["stream_mean"] = {k: sum(s[k] for s in res["stream"]) / len(res["stream"])
                              for k in ("ms", "kernel_ms", "host_ms", "bound_ms")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

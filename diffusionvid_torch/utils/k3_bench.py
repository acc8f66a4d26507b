"""Time kernel K3 (the ROIAlign feature gradient) of a checkout on a CUDA card.

    python diffusionvid_torch/utils/k3_bench.py [--root DIR] [--train-inputs FILE]
                                                [--seed N] [--iters N]

Imports ``diffusionvid_torch`` from ``--root`` (default: the checkout this
file is in), so that two checkouts of the repository are timed on the same
inputs by one script, each in its own process; run it as a file, not with
``-m``.  The inputs are ``chip_smoke.py``'s phase 3 cases in bfloat16 (the
train-shape case with ``flagship_rois``, the wide map, the crowded case
with ``crowded_rois``), drawn from ``--seed`` as phase 3 draws them, and,
if ``--train-inputs`` is given, the four launches of the R-101 train step's
last micro-step that ``chip_smoke.py`` saved to
``build/chip_smoke/k3_train_inputs.pt``.  Prints one JSON line: the root,
the card's name and power limit, and per case ``ms`` (the card's time in
K3's kernels a call, from ``torch.profiler``) and ``event_ms`` (CUDA events
around back-to-back calls, which a fast kernel's host side paces).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--train-inputs", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs        # input generators and timing of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    from diffusionvid_torch.ops import roi_align as ra
    import diffusionvid_torch
    require_root = Path(diffusionvid_torch.__file__).resolve().parents[1]
    if require_root != Path(args.root).resolve():
        raise RuntimeError(f"imported diffusionvid_torch from {require_root}, not {args.root}")

    dev, dtype = torch.device("cuda"), torch.bfloat16
    scales = (1 / 8, 1 / 16, 1 / 32)
    gen = torch.Generator().manual_seed(args.seed)
    cases = {}
    for name, (f, r, c, h, w, fn) in {
            "train_shape": (5, 300, 256, 608, 1024, cs.flagship_rois),
            "wide": (2, 120, 200, 296, 2400, cs.flagship_rois),
            "crowded": (5, 300, 256, 608, 1024, cs.crowded_rois)}.items():
        rois = fn(gen, f, r, h, w).to(dev)
        g = torch.randn(f, r, 49, c, generator=gen).to(dev, dtype)
        cases[name] = [(g, rois, [(-(-h // s), -(-w // s)) for s in (8, 16, 32)], scales)]
    if args.train_inputs:
        cases["train_step"] = [(c["g"].to(dev, dtype), c["rois"].to(dev), c["shapes"],
                                c["scales"]) for c in torch.load(args.train_inputs)]
    res = {"root": args.root, "nvidia_smi": cs.nvidia_smi_line(), "ms": {}, "event_ms": {}}
    for name, inputs in cases.items():
        for key, timer in (("ms", lambda f: cs.device_ms(f, cs.K3_KERNELS, args.iters)),
                           ("event_ms", lambda f: cs.cuda_time_ms(f, args.iters, 5))):
            times = [timer(lambda: ra.multilevel_roi_align_bwd(g, rois, shapes, sc, dtype))
                     for g, rois, shapes, sc in inputs]
            res[key][name] = sum(times) / len(times)
            if len(times) > 1:
                res[key][name + "_per_stage"] = times
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

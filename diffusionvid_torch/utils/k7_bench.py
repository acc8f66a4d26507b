"""Time kernel K7 (Swin window attention over pre-projected q, k, v) of a
checkout on a CUDA card.

    python diffusionvid_torch/utils/k7_bench.py [--root DIR] [--seed N] [--iters N]
                                                [--candidates]

Imports ``diffusionvid_torch`` from ``--root`` (default: the checkout this
file is in), so that two checkouts of the repository are timed on the same
inputs by one script, each in its own process; run it as a file, not with
``-m``.  The inputs are ``chip_smoke.py``'s phase 3 K7 inputs in bfloat16:
the four Swin-B stage maps of a 4-frame chunk at 608x1024, shift 0 and 3
(masked), drawn from ``--seed`` as phase 3 draws them.  Prints one JSON
line: the root, the card's name and power limit, and per stage and shift
``ms`` (CUDA events around back-to-back wrapper calls), ``kernel_ms`` (the
card's time in K7's kernel, from ``torch.profiler``), ``host_ms`` (the
host's time to enqueue a call), ``library_ms``
(``F.scaled_dot_product_attention`` over the partitioned windows) and the
bound, with their means per launch over one backbone pass (stage depths 2,
2, 18, 2).  With ``--candidates`` (a package that has ``window_plans``),
also every launch plan's ``kernel_ms`` and error against the plain version
per stage and shift, and the plan the package picks.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
PLAN_KEYS = ("group", "wpb", "stages", "blocks", "blocks_per_sm", "waves", "work", "cost")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--candidates", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs        # input generators and timing of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    import diffusionvid_torch
    from diffusionvid_torch.models.swin import shift_attn_mask
    from diffusionvid_torch.ops import window_attention as wa
    root = Path(diffusionvid_torch.__file__).resolve().parents[1]
    if root != Path(args.root).resolve():
        raise RuntimeError(f"imported diffusionvid_torch from {root}, not {args.root}")

    dev, dtype = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    frames = cs.SWIN_FRAMES
    gen = torch.Generator().manual_seed(args.seed)
    res = {"root": args.root, "nvidia_smi": cs.nvidia_smi_line(), "sms": sms, "stages": []}
    for s, st in enumerate(cs.SWIN_B_STAGES):
        x, attn, _, (hp, wp) = cs._swin_inputs(gen, dev, dtype, st, frames)
        c, heads, bias = st["c"], st["heads"], attn[4]
        q, k, v = x, *(torch.randn(x.shape, generator=gen).to(dev, dtype) for _ in range(2))
        for shift in (0, 3):
            mask = None
            if shift:
                mask = torch.from_numpy(shift_attn_mask(hp, wp, 7, shift)).to(dev).reshape(
                    hp // 7, wp // 7, 49, 49)
            call = (q, k, v, bias, mask, 7)
            nbytes = (4 * x.numel() * 2 + heads * 2401 * 4
                      + (0 if mask is None else mask.numel() * 4))
            row = {"stage": s, "shape": list(x.shape), "shift": shift, "blocks": st["depth"] / 2,
                   "ms": cs.cuda_time_ms(lambda: wa.window_attention(*call), args.iters),
                   "kernel_ms": cs.device_ms(lambda: wa.window_attention(*call),
                                             cs.K7_KERNELS, args.iters, 1),
                   "host_ms": cs.host_ms(lambda: wa.window_attention(*call), args.iters),
                   "library_ms": cs._sdpa_ms(q, k, v, bias, mask, heads, 7),
                   "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
            if args.candidates:
                want = wa.window_attention_ref(*call).float()
                picked = wa.window_plan(c, frames, hp, wp, sms)
                row["picked"] = {key: picked[key] for key in PLAN_KEYS}
                row["candidates"] = []
                out = torch.empty_like(x)
                for plan in wa.window_plans(c, frames, hp, wp, sms):
                    def launch(plan=plan):
                        wa.launch_window(q, k, v, bias, mask, out, plan)
                    launch()
                    torch.cuda.synchronize()
                    row["candidates"].append(
                        {**{key: plan[key] for key in PLAN_KEYS},
                         "max_abs_err": float((out.float() - want).abs().max()),
                         "kernel_ms": cs.device_ms(launch, cs.K7_KERNELS, args.iters, 1)})
                del want, out
            res["stages"].append(row)
        del x, attn, q, k, v
        torch.cuda.empty_cache()
    res.update(cs._pass_means(res["stages"],
                              ("ms", "kernel_ms", "host_ms", "library_ms", "bound_ms")))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

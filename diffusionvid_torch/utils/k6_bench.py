"""Time kernel K6 (Swin window attention with the qkv projection inside) of a
checkout on a CUDA card.

    python diffusionvid_torch/utils/k6_bench.py [--root DIR] [--seed N] [--iters N]
                                                [--candidates]

Imports ``diffusionvid_torch`` from ``--root`` (default: the checkout this
file is in), so that two checkouts of the repository are timed on the same
inputs by one script, each in its own process; run it as a file, not with
``-m``.  The inputs are ``chip_smoke.py``'s phase 3 K6 inputs in bfloat16:
the four Swin-B stage maps of a 5-frame train sample at 608x1024, shift 0
and 3 (masked), drawn from ``--seed`` as phase 3 draws them.  Prints one
JSON line: the root, the card's name and power limit, and per stage and
shift ``ms`` (CUDA events around back-to-back wrapper calls),
``kernel_ms`` (the card's time in K6's kernel, from ``torch.profiler``) and
``library_full_ms`` (``chip_smoke.k6_library``: one ``F.linear`` plus
``F.scaled_dot_product_attention``), with their means per launch over one
backbone pass (stage depths 2, 2, 18, 2).  With ``--candidates`` (a
package that has ``qkv_plans``), also every launch plan's ``kernel_ms``
and error against the plain version per stage and shift, and the plan
the package picks.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
PLAN_KEYS = ("wpb", "hsplit", "kc", "stages", "blocks", "waves", "work", "cost")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--candidates", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_bench: no CUDA device", file=sys.stderr)
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
    frames = cs.TRAIN["frames"]
    gen = torch.Generator().manual_seed(args.seed)
    res = {"root": args.root, "nvidia_smi": cs.nvidia_smi_line(), "sms": sms, "stages": []}
    for s, st in enumerate(cs.SWIN_B_STAGES):
        x, attn, _, (hp, wp) = cs._swin_inputs(gen, dev, dtype, st, frames)
        c, heads = st["c"], st["heads"]
        wqkv, bqkv, bias = attn[2], attn[3], attn[4]
        for shift in (0, 3):
            mask = None
            if shift:
                mask = torch.from_numpy(shift_attn_mask(hp, wp, 7, shift)).to(dev).reshape(
                    hp // 7, wp // 7, 49, 49)
            call = (x, wqkv, bqkv, bias, mask, 7, heads)
            row = {"stage": s, "shape": list(x.shape), "shift": shift, "blocks": st["depth"] / 2,
                   "ms": cs.cuda_time_ms(lambda: wa.window_attention_qkv(*call), args.iters),
                   "kernel_ms": cs.device_ms(lambda: wa.window_attention_qkv(*call),
                                             cs.K6_KERNELS, args.iters, 1),
                   "library_full_ms": cs.cuda_time_ms(
                       cs.k6_library(x, wqkv, bqkv, bias, mask, heads, 7), args.iters)}
            if args.candidates:
                want = wa.window_attention_qkv_ref(*call).float()
                picked = wa.qkv_plan(c, frames, hp, wp, sms)
                row["picked"] = {k: picked[k] for k in PLAN_KEYS}
                row["candidates"] = []
                out = torch.empty_like(x)
                for plan in wa.qkv_plans(c, frames, hp, wp, sms):
                    def launch(plan=plan):
                        wa.launch_qkv(x, wqkv, bqkv, bias, mask, out, heads, plan)
                    launch()
                    torch.cuda.synchronize()
                    row["candidates"].append(
                        {**{k: plan[k] for k in PLAN_KEYS},
                         "max_abs_err": float((out.float() - want).abs().max()),
                         "kernel_ms": cs.device_ms(launch, cs.K6_KERNELS, args.iters, 1)})
                del want, out
            res["stages"].append(row)
        del x, attn
        torch.cuda.empty_cache()
    res.update(cs._pass_means(res["stages"], ("ms", "kernel_ms", "library_full_ms")))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

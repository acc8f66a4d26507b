"""Time kernel K5 (the Swin MLP half-block) of a checkout on a CUDA card.

    python diffusionvid_torch/utils/k5_bench.py [--root DIR] [--seed N] [--iters N]
                                                [--paths] [--candidates]

Imports ``diffusionvid_torch`` from ``--root`` (default: the checkout this
file is in), so that two checkouts of the repository are timed on the same
inputs by one script, each in its own process; run it as a file, not with
``-m``.  The inputs are ``chip_smoke.py``'s phase 3 K5 inputs in bfloat16:
the four Swin-B stage maps of a 4-frame chunk at 608x1024, drawn from
``--seed`` as phase 3 draws them.  Prints one JSON line: the root, the
card's name and power limit, and per stage ``ms`` (CUDA events around
back-to-back wrapper calls), ``kernel_ms`` (the card's time in K5's
kernels, from ``torch.profiler``), ``host_ms`` (the host's time to enqueue
a call), ``unfused_ms`` (``chip_smoke.k5_unfused``,
the library chain) and, for a package that has ``mlp_plan``, the plan; then
their means per launch over one backbone pass (stage depths 2, 2, 18, 2).

With ``--paths`` (a package that has ``launch_mlp``), also both designs,
the fused kernel and the wgmma path, at C = 128, 256, 384, 512 and 1024
(Swin-B's stage 0 and 1 maps, Swin-T's stage-2 map at 608x1024 over 4
frames, Swin-B's stages 2 and 3): their error against the plain version
and their kernel time, the numbers behind the width at which ``mlp_plan``
switches designs.  With
``--candidates``, every product plan of ``mlp_gemm_plans`` at Swin-B's
stages 2 and 3, each product's kernel time by kernel name, the other
product at its picked plan.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
PLAN_KEYS = ("bn", "stages", "blocks_per_sm", "tiles", "waves", "cost")
# Swin-B's stage maps; C = 384 has none: Swin-T's stage 2 at 608x1024
PATH_CASES = [dict(hw=(152, 256), c=128), dict(hw=(76, 128), c=256), dict(hw=(38, 64), c=384),
              dict(hw=(38, 64), c=512), dict(hw=(19, 32), c=1024)]


def kernel_times(fn, names, iters: int) -> dict:
    """The card's time a call of ``fn`` spends in each kernel whose name
    holds one of ``names`` (``torch.profiler``), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(k in e.name for k in names):
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / iters / 1e3
    return out


def host_ms(fn, iters: int) -> float:
    """The host's time to enqueue a call of ``fn`` (no synchronisation
    inside the window): where it exceeds the card's, it sets the pace of
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--candidates", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs        # input generators and timing of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    import diffusionvid_torch
    from diffusionvid_torch.ops import _build
    from diffusionvid_torch.ops import swin_attention as sa
    root = Path(diffusionvid_torch.__file__).resolve().parents[1]
    if root != Path(args.root).resolve():
        raise RuntimeError(f"imported diffusionvid_torch from {root}, not {args.root}")

    dev, dtype = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = _build.build_all(["swin_block_mlp"]).get("swin_block_mlp", "")
    res = {"root": args.root, "nvidia_smi": cs.nvidia_smi_line(), "sms": sms,
           "ptxas": cs.ptxas_report(report), "stages": []}
    gen = torch.Generator().manual_seed(args.seed)
    tol = cs.TOLERANCE_BF16["swin_block_mlp"]
    for s, st in enumerate(cs.SWIN_B_STAGES):
        x, _, mlp, _ = cs._swin_inputs(gen, dev, dtype, st, cs.SWIN_FRAMES)
        c, m = st["c"], x.numel() // st["c"]
        call = (x, *mlp)
        row = {"stage": s, "shape": list(x.shape), "blocks": st["depth"],
               "ms": cs.cuda_time_ms(lambda: sa.swin_block_mlp(*call), args.iters),
               "kernel_ms": sum(kernel_times(lambda: sa.swin_block_mlp(*call),
                                             cs.K5_KERNELS, args.iters).values()),
               "host_ms": host_ms(lambda: sa.swin_block_mlp(*call), args.iters),
               "unfused_ms": cs.cuda_time_ms(cs.k5_unfused(x, mlp), args.iters)}
        if hasattr(sa, "mlp_plan"):
            row["plan"] = sa.mlp_plan(c, m, sms)
        if args.candidates and hasattr(sa, "mlp_gemm_plans") and c >= sa.MLP_WGMMA_MIN_C:
            picked = sa.mlp_plan(c, m, sms)
            want = sa.swin_block_mlp_ref(*call).float()
            out = torch.empty_like(x)
            row["candidates"] = []
            for prod, n, k in (("fc1", 4 * c, c), ("fc2", c, 4 * c)):
                for cand in sa.mlp_gemm_plans(m, n, k, prod == "fc1", sms):
                    plan = {**picked, prod: cand}
                    def launch(plan=plan):
                        sa.launch_mlp(*call, out, plan=plan)
                    launch()
                    torch.cuda.synchronize()
                    row["candidates"].append(
                        {"product": prod, **{key: cand[key] for key in PLAN_KEYS},
                         "max_abs_err": float((out.float() - want).abs().max()),
                         "kernel_ms": kernel_times(launch, cs.K5_KERNELS, args.iters)})
            del want, out
        res["stages"].append(row)
        del x, mlp, call
        torch.cuda.empty_cache()
    res.update(cs._pass_means(res["stages"], ("ms", "kernel_ms", "host_ms", "unfused_ms")))
    if args.paths:
        res["paths"] = []
        for case in PATH_CASES:
            c = case["c"]
            st = dict(hw=case["hw"], c=c, heads=c // 32)
            x, _, mlp, _ = cs._swin_inputs(gen, dev, dtype, st, cs.SWIN_FRAMES)
            m = x.numel() // c
            want = sa.swin_block_mlp_ref(x, *mlp)
            out = torch.empty_like(x)
            for path in ("fused", "wgmma"):
                plan = sa.mlp_plan(c, m, sms, path=path)
                def launch(plan=plan):
                    sa.launch_mlp(x, *mlp, out, plan=plan)
                launch()
                torch.cuda.synchronize()
                err = cs.compare(out, want, *tol, f"K5 {path} C={c}")
                res["paths"].append(
                    {"c": c, "shape": list(x.shape), "path": path, "plan": plan,
                     "max_abs_err": err["max_abs_err"],
                     "kernel_ms": sum(kernel_times(launch, cs.K5_KERNELS,
                                                   args.iters).values())})
            del x, mlp, want, out
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the data-parallel train step with DDP and with one all-reduce of the gradient.

    python -m diffusionvid_torch.utils.ddp_bench [--ranks W] [--steps N] [--warmup N]
                                                [--config FILE] [--seed N] [--device cpu]
                                                [--out FILE] [KEY VALUE ...]

Spawns W ranks (default: one a card), joined as ``torchrun`` joins them
(the environment, then ``parallel.dist.initialize``: ``nccl``, rank r on
card r; ``gloo`` with ``--device cpu``).  Every rank builds the config's
model with random weights from ``--seed`` and trains one sample a
micro-step, ACCUMULATION_STEPS micro-steps an optimizer step, on random
frames with 1 to 8 random GT boxes (``chip_smoke.train_batch``; 608x1024 on
the card, 64x96 on the CPU), the draws of ``train_loop``.  The gradient is
averaged over the ranks in two ways, on the same weights, batches and
draws:

  * ``ddp``: ``engine/train.py: wrap_data_parallel`` and
    ``make_train_step``, as the train CLI runs it: the micro-steps before
    an optimizer step's last under ``no_sync``, the last one's backward
    all-reducing the gradient bucket by bucket while it runs;
  * ``explicit``: no wrapper; after the last micro-step the accumulated
    gradient is all-reduced in one flat buffer before the clip, with
    nothing to overlap.

Rank 0 prints one JSON line (and writes it to ``--out``): the card's name
and power limit, the ranks and backend, per way the ms of every timed
optimizer step (CUDA-synchronised wall time between barriers) and their
median, and the largest relative difference in norm between the two ways'
gradients at the first update, which must be within 1e-3.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="default: the cards (2 with --device cpu)")
    ap.add_argument("--steps", type=int, default=4, help="timed optimizer steps a way")
    ap.add_argument("--warmup", type=int, default=1, help="warm-up optimizer steps a way")
    ap.add_argument("--config", default=str(HERE / "configs" / "vid_R_101_DiffusionVID.yaml"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="'cpu' for gloo ranks on the CPU")
    ap.add_argument("--out", default=None)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _explicit_update(opt, world: int):
    """Wrap ``opt._update``: all-reduce the accumulated gradient in one flat
    buffer a dtype, then divide by the ranks, before the clip."""
    inner = opt._update

    def update(grads):
        for dtype in {g.dtype for g in grads}:
            mine = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in mine])
            torch.distributed.all_reduce(flat)
            flat /= world
            for g, t in zip(mine, flat.split([g.numel() for g in mine])):
                g.copy_(t.view_as(g))
        inner(grads)

    opt._update = update


def _one_way(way: str, args, cfg, dev, rank: int, world: int) -> tuple[list, list]:
    """``args.warmup`` + ``args.steps`` optimizer steps of ``way``: the
    timed steps' ms and the gradient of the first update."""
    import chip_smoke as cs
    from diffusionvid_torch.engine.train import (
        draw_train_randoms, iteration_generator, make_train_step, optimizer_from_config,
        wrap_data_parallel)
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.parallel import dist

    model = DiffusionDetArch.from_config(cfg, device=dev, seed=args.seed)
    opt = optimizer_from_config(model, cfg)
    first = []
    inner = opt._update

    def keep(grads):
        if not first:
            first.extend(g.detach().clone() for g in grads)
        inner(grads)

    opt._update = keep
    if way == "ddp":
        net = wrap_data_parallel(model)
    else:
        net = model
        _explicit_update(opt, world)
    step = make_train_step(net, opt, cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL)
    frames = 1 + cfg.MODEL.VID.MEGA.REF_NUM_GLOBAL
    h, w = (cs.TRAIN["h"], cs.TRAIN["w"]) if dev.type == "cuda" else (64, 96)
    gen = torch.Generator().manual_seed(args.seed)
    accum = max(1, cfg.SOLVER.ACCUMULATION_STEPS)
    batches = [cs.train_batch(gen, world, frames, cfg.TPU.MAX_GT_BOXES, h, w,
                              cfg.MODEL.DiffusionDet.NUM_CLASSES, dev) for _ in range(accum)]
    ms = []
    for k in range(args.warmup + args.steps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        for m in range(accum):
            it = k * accum + m
            draws = draw_train_randoms(iteration_generator(args.seed, it), world, frames,
                                       cfg.MODEL.DiffusionDet.NUM_PROPOSALS,
                                       p_uncond=model.head.p_uncond, device=dev)
            step(type(batches[m])(*(x[rank:rank + 1] for x in batches[m])),
                 type(draws)(*(x[rank:rank + 1] for x in draws)))
        _sync(dev)
        if k >= args.warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
    del net, step, model, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ms, first


def run_rank(rank: int, world: int, port: int, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from diffusionvid_torch.config import load_config
    from diffusionvid_torch.parallel import dist
    from diffusionvid_torch.utils.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device == "cpu":
        torch.set_num_threads(1)
    if not dist.initialize(args.device, timeout_s=600):
        raise RuntimeError(f"rank {rank}: no process group")
    try:
        dev = resolve_device(args.device)
        cfg = load_config(args.config, list(args.opts))
        res = {}
        grads = {}
        for way in ("ddp", "explicit"):
            ms, grads[way] = _one_way(way, args, cfg, dev, rank, world)
            res[way] = {"ms_per_optimizer_step": ms, "median_ms": statistics.median(ms)}
        err = 0.0
        for a, b in zip(grads["ddp"], grads["explicit"]):
            err = max(err, float(torch.linalg.vector_norm((a - b).float())
                                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-12)))
        if rank == 0:
            line = {"config": os.path.relpath(args.config, HERE), "opts": list(args.opts),
                    "ranks": world, "backend": torch.distributed.get_backend(),
                    "device": str(dev), "card": (torch.cuda.get_device_name(dev)
                                                 if dev.type == "cuda" else "cpu"),
                    "nvidia_smi": (cs.nvidia_smi_line() if dev.type == "cuda"
                                   else "not measured"),
                    "accumulation_steps": cfg.SOLVER.ACCUMULATION_STEPS,
                    "warmup_steps": args.warmup, **res,
                    "explicit_over_ddp": res["explicit"]["median_ms"] / res["ddp"]["median_ms"],
                    "max_rel_grad_diff": err}
            print(json.dumps(line), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(line) + "\n")
        if err >= 1e-3:
            raise RuntimeError(f"rank {rank}: the two ways' gradients differ by {err}")
    finally:
        dist.destroy()


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    args = parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("ddp_bench: no CUDA device (--device cpu for gloo on the CPU)", file=sys.stderr)
        return 2
    world = args.ranks or (torch.cuda.device_count() if args.device != "cpu" else 2)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(run_rank, args=(world, port, args), nprocs=world, join=True,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())

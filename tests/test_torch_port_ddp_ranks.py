"""The rank processes of ``test_torch_port_ddp.py`` (no test here).

A module of its own, without JAX, so that a spawned rank imports only
torch and the port.  ``run_rank`` joins the group as ``torchrun`` would
have it join (the environment variables, then ``parallel.dist.initialize``
on the CPU, ``gloo``) and runs every job of the spec, writing its results
under the spec's directory.
"""

import os
import pickle
from pathlib import Path

import torch


def run_rank(rank: int, world: int, port: int, spec_path: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from diffusionvid_torch.parallel import dist
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    # a collective that waits longer than this fails the job instead of the suite
    assert dist.initialize("cpu", timeout_s=120)
    assert dist.world_size() == world and dist.rank() == rank
    out = Path(spec["out"])
    try:
        results = {"train_step": train_step(spec["train_step"]),
                   "train_step_local": train_step(spec["train_step_local"]),
                   "inference": inference(spec["inference"]),
                   "cli": cli(spec["cli"], rank),
                   "val_failure": val_failure(spec["val_failure"], rank)}
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy()


def train_step(spec: dict) -> dict:
    """One optimizer step (ACCUMULATION_STEPS 2) of the DDP-wrapped model:
    the gradient that reaches the update, the logged losses, the number of
    all-reduces in each micro-step and the parameters after the update."""
    from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

    from diffusionvid_torch.engine import train
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    from diffusionvid_torch.parallel import dist

    model = DiffusionDetArch(**spec["arch"], compute_dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    opt = train.make_optimizer(model, accumulation_steps=2, warmup_iters=0)
    grads, inner = [], opt._update

    def update(g):
        grads.append([x.clone() for x in g])
        inner(g)

    opt._update = update
    ddp = train.wrap_data_parallel(model)
    reduces = [0]

    def counted(state, bucket):
        reduces[0] += 1
        return allreduce_hook(state, bucket)

    ddp.register_comm_hook(None, counted)
    step = train.make_train_step(ddp, opt, spec["num_global"])
    metrics, per_step = [], []
    r = dist.rank()
    for batch, draws in spec["micro"]:
        reduces[0] = 0
        mine = [x[r:r + 1] for x in batch], [x[r:r + 1] for x in draws]
        got = step(train.TrainBatch(*mine[0]), train.TrainDraws(*mine[1]))
        metrics.append({k: float(v) for k, v in dist.all_reduce_mean(got).items()})
        per_step.append(reduces[0])
    names = [n for n, _ in model.named_parameters()]
    return {"grads": dict(zip(names, grads[0])), "metrics": metrics, "reduces": per_step,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "find_unused": ddp.find_unused_parameters, "count": opt.count}


def inference(spec: dict) -> dict:
    """``run_inference`` with the ranks as the shards, each video's noise
    handed over from ``spec["draws"]`` by its video index."""
    from diffusionvid_torch.data import SampleConfig, VIDDataset
    from diffusionvid_torch.engine import inference as inf
    from diffusionvid_torch.engine.streaming import StreamingDetector
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch

    model = DiffusionDetArch(**spec["arch"], compute_dtype=torch.float32)
    model.load_state_dict(spec["state"], strict=True)
    model.eval()
    ds = VIDDataset(*spec["dataset"], is_train=False, use_cache=False)
    video_of = {inf.video_seed(spec["run"]["seed"], v): v for v in range(len(spec["draws"]))}
    queues = {v: list(d) for v, d in enumerate(spec["draws"])}
    videos = []

    def noise(self, state, shape):
        v = video_of[state.rng.initial_seed()]
        if v not in videos:
            videos.append(v)
        return torch.from_numpy(queues[v].pop(0)).reshape(shape)

    inner, StreamingDetector.noise = StreamingDetector.noise, noise
    try:
        preds, gts, results = inf.run_inference(model, ds, SampleConfig(**spec["scfg"]),
                                                use_seq_nms=True, output_dir=spec["output_dir"],
                                                **spec["run"])
    finally:
        StreamingDetector.noise = inner
    return {"predictions": preds, "gts": gts, "results": results, "videos": videos,
            "left": sum(len(queues[v]) for v in videos)}


def cli(spec: dict, rank: int) -> dict:
    """The train CLI for ``MAX_ITER`` 2, then ``--resume`` to 3, recording
    which ranks write checkpoints."""
    from diffusionvid_torch.engine import train
    from diffusionvid_torch.tools import train_net

    writers, inner = [], train.save_checkpoint

    def save(output_dir, step, *args, **kw):
        writers.append((rank, step))
        return inner(output_dir, step, *args, **kw)

    train.save_checkpoint = save
    first = train_net.main(spec["argv"] + ["SOLVER.MAX_ITER", "2"])
    resumed = train_net.main(["--resume"] + spec["argv"] + ["SOLVER.MAX_ITER", "3"])
    return {"first": first, "resumed": resumed, "writers": writers}


def val_failure(spec: dict, rank: int) -> dict:
    """The train CLI validating every iteration while rank 1's validation
    raises before ``run_inference`` gathers: what each rank raised, and
    when."""
    from diffusionvid_torch.engine import inference as inf
    from diffusionvid_torch.tools import train_net

    inner, calls = inf.iter_test_videos, []

    def videos(*args, **kw):
        calls.append(rank)
        if rank == 1:
            raise RuntimeError("injected validation failure")
        return inner(*args, **kw)

    inf.iter_test_videos = videos
    try:
        train_net.main(spec["argv"])
    except Exception as e:
        return {"raised": type(e).__name__, "message": str(e), "validations": len(calls)}
    finally:
        inf.iter_test_videos = inner
    return {"raised": None, "validations": len(calls)}

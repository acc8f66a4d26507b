"""Train DiffusionVID and the MEGA family with the PyTorch port.

Port of ``tools/train_net.py`` (the reference's ``tools/train_net.py:154-243``)
for the diffusion method and the MEGA family's ``base``, ``dff``,
``fgfa``, ``rdn``, ``mega`` and ``dafa``: the config and its ``KEY VALUE``
overrides; ``config.yml`` and a log with the environment in ``OUTPUT_DIR``;
the model from the config with random weights from ``--seed``, then
``--pretrained`` or ``MODEL.WEIGHT`` over them with the class head kept
fresh; the optimizer of ``engine/train.py: optimizer_from_config``; train
samples read from ``DATASETS.TRAIN`` on disk (with the SSD augmentation
when ``INPUT.TRANSFORM`` is set), one a batch, in aspect-ratio groups, in
the method's frame layout (``MethodSampleSpec``); the iterations of
``engine/train.py: train_loop`` with the method's loss
(``engine/train_methods.py`` for the MEGA family), with the batch-reuse
swap, a log line and a ``metrics.jsonl`` record every 20 iterations,
periodic validation through ``run_inference`` (the MEGA family:
``run_inference_video_arch`` over 5 videos) and checkpoints; ``--resume``
from the last checkpoint.  RetinaNet and ``MASK_ON`` / ``KEYPOINT_ON``
raise, naming ROADMAP.md A8.6 (``models/detectors.py: check_trainable``).

    python -m diffusionvid_torch.tools.train_net \\
        --config-file configs/vid_R_101_DiffusionVID.yaml --data-dir DATA \\
        [--pretrained FILE] [--resume] [SOLVER.MAX_ITER 1000]

Every random draw of an iteration derives from the iteration's index: the
samples of the batch loaded at iteration ``it`` from
``RandomState((1000003 * it + 12345) % (2**31 - 1))``, the reuse swap from
``RandomState((7654321 + it) % (2**31 - 1))``, the step's noise and
timesteps (the MEGA family: its samplers' seeds) from
``iteration_generator(seed, it)``.  So a run resumed from a
checkpoint at a multiple of ``BATCH_REUSE_STEPS`` continues the
uninterrupted run bit for bit on the CPU.

Data parallel under ``torchrun --nproc_per_node W -m
diffusionvid_torch.tools.train_net ...``: the W ranks play the part of the
JAX CLI's mesh of W devices (``TPU.MESH_DP``, if set above 1, must be W).
Each batch of W indices comes from the same aspect-ratio batches, rank r
builds sample r from ``RandomState`` seed ``(1000003 * it + 12345 + r) %
(2**31 - 1)`` (the JAX CLI draws all W samples from one ``RandomState`` in
turn: ROADMAP.md C), takes the r-th of the reuse swap's draws and row r of
the step's draws, which are the JAX CLI's.  Rank 0 alone writes
``config.yml``, the log, ``metrics.jsonl`` and the checkpoints; every rank
resumes from the same checkpoint; validation runs sharded by rank and rank
0 evaluates the merged predictions.

Without ``--device`` it runs on the card (``cuda:LOCAL_RANK`` under
``torchrun``) and raises when there is none; ``--device cpu`` runs the
kernels' plain versions on the CPU (over ``gloo`` under ``torchrun``).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time

import numpy as np
import torch

from ..config import load_config
from ..data import (ConcatDataset, PrefetchIterator, SampleConfig, aspect_ratio_group_ids,
                    get_dataset, grouped_batches)
from ..data.sampling import MethodSampleSpec
from ..engine.inference import run_inference
from ..engine.inference_mega import run_inference_video_arch
from ..engine.train import (
    TrainBatch, optimizer_from_config, resume, train_loop, wrap_data_parallel)
from ..engine.train_methods import draw_method_randoms, make_method_loss_fn
from ..models.detectors import (build_detection_model, check_trainable, is_diffusion,
                                video_method)
from ..models.diffusion_det import DiffusionDetArch, local_stages
from ..parallel import dist
from ..utils.checkpoint import last_checkpoint
from ..utils.collect_env import collect_env_info
from ..utils.convert import load_weights_into, weight_path
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger, log_to_file, setup_logger
from ..utils.metrics_io import MetricsWriter
from ..utils.profiling import StepProfiler
from .test_net import detector_args, sample_config

LOG_PERIOD = 20        # iterations between log lines and metrics.jsonl records
VAL_MAX_VIDEOS = 20    # videos a periodic validation runs over (DiffusionVID)
VAL_MAX_VIDEOS_METHODS = 5   # the MEGA family's
# the methods whose C4 trunk nests under ``detector``: a trunk file matches
# none of their tensors, in the JAX package's loader as in the port's
NESTED_TRUNK = ("dff", "fgfa", "rdn", "mega")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DiffusionVID training (PyTorch port)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue from OUTPUT_DIR's last checkpoint")
    parser.add_argument("--pretrained", default=None,
                        help="weights to start from (.pth or .pkl, utils/convert.py); "
                             "the class head is re-initialized")
    parser.add_argument("--no-prefetch", action="store_true",
                        help="build samples in the training thread")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of iterations "
                             "start+10 to start+14 here")
    parser.add_argument("--device", default=None,
                        help="default: the card, raising without one; 'cpu' for tests")
    parser.add_argument("--seed", type=int, default=0,
                        help="the random weights' and the step draws' seed")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def method_spec(cfg):
    """The MEGA family's sample layout of the config; None for DiffusionVID."""
    return None if is_diffusion(cfg) else MethodSampleSpec.from_config(cfg)


def train_sample_config(cfg) -> SampleConfig:
    """The train samples' layout and transforms of the config: DiffusionVID
    with the local attention (ATTENTION.ENABLE) takes REF_NUM_LOCAL local
    refs after the current frame, ahead of the global refs
    (box_head.py:325-346); the MEGA family's layout is ``method_spec``'s."""
    mega = cfg.MODEL.VID.MEGA
    min_train = cfg.INPUT.MIN_SIZE_TRAIN
    return SampleConfig(
        num_global=mega.REF_NUM_GLOBAL,
        num_local=mega.REF_NUM_LOCAL if is_diffusion(cfg) and local_stages(cfg) > 0 else 0,
        local_min_offset=mega.MIN_OFFSET, local_max_offset=mega.MAX_OFFSET,
        min_size=tuple(min_train) if isinstance(min_train, (tuple, list)) else min_train,
        max_size=cfg.INPUT.MAX_SIZE_TRAIN, transform=bool(cfg.INPUT.TRANSFORM),
        pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN))


def build_model(cfg, args, logger):
    """The model with random weights from ``args.seed``, then
    ``--pretrained`` (or ``MODEL.WEIGHT``) over them, ``class_logits`` and
    ``cls_score`` kept fresh.  A file that matches no tensor raises: for
    DFF, FGFA, RDN and MEGA a trunk file is such a file, as the JAX
    package's loader copies none of it (ROADMAP.md §C 5).  Returns (model,
    tensors loaded)."""
    if is_diffusion(cfg):
        model = DiffusionDetArch.from_config(cfg, device=args.device, seed=args.seed)
    else:
        model = build_detection_model(cfg, device=args.device, seed=args.seed)
    pretrained = args.pretrained or weight_path(cfg.MODEL.WEIGHT)
    if not pretrained:
        return model, 0
    method = video_method(cfg)
    try:
        loaded = load_weights_into(model, pretrained, skip_keys=("class_logits", "cls_score"))
    except ValueError as e:
        if method not in NESTED_TRUNK:
            raise
        raise ValueError(
            f"{e}: VID.METHOD {method} nests its trunk under 'detector', so a trunk file "
            f"copies nothing into it, in the JAX package's loader too (ROADMAP.md §C 5); "
            f"train from random weights (MODEL.WEIGHT \"''\")") from e
    logger.info(f"pretrained load from {pretrained}: {loaded} tensors copied (class head fresh)")
    return model, loaded


def sample_seed(it: int, rank: int = 0) -> int:
    """The ``RandomState`` seed of the samples that rank ``rank`` loads at
    iteration ``it``; rank 0's is the JAX CLI's."""
    return (1000003 * it + 12345 + rank) % (2 ** 31 - 1)


def sample_batches(ds: ConcatDataset, batch_iter, cfg: SampleConfig, start_iter: int,
                   reuse_steps: int, rank: int = 0, world: int = 1, spec=None):
    """The batches loaded from ``start_iter`` on, one every ``reuse_steps``
    iterations: the samples of ``batch_iter``'s next indices (with W ranks,
    the rank's one of each W), drawn from a RandomState seeded from the
    iteration that loads them and the rank, in ``spec``'s layout (None:
    DiffusionVID's)."""
    it = start_iter
    while True:
        rng = np.random.RandomState(sample_seed(it, rank))
        indices = next(batch_iter)
        yield [ds.sample(i, rng, cfg, spec) for i in indices[rank::world]]
        it = (it // reuse_steps + 1) * reuse_steps


def reuse_swap(samples, it: int, first_global: int, rank: int = 0) -> None:
    """Batch reuse (the reference's engine/trainer.py:107-124): swap each
    sample's current frame, in place, with a global ref drawn from a
    RandomState seeded from the iteration, so the same loaded batch trains
    another step.  Rank r's sample takes the r-th draw, as the JAX CLI's
    sample r does (every sample has the same frames)."""
    rng = np.random.RandomState((7654321 + it) % (2 ** 31 - 1))
    for _ in range(rank):
        rng.randint(first_global, samples[0]["images"].shape[0])
    for smp in samples:
        j = rng.randint(first_global, smp["images"].shape[0])
        for key in ("images", "gt_boxes", "gt_labels", "gt_valid"):
            smp[key][[0, j]] = smp[key][[j, 0]]


def iteration_samples(batches, start_iter: int, max_iter: int, reuse_steps: int,
                      first_global: int, rank: int = 0):
    """The samples of each iteration ``start_iter .. max_iter - 1``: a new
    batch at iterations that are multiples of ``reuse_steps`` (and at the
    first), otherwise the last one with its frames swapped."""
    samples = None
    for it in range(start_iter, max_iter):
        if samples is None or it % reuse_steps == 0:
            samples = next(batches)
        else:
            reuse_swap(samples, it, first_global, rank)
        yield samples


def collate(samples, device) -> TrainBatch:
    """Samples → a ``TrainBatch`` on ``device`` (labels as int64)."""
    def stack(key, dtype=None):
        t = torch.from_numpy(np.stack([s[key] for s in samples]))
        return (t if dtype is None else t.to(dtype)).to(device)

    return TrainBatch(images=stack("images"), gt_boxes=stack("gt_boxes"),
                      gt_labels=stack("gt_labels", torch.int64), gt_valid=stack("gt_valid"),
                      whwh=stack("whwh"))


def main(argv=None) -> dict:
    """Train; returns the first and last iterations, the tensors loaded
    from pretrained weights, the last iteration's metrics and the last
    checkpoint's path."""
    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    check_trainable(cfg)
    started = not dist.is_initialized() and dist.initialize(args.device)
    try:
        return _main(cfg, args)
    finally:
        if started:
            dist.destroy()


def _main(cfg, args) -> dict:
    world = dist.world_size()
    if cfg.TPU.MESH_DP > 1 and cfg.TPU.MESH_DP != world:
        raise ValueError(f"TPU.MESH_DP {cfg.TPU.MESH_DP} but {world} ranks: the ranks are "
                         "the data-parallel axis (torchrun --nproc_per_node)")
    device = resolve_device(args.device)
    logger = setup_logger()
    if dist.rank() == 0:
        logger.setLevel(logging.DEBUG)
        to_file = log_to_file(logger, cfg.OUTPUT_DIR)
    else:   # the other ranks print their warnings and write nothing
        logger.setLevel(logging.WARNING)
        to_file = contextlib.nullcontext(logger)
    with to_file:
        return _train(cfg, args, device, logger)


class _NoWriter:
    """``MetricsWriter``'s place on the ranks that write no files."""

    def write(self, step: int, **scalars):
        pass

    def close(self):
        pass


def _train(cfg, args, device, logger) -> dict:
    output_dir, sol = cfg.OUTPUT_DIR, cfg.SOLVER
    rank, world = dist.rank(), dist.world_size()
    logger.info(f"config:\n{cfg.dump()}")
    if rank == 0:
        with open(os.path.join(output_dir, "config.yml"), "w") as f:
            f.write(cfg.dump())
    logger.info(f"environment:\n{collect_env_info()}")

    sample_cfg, spec = train_sample_config(cfg), method_spec(cfg)
    datasets = [get_dataset(n, is_train=True, data_dir=args.data_dir) for n in cfg.DATASETS.TRAIN]
    model, loaded = build_model(cfg, args, logger)
    opt = optimizer_from_config(model, cfg)
    start_iter = resume(model, opt, output_dir) if args.resume else 0
    if start_iter:
        logger.info(f"resumed from {last_checkpoint(output_dir)} @ iter {start_iter}")

    # one sample a rank a step; the reference's schedule is IMS_PER_BATCH
    # (1 a GPU) x GPUs x ACCUMULATION_STEPS
    eff = world * max(1, sol.ACCUMULATION_STEPS)
    logger.info(f"data-parallel ranks: {world}; effective batch per optimizer step: {eff} "
                f"samples (SOLVER.IMS_PER_BATCH={sol.IMS_PER_BATCH})")
    if sol.IMS_PER_BATCH > eff:
        logger.warning(f"IMS_PER_BATCH={sol.IMS_PER_BATCH} exceeds ranks x accumulation={eff}; "
                       f"raise SOLVER.ACCUMULATION_STEPS or the ranks to match the reference "
                       f"schedule")

    # aspect-ratio-grouped batches: every batch has one padding bucket.
    # Batches load at iterations that are multiples of BATCH_REUSE_STEPS
    # (the MEGA family reuses a batch only with global frames to swap in);
    # a resumed run skips the ones the earlier run used.
    train_ds = ConcatDataset(datasets)
    batch_iter = grouped_batches(aspect_ratio_group_ids(train_ds), world, seed=0)
    can_reuse = spec is None or spec.num_global > 0
    reuse_steps = max(1, int(sol.BATCH_REUSE_STEPS)) if can_reuse else 1
    first_global = (1 + sample_cfg.num_local if spec is None
                    else 1 + spec.num_local + spec.num_mem)
    for _ in range((start_iter + reuse_steps - 1) // reuse_steps):
        next(batch_iter)
    batches = sample_batches(train_ds, batch_iter, sample_cfg, start_iter, reuse_steps,
                             rank, world, spec)
    if not args.no_prefetch:
        batches = PrefetchIterator(batches, depth=2)

    meters = MetricLogger()
    writer = (MetricsWriter(output_dir, resume_step=start_iter if args.resume else None)
              if rank == 0 else _NoWriter())
    prof = StepProfiler(args.profile_dir if rank == 0 else None, start=start_iter + 10,
                        stop=start_iter + 15)
    state = {"t_last": time.perf_counter(), "val_failures": 0}

    def device_batches():
        samples = iteration_samples(batches, start_iter, sol.MAX_ITER, reuse_steps,
                                    first_global, rank)
        for it, smp in enumerate(samples, start_iter):
            prof.step(it)
            yield collate(smp, device)

    def validate(done: int):
        """Periodic validation (engine/trainer.py:187-207), sharded by rank
        and evaluated on rank 0.  A missing val set is tolerated; any other
        failure aborts at the second in a row, so a broken val path cannot
        hide behind warnings.  Under a process group the ranks agree on the
        outcome (a failure on any rank is a failure on every rank), so that
        all of them go on training or all of them raise."""
        error = None
        try:
            val_ds = get_dataset(cfg.DATASETS.TEST[0], is_train=False, data_dir=args.data_dir)
            if spec is None:
                _, _, results = run_inference(model, val_ds, sample_config(cfg),
                                              **detector_args(cfg), max_videos=VAL_MAX_VIDEOS,
                                              logger=logger)
            else:   # the JAX CLI's settings: the DFF key interval, the rest default
                _, _, results = run_inference_video_arch(
                    model, val_ds, sample_config(cfg), method=spec.method,
                    key_frame_duration=cfg.MODEL.VID.DFF.KEY_FRAME_DURATION,
                    max_videos=VAL_MAX_VIDEOS_METHODS, logger=logger)
            if results:
                writer.write(done, **{"Val/mAP": results["ap50"]})
            outcome = "ok"
        except FileNotFoundError as e:
            outcome, error = "missing", e
        except Exception as e:
            outcome, error = "failed", e
        outcomes = dist.gather_objects(outcome)
        if error is None and any(o != "ok" for o in outcomes):
            error = dist.RankFailed(f"periodic validation by rank: {dict(enumerate(outcomes))}")
        if "failed" not in outcomes:
            state["val_failures"] = 0
            if error is not None:
                logger.warning(f"periodic validation skipped (no data): {error}")
            return
        state["val_failures"] += 1
        if state["val_failures"] >= 2:
            raise error
        logger.warning(f"periodic validation failed ({state['val_failures']}/2): {error}",
                       exc_info=error)

    def on_step(done: int, metrics: dict):
        if done % LOG_PERIOD == 0:     # means over the ranks
            vals = {k: float(v) for k, v in dist.all_reduce_mean(metrics).items()}
            meters.update(**vals)
            now = time.perf_counter()
            dt, state["t_last"] = (now - state["t_last"]) / LOG_PERIOD, now
            logger.info(f"iter {done}/{sol.MAX_ITER} {meters} ({dt:.3f}s/it)")
            writer.write(done, sec_per_iter=dt, **{f"Train/{k}": v for k, v in vals.items()})
        if sol.TEST_PERIOD and done % sol.TEST_PERIOD == 0 and cfg.DATASETS.TEST:
            validate(done)

    net = wrap_data_parallel(model)
    method_kw = ({} if spec is None else
                 dict(loss_fn=make_method_loss_fn(net, spec), draw=draw_method_randoms))
    try:
        metrics = train_loop(net, opt, device_batches(), num_global=sample_cfg.num_global,
                             max_iter=sol.MAX_ITER, seed=args.seed, start_iter=start_iter,
                             checkpoint_period=sol.CHECKPOINT_PERIOD, output_dir=output_dir,
                             log_every=0, on_step=on_step, **method_kw)
    finally:
        prof.close()
        writer.close()
        if isinstance(batches, PrefetchIterator):
            batches.close()
    dist.barrier()      # rank 0 has written the last checkpoint
    checkpoint = last_checkpoint(output_dir)
    logger.info(f"trained iterations {start_iter}..{sol.MAX_ITER}; last checkpoint {checkpoint}")
    return {"start_iter": start_iter, "max_iter": sol.MAX_ITER, "pretrained_tensors": loaded,
            "metrics": {k: float(v) for k, v in metrics.items()}, "checkpoint": checkpoint}


if __name__ == "__main__":
    main()

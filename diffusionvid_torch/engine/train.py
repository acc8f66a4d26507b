"""Training step, solver and iteration loop.

Port of ``diffusionvid_tpu/engine/train.py`` and of the iteration loop of
``tools/train_net.py:225-296`` (the reference trainer and solver:
``mega_core/engine/trainer.py:43-248``, ``mega_core/solver/build.py``);
this package's ``tools/train_net.py`` feeds it samples read from disk:

  * the loss of ``make_loss_fn``: diffusion targets, the training forward
    over the 1 + num_global frames of a sample, the deep-supervised set
    criterion, averaged over the S samples of a batch; the MEGA family's
    methods bring theirs (``engine/train_methods.py``) to the same step and
    loop, with their own draws;
  * the optimizer of ``make_optimizer``: one global-norm clip over every
    gradient, then AdamW (or SGD) per parameter group: main, bias, backbone
    x BACKBONE_MULTIPLIER, backbone bias, and the frozen FrozenBN running
    statistics, which are never updated but count in the clip;
  * ``ACCUMULATION_STEPS`` as ``optax.MultiSteps``: the running mean of k
    micro-gradients, one update every k calls, the schedule counted in
    optimizer steps;
  * ``train_loop``: every random draw of an iteration comes from a generator
    seeded from (seed, iteration), the counterpart of the JAX loop's
    ``fold_in(base_rng, it)``, so a run resumed from a checkpoint continues
    bit for bit; it checkpoints every ``checkpoint_period`` iterations and
    at the last one;
  * data parallelism (``wrap_data_parallel``): under a process group the
    model is wrapped in ``DistributedDataParallel``, each rank takes its row
    of the iteration's draws, the micro-steps before an optimizer step's
    last run under ``no_sync`` and the last one's backward all-reduces
    once, the logged losses are means over the ranks, and rank 0 alone
    writes checkpoints.

Parameters are float32; activations run in the model's compute dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterable, NamedTuple, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from ..models.criterion import set_criterion
from ..parallel import dist
from ..models.diffusion_det import (
    DiffusionDetArch, diffusion_draws, make_schedule, prepare_diffusion_targets)
from ..utils.checkpoint import last_checkpoint, load_checkpoint, save_checkpoint


class TrainBatch(NamedTuple):
    """S samples of B frames each (1 current + num_global, every frame with
    its own GT); S is the data-parallel axis."""

    images: torch.Tensor     # [S, B, H, W, 3] float 0..255
    gt_boxes: torch.Tensor   # [S, B, G, 4] absolute xyxy
    gt_labels: torch.Tensor  # [S, B, G] int64 in 1..K (0 = pad)
    gt_valid: torch.Tensor   # [S, B, G] bool
    whwh: torch.Tensor       # [S, 4] (w, h, w, h) true image size


class TrainDraws(NamedTuple):
    """The random draws of one iteration, per sample."""

    t: torch.Tensor          # [S, B] int64 timesteps
    noise: torch.Tensor      # [S, B, P, 4] standard normal
    place: torch.Tensor      # [S, B, P, 4] standard normal (placeholder boxes)
    null: torch.Tensor       # [S, B] bool, classifier-free-guidance null mask


def iteration_generator(seed: int, it: int) -> torch.Generator:
    """A CPU generator seeded from (seed, iteration)."""
    return torch.Generator().manual_seed((seed * 1_000_003 + it) % (2 ** 63))


def draw_train_randoms(gen: torch.Generator, samples: int, frames: int,
                       num_proposals: int, num_timesteps: int = 1000,
                       p_uncond: float = 0.1, device=None) -> TrainDraws:
    """Draws of one iteration from ``gen`` on the CPU, moved to ``device``."""
    per = [diffusion_draws(gen, frames, num_proposals, num_timesteps)
           for _ in range(samples)]
    null = torch.rand(samples, frames, generator=gen) < p_uncond
    t, noise, place = (torch.stack(x) for x in zip(*per))
    return TrainDraws(t.to(device), noise.to(device), place.to(device), null.to(device))


# ------------------------------------------------------------------ schedules

def warmup_multistep_schedule(base_lr: float, steps, gamma: float = 0.1,
                              warmup_iters: int = 500,
                              warmup_factor: float = 1.0 / 3) -> Callable[[int], float]:
    """WarmupMultiStepLR (solver/lr_scheduler.py:10-53): linear warmup, then
    ``gamma`` at each milestone reached."""
    milestones = sorted(int(s) for s in steps)

    def schedule(count: int) -> float:
        warm = (warmup_factor + (1 - warmup_factor) * count / max(warmup_iters, 1)
                if count < warmup_iters else 1.0)
        return base_lr * gamma ** sum(count >= m for m in milestones) * warm

    return schedule


def warmup_cosine_schedule(base_lr: float, max_iter: int, warmup_iters: int = 500,
                           warmup_factor: float = 1.0 / 3,
                           min_lr_ratio: float = 0.0) -> Callable[[int], float]:
    """Cosine decay after a linear warmup (solver/build.py:61-70)."""

    def schedule(count: int) -> float:
        warm = (warmup_factor + (1 - warmup_factor) * count / max(warmup_iters, 1)
                if count < warmup_iters else 1.0)
        prog = min(max((count - warmup_iters) / max(max_iter - warmup_iters, 1), 0.0), 1.0)
        cos = min_lr_ratio + (1 - min_lr_ratio) * 0.5 * (1.0 + math.cos(math.pi * prog))
        return base_lr * warm * cos

    return schedule


# ------------------------------------------------------------------ optimizer

GROUPS = ("main", "bias", "backbone", "backbone_bias", "frozen")


def param_group(name: str) -> str:
    """The JAX package's ``_param_label`` on the port's names: the trunk
    (``backbone.bottom_up.*``) is the backbone, the FPN is not; a bias is a
    tensor whose JAX leaf is named ``bias``, ``in_proj_bias`` or
    ``class_logits_bias``.  In the trunk only the normalisation layers'
    biases have such a leaf: the Swin modules declare their other biases
    under the layer's name (``qkv_bias``, ``proj_bias``, ``mlp_fc1_bias``,
    ``patch_embed_bias``), which JAX labels as weights.  JAX looks at the
    top-level name alone, so the C4 trunk of DFF, FGFA, RDN and MEGA
    (``detector.backbone.bottom_up.*``) is ``main`` and ``bias`` at the
    full learning rate, while ``base``'s and DAFA's is the backbone; the
    relation's ``Wg_bias`` / ``Wv_bias`` leaves are weights there too."""
    *path, leaf = name.split(".")
    if leaf in ("running_mean", "running_var"):
        return "frozen"
    if name.startswith("backbone.bottom_up."):
        bias = leaf == "bias" and path[-1].startswith("norm")
        return "backbone_bias" if bias else "backbone"
    return "bias" if leaf in ("bias", "in_proj_bias") else "main"


def unused_in_training(model) -> list:
    """The parameters a DiffusionVID train step gives no gradient.  The
    local chain's stages all take the same query and the last one's output
    is the condition, unless the global attention overwrites it
    (box_head.py:359-394): so with GLOBAL.ENABLE every local stage, without
    it every local stage but the last, takes no gradient."""
    head = model.head
    n = len(head.local_attention)
    idle = range(n) if head.global_enable else range(n - 1)
    prefixes = tuple(f"head.local_{kind}.{i}." for i in idle for kind in ("attention", "norm"))
    return [name for name, _ in model.named_parameters() if prefixes and name.startswith(prefixes)]


class Optimizer:
    """Global-norm clip, then AdamW or SGD per parameter group, with
    gradient accumulation.  Call ``accumulate`` after each backward: it
    takes the parameters' gradients and every ``accumulation_steps``-th call
    updates the parameters.  Built by ``make_optimizer``."""

    def __init__(self, model: torch.nn.Module, *, base_lr: float = 1e-4,
                 steps=(80000, 120000), gamma: float = 0.1, warmup_iters: int = 1000,
                 warmup_factor: float = 0.01, weight_decay: float = 1e-4,
                 weight_decay_bias: float = 1e-4, backbone_multiplier: float = 0.1,
                 bias_lr_factor: float = 1.0, clip_norm: float = 1.0,
                 optimizer_type: str = "adamw", momentum: float = 0.9,
                 accumulation_steps: int = 1, lr_scheduler_type: str = "step",
                 max_iter: int = 130000):
        self.params = [p for p in model.parameters()]
        names = {id(p): n for n, p in model.named_parameters()}
        labels = [param_group(names[id(p)]) for p in self.params]
        settings = {"main": (1.0, weight_decay),
                    "bias": (bias_lr_factor, weight_decay_bias),
                    "backbone": (backbone_multiplier, weight_decay),
                    "backbone_bias": (backbone_multiplier * bias_lr_factor, weight_decay_bias)}
        groups, self.schedules = [], []
        for label, (mult, wd) in settings.items():
            members = [p for p, lab in zip(self.params, labels) if lab == label]
            if not members:
                continue
            groups.append({"params": members, "weight_decay": wd, "lr": 0.0,
                           "label": label})
            if lr_scheduler_type == "cosine":
                self.schedules.append(warmup_cosine_schedule(
                    base_lr * mult, max_iter, warmup_iters, warmup_factor))
            else:
                self.schedules.append(warmup_multistep_schedule(
                    base_lr * mult, steps, gamma, warmup_iters, warmup_factor))
        if optimizer_type == "adamw":
            self.inner = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
        elif optimizer_type == "sgd":
            self.inner = torch.optim.SGD(groups, momentum=momentum)
        else:
            raise ValueError(f"unknown optimizer type {optimizer_type!r}")
        self.clip_norm = clip_norm
        self.accumulation_steps = max(1, int(accumulation_steps))
        self.count = 0          # optimizer steps taken
        self.mini_step = 0      # micro-steps accumulated since the last one
        self.acc = None         # running mean of the micro-gradients

    @property
    def update_due(self) -> bool:
        """Whether the next ``accumulate`` updates the parameters."""
        return self.mini_step + 1 >= self.accumulation_steps

    def preset_grads(self) -> None:
        """Before the backward that ends an optimizer step under DDP: every
        parameter's gradient starts at (micro-steps so far) x their running
        mean, so that the backward leaves the sum of this rank's
        micro-gradients, which DDP's all-reduce averages over the ranks;
        ``accumulate(presummed=True)`` then divides by the micro-steps."""
        if self.mini_step:
            for p, a in zip(self.params, self.acc):
                p.grad = a * float(self.mini_step)

    def lr(self, label: str = "main") -> float:
        """The learning rate the next update uses in group ``label``."""
        for group, sched in zip(self.inner.param_groups, self.schedules):
            if group["label"] == label:
                return sched(self.count)
        raise KeyError(label)

    def accumulate(self, presummed: bool = False) -> bool:
        """Take the parameters' gradients (a missing one is zero) into the
        running mean; update on every ``accumulation_steps``-th call.  With
        ``presummed`` the gradients hold the sum of every micro-step's
        (``preset_grads``).  Returns whether the parameters were updated."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        if presummed:
            torch._foreach_div_(grads, float(self.mini_step + 1))
            self.acc = grads
        elif self.mini_step == 0:
            self.acc = grads
        else:
            # acc + (g - acc) / (n + 1), as optax.MultiSteps
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
        self.mini_step += 1
        if self.mini_step < self.accumulation_steps:
            return False
        self._update(self.acc)
        self.acc, self.mini_step = None, 0
        return True

    def _update(self, grads):
        # optax.clip_by_global_norm: (g / norm) * max_norm once the norm
        # reaches max_norm, over every gradient, the frozen ones included
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if float(norm) >= self.clip_norm:
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group, sched in zip(self.inner.param_groups, self.schedules):
            group["lr"] = sched(self.count)
        self.inner.step()   # the frozen group is in no param group
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        """Under a process group every rank must call it: a running mean of
        micro-gradients is each rank's own (the micro-steps ran under
        ``no_sync``) and is saved as its mean over the ranks, which leaves
        the next update's gradient as it was."""
        acc = self.acc
        if acc is not None and dist.is_initialized():
            acc = [a.clone() for a in acc]
            for a in acc:
                torch.distributed.all_reduce(a)
            torch._foreach_div_(acc, float(dist.world_size()))
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.acc = (None if state["acc"] is None
                    else [a.to(p.device) for a, p in zip(state["acc"], self.params)])


def make_optimizer(model: torch.nn.Module, **kw) -> Optimizer:
    """Per-group optimizer mirroring make_optimizer (solver/build.py:9-58)."""
    return Optimizer(model, **kw)


def optimizer_from_config(model: torch.nn.Module, cfg) -> Optimizer:
    sol = cfg.SOLVER
    return make_optimizer(
        model, base_lr=sol.BASE_LR, steps=tuple(sol.STEPS), gamma=sol.GAMMA,
        warmup_iters=sol.WARMUP_ITERS, warmup_factor=sol.WARMUP_FACTOR,
        weight_decay=sol.WEIGHT_DECAY, weight_decay_bias=sol.WEIGHT_DECAY_BIAS,
        backbone_multiplier=sol.BACKBONE_MULTIPLIER, bias_lr_factor=sol.BIAS_LR_FACTOR,
        clip_norm=sol.CLIP_GRADIENTS.CLIP_VALUE, optimizer_type=sol.OPTIMIZER_TYPE,
        momentum=sol.MOMENTUM, accumulation_steps=sol.ACCUMULATION_STEPS,
        lr_scheduler_type=sol.LR_SCHEDULER_TYPE, max_iter=sol.MAX_ITER)


# ------------------------------------------------------------------ loss, step

def unwrap(model):
    """The model under a ``DistributedDataParallel`` wrapper, or the model."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def wrap_data_parallel(model):
    """``DistributedDataParallel`` over the initialized process group (the
    model unchanged without one).  ``find_unused_parameters`` is set when a
    train step leaves some parameter without a gradient: in DiffusionVID
    the local attention's overwritten stages (``unused_in_training``), and
    always for the MEGA family, whose idle parameters depend on the sample
    (DAFA's memory attention without global frames, a MEGA without relation
    stages whose ``global_lm`` has no memory to read)."""
    if not dist.is_initialized():
        return model
    dev = next(model.parameters()).device
    unused = bool(unused_in_training(model)) if isinstance(model, DiffusionDetArch) else True
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        find_unused_parameters=unused)


def make_loss_fn(model, num_global: int, class_weight: float = 2.0,
                 l1_weight: float = 5.0, giou_weight: float = 2.0):
    """``loss_fn(batch, draws) -> (total, losses)``: the per-sample loss
    averaged over the S samples.  ``model`` may be DDP-wrapped."""
    schedules = {}
    num_classes = unwrap(model).num_classes

    def sample_loss(images, gt_boxes, gt_labels, gt_valid, whwh, t, noise, place, null):
        dev = images.device
        if dev not in schedules:
            schedules[dev] = make_schedule(device=dev)
        whwh_b = whwh[None].expand(images.shape[0], 4)
        noisy = prepare_diffusion_targets(schedules[dev], gt_boxes, gt_valid, whwh_b,
                                          t, noise, place)
        logits, boxes = model(images, noisy, t, num_global, null)
        nl = logits.shape[1]
        return set_criterion(logits, boxes, gt_labels[:nl], gt_boxes[:nl], gt_valid[:nl],
                             whwh_b[:nl], num_classes, class_weight=class_weight,
                             l1_weight=l1_weight, giou_weight=giou_weight)

    def loss_fn(batch: TrainBatch, draws: TrainDraws):
        per = [sample_loss(*(x[s] for x in batch), *(x[s] for x in draws))
               for s in range(batch.images.shape[0])]
        total = torch.stack([p[0] for p in per]).mean()
        losses = {k: torch.stack([p[1][k] for p in per]).mean() for k in per[0][1]}
        return total, losses

    return loss_fn


def make_train_step(model, opt: Optimizer, num_global: int = 0, loss_fn=None, **loss_kw):
    """``train_step(batch, draws) -> metrics``: one micro-step (forward,
    backward, ``opt.accumulate``) of ``loss_fn(batch, draws)``, by default
    DiffusionVID's ``make_loss_fn(model, num_global, **loss_kw)``.  The
    metrics are this rank's, detached tensors on the model's device, read
    without a host sync
    (``parallel.dist.all_reduce_mean`` makes them means over the ranks
    where they are read).  With a DDP-wrapped ``model`` the micro-steps
    before an optimizer step's last run under ``no_sync`` and the last
    one's backward all-reduces the summed micro-gradients
    (``Optimizer.preset_grads``)."""
    if loss_fn is None:
        loss_fn = make_loss_fn(model, num_global, **loss_kw)
    ddp = isinstance(model, DistributedDataParallel)

    def train_step(batch: TrainBatch, draws: TrainDraws) -> dict:
        sync = opt.update_due
        if ddp and sync:
            opt.preset_grads()
        with model.no_sync() if ddp and not sync else contextlib.nullcontext():
            total, losses = loss_fn(batch, draws)
            total.backward()
        opt.accumulate(presummed=ddp and sync)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return train_step


def resume(model, opt: Optimizer, output_dir: str) -> int:
    """Load the checkpoint ``last_checkpoint`` names into the model and
    the optimizer; returns the iteration to continue from (0 without one)."""
    path = last_checkpoint(output_dir)
    if path is None:
        return 0
    ck = load_checkpoint(path)
    model.load_state_dict(ck["model"])
    opt.load_state_dict(ck["optimizer"])
    return int(ck["step"])


def train_loop(model, opt: Optimizer, batches: Iterable[TrainBatch], *,
               num_global: int = 0, max_iter: int, seed: int = 0, start_iter: int = 0,
               checkpoint_period: int = 0, output_dir: Optional[str] = None,
               log_every: int = 20, log: Callable[[str], None] = print,
               on_step: Optional[Callable[[int, dict], None]] = None,
               loss_fn=None, draw=None) -> dict:
    """Micro-steps ``start_iter .. max_iter - 1`` over ``batches`` (one
    batch per iteration, the iterable starting at ``start_iter``'s) of
    ``loss_fn`` (``make_train_step``'s; DiffusionVID's by default).  The
    draws of iteration ``it`` are ``draw(iteration_generator(seed, it),
    samples, frames)`` (by default DiffusionVID's ``draw_train_randoms``; a
    named tuple of tensors whose first axis is the sample); under a process
    group of W ranks they are drawn for the W x S samples of the iteration
    and rank r takes rows r*S .. r*S + S - 1 (``model`` DDP-wrapped by
    ``wrap_data_parallel``).  After each iteration
    ``on_step(iterations done, metrics)`` runs (the train CLI's logging and
    validation; the rank's own metrics), then, with ``output_dir``, the
    checkpoint every ``checkpoint_period`` iterations and at ``max_iter``,
    written by rank 0.  Logs, and returns, the metrics as means over the
    ranks."""
    step = make_train_step(model, opt, num_global, loss_fn=loss_fn)
    net = unwrap(model)
    if draw is None:
        def draw(gen, samples, frames):
            return draw_train_randoms(gen, samples, frames, net.num_proposals,
                                      p_uncond=net.head.p_uncond)
    world, rank = dist.world_size(), dist.rank()
    metrics = {}
    batch_iter = iter(batches)
    for it in range(start_iter, max_iter):
        batch = next(batch_iter)
        s, b = batch.images.shape[:2]
        draws = draw(iteration_generator(seed, it), world * s, b)
        draws = type(draws)(*(x[rank * s:(rank + 1) * s].to(batch.images.device)
                              for x in draws))
        metrics = step(batch, draws)
        done = it + 1
        if log_every and done % log_every == 0:
            shown = dist.all_reduce_mean(metrics)
            log(f"iter {done}/{max_iter} "
                + " ".join(f"{k} {float(v):.4f}" for k, v in sorted(shown.items())))
        if on_step is not None:
            on_step(done, metrics)
        if output_dir and ((checkpoint_period and done % checkpoint_period == 0)
                           or done == max_iter):
            opt_state = opt.state_dict()     # a collective under a process group
            if rank == 0:
                save_checkpoint(output_dir, done, net.state_dict(), opt_state)
    return dist.all_reduce_mean(metrics)

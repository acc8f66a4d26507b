"""Train steps of the MEGA family's methods: base, dff, fgfa, rdn, mega, dafa.

Port of ``diffusionvid_tpu/engine/train_methods.py:27-95`` (the reference
trains every detector through one ``do_train`` loop because each returns a
loss dict, ``mega_core/engine/trainer.py:43-146``).  A sample's frames are
ordered [cur, locals…, mems…, globals…] (``data/sampling.py:
MethodSampleSpec``); each method takes its slices of them, and the losses
are on the current frame's GT.  A sample's loss is the sum of its loss dict
(DAFA's: ``total_loss_stages``, the weighted sum over its stages); a
batch's is the mean over its samples.  The loss plugs into
``engine/train.py``'s ``make_train_step`` and ``train_loop``.

The RPN's and the Fast R-CNN head's samplers take their keys from a
per-sample generator: an iteration's draws (``draw_method_randoms``) are one
seed a sample, drawn from the iteration's generator, so that a resumed run
and every data-parallel rank draw what the uninterrupted single-process run
draws.  DAFA draws nothing (its simOTA assignment is deterministic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn.parallel import DistributedDataParallel

from ..data.sampling import MethodSampleSpec


class MethodDraws(NamedTuple):
    """The random draws of one iteration: each sample's sampler seed."""

    seeds: torch.Tensor      # [S] int64


def draw_method_randoms(gen: torch.Generator, samples: int, frames: int = 0) -> MethodDraws:
    """An iteration's draws from ``gen`` (``frames`` is not used: the keys'
    sizes follow from the model's maps)."""
    return MethodDraws(torch.randint(0, 2 ** 62, (samples,), generator=gen))


def uniform_draw(seed, device):
    """``draw(shape)``: uniforms in [0, 1) from a CPU generator seeded with
    ``seed``, on ``device``; the models call it once a sampler."""
    gen = torch.Generator().manual_seed(int(seed))

    def draw(shape):
        return torch.rand(shape, generator=gen).to(device)

    return draw


def _call(model, name: str, *args):
    """``model.<name>(*args)``; through ``DistributedDataParallel``'s forward
    when ``model`` is wrapped, so that its gradient hooks see the pass."""
    if not isinstance(model, DistributedDataParallel):
        return getattr(model, name)(*args)
    net = model.module
    net.forward = getattr(net, name)
    try:
        return model(*args)
    finally:
        del net.forward


def method_sample_loss(model, spec: MethodSampleSpec, images, gt_boxes, gt_labels, gt_valid,
                       whwh, draw):
    """One sample's (total, loss dict): ``images`` ``[B, H, W, 3]`` in the
    layout of ``spec``, its GT ``[B, G]``, ``whwh`` ``[4]``."""
    m, l, me, g = spec.method, spec.num_local, spec.num_mem, spec.num_global
    w, h = whwh[:2].tolist()
    hw = (h, w)
    cur = images[:1]
    first = (gt_boxes[:1], gt_labels[:1], gt_valid[:1])
    if m == "base":
        losses = _call(model, "train_loss", cur, hw, *first, draw)
    elif m == "dff":
        losses = _call(model, "train_loss", cur, images[1:2], hw, *first, draw)
    elif m == "fgfa":
        losses = _call(model, "train_loss", cur, images[1:1 + l], hw, *first, draw)
    elif m == "rdn":
        losses = _call(model, "train_loss", cur, images[1:1 + l], hw, gt_boxes[0],
                       gt_labels[0], gt_valid[0], draw)
    elif m == "mega":
        losses = _call(model, "train_loss_mega", cur, images[1:1 + l],
                       images[1 + l:1 + l + me], images[1 + l + me:1 + l + me + g], hw,
                       gt_boxes[0], gt_labels[0], gt_valid[0], draw)
    elif m == "dafa":
        losses = _call(model, "train_loss", cur, images[1 + l + me:1 + l + me + g], whwh,
                       *first)
    else:
        raise ValueError(f"no train step for method {m}")
    if m == "dafa":
        return losses.pop("total_loss_stages"), losses
    return sum(losses.values()), losses


def make_method_loss_fn(model, spec: MethodSampleSpec):
    """``loss_fn(batch, draws) -> (total, losses)``: the per-sample loss of
    ``spec.method`` averaged over the S samples, each sample's samplers
    keyed by its seed in ``draws`` (``MethodDraws``).  ``model`` may be
    DDP-wrapped."""

    def loss_fn(batch, draws: MethodDraws):
        dev = batch.images.device
        per = [method_sample_loss(model, spec, *(x[s] for x in batch),
                                  uniform_draw(draws.seeds[s], dev))
               for s in range(batch.images.shape[0])]
        total = torch.stack([p[0] for p in per]).mean()
        losses = {k: torch.stack([p[1][k] for p in per]).mean() for k in per[0][1]}
        return total, losses

    return loss_fn

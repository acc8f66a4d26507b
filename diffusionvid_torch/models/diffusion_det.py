"""DiffusionDet / DiffusionVID meta-architecture in PyTorch.

Port of ``diffusionvid_tpu/models/diffusion_det.py``: the cosine schedule
(buffers derived in float64, cast at the end), DDIM time pairs, the
signal-space ↔ box-space transforms, the training targets
(``q_sample``, ``prepare_diffusion_targets``), the DDIM noise estimate
``predict_noise_from_start`` and ``DiffusionDetArch`` (ResNet or Swin + FPN +
DynamicHead) with its training forward and the streaming sub-entrypoints
``extract_features``, ``extract_proposals``, ``refine`` and
``full_forward_test``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..structures.boxes import cxcywh_to_xyxy, xyxy_to_cxcywh
from ..utils.device import resolve_device
from .fpn import FPN
from .heads import DynamicHead
from .resnet import ResNet
from .swin import SwinTransformer

_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    num_timesteps: int
    scale: float


def cosine_beta_schedule(timesteps: int = 1000, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (diffusion_det.py:50-61), float64."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)


def make_schedule(timesteps: int = 1000, scale: float = 2.0,
                  device="cpu") -> DiffusionSchedule:
    """Every buffer is derived in float64 and cast to float32 at the end
    (computing 1/ac - 1 in float32 loses about 3 digits at small t)."""
    betas = cosine_beta_schedule(timesteps)
    ac = np.cumprod(1.0 - betas)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return DiffusionSchedule(
        betas=f32(betas), alphas_cumprod=f32(ac),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1.0)),
        num_timesteps=timesteps, scale=scale)


def ddim_times(num_timesteps: int, sampling_steps: int):
    """[(T-1 → next), ...] time pairs (diffusion_det.py:536-539)."""
    times = np.linspace(-1, num_timesteps - 1, sampling_steps + 1).astype(int)
    times = list(reversed(times.tolist()))
    return list(zip(times[:-1], times[1:]))


def signal_to_boxes(x, whwh, scale: float):
    """Clamp to ±scale, map to [0,1] cxcywh, then absolute xyxy."""
    x = x.clamp(-scale, scale)
    x = ((x / scale) + 1.0) / 2.0
    return cxcywh_to_xyxy(x) * whwh[..., None, :]


def boxes_to_signal(boxes_xyxy, whwh, scale: float):
    """Absolute xyxy → clamped signal space."""
    x = xyxy_to_cxcywh(boxes_xyxy / whwh[..., None, :])
    return ((x * 2.0 - 1.0) * scale).clamp(-scale, scale)


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """x_t = sqrt(ac_t) x_0 + sqrt(1 - ac_t) noise, per frame ``t`` [B]."""
    c1 = sched.sqrt_alphas_cumprod[t][..., None, None]
    c2 = sched.sqrt_one_minus_alphas_cumprod[t][..., None, None]
    return c1 * x_start + c2 * noise


def predict_noise_from_start(sched: DiffusionSchedule, x_t, t, x0):
    """eps = (sqrt(1/ac_t) x_t - x0) / sqrt(1/ac_t - 1), per frame ``t`` [B]
    (diffusion_det.py:649-653)."""
    c1 = sched.sqrt_recip_alphas_cumprod[t][..., None, None]
    c2 = sched.sqrt_recipm1_alphas_cumprod[t][..., None, None]
    return (c1 * x_t - x0) / c2


def prepare_diffusion_targets(sched: DiffusionSchedule, gt_boxes_xyxy, gt_valid,
                              whwh, t, noise, place):
    """Noisy training boxes per frame (prepare_diffusion_concat,
    diffusion_det.py:690-725), static-shape, from explicit draws.

    gt_boxes_xyxy [B, G, 4] absolute, gt_valid [B, G], whwh [B, 4]; the
    draws: ``t`` [B] timesteps, ``noise`` [B, P, 4] and ``place`` [B, P, 4]
    standard normal (the placeholder boxes are ``place / 6 + 0.5``).
    Returns the noisy absolute xyxy boxes [B, P, 4]."""
    g = gt_boxes_xyxy.shape[1]
    p = noise.shape[1]
    # normalized cxcywh GT; a frame without GT gets one full-image box
    gt_norm = xyxy_to_cxcywh(gt_boxes_xyxy / whwh[:, None, :])
    any_gt = gt_valid.any(1)
    fake = torch.tensor([0.5, 0.5, 1.0, 1.0], device=gt_norm.device)
    gt_valid = gt_valid.clone()
    gt_valid[:, 0] |= ~any_gt
    gt_norm[:, 0] = torch.where(any_gt[:, None], gt_norm[:, 0], fake)
    # placeholder boxes ~ N(0.5, 1/6), wh at least 1e-4
    place = place / 6.0 + 0.5
    place = torch.cat([place[..., :2], place[..., 2:].clamp(min=1e-4)], -1)
    # slot i takes GT i when valid; with G > P the first P slots are used
    ge = min(g, p)
    head = torch.where(gt_valid[:, :ge, None], gt_norm[:, :ge], place[:, :ge])
    x_start = torch.cat([head, place[:, ge:]], 1)
    x_start = (x_start * 2.0 - 1.0) * sched.scale
    x = q_sample(sched, x_start, t, noise)
    return signal_to_boxes(x, whwh, sched.scale)


def diffusion_draws(gen: torch.Generator, frames: int, num_proposals: int,
                    num_timesteps: int, device=None):
    """The random draws of ``prepare_diffusion_targets`` for ``frames``
    frames: (t [B] int64, noise [B, P, 4], place [B, P, 4]).  Drawn on the
    CPU from ``gen`` and moved to ``device``, so a seed gives the same draws
    on any device."""
    t = torch.randint(0, num_timesteps, (frames,), generator=gen)
    noise = torch.randn(frames, num_proposals, 4, generator=gen)
    place = torch.randn(frames, num_proposals, 4, generator=gen)
    return t.to(device), noise.to(device), place.to(device)


def local_stages(cfg) -> int:
    """The local attention's stages: ATTENTION.STAGE when ATTENTION.ENABLE."""
    att = cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION
    return int(att.STAGE) if att.ENABLE else 0


class DiffusionDetArch(nn.Module):
    """ResNet or Swin + FPN + DynamicHead.  ``backbone`` is detectron2's FPN
    module (``backbone.bottom_up`` the trunk) and ``head`` the decoder, so
    the state dict has the reference checkpoint's names.

    Parameters are float32; activations run in ``compute_dtype``.  Build
    with ``from_config``, which places the model on the card unless
    ``device`` says otherwise."""

    def __init__(self, depth: int = 101, num_classes: int = 30,
                 num_proposals: int = 300, hidden_dim: int = 256,
                 num_heads: int = 3, num_heads_local: int = 1,
                 res_stage: int = 1, global_enable: bool = True, local_stages: int = 0,
                 backbone_type: str = "resnet", swin_size: str = "B-22k",
                 fpn_in=("res3", "res4", "res5"), head_levels=("p3", "p4", "p5"),
                 pixel_mean=(123.675, 116.280, 103.530),
                 pixel_std=(58.395, 57.120, 57.375),
                 compute_dtype=torch.float32, swin_kernel: str = "v3"):
        super().__init__()
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.hidden_dim, self.num_heads_local = hidden_dim, num_heads_local
        self.res_stage = res_stage
        self.local_stages = local_stages if num_heads_local > 0 else 0
        self.head_levels = tuple(head_levels)
        self.compute_dtype = compute_dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)
        self.backbone_type = backbone_type
        if backbone_type == "swin":
            trunk = SwinTransformer.from_size(
                swin_size, out_indices=tuple(sorted(int(k[4:]) for k in fpn_in)),
                kernel_mode=swin_kernel)
            channels = [trunk.dims[int(k[4:])] for k in fpn_in]
        else:
            trunk = ResNet(depth, out_features=fpn_in)
            channels = [_CHANNELS[k] for k in fpn_in]
        self.backbone = FPN(trunk, fpn_in, channels, hidden_dim)
        self.head = DynamicHead(
            num_classes=num_classes, d_model=hidden_dim, num_heads=num_heads,
            num_heads_local=num_heads_local, global_stages=res_stage,
            global_enable=global_enable, local_stages=local_stages,
            top_k=(min(75, num_proposals), min(25, num_proposals)),
            dtype=compute_dtype)

    @classmethod
    def from_config(cls, cfg, device=None, dtype=None, seed: int = 0,
                    swin_kernel: str = "v3"):
        """Build from a config tree with random weights drawn from ``seed``
        (load a checkpoint over them with ``load_state_dict``).  ``device``
        None means the card, and raises without one.  ``swin_kernel`` is the
        Swin trunk's ``kernel_mode`` (``models/swin.py``)."""
        device = resolve_device(device)
        dd = cfg.MODEL.DiffusionDet
        is_swin = "swin" in cfg.MODEL.BACKBONE.NAME.lower()
        if dtype is None:
            dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                     else torch.float32)
        model = cls(
            depth=cfg.MODEL.RESNETS.DEPTH, num_classes=dd.NUM_CLASSES,
            num_proposals=dd.NUM_PROPOSALS, hidden_dim=dd.HIDDEN_DIM,
            num_heads=dd.NUM_HEADS, num_heads_local=dd.NUM_HEADS_LOCAL,
            res_stage=cfg.MODEL.VID.MEGA.GLOBAL.RES_STAGE,
            global_enable=bool(cfg.MODEL.VID.MEGA.GLOBAL.ENABLE),
            local_stages=local_stages(cfg),
            backbone_type="swin" if is_swin else "resnet",
            swin_size=cfg.MODEL.SWIN.SIZE if is_swin else "B-22k",
            fpn_in=tuple(cfg.MODEL.FPN.IN_FEATURES),
            head_levels=tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES),
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD), compute_dtype=dtype,
            swin_kernel=swin_kernel)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(device).eval()

    def reset_parameters(self, gen: torch.Generator):
        self.backbone.reset_parameters(gen)
        self.head.reset_parameters(gen)

    @property
    def spatial_scales(self):
        return tuple(1.0 / (2 ** int(lvl[1:])) for lvl in self.head_levels)

    def forward(self, images, noisy_boxes, t, num_global: int, null):
        """Training forward: one head pass over all B frames of a sample
        (diffusion_det.py:338-375).  images [B, H, W, 3] in 0..255,
        noisy_boxes [B, N, 4], t [B], ``null`` [B] bool the CFG null mask.
        Returns float32 logits [S, B, N, K] and boxes [S, B, N, 4] over the
        S stages."""
        feats = self.extract_features(images)
        logits, boxes = self.head(feats, self.spatial_scales, noisy_boxes, t,
                                  num_global, null)
        return logits.float(), boxes.float()

    def extract_features(self, images):
        """images [B, H, W, 3] in 0..255 → list of NHWC head-level maps.
        The NCHW view of NHWC maps is channels-last, so the convolutions
        run channels-last and the NHWC view of each output is contiguous.
        The Swin trunk takes and gives NHWC maps; the FPN their NCHW views."""
        x = ((images - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        trunk = self.backbone.bottom_up
        if self.backbone_type == "swin":
            feats = {k: v.permute(0, 3, 1, 2) for k, v in trunk(x).items()}
        else:
            feats = trunk(x.permute(0, 3, 1, 2))
        pyr = self.backbone(feats)
        return [pyr[lvl].permute(0, 2, 3, 1).contiguous() for lvl in self.head_levels]

    def extract_proposals(self, feats, boxes_init, t):
        """Shared stages + top-k on ready FPN maps (the per-chunk
        feature-extraction pass, diffusion_det.py:436-460)."""
        inter_logits, inter_boxes, pro, _ = self.head.shared_stages(
            feats, self.spatial_scales, boxes_init, t)
        k1, k2 = self.head.topk_features(inter_logits[-1], pro)
        return inter_logits[-1].float(), inter_boxes[-1].float(), pro, k1, k2

    def refine(self, feats, bboxes, pro_features, t, memory, memory_mask,
               memory_dis=None, memory_dis_mask=None, local_kv=None):
        """Local and global cross-attention + the conditioned stage (one
        DDIM model call on the chunk, diffusion_det.py:551-557);
        ``local_kv`` the local keys (``DynamicHead.condition``)."""
        logits, boxes, pro = self.head.condition(
            feats, self.spatial_scales, bboxes, pro_features, t, memory,
            memory_mask, memory_dis=memory_dis, memory_dis_mask=memory_dis_mask,
            local_kv=local_kv)
        return logits[-1].float(), boxes[-1].float(), pro

    def full_forward_test(self, feats, bboxes, t, memory, memory_mask,
                          memory_dis=None, memory_dis_mask=None, local_kv=None):
        """The whole stack on the given boxes, one DDIM step of the xN
        ensemble (box_head.py:286-299 with sampling_timesteps > 1): the
        shared stages, then, with NUM_HEADS_LOCAL > 0, the conditioned
        stage on the last shared boxes and features.  Plain DiffusionDet
        (NUM_HEADS_LOCAL 0) returns the last shared stage.  Returns float32
        logits and boxes, and the last proposal features."""
        inter_logits, inter_boxes, pro, _ = self.head.shared_stages(
            feats, self.spatial_scales, bboxes, t)
        if self.num_heads_local == 0:
            return inter_logits[-1].float(), inter_boxes[-1].float(), pro
        return self.refine(feats, inter_boxes[-1], pro, t, memory, memory_mask,
                           memory_dis, memory_dis_mask, local_kv)

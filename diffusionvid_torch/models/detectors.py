"""Meta-architecture dispatch: config → the port's model.

Port of ``diffusionvid_tpu/models/detectors.py:15-115`` for the methods the
port runs: ``diffusion`` (``DiffusionDetArch``) and the MEGA family's
``base``, ``dff``, ``fgfa``, ``rdn``, ``mega`` and ``dafa``, with ResNeXt
(``RESNETS.NUM_GROUPS`` / ``WIDTH_PER_GROUP``) on the C4 ones and MEGA's
pixel flags, and the RPN's train and test selection sizes
(``MODEL.RPN.*_NMS_TOP_N_TRAIN`` / ``_TEST``).  RetinaNet and the mask and
keypoint heads raise and name their ROADMAP.md item (A8).  The model is
placed on the card unless ``device`` says otherwise, with random weights
drawn from ``seed``.  As in the JAX package, the MEGA family keeps its
modules' pixel mean and std whatever ``MODEL.PIXEL_MEAN`` says (the
defaults are the same).
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device


def video_method(cfg) -> str:
    """The VID method the CLIs run: ``base`` unless ``VID.ENABLE``."""
    return cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"


def check_supported(cfg):
    """Raise, naming the ROADMAP.md item, for what the port does not run."""
    method = video_method(cfg)
    arch = cfg.MODEL.META_ARCHITECTURE
    if method == "diffusion" or arch == "DiffusionDet":
        return
    if cfg.MODEL.RETINANET_ON or arch == "RetinaNet":
        raise NotImplementedError("RetinaNet is not ported: ROADMAP.md A8")
    if method not in ("base", "dff", "fgfa", "rdn", "mega", "dafa"):
        raise ValueError(f"unknown META_ARCHITECTURE={arch} / VID.METHOD={method}")
    if cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError("MODEL.MASK_ON / KEYPOINT_ON (the mask and keypoint "
                                  "heads) are not ported: ROADMAP.md A8")


def compute_dtype(cfg):
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def build_detection_model(cfg, device=None, dtype=None, seed: int = 0, **kw):
    """cfg → the model of its meta-architecture, in eval mode on ``device``
    (None: the card, raising without one).  ``kw`` goes to
    ``DiffusionDetArch.from_config`` (``swin_kernel``)."""
    check_supported(cfg)
    method = video_method(cfg)
    if method == "diffusion" or cfg.MODEL.META_ARCHITECTURE == "DiffusionDet":
        from .diffusion_det import DiffusionDetArch
        return DiffusionDetArch.from_config(cfg, device=device, dtype=dtype, seed=seed, **kw)
    device = resolve_device(device)
    dt = dtype if dtype is not None else compute_dtype(cfg)
    depth = cfg.MODEL.RESNETS.DEPTH
    ncls = cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
    dil = cfg.MODEL.RESNETS.RES5_DILATION
    rpn = cfg.MODEL.RPN
    mega = cfg.MODEL.VID.MEGA
    # the JAX builder's nms_kw: ResNeXt reaches every C4 architecture
    trunk = dict(num_groups=cfg.MODEL.RESNETS.NUM_GROUPS,
                 width_per_group=cfg.MODEL.RESNETS.WIDTH_PER_GROUP)
    nms = dict(pre_nms=rpn.PRE_NMS_TOP_N_TEST, post_nms=rpn.POST_NMS_TOP_N_TEST,
               pre_nms_train=rpn.PRE_NMS_TOP_N_TRAIN, post_nms_train=rpn.POST_NMS_TOP_N_TRAIN)
    if method == "base":
        from .rcnn import GeneralizedRCNN
        model = GeneralizedRCNN(depth=depth, num_classes=ncls,
                                anchor_sizes=tuple(rpn.ANCHOR_SIZES),
                                pre_nms_test=rpn.PRE_NMS_TOP_N_TEST,
                                post_nms_test=rpn.POST_NMS_TOP_N_TEST,
                                pre_nms_train=rpn.PRE_NMS_TOP_N_TRAIN,
                                post_nms_train=rpn.POST_NMS_TOP_N_TRAIN, res5_dilation=dil,
                                compute_dtype=dt, **trunk)
    elif method == "dff":
        from .video_archs import DFFArch
        model = DFFArch(depth=depth, num_classes=ncls,
                        key_frame_duration=cfg.MODEL.VID.DFF.KEY_FRAME_DURATION,
                        res5_dilation=dil, compute_dtype=dt, **nms, **trunk)
    elif method == "fgfa":
        from .video_archs import FGFAArch
        model = FGFAArch(depth=depth, num_classes=ncls, res5_dilation=dil, compute_dtype=dt,
                         **nms, **trunk)
    elif method == "dafa":
        from .dafa import SparseRCNNDAFA
        model = SparseRCNNDAFA(depth=depth, num_classes=cfg.MODEL.DiffusionDet.NUM_CLASSES,
                               num_proposals=cfg.MODEL.DiffusionDet.NUM_PROPOSALS,
                               memory_size=mega.MEMORY_MANAGEMENT_SIZE_TEST,
                               res_stage=mega.GLOBAL.RES_STAGE, compute_dtype=dt)
    else:
        from .video_archs import MEGAArch, RDNArch
        attn = cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION
        ref_post = cfg.MODEL.VID.RPN.REF_POST_NMS_TOP_N
        # ATTENTION.ENABLE off gives no relation stage, which is also what
        # arms LOCAL.PIXEL_ATTEND's replacement of the box relation; the JAX
        # builder gives RDN no pixel flag: only MEGA reads them
        common = dict(depth=depth, num_classes=ncls, res5_dilation=dil,
                      relation_stages=attn.STAGE if attn.ENABLE else 0,
                      advanced_stages=attn.ADVANCED_STAGE,
                      advanced_num=int(ref_post * cfg.MODEL.VID.RDN.RATIO),
                      ref_post_nms=ref_post, compute_dtype=dt, **nms, **trunk)
        if method == "rdn":
            model = RDNArch(**common)
        else:
            model = MEGAArch(**common, memory_size=mega.MEMORY_MANAGEMENT_SIZE_TEST,
                             use_stage_mem=mega.MEMORY.ENABLE, mem_frames=mega.MEMORY.SIZE,
                             pixel_attend_local=mega.LOCAL.PIXEL_ATTEND,
                             pixel_attend_global=mega.GLOBAL.PIXEL_ATTEND,
                             pixel_mem_size=mega.MEMORY_MANAGEMENT_SIZE_PIXEL_TEST)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

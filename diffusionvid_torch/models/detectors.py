"""Meta-architecture dispatch: config → the port's model.

Port of ``diffusionvid_tpu/models/detectors.py:15-115`` for the methods the
port runs: ``diffusion`` (``DiffusionDetArch``) and the MEGA family's
``base``, ``rdn``, ``mega`` and ``dafa``.  The rest raise and name their
ROADMAP.md item.  The model is placed on the card unless ``device`` says
otherwise, with random weights drawn from ``seed``.  As in the JAX package,
the MEGA family keeps its modules' pixel mean and std whatever
``MODEL.PIXEL_MEAN`` says (the defaults are the same).
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device

REFUSALS = {
    "dff": "VID.METHOD dff (flow warping, models/flownet.py) is not ported: ROADMAP.md A7.1",
    "fgfa": "VID.METHOD fgfa (flow warping, models/flownet.py) is not ported: ROADMAP.md A7.1",
}


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
    if method in REFUSALS:
        raise NotImplementedError(REFUSALS[method])
    if method not in ("base", "rdn", "mega", "dafa"):
        raise ValueError(f"unknown META_ARCHITECTURE={arch} / VID.METHOD={method}")
    if method != "dafa" and cfg.MODEL.RESNETS.NUM_GROUPS > 1:
        raise NotImplementedError(
            "RESNETS.NUM_GROUPS > 1 (ResNeXt) is not ported: ROADMAP.md A7.3")
    if cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError("MODEL.MASK_ON / KEYPOINT_ON (the mask and keypoint "
                                  "heads) are not ported: ROADMAP.md A8")
    mega = cfg.MODEL.VID.MEGA
    attn = cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION
    stages = attn.STAGE if attn.ENABLE else 0
    # the JAX builder gives RDN no pixel flag: only MEGA reads them
    if method == "mega" and ((mega.LOCAL.PIXEL_ATTEND and stages == 0)
                             or mega.GLOBAL.PIXEL_ATTEND):
        raise NotImplementedError("LOCAL/GLOBAL.PIXEL_ATTEND (the pixel-attention paths) "
                                  "is not ported: ROADMAP.md A7.2")
    if cfg.TEST.BBOX_AUG.ENABLED:
        raise NotImplementedError("TEST.BBOX_AUG is not ported: ROADMAP.md A7.4")


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
    if method == "base":
        from .rcnn import GeneralizedRCNN
        model = GeneralizedRCNN(depth=depth, num_classes=ncls,
                                anchor_sizes=tuple(rpn.ANCHOR_SIZES),
                                pre_nms_test=rpn.PRE_NMS_TOP_N_TEST,
                                post_nms_test=rpn.POST_NMS_TOP_N_TEST, res5_dilation=dil,
                                compute_dtype=dt)
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
        common = dict(depth=depth, num_classes=ncls, res5_dilation=dil,
                      pre_nms=rpn.PRE_NMS_TOP_N_TEST, post_nms=rpn.POST_NMS_TOP_N_TEST,
                      relation_stages=attn.STAGE if attn.ENABLE else 0,
                      advanced_stages=attn.ADVANCED_STAGE,
                      advanced_num=int(ref_post * cfg.MODEL.VID.RDN.RATIO),
                      ref_post_nms=ref_post, compute_dtype=dt)
        if method == "rdn":
            model = RDNArch(**common)
        else:
            model = MEGAArch(**common, memory_size=mega.MEMORY_MANAGEMENT_SIZE_TEST,
                             use_stage_mem=mega.MEMORY.ENABLE, mem_frames=mega.MEMORY.SIZE,
                             pixel_attend_local=mega.LOCAL.PIXEL_ATTEND,
                             pixel_attend_global=mega.GLOBAL.PIXEL_ATTEND)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

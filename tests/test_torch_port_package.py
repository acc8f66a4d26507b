"""The port stands alone: no JAX import anywhere in it, it imports with JAX
blocked, its config loads the repository's YAMLs as the JAX package does,
and its entry points refuse to fall back to the CPU without being asked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from diffusionvid_tpu.config import load_config as jax_load_config

from diffusionvid_torch.config import load_config
from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
from diffusionvid_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffusionvid_tpu")
PORT_FILES = sorted((ROOT / "diffusionvid_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
CONFIGS = ["configs/vid_R_101_DiffusionVID.yaml", "configs/vid_R_50_tiny_synthetic.yaml",
           "configs/vid_Swin_B_DiffusionVID.yaml", "configs/vid_R_101_C4_1x.yaml",
           "configs/RDN/vid_R_101_C4_RDN_base_1x.yaml", "configs/MEGA/vid_R_101_C4_MEGA_1x.yaml",
           "configs/MEGA/vid_R_101_C4_DAFA_1x.yaml", "configs/DFF/vid_R_101_C4_DFF_1x.yaml",
           "configs/FGFA/vid_R_101_C4_FGFA_1x.yaml", "configs/MEGA/vid_X_101_C4_MEGA_1x.yaml",
           "configs/e2e_mask_rcnn_R_50_C4_1x.yaml"]
# the keys the MEGA family's builder, engine and CLI read
MEGA_KEYS = {"MODEL.RPN.ANCHOR_SIZES", "MODEL.RPN.PRE_NMS_TOP_N_TEST",
             "MODEL.RPN.POST_NMS_TOP_N_TEST", "MODEL.ROI_BOX_HEAD.NUM_CLASSES",
             "MODEL.RESNETS.RES5_DILATION", "MODEL.VID.ROI_BOX_HEAD.ATTENTION.ADVANCED_STAGE",
             "MODEL.VID.RPN.REF_POST_NMS_TOP_N", "MODEL.VID.RDN.RATIO",
             "MODEL.VID.MEGA.MEMORY.ENABLE", "MODEL.VID.MEGA.MEMORY.SIZE",
             "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "MODEL.VID.MEGA.LOCAL.PIXEL_ATTEND",
             "MODEL.VID.MEGA.GLOBAL.PIXEL_ATTEND", "MODEL.VID.MEGA.SHUFFLED_CUR_TEST",
             "MODEL.VID.DFF.KEY_FRAME_DURATION", "TEST.BBOX_AUG.ENABLED", "TEST.BBOX_AUG.SCALES",
             "MODEL.MASK_ON", "MODEL.KEYPOINT_ON", "MODEL.RETINANET_ON", "MODEL.VID.METHOD",
             "MODEL.META_ARCHITECTURE", "TEST.BBOX_AUG.H_FLIP", "TEST.BBOX_AUG.MAX_SIZE",
             "TEST.BBOX_AUG.SCALE_H_FLIP", "MODEL.RESNETS.NUM_GROUPS",
             "MODEL.RESNETS.WIDTH_PER_GROUP", "MODEL.RESNETS.STRIDE_IN_1X1",
             "MODEL.VID.FGFA.MIN_OFFSET", "MODEL.VID.FGFA.MAX_OFFSET", "MODEL.VID.DFF.MIN_OFFSET",
             "MODEL.VID.MEGA.ALL_FRAME_INTERVAL", "MODEL.VID.MEGA.KEY_FRAME_LOCATION",
             "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_PIXEL_TEST",
             "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_PIXEL_TRAIN"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_imports_with_jax_blocked():
    mods = sorted("diffusionvid_torch." + ".".join(p.relative_to(ROOT / "diffusionvid_torch")
                                                   .with_suffix("").parts)
                  for p in (ROOT / "diffusionvid_torch").rglob("*.py")
                  if p.name != "__init__.py")
    for new in ("config.node", "data.vid_dataset", "data.sampling", "data.prefetch",
                "data.catalog", "data.transforms", "evaluation.vid_eval", "engine.seq_nms",
                "engine.inference", "tools.test_net", "tools.test_prediction",
                "utils.logging", "utils.metrics_io", "utils.profiling", "data.samplers",
                "tools.train_net", "utils.collect_env", "utils.convert", "models.rpn",
                "models.box_head", "models.rcnn", "models.relation", "models.video_archs",
                "models.dafa", "models.detectors", "engine.inference_mega", "models.flownet",
                "models.pixel_attention", "engine.bbox_aug", "structures.masks",
                "evaluation.coco_eval", "data.coco_voc", "data.cityscapes",
                "engine.inference_still", "models.mask_keypoint", "models.retinanet"):
        assert "diffusionvid_torch." + new in mods, new
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
            f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("cfg_file", CONFIGS)
def test_config_matches_jax_package(cfg_file):
    cfg = load_config(str(ROOT / cfg_file))
    ref = dict(_leaves(jax_load_config(str(ROOT / cfg_file))))
    shared = {k: v for k, v in _leaves(cfg) if k in ref and k != "MODEL.DEVICE"}
    assert len(shared) > 50
    assert {"MODEL.RPN_ONLY", "TEST.EXPECTED_RESULTS", "TEST.EXPECTED_RESULTS_SIGMA_TOL",
            "TEST.SEQ_NMS", "DATASETS.TEST", "MODEL.VID.MEGA.GLOBAL.SHUFFLE", "INPUT.TRANSFORM",
            "SOLVER.TEST_PERIOD", "SOLVER.IMS_PER_BATCH", "SOLVER.BATCH_REUSE_STEPS",
            "DATALOADER.ASPECT_RATIO_GROUPING", "INPUT.MIN_SIZE_TRAIN", "INPUT.MAX_SIZE_TRAIN",
            "DATASETS.TRAIN", "SOLVER.CHECKPOINT_PERIOD", "SOLVER.MAX_ITER"} | MEGA_KEYS <= set(shared)
    for k, v in shared.items():
        assert v == ref[k], k


@pytest.mark.parametrize("cfg_file", CONFIGS)
def test_config_with_cli_opts_matches_jax_package(cfg_file):
    """The test CLI's ``KEY VALUE`` overrides merge as in the JAX package."""
    opts = ["MODEL.DiffusionDet.SAMPLE_STEP", "4", "INPUT.MIN_SIZE_TEST", "480",
            "TEST.SEQ_NMS", "True", "MODEL.WEIGHT", "''", "DATASETS.TEST", "('VID_val_frames',)"]
    cfg = dict(_leaves(load_config(str(ROOT / cfg_file), opts)))
    ref = dict(_leaves(jax_load_config(str(ROOT / cfg_file), opts)))
    for k in opts[0::2]:
        assert cfg[k] == ref[k], k


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(str(ROOT / CONFIGS[1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionDetArch.from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionDetArch.from_config(cfg, device="cuda")


def test_from_config_on_cpu():
    cfg = load_config(str(ROOT / CONFIGS[1]))
    model = DiffusionDetArch.from_config(cfg, device="cpu")
    assert model.compute_dtype == torch.float32
    assert len(model.head.head_series) == 1 and len(model.head.head_series_cond) == 1
    assert model.head.top_k == (50, 25)
    flagship = load_config(str(ROOT / CONFIGS[0]))
    assert flagship.TPU.COMPUTE_DTYPE == "bfloat16"
    assert flagship.MODEL.DiffusionDet.NUM_HEADS == 3


def test_from_config_builds_swin_b_on_cpu():
    """The Swin-B flagship: Swin-B trunk (embed 128, depths 2/2/18/2),
    FPN over swin1..3 into p3..p5, bf16 activations."""
    from diffusionvid_torch.models.swin import SwinTransformer
    cfg = load_config(str(ROOT / CONFIGS[2]))
    model = DiffusionDetArch.from_config(cfg, device="cpu")
    trunk = model.backbone.bottom_up
    assert isinstance(trunk, SwinTransformer) and model.backbone_type == "swin"
    assert [len(layer.blocks) for layer in trunk.layers] == [2, 2, 18, 2]
    assert trunk.dims == [128, 256, 512, 1024] and trunk.out_indices == (1, 2, 3)
    assert model.backbone.levels == [3, 4, 5]
    assert [getattr(model.backbone, f"fpn_lateral{lvl}").weight.shape[1]
            for lvl in (3, 4, 5)] == [256, 512, 1024]
    assert model.compute_dtype == torch.bfloat16
    assert next(model.parameters()).device.type == "cpu"
    assert cfg.INPUT.INFER_BATCH == 4


def test_kernel_sources_and_build_target():
    """Every kernel source has its library name keyed by a content hash,
    inside the repository's git-ignored build directory."""
    assert _build.sources() == ["dynamic_conv", "roi_align_bwd", "roi_align_fwd",
                                "swin_block_attn", "swin_block_mlp", "window_attn_qkv"]
    for name in _build.sources():
        target = _build._target(name)
        assert target.parent == ROOT / "build" / "diffusionvid_torch"
        assert target.name.startswith(f"lib{name}-") and target.suffix == ".so"
    assert "build/" in (ROOT / ".gitignore").read_text().split()

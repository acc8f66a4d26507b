"""DFF, FGFA, ResNeXt and ``TEST.BBOX_AUG`` in the port against the JAX package.

Module by module on inputs made with numpy from a seed, weights from the
JAX package's init carried by ``state_dict_from_jax``, in float32 within
1e-4 relative: FlowNetS's ``Deconv`` (which correlates with the stored
kernel: the port flips it), ``_avgpool2`` on odd extents, ``FlowNetS``
with and without DFF's scale map (its deconvolutions cropped by
``_crop_like``), ``warp_features`` with flows that leave the map,
``EmbedNet``, a grouped bottleneck and the grouped res5 head; the
``bbox_aug`` numpy parts array for array.

Then the whole paths: each config (``DFF``, ``FGFA``, ``MEGA`` on the
X-101 config's ResNeXt, ``base`` with ``TEST.BBOX_AUG``) cut to depth 18, built
by both packages' builders, the JAX package's init conditioned as in
``test_torch_port_rcnn.py`` and carried over; ``run_inference_video_arch``
of both packages on the ``mini_vid`` fixture at 64x96: frame by frame the
labels and the detection counts equal, the scores and boxes within 1e-3
relative, the AP50s equal.  The port's test CLI runs the same config with
the JAX tree as a ``--checkpoint`` and gives the JAX run's predictions.
Last, ``--torch-weights`` copies into DFF, FGFA and X-101 MEGA what the
JAX package's loader copies: nothing, since both nest the trunk under
``detector``.
"""

import functools
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.config import load_config as jax_load_config
from diffusionvid_tpu.data import SampleConfig as JaxSampleConfig
from diffusionvid_tpu.engine import bbox_aug as jax_bbox_aug
from diffusionvid_tpu.engine import inference_mega as jax_inference_mega
from diffusionvid_tpu.models import box_head as jax_box_head
from diffusionvid_tpu.models import flownet as jax_flownet
from diffusionvid_tpu.models import resnet as jax_resnet
from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
from diffusionvid_tpu.utils import checkpoint as jax_checkpoint
from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained

from diffusionvid_torch.config import load_config
from diffusionvid_torch.data import SampleConfig, VIDDataset
from diffusionvid_torch.engine import bbox_aug
from diffusionvid_torch.engine.inference_mega import run_inference_video_arch
from diffusionvid_torch.models import box_head, flownet, resnet
from diffusionvid_torch.models.detectors import build_detection_model, video_method
from diffusionvid_torch.tools import test_net
from diffusionvid_torch.utils.convert import load_weights_into, state_dict_from_jax
from test_data import mini_vid  # noqa: F401  (the shared fixture)
from test_torch_port_inference import catalog_vid  # noqa: F401
from test_torch_port_mega import predictions_agree, reference_pth  # noqa: F401
from test_torch_port_rcnn import conditioned, one_thread, rel_err  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-4


def _port_sub(tree, prefix: str):
    """``state_dict_from_jax`` of ``{prefix: tree}`` with the prefix off."""
    return {k[len(prefix) + 1:]: v for k, v in state_dict_from_jax({prefix: tree}).items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- FlowNetS and warping

@pytest.mark.parametrize("cin, cout, hw", [(5, 2, (6, 7)), (16, 8, (3, 4))])
def test_deconv_flips_the_stored_kernel(cin, cout, hw):
    rng = np.random.RandomState(cin)
    x = rng.randn(1, *hw, cin).astype(np.float32)
    jmod = jax_flownet.Deconv(cout)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), x)["params"]
    params = dict(params, bias=rng.randn(cout).astype(np.float32))
    want = jmod.apply({"params": params}, x)
    mod = flownet.Deconv(cin, cout)
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    with torch.no_grad():
        got = mod(_nchw(x))
        unflipped = torch.nn.functional.conv_transpose2d(_nchw(x), mod.weight, mod.bias,
                                                         stride=2)
    assert got.shape[2:] == (2 * hw[0] + 2, 2 * hw[1] + 2)
    assert rel_err(_nhwc(got), want) < RTOL
    assert rel_err(_nhwc(unflipped), want) > 0.1      # the library's kernel convention


@pytest.mark.parametrize("hw", [(5, 7), (4, 9), (6, 6)])
def test_avgpool2_ceil_mode(hw):
    x = np.random.RandomState(hw[1]).randn(2, *hw, 3).astype(np.float32)
    want = jax_flownet._avgpool2(jnp.asarray(x))
    got = flownet._avgpool2(_nchw(x))
    assert got.shape[2:] == ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    assert rel_err(_nhwc(got), want) < 1e-6


@functools.lru_cache(maxsize=None)
def jax_flownet_params(predict_scale: bool) -> dict:
    net = jax_flownet.FlowNetS(predict_scale=predict_scale)
    init = jax.jit(lambda r: net.init(r, jnp.zeros((1, 64, 96, 6))))
    return conditioned(init(jax.random.PRNGKey(3))["params"], 3)


@pytest.mark.parametrize("predict_scale, hw", [(True, (64, 96)), (False, (72, 100))],
                         ids=["dff_scale", "fgfa"])
def test_flownet_matches(predict_scale, hw):
    """Two image pairs in 0..1; at 72x100 the encoder's extents are odd
    (the pools pad an edge), and at both sizes every deconvolution is
    cropped."""
    params = jax_flownet_params(predict_scale)
    pair = np.random.RandomState(7).uniform(0, 1, (2, *hw, 6)).astype(np.float32)
    net = jax_flownet.FlowNetS(predict_scale=predict_scale)
    want = jax.jit(lambda p, x: net.apply({"params": p}, x))(params, pair)
    port = flownet.FlowNetS(predict_scale=predict_scale)
    port.load_state_dict(_port_sub(params, "flownet"), strict=True)
    with torch.no_grad():
        got = port(_nchw(pair))
    got, want = (got, want) if predict_scale else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == _nchw(w).shape
        assert rel_err(_nhwc(g), w) < RTOL
        assert np.abs(np.asarray(w)).max() > 0.1


def test_warp_features_matches():
    """Flows up to ±6 pixels on a 5x7 map: samples inside, across the
    border (some corners zeroed) and wholly outside."""
    rng = np.random.RandomState(8)
    feat = rng.randn(2, 5, 7, 16).astype(np.float32)
    flow = rng.uniform(-6, 6, (2, 5, 7, 2)).astype(np.float32)
    flow[0, 0, 0] = (0.25, -0.5)      # one corner row above the map
    flow[0, 1, 1] = (2.0, 3.0)        # on the grid
    want = jax_flownet.warp_features(jnp.asarray(feat), jnp.asarray(flow))
    got = flownet.warp_features(_nchw(feat), _nchw(flow))
    assert rel_err(_nhwc(got), want) < 1e-6
    assert (np.abs(np.asarray(want)).sum(-1) == 0).any()


def test_embednet_matches():
    x = np.random.RandomState(9).randn(3, 4, 6, 1024).astype(np.float32)
    net = jax_flownet.EmbedNet()
    params = conditioned(jax.jit(net.init)(jax.random.PRNGKey(4), x)["params"])
    want = net.apply({"params": params}, x)
    port = flownet.EmbedNet()
    port.load_state_dict(_port_sub(params, "embednet"), strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert rel_err(_nhwc(got), want) < RTOL


# ---------------------------------------------------------------- ResNeXt

@pytest.mark.parametrize("groups, stride, dilation", [(8, 2, 1), (4, 1, 2)])
def test_grouped_bottleneck_matches(groups, stride, dilation):
    """One bottleneck with a shortcut, its 3x3 grouped; the weights carry
    over with the trunk's name rule, the grouped kernel in torch's
    ``[out, in / groups, 3, 3]`` on both sides."""
    x = np.random.RandomState(groups).randn(2, 9, 11, 32).astype(np.float32)
    block = jax_resnet.Bottleneck(mid=64, out=128, stride=stride, dilation=dilation,
                                  has_shortcut=True, groups=groups)
    params = conditioned(jax.jit(block.init)(jax.random.PRNGKey(5), x)["params"])
    assert params["conv2"]["weight"].shape == (64, 64 // groups, 3, 3)
    want = block.apply({"params": params}, x)
    port = resnet.BottleneckBlock(32, 64, 128, stride, dilation, groups)
    state = state_dict_from_jax({"backbone": {"layer1.0": params}})
    port.load_state_dict({k[len("backbone.bottom_up.res2.0."):]: v for k, v in state.items()},
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert rel_err(_nhwc(got), want) < RTOL


def test_grouped_res5_head_matches():
    """The C4 box head on ResNeXt (4 groups of 8, res5's bottlenecks 256
    wide at depth 18): ROIAlign 14x14 → grouped res5 → mean."""
    rng = np.random.RandomState(3)
    feat = rng.randn(1, 4, 6, 1024).astype(np.float32)
    xy = rng.uniform(0, 60, (1, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (1, 6, 2))], -1).astype(np.float32)
    jext = jax_box_head.C4BoxFeatureExtractor(depth=18, num_groups=4, width_per_group=8)
    params = conditioned(jax.jit(jext.init)(jax.random.PRNGKey(6), feat, boxes)["params"])
    want = jax.jit(lambda p, f, b: jext.apply({"params": p}, f, b))(params, feat, boxes)
    ext = box_head.C4BoxFeatureExtractor(18, 1, 4, 8)
    assert ext.head.res5[0].conv2.weight.shape == (256, 64, 3, 3)
    ext.load_state_dict(_port_sub(params, "roi_head"), strict=True)
    with torch.no_grad():
        got = ext(torch.from_numpy(feat), torch.from_numpy(boxes))
    assert rel_err(got.numpy(), want) < RTOL


# ---------------------------------------------------------------- bbox_aug

def _dets(rng, n, ncls=4):
    xy = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1).astype(np.float32)
    scores = np.round(rng.uniform(0.05, 1, n), 2).astype(np.float32)     # ties
    return {"boxes": boxes, "scores": scores, "labels": rng.randint(1, ncls, n)}


@pytest.mark.parametrize("sets, iou, max_dets", [((30, 25, 0), 0.5, 300), ((40, 40), 0.3, 12),
                                                 ((0,), 0.5, 300)],
                         ids=["three_sets", "capped", "empty"])
def test_merge_augmented_equal(sets, iou, max_dets):
    rng = np.random.RandomState(len(sets) + max_dets)
    det_sets = [_dets(rng, n) for n in sets]
    if len(sets) > 1:     # the same boxes from two augmentations
        det_sets[1]["boxes"][:3] = det_sets[0]["boxes"][:3]
    want = jax_bbox_aug.merge_augmented(det_sets, iou, max_dets)
    got = bbox_aug.merge_augmented(det_sets, iou, max_dets)
    for k in ("boxes", "scores", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if sum(sets):
        assert 0 < len(got["scores"]) <= min(max_dets, sum(sets))


def test_flip_boxes_back_and_hflip_tta_equal():
    rng = np.random.RandomState(2)
    boxes = _dets(rng, 10)["boxes"]
    np.testing.assert_array_equal(bbox_aug.flip_boxes_back(boxes, 97),
                                  jax_bbox_aug.flip_boxes_back(boxes, 97))
    frames = rng.uniform(0, 255, (2, 6, 9, 3)).astype(np.float32)

    def detect(fr, whwh, bias=0.0):     # boxes and scores that follow the pixels
        out = []
        for img in fr:
            col = img.mean(axis=(0, 2))
            x = np.argsort(col)[-3:].astype(np.float32)
            b = np.stack([x, x * 0, x + 2, x * 0 + 5], 1).astype(np.float32)
            out.append({"boxes": b, "scores": (col[x.astype(int)] / 255 + bias).astype(
                np.float32), "labels": np.arange(1, 4)})
        return out

    whwh = np.asarray([9, 6, 9, 6], np.float32)
    got = bbox_aug.hflip_tta(detect, frames, whwh, bias=0.1)
    want = jax_bbox_aug.hflip_tta(detect, frames, whwh, bias=0.1)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[k], w[k])


def test_scale_variant_without_cv2_is_the_ports_own(monkeypatch):
    """``TEST.BBOX_AUG``'s scale variants resize with ``cv2`` as the JAX
    package does; where ``cv2`` is not installed (the card's host), with
    ``resize_bilinear``: within one grey level of ``cv2`` on uint8 frames."""
    import importlib.util

    from diffusionvid_torch.data.transforms import resize_bilinear, transform_frame
    from diffusionvid_torch.engine.inference_mega import scale_variant
    img = np.random.RandomState(3).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    with_cv2 = scale_variant(img, 0.75, True, (64, 160))
    np.testing.assert_array_equal(with_cv2, transform_frame(img, 0.75, True, (64, 160)))
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "cv2" else real(name, *a))
    without = scale_variant(img, 0.75, True, (64, 160))
    assert without.shape == (64, 160, 3) and not without[:, 72:].any()
    np.testing.assert_array_equal(without[:48, :72], resize_bilinear(img, (48, 72))[:, ::-1])
    assert np.abs(without.astype(int) - with_cv2.astype(int)).max() <= 1


# ---------------------------------------------------------------- whole paths

TINY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "5",
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100", "MODEL.RPN.POST_NMS_TOP_N_TEST", "8",
        "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "INPUT.INFER_BATCH", "4",
        "MODEL.VID.MEGA.GLOBAL.SIZE", "3", "TPU.COMPUTE_DTYPE", "float32", "MODEL.WEIGHT", "''"]
# (config, its overrides), each run over the fixture's first video: DFF with
# keys at frames 0 and 4; MEGA on the X-101 config's ResNeXt narrowed to 8
# groups of 8 (res2's bottleneck 64 wide, as R-18's), 8 reference proposals
# a frame and its stage rings off (they push 75 rows a frame; the rings are
# held in test_torch_port_rcnn.py); base with the h-flip and one scale, also
# flipped (the variant re-resized with cv2 on both sides into a 96x160
# bucket)
PATHS = {
    "dff": ("configs/DFF/vid_R_101_C4_DFF_1x.yaml", ["MODEL.VID.DFF.KEY_FRAME_DURATION", "4"]),
    "fgfa": ("configs/FGFA/vid_R_101_C4_FGFA_1x.yaml", []),
    "mega_x101": ("configs/MEGA/vid_X_101_C4_MEGA_1x.yaml",
                  ["MODEL.RESNETS.NUM_GROUPS", "8", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
                   "MODEL.VID.RPN.REF_POST_NMS_TOP_N", "8", "MODEL.VID.MEGA.MEMORY.ENABLE",
                   "False", "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "8"]),
    "base_bbox_aug": ("configs/vid_R_101_C4_1x.yaml",
                      ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.SCALES", "(80,)",
                       "TEST.BBOX_AUG.MAX_SIZE", "160", "TEST.BBOX_AUG.SCALE_H_FLIP", "True"]),
}


def jax_init(jmodel, method: str, h: int, w: int):
    """The JAX package's CLI init of each method (``tools/test_net.py``)."""
    cur, refs = jnp.zeros((1, h, w, 3)), jnp.zeros((2, h, w, 3))
    key = jax.random.PRNGKey(0)
    if method == "base":
        return jax.jit(lambda r: jmodel.init(r, cur, (h, w)))(key)
    if method == "dff":
        return jax.jit(lambda r: jmodel.init(r, cur, cur, (h, w), is_key=False))(key)
    if method == "fgfa":
        return jax.jit(lambda r: jmodel.init(r, cur, refs, (h, w)))(key)
    if getattr(jmodel, "pixel_replaces_box", False):
        # the pixel path's own call: the box forward of a model with no
        # relation stage and MEMORY.ENABLE stacks zero stage rings and raises;
        # at 160x240, a res4 map of 160 pixels (the pixel memories keep 100)
        cur, refs = jnp.zeros((1, 160, 240, 3)), jnp.zeros((3, 160, 240, 3))
        return jax.jit(lambda r: jmodel.init(
            r, cur, refs, jnp.ones(3, bool), (160, 240), jmodel.init_state(),
            jmodel.init_pixel_state(), method=type(jmodel).pixel_call))(key)
    return jax.jit(lambda r: jmodel.init(r, cur, refs, (h, w), state=jmodel.init_state()))(key)


@functools.lru_cache(maxsize=None)
def path_case(config: str, opts: tuple, seed: int = 0):
    """The config's JAX model and conditioned tree, and the port's config
    and model with that tree loaded strictly."""
    cfg = load_config(str(ROOT / config), list(opts))
    method = video_method(cfg)
    jmodel = jax_build(jax_load_config(str(ROOT / config), list(opts)))
    tree = conditioned(jax_init(jmodel, method, 64, 96)["params"], seed)
    if "flownet" in tree:   # flows of a few feature pixels, past the map's border
        conv5 = tree["flownet"]["Convolution5"]
        tree["flownet"]["Convolution5"] = {k: v * np.float32(8.0) for k, v in conv5.items()}
    model = build_detection_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return cfg, method, jmodel, tree, model.eval()


def sample_fields(cfg) -> dict:
    mega = cfg.MODEL.VID.MEGA
    return dict(num_global=mega.REF_NUM_GLOBAL, min_size=cfg.INPUT.MIN_SIZE_TEST,
                max_size=cfg.INPUT.MAX_SIZE_TEST, global_size=mega.GLOBAL.SIZE,
                infer_batch=cfg.INPUT.INFER_BATCH, shuffle_global=mega.GLOBAL.SHUFFLE)


def _datasets(spec):
    from diffusionvid_tpu.data import VIDDataset as JaxVID
    args = ("test_set", spec["root"], spec["img_dir"], spec["anno_dir"], spec["index"])
    return VIDDataset(*args, is_train=False, use_cache=False), JaxVID(
        *args, is_train=False, use_cache=False)


@functools.lru_cache(maxsize=None)
def jax_path_run(config: str, opts: tuple, spec_items: tuple):
    """The JAX package's ``run_inference_video_arch`` over the first video
    with the options its CLI passes: (predictions, AP50)."""
    cfg, method, jmodel, tree, _ = path_case(config, opts)
    _, jds = _datasets(dict(spec_items))
    aug = cfg.TEST.BBOX_AUG
    mega = cfg.MODEL.VID.MEGA
    preds, _, res = jax_inference_mega.run_inference_video_arch(
        jmodel, {"params": tree}, jds, JaxSampleConfig(**sample_fields(cfg)), method=method,
        key_frame_duration=cfg.MODEL.VID.DFF.KEY_FRAME_DURATION, max_videos=1,
        use_bbox_aug=bool(aug.ENABLED), bbox_aug_h_flip=bool(aug.H_FLIP),
        bbox_aug_scales=tuple(aug.SCALES), bbox_aug_max_size=int(aug.MAX_SIZE),
        bbox_aug_scale_h_flip=bool(aug.SCALE_H_FLIP),
        all_frame_interval=int(mega.ALL_FRAME_INTERVAL),
        key_frame_location=int(mega.KEY_FRAME_LOCATION))
    return preds, res["ap50"]


def run_path_vs_jax(name, spec, paths, tiny):
    """``run_inference_video_arch`` of both packages on ``spec``: the port's
    predictions, the JAX package's, both AP50s and the case."""
    config, extra = paths[name]
    opts = tuple(tiny + extra)
    cfg, method, _, _, model = path_case(config, opts)
    jpreds, jap = jax_path_run(config, opts, tuple(sorted(spec.items())))
    ds, _ = _datasets(spec)
    kw = test_net.video_arch_args(cfg)
    preds, _, res = run_inference_video_arch(model, ds, SampleConfig(**sample_fields(cfg)),
                                             method=method, max_videos=1, **kw)
    assert len(preds) == 6
    predictions_agree(preds, jpreds, name)
    assert res["ap50"] == jap
    return preds, jpreds


@pytest.mark.parametrize("name", sorted(PATHS))
def test_path_vs_jax(mini_vid, name):  # noqa: F811
    preds, _ = run_path_vs_jax(name, mini_vid, PATHS, TINY)
    for p in preds:   # original coordinates: the 160x240 frame, not 64x96
        assert p["boxes"][:, 0::2].max(initial=0) <= 240
        assert p["boxes"][:, 1::2].max(initial=0) <= 160


def cli_vs_jax(name, mini_vid, catalog_vid, tmp_path, monkeypatch, paths, tiny):  # noqa: F811
    """The test CLI with the JAX tree as a JAX package checkpoint: its
    predictions are the JAX run's."""
    config, extra = paths[name]
    opts = list(tiny + extra)
    _, _, _, tree, _ = path_case(config, tuple(opts))
    jpreds, jap = jax_path_run(config, tuple(opts), tuple(sorted(mini_vid.items())))
    monkeypatch.setattr(jax_checkpoint, "_HAS_ORBAX", False)
    ckpt = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), 1, tree)
    out = tmp_path / "out"
    args = ["--config-file", str(ROOT / config), "--data-dir", str(catalog_vid),
            "--output-dir", str(out), "--device", "cpu", "--checkpoint", ckpt,
            "--max-videos", "1"]
    results = test_net.main(args + opts)
    with open(out / "predictions.pkl", "rb") as f:
        preds = pickle.load(f)
    predictions_agree(preds, jpreds, f"CLI {name}")
    assert results["ap50"] == jap
    assert "FINAL AP50" in (out / "log.txt").read_text()


@pytest.mark.parametrize("name", sorted(PATHS))
def test_cli_vs_jax(mini_vid, catalog_vid, tmp_path, monkeypatch, name):  # noqa: F811
    cli_vs_jax(name, mini_vid, catalog_vid, tmp_path, monkeypatch, PATHS, TINY)


def test_bbox_aug_refused_off_base(mini_vid):  # noqa: F811
    """JAX's ``ValueError`` for ``TEST.BBOX_AUG`` on a temporal method, before
    any frame runs."""
    for method in ("dff", "fgfa", "rdn", "mega", "dafa"):
        with pytest.raises(ValueError, match="only implemented for METHOD 'base'"):
            run_inference_video_arch(None, None, None, method=method, use_bbox_aug=True)


@pytest.mark.parametrize("name", ["dff", "fgfa", "mega_x101"])
def test_torch_weights_copy_what_jax_copies(reference_pth, name):  # noqa: F811
    """The JAX loader has no FlowNet rule and nests every trunk under
    ``detector``: from a reference DiffusionVID file it copies nothing into
    DFF, FGFA or MEGA, and the port refuses the file the same way."""
    config, extra = PATHS[name]
    _, _, _, tree, model = path_case(config, tuple(TINY + extra))
    _, copied = jax_merge_pretrained(tree, load_torch_checkpoint(reference_pth)["params"],
                                     skip_keys=())
    assert copied == 0
    with pytest.raises(ValueError, match="no tensor matches"):
        load_weights_into(model, reference_pth)

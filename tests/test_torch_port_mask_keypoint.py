"""The mask and keypoint heads of the port against the JAX package.

On seeded numpy inputs and weights: ``ConvTranspose`` at the heads' two
shapes (2x2 stride 2; 4x4 stride 2 padding 1: JAX correlates with the
stored kernel), the keypoint head's x2 bilinear resize against
``jax.image.resize``, both heads on 5 ROIs, the whole ``GeneralizedRCNN``
with both heads at depth 18 on 64x96 (the ``CombinedROIHeads`` dict:
``dets``, ``masks``, ``keypoints`` within 1e-3), ``mask_loss`` and
``keypoint_loss`` with their gradients against ``jax.value_and_grad`` (a
logit exactly 0 among them: JAX's gradient at the kinks), ``paste_masks``,
``heatmaps_to_keypoints``, ``PolygonMasks`` and ``Keypoints``; the factory
on the shipped mask config, the names the JAX tree carries over to, and
``--torch-weights`` copying what the JAX loader copies.  Also the fault both
runners share: the heads' dict is not a ``BoxArray`` (ROADMAP.md §C 9).

The heads run 16 channels wide and the model keeps 16 detections an image
(both packages' head classes and ``postprocess_classic`` narrowed alike):
at their widths, on 300 detections, the JAX gather alone holds about 1 GB.
"""

import functools
from pathlib import Path
from typing import Sequence

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.config import load_config as jax_load_config
from diffusionvid_tpu.data import SampleConfig as JaxSampleConfig
from diffusionvid_tpu.data import VIDDataset as JaxVID
from diffusionvid_tpu.engine import inference_mega as jax_inference_mega
from diffusionvid_tpu.engine import inference_still as jax_still
from diffusionvid_tpu.models import mask_keypoint as jax_mk
from diffusionvid_tpu.models import rcnn as jax_rcnn
from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
from diffusionvid_tpu.structures import masks as jax_masks
from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained

from diffusionvid_torch.config import load_config
from diffusionvid_torch.data import SampleConfig, VIDDataset
from diffusionvid_torch.engine.inference_mega import run_inference_video_arch
from diffusionvid_torch.engine.inference_still import run_inference_still
from diffusionvid_torch.models import mask_keypoint as mk
from diffusionvid_torch.models import rcnn
from diffusionvid_torch.models.detectors import build_detection_model
from diffusionvid_torch.structures import masks
from diffusionvid_torch.utils.convert import _flatten, _torch_name, load_weights_into
from diffusionvid_torch.utils.convert import state_dict_from_jax
from test_data import mini_vid  # noqa: F401  (the shared fixture)
from test_torch_port_mega import reference_pth  # noqa: F401  (the shared fixture)
from test_torch_port_still import seeded_params
from test_torch_port_weights import one_thread, rel_err  # noqa: F401  (one_thread: the fixture)

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
CLASSES, KEYPOINTS, DETS, NARROW = 5, 4, 16, (16, 16)
RCNN = dict(depth=18, num_classes=CLASSES, pre_nms_test=100, post_nms_test=8)
RTOL = 1e-3
MASK_CONFIG = str(ROOT / "configs" / "e2e_mask_rcnn_R_50_C4_1x.yaml")


JAX_HEADS = {"MaskHead": jax_mk.MaskHead, "KeypointHead": jax_mk.KeypointHead}


class NarrowMaskHead(jax_mk.MaskHead):
    conv_layers: Sequence[int] = NARROW


class NarrowKeypointHead(jax_mk.KeypointHead):
    conv_layers: Sequence[int] = NARROW


def _rois(rng, b, r, h, w):
    xy = rng.uniform(-8, 0.7 * w, (b, r, 2))
    wh = rng.uniform(4, 0.6 * w, (b, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("kernel, stride, pad", [(2, 2, 0), (4, 2, 1)], ids=["k2s2", "k4s2p1"])
def test_conv_transpose_flips_the_stored_kernel(kernel, stride, pad):
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    layer = jax_mk.ConvTranspose(3, kernel, stride, padding=pad)
    params = seeded_params(layer, x, seed=kernel)
    want = layer.apply({"params": params}, x)
    port = mk.ConvTranspose(8, 3, kernel, stride, pad)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 12, 3)
    assert rel_err(got.numpy(), want) < 1e-6
    # the stored kernel, not flipped, is another function
    unflipped = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), port.weight, port.bias, stride, pad)
    assert rel_err(unflipped.permute(0, 2, 3, 1).detach().numpy(), want) > 0.1


def test_keypoint_resize_matches_jax_image_resize():
    x = np.random.RandomState(0).randn(3, 7, 7, 4).astype(np.float32)
    want = jax.image.resize(x, (3, 14, 14, 4), "linear")
    got = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(14, 14),
                                          mode="bilinear", align_corners=False)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-6


@pytest.mark.parametrize("kind", ["mask", "keypoint"])
def test_heads_match(kind):
    """Each head on an NHWC map of 64 channels at 1/16, 5 ROIs (some over
    the border): the ROIAlign, convolutions, transposed conv (and the
    keypoint head's resize) within 1e-5."""
    rng = np.random.RandomState(7)
    feat = rng.randn(1, 5, 7, 64).astype(np.float32)
    rois = _rois(rng, 1, 5, 80, 112)
    if kind == "mask":
        jhead, head = NarrowMaskHead(num_classes=CLASSES), mk.MaskHead(64, CLASSES, NARROW)
    else:
        jhead, head = NarrowKeypointHead(num_keypoints=KEYPOINTS), mk.KeypointHead(
            64, KEYPOINTS, NARROW)
    params = seeded_params(jhead, [feat], (1 / 16,), rois, seed=3)
    want = jax.jit(lambda p, f, r: jhead.apply({"params": p}, [f], (1 / 16,), r))(
        params, feat, rois)
    prefix = "mask_head" if kind == "mask" else "kp_head"
    head.load_state_dict({k[len(prefix) + 1:]: v for k, v in state_dict_from_jax(
        {prefix: params}).items()}, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(feat), 1 / 16, torch.from_numpy(rois))
    side = 28 if kind == "mask" else 56
    assert got.shape == want.shape == (1, 5, side, side, CLASSES if kind == "mask" else KEYPOINTS)
    assert rel_err(got.numpy(), want) < 1e-5


# ---------------------------------------------------------------- the model's dict

@pytest.fixture(scope="module")
def heads_model():
    """(JAX model, params, port model) of ``GeneralizedRCNN`` with both
    heads (narrow), 16 detections an image in both packages."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_mk, "MaskHead", NarrowMaskHead)
    patch.setattr(jax_mk, "KeypointHead", NarrowKeypointHead)
    patch.setattr(jax_rcnn, "postprocess_classic",
                  functools.partial(jax_rcnn.postprocess_classic, detections=DETS))
    patch.setattr(rcnn, "postprocess_classic",
                  functools.partial(rcnn.postprocess_classic, detections=DETS))
    jmodel = jax_rcnn.GeneralizedRCNN(**RCNN, mask_on=True, keypoint_on=True,
                                      num_keypoints=KEYPOINTS)
    params = seeded_params(jmodel, jnp.zeros((1, H, W, 3)), (H, W), seed=5)
    for head in ("mask_head", "kp_head"):     # logits of a few units: masks spread over (0, 1)
        params[head] = jax.tree.map(lambda a: a * np.float32(2.0) if a.ndim == 4 else a,
                                    params[head])
    model = rcnn.GeneralizedRCNN(**RCNN, mask_on=True, keypoint_on=True,
                                 num_keypoints=KEYPOINTS)
    model.mask_head = mk.MaskHead(1024, CLASSES, NARROW)
    model.kp_head = mk.KeypointHead(1024, KEYPOINTS, NARROW)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    yield jmodel, params, model.eval()
    patch.undo()


def test_combined_roi_heads_dict_matches(heads_model):
    jmodel, params, model = heads_model
    images = np.random.RandomState(0).uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, (H, W)))(params, images)
    with torch.no_grad():
        got = model(torch.from_numpy(images), (float(H), float(W)))
    assert sorted(got) == sorted(want) == ["dets", "keypoints", "masks"]
    dets, jdets = got["dets"], want["dets"]
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(getattr(dets, k).numpy(), np.asarray(getattr(jdets, k)))
    assert dets.valid.sum() > 10
    for k in ("scores", "boxes"):
        assert rel_err(getattr(dets, k).numpy(), getattr(jdets, k)) < RTOL, k
    assert got["masks"].shape == (2, DETS, 28, 28)
    assert got["keypoints"].shape == (2, DETS, 56, 56, KEYPOINTS)
    for k in ("masks", "keypoints"):
        assert rel_err(got[k].numpy(), want[k]) < RTOL, k
    assert float(got["masks"].std()) > 0.1 and float(got["keypoints"].std()) > 0.1


def test_runners_refuse_the_heads_dict(heads_model, mini_vid, tmp_path):  # noqa: F811
    """ROADMAP.md §C 9: the JAX runners read ``dets.valid`` from what the
    model returns, and fail on the heads' dict after running the model; the
    port's raise, naming the item, before the first image or frame."""
    jmodel, params, model = heads_model

    class OneImage:
        classes = ("__background__",) + tuple(f"c{i}" for i in range(1, CLASSES))
        annos = [type("Anno", (), dict(boxes=np.zeros((1, 4), np.float32),
                                       labels=np.ones(1, np.int32), height=H, width=W))()]

        def __len__(self):
            return 1

        def get_groundtruth(self, i):
            return self.annos[i]

        def image_path(self, i):
            return "image"

        def load_image(self, path):
            self.loaded = True
            return np.full((H, W, 3), 100.0, np.float32)

    ds = OneImage()
    with pytest.raises(AttributeError, match="'dict' object has no attribute 'valid'"):
        jax_still.run_inference_still(jmodel, {"params": params}, ds, min_size=H, max_size=W)
    ds = OneImage()
    with pytest.raises(ValueError, match=r"ROADMAP\.md §C 9"):
        run_inference_still(model, ds, min_size=H, max_size=W)
    assert not hasattr(ds, "loaded")

    args = ("test_set", mini_vid["root"], mini_vid["img_dir"], mini_vid["anno_dir"],
            mini_vid["index"])
    scfg = dict(global_size=3, infer_batch=4, min_size=H, max_size=W)
    with pytest.raises(AttributeError, match="'dict' object has no attribute 'valid'"):
        jax_inference_mega.run_inference_video_arch(
            jmodel, {"params": params}, JaxVID(*args, is_train=False, use_cache=False),
            JaxSampleConfig(**scfg), method="base", max_videos=1)
    with pytest.raises(ValueError, match=r"ROADMAP\.md §C 9"):
        run_inference_video_arch(model, VIDDataset(*args, is_train=False, use_cache=False),
                                 SampleConfig(**scfg), method="base", output_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------- losses

def _mask_case(seed):
    rng = np.random.RandomState(seed)
    b, r, m, k, g = 2, 6, 28, CLASSES, 3
    logits = rng.randn(b, r, m, m, k).astype(np.float32)
    logits[0, 0, :4, :4] = 0.0                              # JAX's kinks
    boxes = _rois(rng, b, r, 60, 90)
    labels = rng.randint(0, k, (b, r)).astype(np.int32)
    labels[0, 0] = 2
    valid = rng.uniform(size=(b, r)) > 0.2
    valid[0, 0] = True
    gt_masks = (rng.uniform(size=(b, g, 64, 96)) > 0.5).astype(np.float32)
    gt_boxes = _rois(rng, b, g, 60, 90)
    gt_labels = rng.randint(1, k, (b, g)).astype(np.int32)
    gt_valid = np.array([[True, True, False], [True, False, True]])
    return logits, boxes, labels, valid, gt_masks, gt_boxes, gt_labels, gt_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_loss_and_gradient_match(seed):
    case = _mask_case(seed)
    want, jgrad = jax.jit(jax.value_and_grad(jax_mk.mask_loss))(*case)
    logits = torch.from_numpy(case[0]).requires_grad_()
    got = mk.mask_loss(logits, *(torch.from_numpy(np.asarray(a)) for a in case[1:]))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want)) and float(want) > 0
    assert rel_err(logits.grad.numpy(), jgrad) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_keypoint_loss_and_gradient_match(seed):
    rng = np.random.RandomState(seed)
    b, r, s, k = 2, 5, 56, KEYPOINTS
    logits = rng.randn(b, r, s, s, k).astype(np.float32)
    boxes = _rois(rng, b, r, 60, 90)
    kps = np.concatenate([boxes[..., None, :2] + rng.uniform(-10, 60, (b, r, k, 2)),
                          rng.randint(0, 3, (b, r, k, 1))], -1).astype(np.float32)
    valid = rng.uniform(size=(b, r)) > 0.2
    want, jgrad = jax.jit(jax.value_and_grad(jax_mk.keypoint_loss))(logits, boxes, kps, valid)
    lg = torch.from_numpy(logits).requires_grad_()
    got = mk.keypoint_loss(lg, torch.from_numpy(boxes), torch.from_numpy(kps),
                           torch.from_numpy(valid))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want)) and float(want) > 0
    assert rel_err(lg.grad.numpy(), jgrad) < 1e-5


def test_paste_masks_and_heatmaps_to_keypoints_match():
    rng = np.random.RandomState(4)
    probs = rng.uniform(size=(6, 28, 28)).astype(np.float32)
    boxes = _rois(rng, 1, 6, 50, 70)[0]
    boxes[0] = [-5.5, -3.2, 30.7, 20.1]                      # over the border
    np.testing.assert_array_equal(mk.paste_masks(probs, boxes, 50, 70),
                                  jax_mk.paste_masks(probs, boxes, 50, 70))
    heat = rng.randn(6, 56, 56, KEYPOINTS).astype(np.float32)
    np.testing.assert_array_equal(mk.heatmaps_to_keypoints(heat, boxes),
                                  jax_mk.heatmaps_to_keypoints(heat, boxes))


def test_polygon_masks_and_keypoints_match():
    rng = np.random.RandomState(5)
    verts = rng.uniform(0, 60, (4, 7, 2)).astype(np.float32)
    counts = np.array([7, 3, 2, 5], np.int32)
    got, want = masks.PolygonMasks(verts, counts), jax_masks.PolygonMasks(verts, counts)
    for op, args in (("resize", (0.5, 1.5)), ("transpose_lr", (64,)), ("crop", ((5, 8, 40, 50),))):
        np.testing.assert_array_equal(getattr(got, op)(*args).vertices,
                                      getattr(want, op)(*args).vertices, err_msg=op)
    raster = got.rasterize(64, 64)
    np.testing.assert_array_equal(raster, want.rasterize(64, 64))
    assert raster[0].sum() > 0 and raster[2].sum() == 0
    pts = np.concatenate([rng.uniform(0, 60, (3, 17, 2)), rng.randint(0, 3, (3, 17, 1))],
                         -1).astype(np.float32)
    kg, kw = masks.Keypoints(pts), jax_masks.Keypoints(pts)
    for op, args in (("resize", (0.5, 1.5)), ("transpose_lr", (64,)), ("crop", ((5, 8, 40, 50),))):
        np.testing.assert_array_equal(getattr(kg, op)(*args).points,
                                      getattr(kw, op)(*args).points, err_msg=op)
    assert masks.PERSON_KEYPOINTS == jax_masks.PERSON_KEYPOINTS
    assert masks.FLIP_MAP == jax_masks.FLIP_MAP


# ---------------------------------------------------------------- model factory and weights

@pytest.mark.parametrize("keypoints", [False, True], ids=["mask", "mask_keypoint"])
def test_build_detection_model_builds_the_mask_config(keypoints, monkeypatch):
    """``configs/e2e_mask_rcnn_R_50_C4_1x.yaml`` (at depth 18), and with
    ``KEYPOINT_ON``: the heads of the JAX ``build_detection_model`` at their full widths, 81
    classes and 17 keypoints, and the JAX tree's every name carried to a
    tensor of the port's model of the same shape."""
    for name, cls in JAX_HEADS.items():    # not the narrow heads of ``heads_model``
        monkeypatch.setattr(jax_mk, name, cls)
    opts = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32"] + (
        ["MODEL.KEYPOINT_ON", "True"] if keypoints else [])
    ref = jax_build(jax_load_config(MASK_CONFIG, opts))
    model = build_detection_model(load_config(MASK_CONFIG, opts), device="cpu")
    assert (ref.mask_on, ref.keypoint_on, ref.num_classes, ref.num_keypoints) == (
        True, keypoints, 81, 17)
    assert model.mask_head.mask_fcn_logits.weight.shape == (81, 256, 1, 1)
    assert (model.kp_head is not None) == keypoints
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                                             (H, W)))["params"]
    state = model.state_dict()
    names = {_torch_name(path, (3, 4, 5)): v.shape for path, v in _flatten(shapes)}
    assert names.keys() == state.keys()
    assert all(tuple(state[k].shape) == tuple(s) for k, s in names.items())


def test_torch_weights_copy_what_jax_copies(heads_model, reference_pth, tmp_path):  # noqa: F811
    """A reference file with the heads' reference names (maskrcnn-benchmark's
    ``roi_heads.mask.*`` / ``roi_heads.keypoint.*``): the JAX loader has no
    rule for them, so both packages copy the trunk alone, count for count,
    and leave the heads as they were."""
    _, params, model = heads_model
    ref = torch.load(reference_pth)["model"]
    ref["roi_heads.mask.feature_extractor.mask_fcn1.weight"] = torch.ones(16, 1024, 3, 3)
    ref["roi_heads.keypoint.predictor.kps_score_lowres.weight"] = torch.ones(16, KEYPOINTS, 4, 4)
    path = tmp_path / "mask_rcnn.pth"
    torch.save({"model": ref}, path)
    _, copied = jax_merge_pretrained(params, load_torch_checkpoint(str(path))["params"],
                                     skip_keys=())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert copied > 50
    assert load_weights_into(model, str(path)) == copied
    after = model.state_dict()
    for k in before:
        if k.startswith(("mask_head.", "kp_head.")):
            assert torch.equal(after[k], before[k]), k
    assert torch.equal(after["backbone.bottom_up.res4.1.conv3.weight"],
                       ref["backbone.bottom_up.res4.1.conv3.weight"])
    model.load_state_dict(before)

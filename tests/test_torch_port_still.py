"""The still-image path of the port against the JAX package.

On seeded numpy inputs: COCO's mAP (``evaluate_coco``, with crowd GT and
area-range ignores), the VOC-style ``evaluate_still`` and
``evaluate_cityscapes`` on random predictions; the COCO, VOC and Cityscapes
datasets on tiny files (crowds, ``difficult`` objects, unknown names,
polygons under 3 vertices, empty images); ``run_inference_still`` and the
test CLI's still-image branch on 3 images of 96x128 (one resized from
80x120) with the ``base`` detector and with RetinaNet at depth 18, the
CLI loading the JAX tree by ``--checkpoint``: labels equal, scores and
boxes within 1e-3, the same AP; ``--max-videos`` bounding the images; and
the JAX CLI's ``SystemExit`` for another detector.

The JAX models' parameters are drawn with numpy (``seeded_params``, from
``jax.eval_shape`` of their init: no compiled init); their forward is
compiled once a model and image shape for the whole module
(``cached_jit``), where the JAX runner would compile it again at each call.
"""

import json
import os
import pickle
import types
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from diffusionvid_tpu.data import catalog as jax_catalog
from diffusionvid_tpu.data import cityscapes as jax_cityscapes
from diffusionvid_tpu.data import coco_voc as jax_coco_voc
from diffusionvid_tpu.engine import inference_still as jax_still
from diffusionvid_tpu.evaluation import coco_eval as jax_coco_eval
from diffusionvid_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from diffusionvid_tpu.models.retinanet import RetinaNet as JaxRetinaNet

from diffusionvid_torch.data import catalog, cityscapes, coco_voc
from diffusionvid_torch.engine.inference_still import run_inference_still
from diffusionvid_torch.evaluation import coco_eval
from diffusionvid_torch.models.rcnn import GeneralizedRCNN
from diffusionvid_torch.models.retinanet import RetinaNet
from diffusionvid_torch.tools import test_net
from diffusionvid_torch.utils.convert import state_dict_from_jax
from test_torch_port_weights import one_thread, rel_err  # noqa: F401  (one_thread: the fixture)

ROOT = Path(__file__).resolve().parent.parent
H, W = 96, 128
CLASSES = 5                      # GeneralizedRCNN's, with the background
RETINA_CLASSES = 4               # RetinaNet's foreground classes
RCNN = dict(depth=18, num_classes=CLASSES, pre_nms_test=100, post_nms_test=8)
RTOL = 1e-3
# the images: two at the bucket's size and one resized (scale 128 / 120)
IMAGES = [(96, 128), (96, 128), (80, 120)]


# ---------------------------------------------------------------- JAX side

def seeded_params(module, *args, seed: int = 0, conv_gain: float = 1.0, **kw) -> dict:
    """A parameter tree of ``module``'s init shapes drawn with numpy: every
    4-D weight at variance ``conv_gain / fan-in`` (its trailing axes), a 2-D
    weight at ``1 / in``, FrozenBN at identity, other 1-D tensors (biases)
    ``0.2 * N(0, 1)``; so that maps and logits are O(1) and the scores
    spread."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        shape, name = leaf.shape, str(path[-1].key)
        parent = str(path[-2].key) if len(path) > 1 else ""
        if len(shape) == 4:
            return (rng.randn(*shape) * np.sqrt(conv_gain / np.prod(shape[1:]))).astype(
                np.float32)
        if len(shape) == 2:
            return (rng.randn(*shape) / np.sqrt(shape[1])).astype(np.float32)
        if parent.startswith(("bn", "downsample_bn")) or "_bn" in parent:
            return np.full(shape, 1.0 if name in ("weight", "running_var") else 0.0, np.float32)
        return (0.2 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_JITS = {}


def cached_jit(fn):
    """``jax.jit`` of the JAX runner's per-call lambda, one compile per model
    (the lambda's closure) for the whole process."""
    key = (fn.__code__, tuple(id(c.cell_contents) for c in fn.__closure__ or ()))
    if key not in _JITS:
        _JITS[key] = jax.jit(fn)
    return _JITS[key]


@pytest.fixture(scope="module")
def jax_models():
    """name → (JAX model, its params): ``base`` (``GeneralizedRCNN``) and
    ``retinanet`` (4 classes; the class logits' bias raised so that scores
    above 0.05 spread over the anchors)."""
    x = jnp.zeros((1, H, W, 3))
    base = JaxRCNN(**RCNN)
    retina = JaxRetinaNet(depth=18, num_classes=RETINA_CLASSES)
    rp = seeded_params(retina, x, (H, W), seed=2)
    rp["head"]["cls_logits"]["bias"] = rp["head"]["cls_logits"]["bias"] + np.float32(2.5)
    return {"base": (base, seeded_params(base, x, (H, W), seed=1)), "retinanet": (retina, rp)}


def port_model(name, params):
    model = (GeneralizedRCNN(**RCNN) if name == "base"
             else RetinaNet(depth=18, num_classes=RETINA_CLASSES))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


# ---------------------------------------------------------------- datasets on disk

def _boxes(rng, n, h, w):
    xy = rng.uniform(0, 0.6, (n, 2)) * (w, h)
    wh = rng.uniform(0.2, 0.4, (n, 2)) * (w, h)
    return np.concatenate([xy, np.minimum(xy + wh, (w - 1, h - 1))], 1).round(1)


def _image(path: Path, h, w, seed):
    import cv2
    img = np.random.RandomState(seed).uniform(0, 255, (h, w, 3)).astype(np.uint8)
    cv2.imwrite(str(path), img)


def write_coco(root: Path, split="val"):
    """``coco/annotations/instances_<split>.json`` and the images: category
    ids 3, 7, 11, one crowd annotation and one image without annotations."""
    rng = np.random.RandomState(0)
    (root / "coco" / "annotations").mkdir(parents=True)
    (root / "coco" / split).mkdir()
    images, anns = [], []
    for i, (h, w) in enumerate(IMAGES + [(96, 128)]):
        name = f"{i:012d}.png"
        _image(root / "coco" / split / name, h, w, i)
        images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
        if i == len(IMAGES):
            continue    # no annotation: filtered out
        for j, b in enumerate(_boxes(rng, 3, h, w)):
            anns.append({"id": len(anns), "image_id": 100 + i, "category_id": (3, 7, 11)[j],
                         "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                         "iscrowd": int(i == 1 and j == 2)})
    cats = [{"id": c, "name": f"cat{c}"} for c in (11, 3, 7)]
    with open(root / "coco" / "annotations" / f"instances_{split}.json", "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)


def write_voc(root: Path, split="test"):
    """The VOC layout: a ``difficult`` object and an unknown name, 1-based
    coordinates."""
    rng = np.random.RandomState(1)
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (root / "voc" / d).mkdir(parents=True)
    names = []
    for i, (h, w) in enumerate(IMAGES):
        name = f"2007_{i:06d}"
        names.append(name)
        _image(root / "voc" / "JPEGImages" / f"{name}.jpg", h, w, 10 + i)
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "height").text = str(h)
        ET.SubElement(size, "width").text = str(w)
        objs = zip(("aeroplane", "bicycle", "Bird ", "unicorn"), _boxes(rng, 4, h, w))
        for j, (cls, b) in enumerate(objs):
            o = ET.SubElement(ann, "object")
            ET.SubElement(o, "name").text = cls
            ET.SubElement(o, "difficult").text = str(int(i == 0 and j == 1))
            bb = ET.SubElement(o, "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"), b + 1):
                ET.SubElement(bb, k).text = str(int(v))
        ET.ElementTree(ann).write(root / "voc" / "Annotations" / f"{name}.xml")
    (root / "voc" / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(names) + "\n")


def write_cityscapes(root: Path, split="val"):
    """``gtFine`` polygons over two cities: a ``cargroup`` crowd, a 2-vertex
    polygon, an unknown label, a polygon past the border; one image with
    nothing left."""
    rng = np.random.RandomState(2)
    k = 0
    for city in ("aachen", "bonn"):
        gt = root / "cityscapes" / "gtFine" / split / city
        img = root / "cityscapes" / "leftImg8bit" / split / city
        gt.mkdir(parents=True)
        img.mkdir(parents=True)
        for i, (h, w) in enumerate(IMAGES if city == "aachen" else IMAGES[:1]):
            stem = f"{city}_{i:06d}_000019"
            objs = []
            if city == "aachen":
                for cls, b in zip(("person", "rider", "car", "cargroup", "truck"),
                                  _boxes(rng, 5, h, w)):
                    x1, y1, x2, y2 = b
                    objs.append({"label": cls, "polygon": [[x1, y1], [x2, y1 + 3], [x2 + 9, y2],
                                                           [x1 - 4, y2]]})
                objs += [{"label": "car", "polygon": [[1, 1], [9, 9]]},
                         {"label": "sky", "polygon": [[1, 1], [9, 9], [1, 9]]}]
            with open(gt / f"{stem}_gtFine_polygons.json", "w") as f:
                json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)
            _image(img / f"{stem}_leftImg8bit.png", h, w, 20 + k)
            k += 1


WRITERS = {"coco": (write_coco, "coco_val"), "voc": (write_voc, "voc_test"),
           "cityscapes": (write_cityscapes, "cityscapes_val")}


@pytest.fixture(scope="module")
def still_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("still")
    for write, _ in WRITERS.values():
        write(root)
    return root


def _same_annos(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got.annos, want.annos):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert (g.height, g.width) == (w.height, w.width)


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_datasets_match(still_root, kind):
    """The catalog's dataset of each layout and the JAX catalog's: the same
    images, classes, annotations and decoded pixels."""
    name = WRITERS[kind][1]
    got = catalog.get_dataset(name, is_train=False, data_dir=str(still_root))
    want = jax_catalog.get_dataset(name, is_train=False, data_dir=str(still_root))
    assert type(got).__name__ == type(want).__name__ and got.is_video is want.is_video is False
    assert got.classes == want.classes
    _same_annos(got, want)
    for i in range(len(got)):
        assert got.image_path(i) == want.image_path(i)
        assert got.get_groundtruth(i).boxes.dtype == np.float32
    np.testing.assert_array_equal(got.load_image(got.image_path(2)),
                                  want.load_image(want.image_path(2)))
    if kind == "coco":
        assert len(got) == len(IMAGES) and got.cat_to_label == want.cat_to_label == {
            3: 1, 7: 2, 11: 3}
        assert len(coco_voc.COCODataset(*_coco_paths(still_root), filter_empty=False)) == 4
    if kind == "cityscapes":
        assert sum(len(a.labels) for a in got.annos) == 3 * 4


def _coco_paths(root):
    return (str(root / "coco" / "annotations" / "instances_val.json"), str(root / "coco" / "val"))


# ---------------------------------------------------------------- evaluators

def _random_case(seed, images=6, classes=4):
    """GT and predictions: each GT box found again, shifted, with a random
    score, plus false positives; some GT small (COCO's area ranges)."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for _ in range(images):
        n = rng.randint(0, 5)
        xy = rng.uniform(0, 300, (n, 2))
        wh = np.where(rng.uniform(size=(n, 1)) < 0.3, rng.uniform(4, 30, (n, 2)),
                      rng.uniform(30, 200, (n, 2)))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = rng.randint(1, classes + 1, n).astype(np.int32)
        gts.append({"boxes": boxes, "labels": labels})
        hits = boxes + rng.uniform(-8, 8, boxes.shape).astype(np.float32)
        fp = rng.uniform(0, 400, (rng.randint(0, 4), 2))
        fp = np.concatenate([fp, fp + rng.uniform(10, 100, fp.shape)], 1).astype(np.float32)
        pb = np.concatenate([hits, fp])
        preds.append({"boxes": pb, "scores": rng.uniform(0, 1, len(pb)).astype(np.float32),
                      "labels": np.concatenate([labels, rng.randint(1, classes + 1, len(fp))])})
    return gts, preds


def _same_results(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert (np.isnan(v) and np.isnan(got[k])) or got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_coco_matches(seed):
    gts, preds = _random_case(seed)
    got = coco_eval.evaluate_coco(gts, preds, 4)
    want = jax_coco_eval.evaluate_coco(gts, preds, 4)
    _same_results(got, want)
    assert 0 < got["AP50"] < 1
    # max_dets, and a crowd GT matched by several detections
    _same_results(coco_eval.evaluate_coco(gts, preds, 5, max_dets=2),
                  jax_coco_eval.evaluate_coco(gts, preds, 5, max_dets=2))
    gt_boxes = np.asarray([[0, 0, 50, 50], [100, 100, 120, 110]], np.float64)
    det = np.asarray([[1, 1, 50, 50], [0, 0, 49, 51], [99, 100, 120, 110]], np.float64)
    args = (det, np.asarray([0.9, 0.8, 0.7]), gt_boxes, np.asarray([False, True]), 100,
            np.asarray([True, False]))
    for g, w in zip(coco_eval._match_image(*args), jax_coco_eval._match_image(*args)):
        np.testing.assert_array_equal(g, w)


def test_evaluate_still_and_cityscapes_match(still_root):
    """``evaluate_still`` (VOC AP at 0.5 and 0.75) on the VOC set and
    ``evaluate_cityscapes`` on the Cityscapes set, random predictions."""
    for name, port_eval, jax_eval, kw in (
            ("voc_test", coco_voc.evaluate_still, jax_coco_voc.evaluate_still,
             dict(iou_thresholds=(0.5, 0.75))),
            ("cityscapes_val", cityscapes.evaluate_cityscapes, jax_cityscapes.evaluate_cityscapes,
             {})):
        ds = catalog.get_dataset(name, is_train=False, data_dir=str(still_root))
        rng = np.random.RandomState(3)
        preds = []
        for a in ds.annos:
            b = a.boxes + rng.uniform(-3, 3, a.boxes.shape).astype(np.float32)
            preds.append({"boxes": b, "scores": rng.uniform(0, 1, len(b)).astype(np.float32),
                          "labels": a.labels})
        got = port_eval(ds, preds, **kw)
        _same_results(got, jax_eval(ds, preds, **kw))
        assert got.get("ap50", got.get("AP50")) > 0


# ---------------------------------------------------------------- runner and CLI

def _jax_run(jax_models, name, kind, still_root, **kw):
    model, params = jax_models[name]
    ds = jax_catalog.get_dataset(WRITERS[kind][1], is_train=False, data_dir=str(still_root))
    orig, jax_still.jax = jax_still.jax, types.SimpleNamespace(jit=cached_jit)
    try:
        return jax_still.run_inference_still(model, {"params": params}, ds, min_size=H,
                                             max_size=W, evaluator=kind, **kw)
    finally:
        jax_still.jax = orig


def predictions_agree(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"image {i}")
        if len(w["scores"]):
            assert rel_err(g["scores"], w["scores"]) < RTOL, f"image {i} scores"
            assert rel_err(g["boxes"], w["boxes"]) < RTOL, f"image {i} boxes"
    assert sum(len(w["scores"]) for w in want) > 0, "no detection"


CLI_OPTS = ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES5_DILATION", "1",
            "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.ROI_BOX_HEAD.NUM_CLASSES", str(CLASSES), "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100",
            "MODEL.RPN.POST_NMS_TOP_N_TEST", "8", "MODEL.RETINANET.NUM_CLASSES",
            str(RETINA_CLASSES), "INPUT.MIN_SIZE_TEST", str(H), "INPUT.MAX_SIZE_TEST", str(W)]


@pytest.mark.parametrize("name, kind, max_images", [
    ("base", "coco", None), ("base", "voc", 2), ("base", "cityscapes", None),
    ("retinanet", "coco", None), ("retinanet", "voc", None), ("retinanet", "cityscapes", 2),
])
def test_runner_and_cli_match(jax_models, still_root, tmp_path, name, kind, max_images):
    """``run_inference_still`` and the test CLI (the JAX tree by
    ``--checkpoint``, ``--max-videos`` as ``max_images``) against the JAX
    runner on the same tree: the predictions within 1e-3, labels equal, the
    same AP; the CLI logs ``FINAL AP50`` and writes ``predictions.pkl``."""
    jpreds, jgt, jres = _jax_run(jax_models, name, kind, still_root, max_images=max_images)
    ds = catalog.get_dataset(WRITERS[kind][1], is_train=False, data_dir=str(still_root))
    preds, gt, res = run_inference_still(port_model(name, jax_models[name][1]), ds, min_size=H,
                                         max_size=W, evaluator=kind, max_images=max_images)
    predictions_agree(preds, jpreds)
    assert len(gt) == len(jgt) == (max_images or len(ds))
    _same_results(res, jres)

    ckpt = tmp_path / "model_0000000.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"params": jax_models[name][1]}, f)
    out = tmp_path / "out"
    opts = CLI_OPTS + ["DATASETS.TEST", f"('{WRITERS[kind][1]}',)"] + (
        ["MODEL.RETINANET_ON", "True"] if name == "retinanet" else [])
    cli = test_net.main(["--config-file", str(ROOT / "configs" / "vid_R_101_C4_1x.yaml"),
                         "--data-dir", str(still_root), "--output-dir", str(out), "--device",
                         "cpu", "--checkpoint", str(ckpt)]
                        + (["--max-videos", str(max_images)] if max_images else []) + opts)
    with open(out / "predictions.pkl", "rb") as f:
        cli_preds = pickle.load(f)
    predictions_agree(cli_preds, jpreds)
    _same_results(cli, jres)
    assert f"FINAL AP50 = {jres['ap50']:.4f}" in (out / "log.txt").read_text()


@pytest.mark.parametrize("opts", [
    ["MODEL.VID.ENABLE", "True", "MODEL.VID.METHOD", "rdn"],
    ["MODEL.META_ARCHITECTURE", "DiffusionDet"],
], ids=["rdn", "diffusion"])
def test_cli_exits_for_other_detectors(still_root, tmp_path, opts):
    """The JAX CLI's ``SystemExit`` for a detector that is not single-frame,
    before a model is built."""
    with pytest.raises(SystemExit, match=r"needs a single-frame detector \(VID\.METHOD base / "
                                         r"META_ARCHITECTURE GeneralizedRCNN\); got method="):
        test_net.main(["--config-file", str(ROOT / "configs" / "vid_R_101_C4_1x.yaml"),
                       "--data-dir", str(still_root), "--output-dir", str(tmp_path),
                       "--device", "cpu", *CLI_OPTS, "DATASETS.TEST", "('coco_val',)", *opts])
    assert not os.path.exists(tmp_path / "predictions.pkl")

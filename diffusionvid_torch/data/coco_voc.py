"""COCO- and VOC-layout still-image datasets.

Port of ``diffusionvid_tpu/data/coco_voc.py:31-175`` (the reference's
generic ``mega_core/data/datasets/{coco,voc}.py`` and their evaluators):
the COCO instances JSON read as plain JSON (no pycocotools), the VOC
``JPEGImages`` / ``Annotations`` / ``ImageSets`` layout, each image a
``FrameAnno``; ``evaluate_still`` is the VOC-style AP of
``evaluation/vid_eval.py`` (``calc_prec_rec`` / ``calc_ap``) at one or more
IoU thresholds.  Images are decoded with ``cv2``, imported when one is
loaded.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .vid_dataset import FrameAnno

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_rgb(path: str) -> np.ndarray:
    """An image file → [H, W, 3] float32 RGB (``cv2``)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)


class StillDataset:
    """What the still-image datasets share: ``annos`` (a ``FrameAnno`` an
    image), ``classes`` (background first) and ``image_path``."""

    is_video = False
    annos: List[FrameAnno]

    def __len__(self):
        return len(self.annos)

    def load_image(self, path: str) -> np.ndarray:
        return load_rgb(path)

    def get_groundtruth(self, idx: int) -> FrameAnno:
        return self.annos[idx]


class COCODataset(StillDataset):
    """A COCO instances JSON: labels 1..K in the order of the category ids
    (the reference's ``json_category_id_to_contiguous_id``), crowd
    annotations dropped, images without annotations dropped unless
    ``filter_empty`` is off."""

    def __init__(self, annotation_file: str, image_dir: str, filter_empty: bool = True):
        with open(annotation_file) as f:
            coco = json.load(f)
        self.image_dir = image_dir
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.cat_to_label = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self.classes = ("__background__",) + tuple(c["name"] for c in cats)

        anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.images = []
        self.annos = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if filter_empty and not anns:
                continue
            boxes, labels = [], []
            for a in anns:
                x, y, w, h = a["bbox"]
                boxes.append([x, y, x + w, y + h])
                labels.append(self.cat_to_label[a["category_id"]])
            self.images.append(img)
            self.annos.append(FrameAnno(np.asarray(boxes, np.float32).reshape(-1, 4),
                                        np.asarray(labels, np.int32),
                                        int(img["height"]), int(img["width"])))

    def image_path(self, idx: int) -> str:
        return os.path.join(self.image_dir, self.images[idx]["file_name"])


class VOCDataset(StillDataset):
    """The PASCAL VOC layout: ``ImageSets/Main/<split>.txt``, one XML an
    image; ``difficult`` objects and unknown names dropped; the 1-based
    pixel coordinates made 0-based (the reference's voc.py)."""

    def __init__(self, root: str, split: str = "trainval", filter_empty: bool = True):
        self.root = root
        with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt")) as f:
            names = [line.strip() for line in f if line.strip()]
        self.classes = VOC_CLASSES
        cls_map = {c: i for i, c in enumerate(VOC_CLASSES)}
        self.names = []
        self.annos = []
        for n in names:
            anno = self._parse(os.path.join(root, "Annotations", f"{n}.xml"), cls_map)
            if filter_empty and not len(anno.labels):
                continue
            self.names.append(n)
            self.annos.append(anno)

    @staticmethod
    def _parse(path: str, cls_map) -> FrameAnno:
        root = ET.parse(path).getroot()
        size = root.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        boxes, labels = [], []
        for obj in root.findall("object"):
            if obj.find("difficult") is not None and int(obj.find("difficult").text):
                continue
            name = obj.find("name").text.lower().strip()
            if name not in cls_map:
                continue
            bb = obj.find("bndbox")
            boxes.append([float(bb.find(k).text) - 1 for k in ("xmin", "ymin", "xmax", "ymax")])
            labels.append(cls_map[name])
        return FrameAnno(np.asarray(boxes, np.float32).reshape(-1, 4),
                         np.asarray(labels, np.int32), h, w)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.root, "JPEGImages", f"{self.names[idx]}.jpg")


def evaluate_still(dataset, predictions, num_classes: Optional[int] = None,
                   iou_thresholds=(0.5,)) -> dict:
    """VOC-style AP of ``predictions`` against every image of ``dataset``
    at each IoU threshold: ``ap@<thr>``, ``map`` (their mean) and ``ap50``."""
    from ..evaluation.vid_eval import calc_ap, calc_prec_rec

    k = num_classes or (len(dataset.classes) - 1)
    gt = [{"boxes": a.boxes, "labels": a.labels} for a in dataset.annos]
    out, aps = {}, []
    for thr in iou_thresholds:
        prec, rec = calc_prec_rec(gt, predictions, None, thr, (0.0, 1.0), k)
        m = float(np.nanmean(calc_ap(prec, rec)[1:]))
        out[f"ap@{thr:.2f}"] = m
        aps.append(m)
    out["map"] = float(np.mean(aps))
    out["ap50"] = out.get("ap@0.50", aps[0])
    return out

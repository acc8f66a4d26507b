"""The Cityscapes instance-detection dataset.

Port of ``diffusionvid_tpu/data/cityscapes.py:36-111`` (the reference's
Cityscapes dataset and its evaluator): the ``gtFine`` polygon JSONs, the 8
instance classes as boxes from their polygons' extents (``*group`` crowds
and polygons under 3 vertices dropped, clipped into the image), and COCO's
mAP (``evaluation/coco_eval.py``), the metric Cityscapes detection papers
report.

Layout:
    <root>/leftImg8bit/<split>/<city>/<name>_leftImg8bit.png
    <root>/gtFine/<split>/<city>/<name>_gtFine_polygons.json
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .coco_voc import StillDataset
from .vid_dataset import FrameAnno

# the 8 instance classes, in cityscapesscripts' order
CITYSCAPES_CLASSES = (
    "__background__",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)
_LABEL = {c: i for i, c in enumerate(CITYSCAPES_CLASSES)}


class CityscapesDataset(StillDataset):
    """Boxes from the polygons of ``gtFine/<split>``, the JSONs in sorted
    order."""

    def __init__(self, root: str, split: str = "val", filter_empty: bool = True):
        self.root = root
        self.classes = CITYSCAPES_CLASSES
        pattern = os.path.join(root, "gtFine", split, "*", "*_gtFine_polygons.json")
        self.names = []
        self.annos = []
        for jf in sorted(glob.glob(pattern)):
            anno = self._parse(jf)
            if filter_empty and not len(anno.labels):
                continue
            city = os.path.basename(os.path.dirname(jf))
            stem = os.path.basename(jf).replace("_gtFine_polygons.json", "")
            self.names.append(os.path.join("leftImg8bit", split, city,
                                           f"{stem}_leftImg8bit.png"))
            self.annos.append(anno)

    @staticmethod
    def _parse(path: str) -> FrameAnno:
        with open(path) as f:
            data = json.load(f)
        h, w = int(data["imgHeight"]), int(data["imgWidth"])
        boxes, labels = [], []
        for obj in data.get("objects", []):
            name = obj["label"]
            if name.endswith("group") or _LABEL.get(name, 0) == 0:
                continue
            poly = np.asarray(obj["polygon"], np.float32).reshape(-1, 2)
            if len(poly) < 3:
                continue
            x1, y1 = poly.min(axis=0)
            x2, y2 = poly.max(axis=0)
            x1, x2 = np.clip([x1, x2], 0, w - 1)
            y1, y2 = np.clip([y1, y2], 0, h - 1)
            if x2 <= x1 or y2 <= y1:
                continue
            boxes.append([x1, y1, x2, y2])
            labels.append(_LABEL[name])
        return FrameAnno(np.asarray(boxes, np.float32).reshape(-1, 4),
                         np.asarray(labels, np.int32), h, w)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.root, self.names[idx])


def evaluate_cityscapes(dataset, predictions) -> dict:
    """COCO's mAP over the 8 instance classes."""
    from ..evaluation.coco_eval import evaluate_coco

    gt = [{"boxes": a.boxes, "labels": a.labels} for a in dataset.annos]
    return evaluate_coco(gt, predictions, num_classes=len(CITYSCAPES_CLASSES) - 1)

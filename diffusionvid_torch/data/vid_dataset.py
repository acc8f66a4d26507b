"""ILSVRC VID/DET dataset layer.

Port of ``diffusionvid_tpu/data/vid_dataset.py`` (the reference's
``VIDDataset``, ``mega_core/data/datasets/vid.py:21-242``): txt index files
(``video_dir frame_id [seg_id seg_len]``), XML annotations with the
30-class wnid map, a pickle cache of the parsed annotations, and the
empty-frame filter of training, emitting numpy arrays; ``pad_groundtruth``
pads a frame's GT to the static slots of a train batch.

The cache file has a name of its own (``<image_set>_anno_torch.pkl``) and
holds this module's ``FrameAnno``: the JAX package's cache holds objects of
its own module, and unpickling them would import that package.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

# The 30 ImageNet-VID classes (+background), standard ILSVRC constants
# (vid.py:22-39).
VID_CLASSES = (
    "__background__",
    "airplane", "antelope", "bear", "bicycle",
    "bird", "bus", "car", "cattle",
    "dog", "domestic_cat", "elephant", "fox",
    "giant_panda", "hamster", "horse", "lion",
    "lizard", "monkey", "motorcycle", "rabbit",
    "red_panda", "sheep", "snake", "squirrel",
    "tiger", "train", "turtle", "watercraft",
    "whale", "zebra",
)

VID_WNIDS = (
    "__background__",
    "n02691156", "n02419796", "n02131653", "n02834778",
    "n01503061", "n02924116", "n02958343", "n02402425",
    "n02084071", "n02121808", "n02503517", "n02118333",
    "n02510455", "n02342885", "n02374451", "n02129165",
    "n01674464", "n02484322", "n03790512", "n02324045",
    "n02509815", "n02411705", "n01726692", "n02355227",
    "n02129604", "n04468005", "n01662784", "n04530566",
    "n02062744", "n02391049",
)

WNID_TO_LABEL = {w: i for i, w in enumerate(VID_WNIDS)}


@dataclass
class FrameAnno:
    boxes: np.ndarray     # [n, 4] xyxy float32 (clipped into the image)
    labels: np.ndarray    # [n] int32 in 1..30
    height: int
    width: int


def parse_vid_xml(path: str) -> FrameAnno:
    """Parse one ILSVRC annotation XML (vid.py:139-166 semantics: clip into
    [0, size-1], drop non-VID wnids)."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    boxes, labels = [], []
    for obj in root.findall("object"):
        name = obj.find("name").text.lower().strip()
        if name not in WNID_TO_LABEL:
            continue
        bb = obj.find("bndbox")
        boxes.append([
            max(float(bb.find("xmin").text), 0.0),
            max(float(bb.find("ymin").text), 0.0),
            min(float(bb.find("xmax").text), w - 1.0),
            min(float(bb.find("ymax").text), h - 1.0),
        ])
        labels.append(WNID_TO_LABEL[name])
    return FrameAnno(
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(labels, np.int32), h, w)


class VIDDataset:
    """Frame-level dataset over an ILSVRC index file.

    Index formats (vid.py:56-66):
      * 2 columns: ``path frame_id``                      (DET-style stills)
      * 4 columns: ``video_dir frame_id seg_id seg_len``  (VID sequences)
    """

    def __init__(self, image_set: str, data_dir: str, img_dir: str,
                 anno_path: str, img_index: str, is_train: bool = True,
                 use_cache: bool = True):
        self.image_set = image_set
        self.data_dir = data_dir
        self.img_dir = img_dir
        self.anno_path = anno_path
        self.is_train = is_train
        self._img_tmpl = os.path.join(img_dir, "%s.JPEG")
        self._anno_tmpl = os.path.join(anno_path, "%s.xml")

        with open(img_index) as f:
            lines = [x.strip().split() for x in f if x.strip()]
        self.is_video = len(lines[0]) == 4
        if self.is_video:
            self.image_set_index = ["%s/%06d" % (x[0], int(x[2])) for x in lines]
            self.pattern = [x[0] + "/%06d" for x in lines]
            self.frame_id = [int(x[1]) for x in lines]
            self.frame_seg_id = [int(x[2]) for x in lines]
            self.frame_seg_len = [int(x[3]) for x in lines]
        else:
            self.image_set_index = [x[0] for x in lines]
            self.frame_id = [int(x[1]) for x in lines]
            self.pattern = None

        self.annos = self._load_annos(use_cache)

        if is_train:
            self._filter([len(a.labels) > 0 for a in self.annos])

    # ---- internals ----
    def _filter(self, keep):
        sel = [i for i, k in enumerate(keep) if k]
        self.image_set_index = [self.image_set_index[i] for i in sel]
        self.frame_id = [self.frame_id[i] for i in sel]
        self.annos = [self.annos[i] for i in sel]
        if self.is_video:
            self.pattern = [self.pattern[i] for i in sel]
            self.frame_seg_id = [self.frame_seg_id[i] for i in sel]
            self.frame_seg_len = [self.frame_seg_len[i] for i in sel]

    def _cache_file(self):
        cache_dir = os.path.join(self.data_dir, "cache")
        os.makedirs(cache_dir, exist_ok=True)
        return os.path.join(cache_dir, self.image_set + "_anno_torch.pkl")

    def _load_annos(self, use_cache: bool):
        cache = self._cache_file()
        if use_cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        annos = [parse_vid_xml(self._anno_tmpl % name) for name in self.image_set_index]
        if use_cache:
            try:
                with open(cache, "wb") as f:
                    pickle.dump(annos, f)
            except OSError:
                pass
        return annos

    # ---- public ----
    def __len__(self):
        return len(self.image_set_index)

    def image_path(self, idx: int) -> str:
        return self._img_tmpl % self.image_set_index[idx]

    def frame_path(self, idx: int, frame: int) -> str:
        assert self.is_video
        return self._img_tmpl % (self.pattern[idx] % frame)

    def load_image(self, path: str, dtype=np.float32) -> np.ndarray:
        """RGB HWC in 0..255.  ``dtype=np.uint8`` skips the float cast: the
        streaming path resizes, pads and moves uint8 to the card and casts
        there."""
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img if dtype == np.uint8 else img.astype(dtype)

    def get_groundtruth(self, idx: int) -> FrameAnno:
        return self.annos[idx]

    def get_groundtruth_for_frame(self, idx: int, frame: int) -> FrameAnno:
        assert self.is_video
        return parse_vid_xml(self._anno_tmpl % (self.pattern[idx] % frame))

    def video_starts(self):
        """Indices where a new video begins (frame_seg_id == 0); the
        video-boundary eval sharding (samplers/distributed.py:69-115)."""
        assert self.is_video
        return [i for i, s in enumerate(self.frame_seg_id) if s == 0]


def pad_groundtruth(anno: FrameAnno, max_gt: int, scale: float = 1.0,
                    flip: bool = False):
    """FrameAnno → static (boxes [G,4], labels [G], valid [G]) with the
    resize scale and horizontal flip applied."""
    n = min(len(anno.labels), max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    if n:
        b = anno.boxes[:n] * scale
        if flip:
            w = anno.width * scale
            # TO_REMOVE=1 flip convention (bounding_box.py transpose)
            b = np.stack([w - b[:, 2] - 1, b[:, 1], w - b[:, 0] - 1, b[:, 3]], 1)
        boxes[:n] = b
        labels[:n] = anno.labels[:n]
        valid[:n] = True
    return boxes, labels, valid

"""Dataset catalog: name → paths + factory.

Port of ``diffusionvid_tpu/data/catalog.py`` (the reference's
``DatasetCatalog``, ``mega_core/config/paths_catalog.py:152-255``): the
standard ILSVRC layout under a data root, ``DIFFUSIONVID_DATA_DIR`` or
``datasets`` unless a ``data_dir`` is given; and the still-image names
(``coco_<split>``, ``voc_<split>``, ``cityscapes_<split>``) under
``coco/``, ``voc/`` and ``cityscapes/`` of the same root.
"""

from __future__ import annotations

import os

from .vid_dataset import VIDDataset

DATA_DIR = os.environ.get("DIFFUSIONVID_DATA_DIR", "datasets")

# name → (img_dir, anno_dir, index_file) relative to the data root
# (paths_catalog.py:152-186)
DATASETS = {
    "DET_train_30classes": ("ILSVRC2015/Data/DET", "ILSVRC2015/Annotations/DET",
                            "ILSVRC2015/ImageSets/DET_train_30classes.txt"),
    "VID_train_15frames": ("ILSVRC2015/Data/VID", "ILSVRC2015/Annotations/VID",
                           "ILSVRC2015/ImageSets/VID_train_15frames.txt"),
    "VID_train_every10frames": ("ILSVRC2015/Data/VID", "ILSVRC2015/Annotations/VID",
                                "ILSVRC2015/ImageSets/VID_train_every10frames.txt"),
    "VID_val_frames": ("ILSVRC2015/Data/VID", "ILSVRC2015/Annotations/VID",
                       "ILSVRC2015/ImageSets/VID_val_frames.txt"),
    "VID_val_videos": ("ILSVRC2015/Data/VID", "ILSVRC2015/Annotations/VID",
                       "ILSVRC2015/ImageSets/VID_val_videos.txt"),
    "VID_val_videos_miniset": ("ILSVRC2015/Data/VID", "ILSVRC2015/Annotations/VID",
                               "ILSVRC2015/ImageSets/VID_val_videos_miniset.txt"),
    # YouTube-Objects variants (paths_catalog.py YouTube_Objects entries)
    "YouTube_Objects": ("YTO/Data", "YTO/Annotations", "YTO/ImageSets/yto_test.txt"),
    "YouTube_Objects_train": ("YTO/Data", "YTO/Annotations", "YTO/ImageSets/yto_train.txt"),
}



def get_dataset(name: str, is_train: bool, data_dir: str | None = None):
    """``name`` → its dataset: a ``VIDDataset``, or for the still-image
    names a ``COCODataset`` (``coco/annotations/instances_<split>.json``,
    images in ``coco/<split>``), ``VOCDataset`` (``voc``) or
    ``CityscapesDataset`` (``cityscapes``)."""
    root = data_dir or DATA_DIR
    if name.startswith("coco_"):
        from .coco_voc import COCODataset
        split = name[len("coco_"):]
        return COCODataset(os.path.join(root, "coco", "annotations", f"instances_{split}.json"),
                           os.path.join(root, "coco", split))
    if name.startswith("voc_"):
        from .coco_voc import VOCDataset
        return VOCDataset(os.path.join(root, "voc"), split=name[len("voc_"):])
    if name.startswith("cityscapes_"):
        from .cityscapes import CityscapesDataset
        return CityscapesDataset(os.path.join(root, "cityscapes"),
                                 split=name[len("cityscapes_"):])
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name}; known: {sorted(DATASETS)}")
    img_dir, anno_dir, index = DATASETS[name]
    return VIDDataset(
        image_set=name,
        data_dir=root,
        img_dir=os.path.join(root, img_dir),
        anno_path=os.path.join(root, anno_dir),
        img_index=os.path.join(root, index),
        is_train=is_train,
    )

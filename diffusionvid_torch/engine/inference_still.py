"""Still-image dataset inference and evaluation.

Port of ``diffusionvid_tpu/engine/inference_still.py:23-87`` (the
reference's test loop over its generic datasets with their evaluators):
one image at a time through a single-frame detector (``GeneralizedRCNN``
or ``RetinaNet``, both called as ``model(images, image_hw)``), then the
evaluator by name: COCO's mAP (``coco``, ``cityscapes``) or the VOC-style
AP (any other name: ``voc``).  An image is resized by ``resize_scale``,
padded into its orientation bucket (``frame_bucket`` /
``transform_frame``), and detected on the model's device; the detections
above ``score_thresh`` are divided by the scale into the image's
coordinates.  Each image's detections go to
the host after the next image is on the device.

A ``GeneralizedRCNN`` with a mask or keypoint head returns the heads' dict,
which neither the JAX package's runner nor this one turns into
predictions: this runner refuses such a model before its first image
(``refuse_roi_heads``; ROADMAP.md §C 9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.transforms import frame_bucket, resize_scale, transform_frame
from .inference import _to_numpy


def refuse_roi_heads(model):
    """Raise for a model whose test forward returns the mask and keypoint
    heads' dict instead of a ``BoxArray``."""
    if any(getattr(model, head, None) is not None for head in ("mask_head", "kp_head")):
        raise ValueError(
            "the model runs the mask or keypoint head (MODEL.MASK_ON / KEYPOINT_ON) and returns "
            "the heads' dict, which the evaluation runners do not read, in the JAX package "
            "neither (ROADMAP.md §C 9): evaluate it without those flags")


def evaluator_for(dataset_name: str) -> str:
    """The JAX test CLI's choice of evaluator by the dataset's name."""
    if dataset_name.startswith("coco_"):
        return "coco"
    return "cityscapes" if dataset_name.startswith("cityscapes_") else "voc"


def run_inference_still(model, dataset, *, min_size: int = 600, max_size: int = 1000,
                        logger=None, max_images: Optional[int] = None,
                        score_thresh: float = 0.05, evaluator: str = "voc"):
    """Per-image inference over a still-image dataset (``COCODataset``,
    ``VOCDataset``, ``CityscapesDataset``), the first ``max_images`` images
    at most.  Returns (predictions, gt_list, results); ``results`` has
    ``ap50``.  With ``max_images`` below the dataset's size, the VOC
    evaluator counts the images that ran only, as the JAX package's does."""
    refuse_roi_heads(model)
    num_classes = len(dataset.classes) - 1
    device = next(model.parameters()).device
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    predictions, gt_list = [None] * n, []
    pending = None
    with torch.no_grad():
        for i in range(n):
            anno = dataset.get_groundtruth(i)
            scale = resize_scale(anno.height, anno.width, min_size, max_size)
            bucket = frame_bucket(anno.height, anno.width, min_size, max_size)
            frame = transform_frame(dataset.load_image(dataset.image_path(i)), scale, False,
                                    bucket)
            hw = (float(round(anno.height * scale)), float(round(anno.width * scale)))
            dets = model(torch.from_numpy(np.ascontiguousarray(frame[None])).to(device), hw)
            if pending is not None:
                predictions[pending[0]] = _to_numpy(pending[1], pending[2], score_thresh)
            pending = (i, dets, scale)
            gt_list.append({"boxes": anno.boxes, "labels": anno.labels})
            if logger and (i + 1) % 50 == 0:
                logger.info(f"[still] {i + 1}/{n} images")
        if pending is not None:
            predictions[pending[0]] = _to_numpy(pending[1], pending[2], score_thresh)

    if evaluator in ("coco", "cityscapes"):
        from ..evaluation.coco_eval import evaluate_coco
        results = evaluate_coco(gt_list, predictions, num_classes)
        results["ap50"] = results["AP50"]
    elif max_images is not None and max_images < len(dataset):
        # evaluate_still reads every image's GT: count the images that ran
        from ..evaluation.vid_eval import calc_ap, calc_prec_rec
        prec, rec = calc_prec_rec(gt_list, predictions, None, 0.5, (0.0, 1.0), num_classes)
        results = {"ap50": float(np.nanmean(calc_ap(prec, rec)[1:]))}
    else:
        from ..data.coco_voc import evaluate_still
        results = evaluate_still(dataset, predictions, num_classes=num_classes)
    if logger:
        logger.info(f"[still/{evaluator}] results: "
                    + ", ".join(f"{k}={v:.4f}" for k, v in results.items()
                                if isinstance(v, float)))
    return predictions, gt_list, results

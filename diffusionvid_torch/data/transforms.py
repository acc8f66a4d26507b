"""Image transforms of the test pipeline.

Port of the test side of ``diffusionvid_tpu/data/transforms.py:20-91``: the
maskrcnn resize scale, then a zero pad into one of two static orientation
buckets (landscape 608x1024 / portrait 1024x608 at the default 600/1000
min/max sizes), so every chunk of a video has one shape.  Normalization
lives in the model (``DiffusionDetArch.extract_features``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_scale(height: int, width: int, min_size: int = 600,
                 max_size: int = 1000) -> float:
    """maskrcnn-style scale: short side → min_size unless the long side
    would exceed max_size (transforms.py Resize.get_size semantics)."""
    short, long = min(height, width), max(height, width)
    scale = min_size / short
    if long * scale > max_size:
        scale = max_size / long
    return scale


def bucket_shape(min_size: int = 600, max_size: int = 1000,
                 divisor: int = 32) -> Tuple[int, int]:
    """Static (short, long) padded extents covering any resized image."""
    def rup(v):
        return ((v + divisor - 1) // divisor) * divisor
    return rup(min_size), rup(max_size)


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize by ``scale``.  At the image's own size it returns
    the image (``cv2.resize`` to the same size is a copy), so that frames
    already at their scale need no ``cv2``."""
    h, w = img.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) == (h, w):
        return img
    import cv2
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)


def pad_to(img: np.ndarray, shape_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to the static bucket (collate_batch.py:25-35
    size-divisible padding, taken to a fixed extent)."""
    h, w = img.shape[:2]
    ph, pw = shape_hw
    if h > ph or w > pw:
        raise ValueError(f"image {img.shape} exceeds the bucket {shape_hw}")
    out = np.zeros((ph, pw, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def transform_frame(img: np.ndarray, scale: float, flip: bool,
                    bucket_hw: Tuple[int, int]) -> np.ndarray:
    """resize → optional hflip → pad to the bucket. Returns [H,W,3]."""
    img = resize_image(img, scale)
    if flip:
        img = img[:, ::-1]
    return pad_to(np.ascontiguousarray(img), bucket_hw)


def frame_bucket(height: int, width: int, min_size: int = 600,
                 max_size: int = 1000, divisor: int = 32) -> Tuple[int, int]:
    """Orientation-dependent static bucket for this image."""
    s, l = bucket_shape(min_size, max_size, divisor)
    return (s, l) if width >= height else (l, s)

"""Image transforms of the test and train pipelines.

Port of ``diffusionvid_tpu/data/transforms.py:20-247``: the maskrcnn resize
scale, then a zero pad into one of two static orientation buckets
(landscape 608x1024 / portrait 1024x608 at the default 600/1000 min/max
sizes), so every chunk of a video and every train sample has one shape;
and the train side's SSD augmentation (``INPUT.TRANSFORM``).  Normalization
lives in the model (``DiffusionDetArch.extract_features``).

The train side resizes and converts RGB to HSV and back with its own numpy
code, ``resize_bilinear``, ``rgb_to_hsv`` and ``hsv_to_rgb``, whether or not
``cv2`` is installed: the card's host has no ``cv2``.  They follow OpenCV's
float formulas (``INTER_LINEAR`` with half-pixel centres and clamped edges;
``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` on float images, H in degrees, no
clipping).  On uint8 images OpenCV's resize uses 11-bit fixed-point weights
where this one rounds a float result, so the two differ by up to one grey
level.
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


# ---------------------------------------------------------------------------
# The train side's own resize and colour conversion
# ---------------------------------------------------------------------------

def _linear_taps(src: int, dst: int):
    """OpenCV's ``INTER_LINEAR`` taps along one axis: for each output
    position the two source indices and their float32 weights, the source
    coordinate ``(d + 0.5) * src / dst - 0.5`` clamped to the edge pixels."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0).astype(np.float32)
    edge = (i0 < 0) | (i0 >= src - 1)
    i0 = np.clip(i0, 0, src - 1)
    frac[edge] = 0.0
    return i0, np.minimum(i0 + 1, src - 1), (1.0 - frac)[:, None], frac[:, None]


def resize_bilinear(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an [H, W, C] image to ``size_hw``, rows of
    horizontal taps first, in float32; a uint8 image is rounded back."""
    h, w = img.shape[:2]
    rh, rw = size_hw
    if (rh, rw) == (h, w):
        return img.copy()
    x0, x1, ax0, ax1 = _linear_taps(w, rw)
    y0, y1, ay0, ay1 = _linear_taps(h, rh)
    src = img.astype(np.float32, copy=False)
    rows = src[:, x0] * ax0 + src[:, x1] * ax1
    out = rows[y0] * ay0[:, None] + rows[y1] * ay1[:, None]
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype, copy=False)


_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Float RGB → HSV as OpenCV's ``COLOR_RGB2HSV`` on float images: H in
    degrees [0, 360), S = (max - min) / (|max| + eps), V = max; any range."""
    img = img.astype(np.float32, copy=False)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = np.float32(60.0) / (diff + _FLT_EPSILON)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0),
                          (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], -1).astype(np.float32, copy=False)


# for each sector of the hue circle, the indices into (v, p, q, t) of B, G, R
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Float HSV → RGB as OpenCV's ``COLOR_HSV2RGB`` on float images, H in
    degrees within [-360, 720); nothing is clipped."""
    hsv = hsv.astype(np.float32, copy=False)
    h = hsv[..., 0] * np.float32(6.0 / 360.0)
    s, v = hsv[..., 1], hsv[..., 2]
    h = np.where(h < 0, h + np.float32(6.0), np.where(h >= 6, h - np.float32(6.0), h))
    sector = np.floor(h)
    frac = h - sector
    outside = (sector < 0) | (sector >= 6)
    sector = np.where(outside, 0, sector).astype(np.int64)
    frac = np.where(outside, np.float32(0.0), frac)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * frac), v * (one - s * (one - frac))], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], axis=-1)
    return np.ascontiguousarray(bgr[..., ::-1])


def transform_frame_to(img: np.ndarray, size_hw: Tuple[int, int], flip: bool,
                       bucket_hw: Tuple[int, int]) -> np.ndarray:
    """Resize to an exact (h, w) → optional hflip → pad to the bucket.  The
    train path's resize: each frame lands on the sample's static target
    whatever the SSD augmentation made of its extent."""
    img = resize_bilinear(img, size_hw)
    if flip:
        img = img[:, ::-1]
    return pad_to(np.ascontiguousarray(img), bucket_hw)


# ---------------------------------------------------------------------------
# SSD-style train augmentation, the reference's INPUT.TRANSFORM path
# (transforms/build.py:67-68 appends TS.SSDAugmentation): PhotometricDistort
# → Expand(mean-fill) → RandomSampleCrop, before resize
# (transforms_selsa.py:449-471).  Every draw of ``rng`` happens in the JAX
# package's order and number, coins that skip included: a sample built from
# one seed gets the same boxes and labels on both sides.
# ---------------------------------------------------------------------------

def ssd_photometric_distort(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """PhotometricDistort (transforms_selsa.py:422-446): random brightness,
    then (contrast → HSV saturation/hue) or (HSV saturation/hue → contrast),
    then a random channel permutation.  Every sub-op flips its own coin.
    float32 RGB 0..255 in and out (``ssd_augment`` clips at its end)."""
    out = img.astype(np.float32)
    # RandomBrightness(delta=32)
    if rng.randint(2):
        out = out + rng.uniform(-32.0, 32.0)

    def contrast(im):
        # RandomContrast(0.5, 1.5); the coin consumes an alpha draw either way
        if rng.randint(2):
            return im * rng.uniform(0.5, 1.5)
        rng.uniform(0.5, 1.5)
        return im

    def satur_hue(im):
        # RGB → HSV (H in degrees, V on the input's scale) → RandomSaturation
        # / RandomHue → back
        hsv = rgb_to_hsv(im)
        if rng.randint(2):
            hsv[:, :, 1] *= rng.uniform(0.5, 1.5)
        else:
            rng.uniform(0.5, 1.5)
        if rng.randint(2):
            h = hsv[:, :, 0] + rng.uniform(-18.0, 18.0)
            h[h > 360.0] -= 360.0
            h[h < 0.0] += 360.0
            hsv[:, :, 0] = h
        else:
            rng.uniform(-18.0, 18.0)
        return hsv_to_rgb(hsv)

    if rng.randint(2):
        out = satur_hue(contrast(out))      # pd[:-1]: contrast first
    else:
        out = contrast(satur_hue(out))      # pd[1:]: contrast last

    # RandomLightingNoise: random channel permutation
    perms = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
    if rng.randint(2):
        out = out[:, :, list(perms[rng.randint(len(perms))])]
    else:
        rng.randint(len(perms))
    return out


def ssd_expand(img: np.ndarray, boxes: np.ndarray, rng: np.random.RandomState, mean,
               expand_scale: float = 2.0):
    """Expand (transforms_selsa.py:347-388): paste onto a mean-filled canvas
    up to ``expand_scale`` times the size, shifting the boxes; 50% skip.
    The reference fills with ``mean[::-1]`` rounded (is_RGB=True), kept as
    it is even when PIXEL_MEAN is already RGB."""
    if rng.randint(2):
        return img, boxes
    h, w = img.shape[:2]
    ratio = rng.uniform(1.0, expand_scale)
    left = int(rng.uniform(0, w * ratio - w))
    top = int(rng.uniform(0, h * ratio - h))
    fill = [round(float(m)) for m in list(mean)[::-1]]
    out = np.empty((int(h * ratio), int(w * ratio), img.shape[2]), img.dtype)
    out[:, :] = np.asarray(fill, img.dtype)
    out[top: top + h, left: left + w] = img
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :2] += (left, top)
        boxes[:, 2:] += (left, top)
    return out, boxes


_SSD_CROP_MODES = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None), (None, None))


def ssd_random_sample_crop(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                           rng: np.random.RandomState, crop_pert: float = 0.3,
                           max_rounds: int = 20):
    """RandomSampleCrop (transforms_selsa.py:224-345): an aspect-preserving
    window at least ``crop_pert`` of the width, kept when every GT's IoU
    with it lies within the mode's bounds; GTs stay by their centre.  The
    reference retries modes for ever; ``max_rounds`` bounds that (mode None
    exits at once, with p = 1/6 a round)."""
    for _ in range(max_rounds):
        mode = _SSD_CROP_MODES[rng.randint(len(_SSD_CROP_MODES))]
        if mode is None:
            return img, boxes, labels
        min_iou = -np.inf if mode[0] is None else mode[0]
        max_iou = np.inf if mode[1] is None else mode[1]
        h, w = img.shape[:2]
        aspect = float(h) / float(w)
        for _ in range(50):
            cw = rng.uniform(crop_pert * w, w)
            ch = cw * aspect
            left = rng.uniform(0.0, w - cw)
            top = rng.uniform(0.0, h - ch)
            rect = np.array([int(left), int(top), int(left + cw), int(top + ch)])
            if len(boxes):
                ix = (np.minimum(boxes[:, 2], rect[2])
                      - np.maximum(boxes[:, 0], rect[0])).clip(min=0)
                iy = (np.minimum(boxes[:, 3], rect[3])
                      - np.maximum(boxes[:, 1], rect[1])).clip(min=0)
                inter = ix * iy
                area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                area_r = (rect[2] - rect[0]) * (rect[3] - rect[1])
                iou = inter / np.maximum(area_b + area_r - inter, 1e-9)
                if iou.min() < min_iou or iou.max() > max_iou:
                    continue
                centers = 0.5 * (boxes[:, :2] + boxes[:, 2:])
                keep = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1])
                        & (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
                if not keep.any():
                    continue
                nb = boxes[keep].copy()
                nb[:, :2] = np.maximum(nb[:, :2], rect[:2]) - rect[:2]
                nb[:, 2:] = np.minimum(nb[:, 2:], rect[2:]) - rect[:2]
                nl = labels[keep]
            else:
                nb, nl = boxes, labels
            return np.ascontiguousarray(img[rect[1]: rect[3], rect[0]: rect[2]]), nb, nl
    return img, boxes, labels


def ssd_augment(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                rng: np.random.RandomState, pixel_mean=(123.675, 116.280, 103.530),
                expand_scale: float = 2.0, crop_pert: float = 0.3):
    """SSDAugmentation (transforms_selsa.py:449-480), the INPUT.TRANSFORM
    train pipeline: uint8 RGB and xyxy boxes in, uint8 and the adjusted
    (boxes, labels) out.  Runs before the resize, as in the reference."""
    out = ssd_photometric_distort(img, rng)
    out, boxes = ssd_expand(out, boxes, rng, pixel_mean, expand_scale)
    out, boxes, labels = ssd_random_sample_crop(out, boxes, labels, rng, crop_pert)
    return np.clip(out, 0, 255).astype(np.uint8), np.asarray(boxes, np.float32), labels

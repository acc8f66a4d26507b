"""Segmentation masks and keypoints of the still-image path.

Port of ``diffusionvid_tpu/structures/masks.py`` (the reference's
``segmentation_mask.py`` and ``keypoint.py``, active only with
``MODEL.MASK_ON`` / ``KEYPOINT_ON``): polygons as padded vertex arrays, and
the raster, crop, resize and flip that the mask head's targets need, in
numpy.  ``rasterize`` fills with ``cv2.fillPoly``, imported when it is
called (the card's host has no ``cv2``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PolygonMasks(NamedTuple):
    """[N, P, 2] padded polygon vertices and each polygon's vertex count."""

    vertices: np.ndarray   # [N, P, 2] float32 (x, y)
    counts: np.ndarray     # [N] int32

    def resize(self, scale_x: float, scale_y: float) -> "PolygonMasks":
        v = self.vertices.copy()
        v[..., 0] *= scale_x
        v[..., 1] *= scale_y
        return PolygonMasks(v, self.counts)

    def transpose_lr(self, image_width: float) -> "PolygonMasks":
        """Horizontal flip (segmentation_mask transpose semantics)."""
        v = self.vertices.copy()
        v[..., 0] = image_width - v[..., 0] - 1
        return PolygonMasks(v, self.counts)

    def crop(self, box) -> "PolygonMasks":
        x1, y1, x2, y2 = box
        v = self.vertices.copy()
        v[..., 0] = np.clip(v[..., 0] - x1, 0, x2 - x1)
        v[..., 1] = np.clip(v[..., 1] - y1, 0, y2 - y1)
        return PolygonMasks(v, self.counts)

    def rasterize(self, height: int, width: int) -> np.ndarray:
        """[N, H, W] uint8 masks; a polygon of fewer than 3 vertices stays
        empty."""
        import cv2
        out = np.zeros((len(self.counts), height, width), np.uint8)
        for i, c in enumerate(self.counts):
            if c < 3:
                continue
            pts = self.vertices[i, :c].round().astype(np.int32)
            cv2.fillPoly(out[i], [pts], 1)
        return out


# COCO person keypoints and their left/right pairs (keypoint.py PersonKeypoints)
PERSON_KEYPOINTS = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)
FLIP_MAP = {1: 2, 3: 4, 5: 6, 7: 8, 9: 10, 11: 12, 13: 14, 15: 16}


class Keypoints(NamedTuple):
    """[N, K, 3] (x, y, visibility)."""

    points: np.ndarray

    def resize(self, scale_x: float, scale_y: float) -> "Keypoints":
        p = self.points.copy()
        p[..., 0] *= scale_x
        p[..., 1] *= scale_y
        return Keypoints(p)

    def transpose_lr(self, image_width: float) -> "Keypoints":
        """Mirror x and swap each left keypoint with its right one."""
        p = self.points.copy()
        p[..., 0] = image_width - p[..., 0] - 1
        out = p.copy()
        for a, b in FLIP_MAP.items():
            out[:, a], out[:, b] = p[:, b].copy(), p[:, a].copy()
        return Keypoints(out)

    def crop(self, box) -> "Keypoints":
        """Shift into the box; a keypoint outside it becomes invisible."""
        x1, y1, x2, y2 = box
        p = self.points.copy()
        p[..., 0] -= x1
        p[..., 1] -= y1
        inside = ((p[..., 0] >= 0) & (p[..., 0] <= x2 - x1)
                  & (p[..., 1] >= 0) & (p[..., 1] <= y2 - y1))
        p[..., 2] = np.where(inside, p[..., 2], 0)
        return Keypoints(p)

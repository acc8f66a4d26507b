"""ctypes bindings of the host library ``csrc/vidkit.cpp``.

``match_frame_native`` is the evaluator's per-(frame, class) matching and
``max_chain_native`` seq-NMS's best-chain search, with the semantics of the
Python paths of ``evaluation/vid_eval.py`` and ``engine/seq_nms.py``.  The
library compiles with ``g++`` at first use (``ops/_build.py: load_host``);
a failed build raises.  The callers choose between the library and their
Python path by an argument, never by whether the library loads.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .ops import _build

_lib = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = _build.load_host("vidkit")
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i8 = ctypes.POINTER(ctypes.c_int8)
        c_u8 = ctypes.POINTER(ctypes.c_uint8)
        c_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.vid_match_frame.argtypes = [c_d, ctypes.c_int, c_d, c_d, ctypes.c_int,
                                        ctypes.c_double, ctypes.c_double, c_i8, c_d]
        lib.vid_match_frame.restype = None
        lib.vidkit_max_chain.argtypes = [c_d, c_d, c_u8, c_i32, ctypes.c_int,
                                         ctypes.c_double, c_d, c_i32, c_i32]
        lib.vidkit_max_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_path():
    """The library's file, or None while it is not built."""
    path = _build.host_target("vidkit")
    return path if path.exists() else None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def match_frame_native(pred_boxes, gt_boxes, gt_ignore, iou_thresh: float,
                       empty_weight: float):
    """One frame and class: predictions [n, 4] sorted by descending score,
    GT [g, 4] and its ignore flags [g].  Returns (match int8[n],
    pred_ignore float64[n])."""
    pb = np.ascontiguousarray(pred_boxes, np.float64).reshape(-1, 4)
    gb = np.ascontiguousarray(gt_boxes, np.float64).reshape(-1, 4)
    gi = np.ascontiguousarray(gt_ignore, np.float64).reshape(-1)
    if len(gi) != len(gb):
        raise ValueError(f"{len(gb)} GT boxes but {len(gi)} ignore flags")
    n = len(pb)
    match = np.zeros(n, np.int8)
    pig = np.zeros(n, np.float64)
    get_lib().vid_match_frame(_ptr(pb, ctypes.c_double), n, _ptr(gb, ctypes.c_double),
                              _ptr(gi, ctypes.c_double), len(gb), float(iou_thresh),
                              float(empty_weight), _ptr(match, ctypes.c_int8),
                              _ptr(pig, ctypes.c_double))
    return match, pig


def max_chain_native(boxes, scores, dead, offsets, link_thresh: float):
    """The best chain over the alive boxes of one class of a video, flat
    over frames: boxes [n, 4], scores [n], dead [n], frame f's boxes at
    ``offsets[f]:offsets[f + 1]``.  Returns (root frame, the chain's global
    box ids, its score sum)."""
    b = np.ascontiguousarray(boxes, np.float64).reshape(-1, 4)
    s = np.ascontiguousarray(scores, np.float64)
    d = np.ascontiguousarray(dead, np.uint8)
    off = np.ascontiguousarray(offsets, np.int32)
    n_frames = len(off) - 1
    if n_frames < 0 or off[0] != 0 or np.any(np.diff(off) < 0):
        raise ValueError("offsets must start at 0 and never decrease")
    if not len(b) == len(s) == len(d) == off[-1]:
        raise ValueError(f"{len(b)} boxes, {len(s)} scores and {len(d)} dead flags "
                         f"for offsets ending at {off[-1]}")
    total = ctypes.c_double(0.0)
    root = ctypes.c_int32(0)
    path = np.zeros(max(n_frames, 1), np.int32)
    n = get_lib().vidkit_max_chain(_ptr(b, ctypes.c_double), _ptr(s, ctypes.c_double),
                                   _ptr(d, ctypes.c_uint8), _ptr(off, ctypes.c_int32),
                                   n_frames, float(link_thresh), ctypes.byref(total),
                                   ctypes.byref(root), _ptr(path, ctypes.c_int32))
    return int(root.value), path[:n].tolist(), float(total.value)

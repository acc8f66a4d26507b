"""Dataset-level inference for the MEGA family: base, DFF, FGFA, RDN, MEGA, DAFA.

Port of ``diffusionvid_tpu/engine/inference_mega.py:40-334`` (the
reference's method-dispatched test loop, engine/inference.py:26-93), frame
by frame over each video:

  * base: the single-frame ``GeneralizedRCNN``; with ``TEST.BBOX_AUG`` its
    detections of the h-flipped frame and of the scale variants (each
    re-resized from the content region, optionally flipped too) mapped
    back and merged by class-aware NMS (``engine/bbox_aug.py``);
  * dff: a key frame every ``KEY_FRAME_DURATION`` frames runs the trunk and
    its map is kept; the frames between warp it by the flow;
  * fgfa: the window f-2..f+2 and then the current frame again, last
    (``FGFA_WINDOW``: the JAX CLI passes no window, so it runs the JAX
    engine's default 2; ``MODEL.VID.FGFA.MIN/MAX_OFFSET``, ±9, are not read
    at test time);
  * rdn: relation attention over the local window (frames f-2..f+2);
  * mega: the same window, the global memory primed from the video's
    shuffled global frames (4 at a time), and the per-stage rings threaded
    from frame to frame with ``MEMORY.ENABLE``; ``shuffled_cur``
    (``SHUFFLED_CUR_TEST``) visits the frames in a per-video shuffled order
    with the current frame as its only local reference.  With
    ``GLOBAL.PIXEL_ATTEND`` the global pixel cache fills from the raw global
    maps before the box memory; when ``LOCAL.PIXEL_ATTEND`` replaces the box
    relation, each frame runs ``pixel_call`` over the frame selector's
    offsets (``local_pixel_frame_offsets``; offsets before the video's start
    masked, those past its end on the last frame);
  * dafa: Sparse R-CNN whose memory is primed from the first 4 global
    frames' top-75 features.

Predictions are per-frame dicts in original-image coordinates, scores
above 0.05, as in the JAX package; seq-NMS, ``save_predictions``, the
evaluator and the sharding under ``torchrun`` are the diffusion path's
(``engine/inference.py``).  The whole video goes to the device once; the
previous frame's detections are converted on the host after the current
frame is enqueued (not with ``TEST.BBOX_AUG``, whose variants are made from
the frame on the host).
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.sampling import SampleConfig, iter_test_videos
from ..data.transforms import frame_bucket, resize_scale, transform_frame, transform_frame_to
from ..evaluation.vid_eval import evaluate_vid
from ..models.video_archs import MegaState, PixelState, local_pixel_frame_offsets
from ..parallel import dist
from ..structures.boxes import BoxArray
from .bbox_aug import flip_boxes_back, merge_augmented
from .inference import _detections_to_numpy, save_predictions
from .postprocess import postprocess_frame
from .seq_nms import seq_nms_video

METHODS = ("base", "dff", "fgfa", "rdn", "mega", "dafa")
FGFA_WINDOW = 2


class KeyFrame(NamedTuple):
    """DFF's state: the latest key frame's index and res4 map."""

    index: int
    feat: torch.Tensor


class PixelVideoState(NamedTuple):
    """MEGA's state on the pixel path that replaces the box relation."""

    box: MegaState
    pixel: PixelState


def _to_numpy(dets: BoxArray, scale: float) -> dict:
    """Frame 0 of ``dets`` on the host, scores above 0.05, boxes in the
    original image's coordinates."""
    host = BoxArray(*(t.cpu() for t in dets))
    return _detections_to_numpy(host, 0, scale, score_thresh=0.05)


def prime_state(model, method: str, global_frames, whwh, image_hw):
    """The video's starting state: MEGA's global memory from every global
    frame, 4 at a time (after the global pixel cache, with
    ``GLOBAL.PIXEL_ATTEND``, which the memory's maps are enhanced over);
    DAFA's from the first 4; None otherwise."""
    if method == "mega":
        state = model.init_state()
        pstate = None
        if model.pixel_replaces_box or model.pixel_attend_global:
            pstate = model.init_pixel_state()
        if model.pixel_attend_global:
            for s in range(0, len(global_frames), 4):
                pstate = model.update_global_pixels(pstate, global_frames[s:s + 4])
        for s in range(0, len(global_frames), 4):
            feats, valid = model.memory_features(global_frames[s:s + 4], image_hw, pstate)
            state = model.update_memory(state, feats, valid)
        return PixelVideoState(state, pstate) if model.pixel_replaces_box else state
    if method == "dafa":
        state = model.init_state()
        return model.update_memory(state, model.extract_topk(global_frames[:4], whwh))
    return None


def detect_frame(model, method: str, frames, f: int, state, whwh, image_hw,
                 shuffled_cur: bool = False, key_frame_duration: int = 10,
                 pixel_offsets=None):
    """Frame ``f`` of ``frames`` [N, H, W, 3] (on the model's device) →
    (``BoxArray`` [1, D], the state after it).  ``pixel_offsets``: the
    frame selector's offsets on MEGA's pixel path."""
    cur = frames[f:f + 1]
    n = frames.shape[0]
    if method == "base":
        return model(cur, image_hw), state
    if method == "dafa":
        logits, boxes = model(cur, whwh, state=state)
        return postprocess_frame(logits[-1], boxes[-1], image_hw, model.num_proposals), state
    if method == "dff":
        if f % key_frame_duration == 0:
            state = KeyFrame(f, model.key_features(cur))
            return model.detect(state.feat, image_hw), state
        key = frames[state.index:state.index + 1]
        return model.detect(model.warp_from_key(key, cur, state.feat), image_hw), state
    if method == "fgfa":
        lo, hi = max(0, f - FGFA_WINDOW), min(n, f + FGFA_WINDOW + 1)
        return model(cur, torch.cat([frames[lo:hi], cur], 0), image_hw), state
    if isinstance(state, PixelVideoState):
        offs = torch.tensor(pixel_offsets, device=frames.device)
        refs = frames[(f + offs).clamp(0, n - 1)]
        dets, pstate = model.pixel_call(cur, refs, f + offs >= 0, image_hw, state.box,
                                        state.pixel)
        return dets, state._replace(pixel=pstate)
    lo, hi = (f, f + 1) if shuffled_cur else (max(0, f - 2), min(n, f + 3))
    refs = frames[lo:hi]
    if method == "rdn":
        return model(cur, refs, image_hw), state
    if model.use_stage_mem:
        return model(cur, refs, image_hw, state=state, return_state=True)
    return model(cur, refs, image_hw, state=state), state


def scale_variant(content: np.ndarray, scale: float, flip: bool, bucket_hw) -> np.ndarray:
    """``TEST.BBOX_AUG``'s scale variant of a frame's content: resized by
    ``scale``, mirrored with ``flip``, padded to ``bucket_hw``.  The resize
    is ``cv2``'s (``transform_frame``, the JAX package's) where ``cv2`` is
    installed; on a host without it (the card's) the port's own
    ``resize_bilinear``, within one grey level of ``cv2`` on uint8 frames."""
    if importlib.util.find_spec("cv2") is not None:
        return transform_frame(content, scale, flip, bucket_hw)
    h, w = content.shape[:2]
    return transform_frame_to(content, (int(round(h * scale)), int(round(w * scale))), flip,
                              bucket_hw)


def bbox_aug_frame(model, frame: np.ndarray, dets: BoxArray, content_hw, scale: float, *,
                   h_flip: bool = True, scales=(), max_size: int = 4000,
                   scale_h_flip: bool = False) -> dict:
    """``TEST.BBOX_AUG`` on one frame (bbox_aug.py ``im_detect_bbox_aug``):
    ``dets``, the base detections, plus the model's on the frame with its
    content region mirrored (``h_flip``) and on each scale variant (the
    content re-resized with the short side to the scale, the long side at
    most ``max_size``, into its bucket; mirrored too with
    ``scale_h_flip``), each mapped back to the base frame, merged, and
    divided by ``scale`` into the original image's coordinates.  ``frame``
    is the padded frame on the host, ``content_hw`` its content's (h, w).
    The variants re-resize the resized content (the streaming pipeline
    keeps no raw frame), as in the JAX package."""
    rh, rw = content_hw
    content = frame[:rh, :rw]
    variants = [(None, True)] if h_flip else []
    for size in scales:
        variants += [(int(size), False)] + ([(int(size), True)] if scale_h_flip else [])
    device = next(model.parameters()).device
    det_sets = [_to_numpy(dets, 1.0)]
    for size, flip in variants:
        if size is None:
            image = frame.copy()
            image[:rh, :rw] = content[:, ::-1]
            vh, vw = rh, rw
        else:
            sc = resize_scale(rh, rw, size, max_size)
            vh, vw = int(round(rh * sc)), int(round(rw * sc))
            image = scale_variant(content, sc, flip, frame_bucket(rh, rw, size, max_size))
        found = _to_numpy(model(torch.from_numpy(image[None]).to(device),
                                (float(vh), float(vw))), 1.0)
        if flip:
            found["boxes"] = flip_boxes_back(found["boxes"], vw)
        if size is not None:   # BoxList.resize back to the base frame
            found["boxes"] = found["boxes"] * np.asarray([rw / vw, rh / vh] * 2, np.float32)
        det_sets.append(found)
    merged = merge_augmented(det_sets)
    merged["boxes"] = merged["boxes"] / scale
    return merged


def run_inference_video_arch(model, dataset, sample_cfg: SampleConfig, *, method: str,
                             logger=None, max_videos: Optional[int] = None, seed: int = 0,
                             output_dir: Optional[str] = None, use_seq_nms: bool = False,
                             motion_ious=None, motion_specific: bool = False,
                             shard: int = 0, num_shards: int = 1,
                             key_frame_duration: int = 10, use_bbox_aug: bool = False, bbox_aug_h_flip: bool = True,
                             bbox_aug_scales: tuple = (), bbox_aug_max_size: int = 4000,
                             bbox_aug_scale_h_flip: bool = False, shuffled_cur: bool = False,
                             all_frame_interval: int = 25, key_frame_location: int = 12):
    """Evaluate a MEGA-family model over a VID dataset.  Returns
    (predictions, gt_list, results).  Under a process group (and
    ``num_shards`` 1) the ranks are the shards, as in ``run_inference``:
    every rank returns the merged predictions and GT, rank 0 alone the
    results.  ``use_bbox_aug`` (``TEST.BBOX_AUG``, with its ``H_FLIP``,
    ``SCALES``, ``MAX_SIZE`` and ``SCALE_H_FLIP``) applies to ``base``
    only: the temporal methods' state would not survive a second pass.
    ``all_frame_interval`` and ``key_frame_location`` place the pixel
    path's frame selector."""
    if method not in METHODS:
        raise ValueError(f"unknown VID.METHOD {method!r}")
    if shuffled_cur and method != "mega":
        raise ValueError(f"MODEL.VID.MEGA.SHUFFLED_CUR_TEST only applies to METHOD "
                         f"'mega' (got {method!r})")
    if use_bbox_aug and method != "base":
        raise ValueError(f"TEST.BBOX_AUG is only implemented for METHOD 'base' (got "
                         f"{method!r}); the dff/fgfa/rdn/mega streaming paths keep temporal "
                         f"state that h-flip TTA would invalidate")
    aug = dict(h_flip=bbox_aug_h_flip, scales=tuple(bbox_aug_scales),
               max_size=bbox_aug_max_size, scale_h_flip=bbox_aug_scale_h_flip)
    frame_kw = dict(shuffled_cur=shuffled_cur, key_frame_duration=key_frame_duration,
                    pixel_offsets=local_pixel_frame_offsets(interval=all_frame_interval,
                                                            key_location=key_frame_location))
    gathered = dist.is_initialized() and num_shards == 1
    if gathered:
        shard, num_shards = dist.rank(), dist.world_size()
    if motion_ious is not None and ((num_shards > 1 and not gathered)
                                    or max_videos is not None):
        motion_ious = None   # the rows align to the full dataset only
    device = next(model.parameters()).device
    predictions, gt_list, tagged, tagged_gt = [], [], [], []
    n_frames, t0 = 0, time.perf_counter()

    with (dist.all_or_none() if gathered else contextlib.nullcontext()), torch.no_grad():
        for n_vid, video in enumerate(iter_test_videos(dataset, sample_cfg, seed=seed,
                                                       shard=shard, num_shards=num_shards)):
            if max_videos is not None and n_vid >= max_videos:
                break
            whwh_np = video.whwh
            image_hw = (float(whwh_np[1]), float(whwh_np[0]))
            whwh = torch.from_numpy(np.asarray(whwh_np, np.float32)).to(device)
            scale = float(whwh_np[0]) / float(video.frame_annos[0].width)
            host_frames = np.concatenate([chunk[:n_valid]
                                          for chunk, _, n_valid in video.chunk_iter])
            frames = torch.from_numpy(host_frames).to(device)
            n = frames.shape[0]
            state = prime_state(model, method, torch.from_numpy(video.global_frames).to(device),
                                whwh, image_hw)

            video_preds = [None] * n
            pending = None
            order = (np.random.RandomState(seed + video.video_index).permutation(n)
                     if shuffled_cur else np.arange(n))
            for f in order:
                dets, state = detect_frame(model, method, frames, int(f), state, whwh,
                                           image_hw, **frame_kw)
                if use_bbox_aug:
                    video_preds[f] = bbox_aug_frame(model, host_frames[f], dets,
                                                    (int(whwh_np[1]), int(whwh_np[0])),
                                                    scale, **aug)
                    continue
                if pending is not None:
                    video_preds[pending[0]] = _to_numpy(pending[1], scale)
                pending = (int(f), dets)
            if pending is not None:
                video_preds[pending[0]] = _to_numpy(pending[1], scale)
            n_frames += n

            if use_seq_nms:
                video_preds = seq_nms_video(video_preds)
            predictions.extend(video_preds)
            tagged.append((video.video_index, video_preds))
            video_gt = [{"boxes": a.boxes, "labels": a.labels} for a in video.frame_annos]
            tagged_gt.append((video.video_index, video_gt))
            gt_list.extend(video_gt)
            if logger:
                fps = n_frames / max(time.perf_counter() - t0, 1e-9)
                logger.info(f"[{method}] video {n_vid}: {n} frames ({fps:.1f} fps cumulative)")

    if gathered:
        predictions = dist.gather_predictions(tagged)
        gt_list = dist.gather_predictions(tagged_gt)
        if dist.rank() != 0:
            return predictions, gt_list, None
        shard, num_shards = 0, 1
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        save_predictions(output_dir, predictions, tagged, shard, num_shards)
    results = None
    if gt_list:
        results = evaluate_vid(gt_list, predictions, motion_ious=motion_ious,
                               motion_specific=motion_specific)
        if logger:
            logger.info(f"AP50: {results['ap50']:.4f}  per-motion: {results['per_motion']}")
        if output_dir:
            with open(os.path.join(output_dir, "result.txt"), "w") as f:
                f.write(f"AP50 = {results['ap50']:.4f}\n")
                for k, v in results["per_motion"].items():
                    f.write(f"AP50 | motion={k:>6s} = {v:.4f}\n")
    return predictions, gt_list, results

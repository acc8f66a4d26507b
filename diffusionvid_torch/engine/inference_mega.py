"""Dataset-level inference for the MEGA family: base, RDN, MEGA and DAFA.

Port of ``diffusionvid_tpu/engine/inference_mega.py:40-334`` (the
reference's method-dispatched test loop, engine/inference.py:26-93), frame
by frame over each video:

  * base: the single-frame ``GeneralizedRCNN``;
  * rdn: relation attention over the local window (frames f-2..f+2);
  * mega: the same window, the global memory primed from the video's
    shuffled global frames (4 at a time), and the per-stage rings threaded
    from frame to frame with ``MEMORY.ENABLE``; ``shuffled_cur``
    (``SHUFFLED_CUR_TEST``) visits the frames in a per-video shuffled order
    with the current frame as its only local reference;
  * dafa: Sparse R-CNN whose memory is primed from the first 4 global
    frames' top-75 features.

Predictions are per-frame dicts in original-image coordinates, scores
above 0.05, as in the JAX package; seq-NMS, ``save_predictions``, the
evaluator and the sharding under ``torchrun`` are the diffusion path's
(``engine/inference.py``).  The whole video goes to the device once; the
previous frame's detections are converted on the host after the current
frame is enqueued.  DFF/FGFA (ROADMAP.md A7.1), the pixel paths (A7.2) and
``TEST.BBOX_AUG`` (A7.4) raise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.sampling import SampleConfig, iter_test_videos
from ..evaluation.vid_eval import evaluate_vid
from ..parallel import dist
from ..structures.boxes import BoxArray
from .inference import _detections_to_numpy, save_predictions
from .postprocess import postprocess_frame
from .seq_nms import seq_nms_video

METHODS = ("base", "rdn", "mega", "dafa")


def _to_numpy(dets: BoxArray, scale: float) -> dict:
    """Frame 0 of ``dets`` on the host, scores above 0.05, boxes in the
    original image's coordinates."""
    host = BoxArray(*(t.cpu() for t in dets))
    return _detections_to_numpy(host, 0, scale, score_thresh=0.05)


def prime_state(model, method: str, global_frames, whwh, image_hw):
    """The video's starting state: MEGA's global memory from every global
    frame, 4 at a time; DAFA's from the first 4; None otherwise."""
    if method == "mega":
        state = model.init_state()
        for s in range(0, len(global_frames), 4):
            feats, valid = model.memory_features(global_frames[s:s + 4], image_hw)
            state = model.update_memory(state, feats, valid)
        return state
    if method == "dafa":
        state = model.init_state()
        return model.update_memory(state, model.extract_topk(global_frames[:4], whwh))
    return None


def detect_frame(model, method: str, frames, f: int, state, whwh, image_hw,
                 shuffled_cur: bool = False):
    """Frame ``f`` of ``frames`` [N, H, W, 3] (on the model's device) →
    (``BoxArray`` [1, D], the state after it)."""
    cur = frames[f:f + 1]
    if method == "base":
        return model(cur, image_hw), state
    if method == "dafa":
        logits, boxes = model(cur, whwh, state=state)
        return postprocess_frame(logits[-1], boxes[-1], image_hw, model.num_proposals), state
    n = frames.shape[0]
    lo, hi = (f, f + 1) if shuffled_cur else (max(0, f - 2), min(n, f + 3))
    refs = frames[lo:hi]
    if method == "rdn":
        return model(cur, refs, image_hw), state
    if model.use_stage_mem:
        return model(cur, refs, image_hw, state=state, return_state=True)
    return model(cur, refs, image_hw, state=state), state


def run_inference_video_arch(model, dataset, sample_cfg: SampleConfig, *, method: str,
                             logger=None, max_videos: Optional[int] = None, seed: int = 0,
                             output_dir: Optional[str] = None, use_seq_nms: bool = False,
                             motion_ious=None, motion_specific: bool = False,
                             shard: int = 0, num_shards: int = 1,
                             use_bbox_aug: bool = False, shuffled_cur: bool = False):
    """Evaluate a MEGA-family model over a VID dataset.  Returns
    (predictions, gt_list, results).  Under a process group (and
    ``num_shards`` 1) the ranks are the shards, as in ``run_inference``:
    every rank returns the merged predictions and GT, rank 0 alone the
    results."""
    if method in ("dff", "fgfa"):
        raise NotImplementedError(f"VID.METHOD {method} (flow warping) is not ported: "
                                  "ROADMAP.md A7.1")
    if method not in METHODS:
        raise ValueError(f"unknown VID.METHOD {method!r}")
    if use_bbox_aug:
        raise NotImplementedError("TEST.BBOX_AUG is not ported: ROADMAP.md A7.4")
    if shuffled_cur and method != "mega":
        raise ValueError(f"MODEL.VID.MEGA.SHUFFLED_CUR_TEST only applies to METHOD "
                         f"'mega' (got {method!r})")
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
            frames = np.concatenate([chunk[:n_valid] for chunk, _, n_valid in video.chunk_iter])
            frames = torch.from_numpy(frames).to(device)
            n = frames.shape[0]
            state = prime_state(model, method, torch.from_numpy(video.global_frames).to(device),
                                whwh, image_hw)

            video_preds = [None] * n
            pending = None
            order = (np.random.RandomState(seed + video.video_index).permutation(n)
                     if shuffled_cur else np.arange(n))
            for f in order:
                dets, state = detect_frame(model, method, frames, int(f), state, whwh,
                                           image_hw, shuffled_cur)
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

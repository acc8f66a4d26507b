"""Dataset-level inference: stream every video, collect and save the
predictions, evaluate.

Port of ``diffusionvid_tpu/engine/inference.py`` (the reference's
``mega_core/engine/inference.py``): each video streams through
``StreamingDetector`` chunk by chunk; shards own whole videos
(samplers/distributed.py:69-115).  Saved predictions (``predictions.pkl``,
the reference's ``predictions.pth``, inference.py:165-168) re-evaluate
without a model (``inference_no_model``, inference.py:184-209).

Each video's noise comes from a generator on the model's device seeded
from ``seed`` and the video's index, so a video's detections do not depend
on the sharding; the draws go through ``StreamingDetector.noise``.

Under an initialized process group (``torchrun``) rank r runs the shard r of
W and the ranks' predictions are gathered (``parallel/dist.py``); rank 0
saves ``predictions.pkl`` and evaluates.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Optional

import numpy as np

from ..data.prefetch import PrefetchIterator
from ..data.sampling import SampleConfig, iter_test_videos
from ..data.vid_dataset import VIDDataset
from ..evaluation.vid_eval import evaluate_vid
from ..parallel import dist
from ..structures.boxes import BoxArray
from .seq_nms import seq_nms_video
from .streaming import StreamingDetector


def video_seed(seed: int, video_index: int) -> int:
    """The seed of a video's noise generator, from the run's seed and the
    video's index in the dataset."""
    return int(np.random.SeedSequence((seed, video_index)).generate_state(1)[0])


def _detections_to_numpy(dets, i, scale, score_thresh: float = 0.0):
    """Row i of a host ``BoxArray`` → numpy dict in ORIGINAL image
    coordinates (boxes divided by the resize scale)."""
    valid = dets.valid[i].numpy()
    scores = dets.scores[i].numpy()
    keep = valid & (scores > score_thresh)
    return {
        "boxes": dets.boxes[i].numpy()[keep] / scale,
        "scores": scores[keep],
        "labels": dets.labels[i].numpy()[keep],
    }


def _chunk_to_numpy(dets, n_valid: int, scale):
    """The first ``n_valid`` frames of a chunk's detections as numpy
    dicts: one copy to the host (which waits for the card), then per frame."""
    host = BoxArray(*(t.cpu() for t in dets))
    return [_detections_to_numpy(host, i, scale) for i in range(n_valid)]


def save_predictions(output_dir, predictions, tagged, shard, num_shards):
    """Single shard: flat ``predictions.pkl`` (the reference's
    predictions.pth, inference.py:165-168).  Sharded: a tagged
    ``predictions_shard{K}of{N}.pkl`` that ``tools/test_net.py`` merges back
    into global frame order."""
    if num_shards > 1:
        path = os.path.join(output_dir, f"predictions_shard{shard}of{num_shards}.pkl")
        with open(path, "wb") as f:
            pickle.dump(tagged, f)
    else:
        with open(os.path.join(output_dir, "predictions.pkl"), "wb") as f:
            pickle.dump(predictions, f)


def run_inference(model, dataset: VIDDataset, sample_cfg: SampleConfig,
                  *, sample_step: int = 1, mem_size: int = 900,
                  num_proposals: int = 300, output_dir: Optional[str] = None,
                  use_seq_nms: bool = False, motion_ious=None,
                  motion_specific: bool = False, seed: int = 0,
                  shard: int = 0, num_shards: int = 1, logger=None,
                  max_videos: Optional[int] = None,
                  stop_update_after_init: bool = True):
    """Run the streaming detector over a test dataset.

    Returns (predictions, gt_list, results_dict_or_None).  Under a process
    group (and ``num_shards`` 1) the ranks are the shards; every rank
    returns the merged predictions and GT, rank 0 alone the results.
    """
    gathered = dist.is_initialized() and num_shards == 1
    if gathered:
        shard, num_shards = dist.rank(), dist.world_size()
    det = StreamingDetector(model, infer_batch=sample_cfg.infer_batch,
                            sample_step=sample_step, mem_size=mem_size,
                            num_proposals=num_proposals,
                            stop_update_after_init=stop_update_after_init)
    if motion_ious is not None and ((num_shards > 1 and not gathered)
                                    or max_videos is not None):
        motion_ious = None   # .mat rows align to the FULL dataset only;
        # sharded runs get motion buckets from the merged eval in test_net
    predictions = []
    tagged = []          # [(video_index, [frame dicts…]), …] for the shard merge
    tagged_gt = []
    gt_list = []
    n_frames = 0
    t0 = time.perf_counter()

    # a rank that fails here fails every rank before the gather below
    with dist.all_or_none() if gathered else contextlib.nullcontext():
        # prefetch: the next video's init frames decode while this one streams,
        # and each video's chunks decode ahead of the card
        videos = PrefetchIterator(iter_test_videos(dataset, sample_cfg, seed=seed, shard=shard,
                                                   num_shards=num_shards), depth=1)
        for n_vid, video in enumerate(videos):
            if max_videos is not None and n_vid >= max_videos:
                videos.close()   # release the producer thread and its buffers
                break
            whwh = video.whwh
            scale = float(whwh[0]) / float(video.frame_annos[0].width)

            state = det.start_video(video_seed(seed, video.video_index), video.global_frames, whwh)
            video_preds = []
            # one-chunk-deep pipeline: chunk N+1 is enqueued on the card before
            # chunk N's detections are copied to the host and converted
            pending = None
            for frames, _, n_valid in PrefetchIterator(video.chunk_iter, depth=2):
                state, dets = det.process_chunk(state, frames, whwh, n_valid)
                if pending is not None:
                    video_preds.extend(_chunk_to_numpy(*pending, scale))
                pending = (dets, n_valid)
                n_frames += n_valid
            if pending is not None:
                video_preds.extend(_chunk_to_numpy(*pending, scale))

            if use_seq_nms:
                video_preds = seq_nms_video(video_preds)

            predictions.extend(video_preds)
            tagged.append((video.video_index, video_preds))
            video_gt = [{"boxes": a.boxes, "labels": a.labels} for a in video.frame_annos]
            tagged_gt.append((video.video_index, video_gt))
            gt_list.extend(video_gt)
            if logger:
                fps = n_frames / max(time.perf_counter() - t0, 1e-9)
                logger.info(f"video {n_vid}: {video.seg_len} frames ({fps:.1f} fps cumulative)")

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


def inference_no_model(predictions_path: str, dataset: VIDDataset,
                       motion_ious=None, motion_specific: bool = False):
    """Re-evaluate saved predictions (``tools/test_prediction.py``)."""
    with open(predictions_path, "rb") as f:
        predictions = pickle.load(f)
    gt_list = [{"boxes": a.boxes, "labels": a.labels} for a in dataset.annos]
    if len(gt_list) != len(predictions):
        raise ValueError(f"{len(gt_list)} GT frames vs {len(predictions)} predictions")
    return evaluate_vid(gt_list, predictions, motion_ious=motion_ious,
                        motion_specific=motion_specific)

"""Streaming-video iteration for inference.

Port of the test side of ``diffusionvid_tpu/data/sampling.py``
(``iter_test_videos``, ``:281-334``; the reference's ``VIDMEGADataset``
test path, ``vid_mega.py:165-255``): per video, a shuffled global index
seeds ``global_size`` init frames for the memory
(STOP_UPDATE_AFTER_INIT_TEST), then the video is consumed in
``infer_batch`` chunks, the tail chunk padded by repeating its last frame.
Videos are sharded at video boundaries.  Everything is host-side numpy;
the engine moves frames to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .prefetch import prefetch_map
from .transforms import frame_bucket, resize_scale, transform_frame
from .vid_dataset import VIDDataset


@dataclass
class SampleConfig:
    """The JAX package's ``SampleConfig``, every field and default; the
    test path reads ``min_size``, ``max_size``, ``global_size``,
    ``infer_batch``, ``shuffle_global`` and ``decode_workers``."""
    num_global: int = 4
    num_local: int = 0
    local_min_offset: int = -12
    local_max_offset: int = 12
    max_gt: int = 64
    min_size: int = 600
    max_size: int = 1000
    hflip_prob: float = 0.5
    global_size: int = 24       # init frames for the test-time memory
    infer_batch: int = 8
    shuffle_global: bool = True
    transform: bool = False     # INPUT.TRANSFORM (train side)
    pixel_mean: tuple = (123.675, 116.280, 103.530)
    decode_workers: int = 8     # threads decoding frames ahead of the card


@dataclass
class VideoChunks:
    """One test video, ready for the streaming engine."""
    video_index: int
    seg_len: int
    global_frames: np.ndarray        # [Ginit, H, W, 3] uint8
    whwh: np.ndarray                 # [4]
    bucket: tuple
    chunk_iter: Iterator             # yields (frames [F,H,W,3], frame_ids, n_valid)
    frame_annos: list                # per-frame FrameAnno (for eval)


def iter_test_videos(ds: VIDDataset, cfg: SampleConfig, seed: int = 0,
                     shard: int = 0, num_shards: int = 1) -> Iterator[VideoChunks]:
    """Iterate whole videos; video ``vi`` belongs to shard ``vi % num_shards``
    (VIDTestDistributedSampler, samplers/distributed.py:69-115)."""
    starts = ds.video_starts()
    for vi, s in enumerate(starts):
        if vi % num_shards != shard:
            continue
        seg_len = ds.frame_seg_len[s]
        anno0 = ds.get_groundtruth(s)
        scale = resize_scale(anno0.height, anno0.width, cfg.min_size, cfg.max_size)
        bucket = frame_bucket(anno0.height, anno0.width, cfg.min_size, cfg.max_size)
        rh = int(round(anno0.height * scale))
        rw = int(round(anno0.width * scale))
        whwh = np.asarray([rw, rh, rw, rh], np.float32)

        rng = np.random.RandomState(seed + vi)
        perm = rng.permutation(seg_len) if cfg.shuffle_global else np.arange(seg_len)
        ginit = perm[: min(cfg.global_size, seg_len)]

        def load(i, s=s, scale=scale, bucket=bucket):
            """Decode, resize and pad one frame, uint8 throughout."""
            img = ds.load_image(ds.frame_path(s, int(i)), dtype=np.uint8)
            return transform_frame(img, scale, False, bucket)

        gframes = np.stack(list(prefetch_map(load, ginit, workers=cfg.decode_workers)))

        def chunks(seg_len=seg_len, load=load):
            f = cfg.infer_batch
            frames_ahead = prefetch_map(load, range(seg_len), workers=cfg.decode_workers,
                                        depth=max(2 * f, 16))
            imgs, ids = [], []
            for i, img in enumerate(frames_ahead):
                imgs.append(img)
                ids.append(i)
                if len(imgs) < f and i != seg_len - 1:
                    continue
                n_valid = len(imgs)
                while len(imgs) < f:   # pad the tail chunk
                    imgs.append(imgs[-1])
                    ids.append(ids[-1])
                yield np.stack(imgs), ids, n_valid
                imgs, ids = [], []

        annos = [ds.get_groundtruth_for_frame(s, i) for i in range(seg_len)]
        yield VideoChunks(vi, seg_len, gframes, whwh, bucket, chunks(), annos)

"""Train samples and streaming-video iteration.

Port of ``diffusionvid_tpu/data/sampling.py`` (the reference's
``VIDMEGADataset`` loading logic, ``mega_core/data/datasets/vid_mega.py``):

  * training (vid_mega.py:35-163): one sample is the current frame and its
    reference frames, each with its own GT, ordered [cur, locals…, mems…,
    globals…]; the flagship path draws REF_NUM_GLOBAL global frames of the
    same video; a DET still stands in for each of its references, augmented
    on its own when INPUT.TRANSFORM is set (vid_mega.py:88-103, 125-130);
  * testing (vid_mega.py:165-255): per video, a shuffled global index seeds
    ``global_size`` init frames for the memory (STOP_UPDATE_AFTER_INIT_TEST),
    then the video is consumed in ``infer_batch`` chunks, the tail chunk
    padded by repeating its last frame; videos are sharded at video
    boundaries.

Everything is host-side numpy; the engine moves frames to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .prefetch import prefetch_map
from .transforms import frame_bucket, resize_scale, ssd_augment, transform_frame, transform_frame_to
from .vid_dataset import FrameAnno, VIDDataset, pad_groundtruth


@dataclass
class SampleConfig:
    """The JAX package's ``SampleConfig``, every field and default."""
    num_global: int = 4
    num_local: int = 0            # local refs (ATTENTION.ENABLE training)
    local_min_offset: int = -12
    local_max_offset: int = 12
    max_gt: int = 64
    min_size: int = 600           # int, or a tuple to draw a scale from
    max_size: int = 1000
    hflip_prob: float = 0.5
    global_size: int = 24       # init frames for the test-time memory
    infer_batch: int = 8
    shuffle_global: bool = True
    transform: bool = False     # INPUT.TRANSFORM (train side)
    pixel_mean: tuple = (123.675, 116.280, 103.530)
    decode_workers: int = 8     # threads decoding frames ahead of the card


def build_train_sample(ds: VIDDataset, idx: int, rng: np.random.RandomState,
                       cfg: SampleConfig):
    """One flagship training sample: images [B,H,W,3] (B = 1 + num_local +
    num_global, each frame with its own GT; the VIDMEGADataset diffusion
    path, vid_mega.py:76-103)."""
    spec = MethodSampleSpec("diffusion", num_global=cfg.num_global, num_local=cfg.num_local,
                            min_offset=cfg.local_min_offset, max_offset=cfg.local_max_offset)
    return build_train_sample_method(ds, idx, rng, cfg, spec)


@dataclass
class MethodSampleSpec:
    """Per-method layout of a train sample's reference frames (the
    reference's per-method dataset wrappers: vid_rdn.py:20-60,
    vid_fgfa.py:18-33, vid_dff.py:18-45, vid_mega.py:40-115).  The image
    stack is ordered [cur, locals…, mems…, globals…]."""

    method: str = "base"          # base|dff|fgfa|rdn|mega|dafa|diffusion
    num_local: int = 0            # refs drawn from [min_offset, max_offset]
    min_offset: int = 0
    max_offset: int = 0
    num_mem: int = 0              # refs centred ALL_FRAME_INTERVAL back
    all_frame_interval: int = 25
    num_global: int = 0           # uniform over the whole video

    @staticmethod
    def from_config(cfg) -> "MethodSampleSpec":
        m = cfg.MODEL.VID.METHOD
        v = cfg.MODEL.VID
        if m == "base":
            return MethodSampleSpec("base")
        if m == "dff":
            return MethodSampleSpec("dff", num_local=1, min_offset=v.DFF.MIN_OFFSET,
                                    max_offset=v.DFF.MAX_OFFSET)
        if m == "fgfa":
            return MethodSampleSpec("fgfa", num_local=v.FGFA.REF_NUM,
                                    min_offset=v.FGFA.MIN_OFFSET, max_offset=v.FGFA.MAX_OFFSET)
        if m == "rdn":
            return MethodSampleSpec("rdn", num_local=v.RDN.REF_NUM,
                                    min_offset=v.RDN.MIN_OFFSET, max_offset=v.RDN.MAX_OFFSET)
        if m in ("mega", "dafa"):
            g = v.MEGA
            # DAFA's train loss reads global refs only, so its local refs
            # are not loaded
            use_local = g.LOCAL.ENABLE and m != "dafa"
            return MethodSampleSpec(
                m, num_local=g.REF_NUM_LOCAL if use_local else 0,
                min_offset=g.MIN_OFFSET, max_offset=g.MAX_OFFSET,
                num_mem=g.REF_NUM_MEM if g.MEMORY.ENABLE else 0,
                all_frame_interval=g.ALL_FRAME_INTERVAL,
                num_global=g.REF_NUM_GLOBAL if g.GLOBAL.ENABLE else 0)
        raise ValueError(f"no train sampling for method {m}")


def build_train_sample_method(ds: VIDDataset, idx: int, rng: np.random.RandomState,
                              cfg: SampleConfig, spec: MethodSampleSpec):
    """A train sample of ``spec``'s layout: images [B,H,W,3] float32 0..255
    padded to the current frame's bucket, and per frame the GT padded to
    ``cfg.max_gt`` slots (labels int32).  The scale, the flip and the bucket
    come from the current frame and hold for every frame of the sample."""
    anno = ds.get_groundtruth(idx)
    min_sizes = cfg.min_size if isinstance(cfg.min_size, (tuple, list)) else (cfg.min_size,)
    min_size = int(min_sizes[rng.randint(len(min_sizes))])
    scale = resize_scale(anno.height, anno.width, min_size, cfg.max_size)
    flip = bool(rng.rand() < cfg.hflip_prob)
    bucket = frame_bucket(anno.height, anno.width, max(min_sizes), cfg.max_size)

    frames: List[np.ndarray] = []
    gts = []
    rh = int(round(anno.height * scale))
    rw = int(round(anno.width * scale))

    def add_frame(img, a: FrameAnno):
        """With INPUT.TRANSFORM the SSD augmentation runs before the resize
        (reference build.py:67-74), on every frame independently; the
        augmented frame is resized to the sample's (rh, rw), which matches
        the reference's per-image resize up to rounding (Expand and the crop
        keep the aspect to 1 px) and keeps one whwh a sample."""
        if cfg.transform:
            img8, b, lab = ssd_augment(np.asarray(img, np.uint8), a.boxes.copy(), a.labels,
                                       rng, cfg.pixel_mean)
            ah, aw = img8.shape[:2]
            b = b * np.asarray([rw / aw, rh / ah, rw / aw, rh / ah], np.float32)
            a = FrameAnno(boxes=b, labels=lab, height=rh, width=rw)
            frames.append(transform_frame_to(img8, (rh, rw), flip, bucket).astype(img.dtype))
            gts.append(pad_groundtruth(a, cfg.max_gt, 1.0, flip))
        else:
            frames.append(transform_frame_to(img, (rh, rw), flip, bucket))
            gts.append(pad_groundtruth(a, cfg.max_gt, scale, flip))

    cur_img = ds.load_image(ds.image_path(idx))

    def add(frame_id: Optional[int]):
        if frame_id is None or not ds.is_video:
            if cfg.transform:      # independent augmentation per copy
                add_frame(cur_img, anno)
            else:
                frames.append(frames[0])
                gts.append(gts[0])
            return
        a = ds.get_groundtruth_for_frame(idx, int(frame_id))
        add_frame(ds.load_image(ds.frame_path(idx, int(frame_id))), a)

    add_frame(cur_img, anno)

    if ds.is_video:
        seg_len = ds.frame_seg_len[idx]
        fid = ds.frame_seg_id[idx]
        span = spec.max_offset - spec.min_offset + 1
        # local refs: offsets drawn without replacement (vid_rdn.py:25-27)
        if spec.num_local:
            offs = rng.choice(span, min(spec.num_local, span),
                              replace=span < spec.num_local) + spec.min_offset
            offs = list(offs) + [0] * (spec.num_local - len(offs))
            for o in offs:
                add(min(max(fid + int(o), 0), seg_len - 1))
        # memory refs: the same offsets around fid - ALL_FRAME_INTERVAL
        # (vid_mega.py:62-73)
        if spec.num_mem:
            center = max(fid - spec.all_frame_interval, 0)
            offs = rng.choice(span, min(spec.num_mem, span),
                              replace=span < spec.num_mem) + spec.min_offset
            offs = list(offs) + [0] * (spec.num_mem - len(offs))
            for o in offs:
                add(min(max(center + int(o), 0), seg_len - 1))
        # global refs: uniform over the video (vid_mega.py:76-86)
        if spec.num_global:
            ids = rng.choice(seg_len, spec.num_global, replace=seg_len < spec.num_global)
            for g in ids:
                add(int(g))
    else:
        for _ in range(spec.num_local + spec.num_mem + spec.num_global):
            add(None)

    return {
        "images": np.stack(frames),
        "gt_boxes": np.stack([g[0] for g in gts]),
        "gt_labels": np.stack([g[1] for g in gts]),
        "gt_valid": np.stack([g[2] for g in gts]),
        "whwh": np.asarray([rw, rh, rw, rh], np.float32),
        "bucket": tuple(frames[0].shape[:2]),
    }


def train_sample_stream(ds: VIDDataset, cfg: SampleConfig, seed: int = 0,
                        shard: int = 0, num_shards: int = 1) -> Iterator[dict]:
    """Endless epoch-shuffled stream of train samples, rank-sharded
    (DistributedSampler + IterationBasedBatchSampler semantics,
    samplers/distributed.py:10-66, iteration_based_batch_sampler.py)."""
    epoch = 0
    while True:
        rng = np.random.RandomState(seed + epoch)
        order = rng.permutation(len(ds))
        for i in order[shard::num_shards]:
            yield build_train_sample(ds, int(i), rng, cfg)
        epoch += 1


class ConcatDataset:
    """Concatenation of frame datasets (the reference's torch ConcatDataset
    over DET_train_30classes + VID_train_15frames, data/build.py), with the
    surface that sampling and grouping read."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = [0]
        for d in self.datasets:
            self.offsets.append(self.offsets[-1] + len(d))

    def __len__(self):
        return self.offsets[-1]

    def _locate(self, idx: int):
        for i in range(len(self.datasets)):
            if idx < self.offsets[i + 1]:
                return self.datasets[i], idx - self.offsets[i]
        raise IndexError(idx)

    @property
    def annos(self):
        return [a for d in self.datasets for a in d.annos]

    def sample(self, idx, rng, cfg, spec: Optional[MethodSampleSpec] = None):
        """The train sample of ``idx``: DiffusionVID's layout, or ``spec``'s."""
        ds, local = self._locate(idx)
        if spec is None:
            return build_train_sample(ds, local, rng, cfg)
        return build_train_sample_method(ds, local, rng, cfg, spec)


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

"""Batch samplers: aspect-ratio grouping and iteration-based epochs.

Port of ``diffusionvid_tpu/data/samplers.py`` (the reference's
``mega_core/data/samplers/``): ``GroupedBatchSampler`` (a batch holds
indices of one aspect-ratio group, here the static padding bucket, so every
batch has one shape), ``IterationBasedBatchSampler`` (endless epoch-seeded
resampling up to an iteration count) and ``DistributedSampler``'s rank
sharding (the ``shard`` / ``num_shards`` arguments).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def aspect_ratio_group_ids(dataset) -> np.ndarray:
    """Group id per frame: 0 = landscape (w >= h), 1 = portrait, the split
    of ``transforms.frame_bucket``."""
    ids = np.zeros(len(dataset), np.int64)
    for i, anno in enumerate(dataset.annos):
        ids[i] = 0 if anno.width >= anno.height else 1
    return ids


def grouped_batches(group_ids: np.ndarray, batch_size: int, *, seed: int = 0,
                    shard: int = 0, num_shards: int = 1,
                    max_iterations: int | None = None) -> Iterator[List[int]]:
    """Endless stream of index batches, each from one aspect-ratio group,
    reshuffled every epoch, rank-sharded; ``max_iterations`` batches at most."""
    epoch = 0
    emitted = 0
    while True:
        rng = np.random.RandomState(seed + epoch)
        order = rng.permutation(len(group_ids))[shard::num_shards]
        buffers: dict = {}
        for idx in order:
            g = int(group_ids[idx])
            buffers.setdefault(g, []).append(int(idx))
            if len(buffers[g]) == batch_size:
                yield buffers.pop(g)
                emitted += 1
                if max_iterations is not None and emitted >= max_iterations:
                    return
        epoch += 1

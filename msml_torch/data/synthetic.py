"""Synthetic batches for smoke runs and throughput measurement.

The port's own numpy copy of `msml_tpu/data/synthetic.py`, drawing the
same numbers from the same seed. The contract is the real pipeline's
(`datasets/load_dataset.py:101-139`): img, msk (1 = clean, 0 = occluded),
ori (the clean image for KD), label. uint8=True gives raw uint8 images,
the `device_light` contract: /255, relight and normalize run in the step.
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(batch_size: int, size: int = 112, channels: int = 3,
                    num_classes: int = 1000, seed: int = 0,
                    uint8: bool = False):
    """-> dict of numpy arrays: img (B, size, size, channels) uint8 or f32,
    msk (B, size, size) int32, ori like img, label (B,) int32."""
    rng = np.random.RandomState(seed)
    if uint8:
        img = rng.randint(0, 256, (batch_size, size, size, channels),
                          dtype=np.uint8)
        ori = rng.randint(0, 256, (batch_size, size, size, channels),
                          dtype=np.uint8)
    else:
        img = rng.randn(batch_size, size, size, channels).astype(np.float32)
        ori = rng.randn(batch_size, size, size, channels).astype(np.float32)
    # reference masks are 255 clean / 0 occluded (rand_occ.py:598-601)
    msk = np.ones((batch_size, size, size), np.int32)
    for i in range(batch_size):
        if rng.rand() < 0.8:  # most samples occluded, like training
            h0, w0 = rng.randint(0, size // 2, 2)
            hh, ww = rng.randint(size // 8, size // 2, 2)
            msk[i, h0:h0 + hh, w0:w0 + ww] = 0
    label = rng.randint(0, num_classes, batch_size).astype(np.int32)
    return {"img": img, "msk": msk, "ori": ori, "label": label}


class SyntheticDataset:
    """Iterable synthetic dataset with a fixed number of steps per epoch
    (`msml_tpu/data/synthetic.py:39-64`): batch i of epoch e on shard s is
    `synthetic_batch` with seed (seed + e * 100003 + i) * num_shards + s."""

    def __init__(self, batch_size: int, steps_per_epoch: int = 100,
                 size: int = 112, channels: int = 3, num_classes: int = 1000,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 uint8: bool = False):
        self.batch_size = batch_size  # per-process batch
        self.steps_per_epoch = steps_per_epoch
        self.size, self.channels = size, channels
        self.num_classes = num_classes
        self.seed = seed
        self.shard_id, self.num_shards = shard_id, num_shards
        self.uint8 = uint8

    def __len__(self):
        return self.steps_per_epoch * self.batch_size * self.num_shards

    def epoch(self, epoch: int):
        for i in range(self.steps_per_epoch):
            yield synthetic_batch(
                self.batch_size, self.size, self.channels, self.num_classes,
                uint8=self.uint8,
                seed=(self.seed + epoch * 100003 + i) * self.num_shards
                + self.shard_id)

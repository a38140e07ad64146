"""A host batch source over numpy tables that are already in memory, beside
the feather-and-JPEG source data/qlearning.py `QLearningBatcher`.

`TableSource` holds the tables that DeviceDataset uploads (see
data/device_dataset.py for their layout) and serves the same batches from
host memory: `get_batch(rows)` with QLearningBatcher.get_batch's contract
and `batches(batch_size)` with its shuffled, drop_last stream. run_train
takes it as its `batcher`. `synthetic_video_tables` makes seeded tables of
a synthetic video: chip_smoke.py's synthetic training phase and the card
tests use them."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .device_dataset import LABEL_KEYS, TABLE_KEYS, check_capacity


class TableSource:
    def __init__(self, tables: Dict[str, np.ndarray], seed: int = 0):
        missing = set(TABLE_KEYS) - set(tables)
        if missing:
            raise ValueError(f"tables lack {sorted(missing)}")
        self._tables = tables
        self.n = len(tables["action"])
        self._rng = np.random.default_rng(seed)

    def tables(self, memory_limit_bytes: Optional[int] = None, data_shards: int = 1,
               sharded: bool = False) -> Dict[str, np.ndarray]:
        frames = self._tables["frames"]
        check_capacity(len(frames), frames.shape[1], memory_limit_bytes, data_shards, sharded)
        return self._tables

    def get_batch(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        t = self._tables
        rows = np.asarray(rows)
        batch = {k: t[k][rows] for k in LABEL_KEYS}
        batch["before"] = t["frames"][t["before_idx"][rows]]  # (B, F, S, S, 3)
        batch["after"] = t["frames"][t["after_idx"][rows]]
        return batch

    def index_stream(self, batch_size: int) -> Iterator[np.ndarray]:
        """Endless shuffled row indices, a fresh permutation per epoch, drop_last."""
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} exceeds dataset size {self.n}")
        while True:
            perm = self._rng.permutation(self.n)
            for i in range(0, self.n - batch_size + 1, batch_size):
                yield perm[i:i + batch_size]

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Endless shuffled batches: get_batch of each index_stream draw."""
        for rows in self.index_stream(batch_size):
            yield self.get_batch(rows)


def synthetic_video_tables(num_frames: int, num_rows: int, image_size: int,
                           seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded tables of one synthetic video of `num_frames` noise frames:
    row i steps from frame i mod (num_frames - 1) to the next frame, takes
    an action in {0, 1, 2} and gets binary rewards for the 5 classes at
    about 10%; terminal is the reward (as QLearningBatcher sets it), gt is
    NaN (no VALUE_LEARNING) and every row is valid."""
    rng = np.random.default_rng(seed)
    num_classes = 5
    before = (np.arange(num_rows) % (num_frames - 1)).astype(np.int32)[:, None]
    reward = (rng.random((num_rows, num_classes)) < 0.1).astype(np.float32)
    return {
        "frames": rng.integers(0, 256, (num_frames, image_size, image_size, 3), np.uint8),
        "before_idx": before,
        "after_idx": before + 1,
        "action": rng.integers(0, 3, num_rows).astype(np.int32),
        "reward": reward,
        "terminal": reward.copy(),
        "gt": np.full((num_rows, num_classes), np.nan, np.float32),
        "valid_mask": np.ones((num_rows, num_classes), np.float32),
    }

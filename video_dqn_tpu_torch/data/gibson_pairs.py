"""Simulator trajectory pairs, the inverse model's training data
(counterpart of video_dqn_tpu/data/gibson_pairs.py:28-116 `split_columns`,
`GibsonPairBatcher`).

The constructor's arguments and semantics are the JAX package's: object
npy rows of 22 columns [before_loc(1), before_pos(3), before_ang(4),
after_loc(1), after_pos(3), after_ang(4), action(1), min_dists(5)];
per-class selection when class_label != 'all'; `known` keeps the rows
within reward_dist of the class; labels action - 1, reward = dist <=
reward_dist, terminal = reward, gt = gamma^dist. A state is the image
`<image_root>/<loc>/0.jpg` (or 0..3.jpg in panorama mode), decoded by the
port's JPEG stage (data/jpeg.py); `cache_images` keeps the decoded states
in RAM. The index streams (`get_batch` without indices, `batches`' epoch
permutations) come from np.random.default_rng(seed), so they are the JAX
batcher's. A batch decodes each distinct state not in the cache once, in
one call.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from .jpeg import load_images

VALID_LABELS = sorted(["bed", "chair", "couch", "dining table", "toilet"])


def split_columns(arr: np.ndarray, widths):
    if arr.shape[-1] != sum(widths):
        raise ValueError(f"widths {sum(widths)} != {arr.shape}")
    out, st = [], 0
    for w in widths:
        out.append(arr[..., st: st + w])
        st += w
    return tuple(out)


class GibsonPairBatcher:
    def __init__(
        self,
        file_location: str,
        gamma: float = 0.9,
        panorama: bool = False,
        known: bool = False,
        reward_dist: float = 1.0,
        class_label: str = "toilet",
        image_root: str = "",
        image_size: int = 224,
        seed: int = 0,
        cache_images: bool = False,
    ):
        self.panorama = panorama
        self.image_root = image_root
        self.image_size = image_size
        self.num_frames = 4 if panorama else 1
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache_images else None

        samples = np.load(file_location, allow_pickle=True)
        (bel, _bpos, _bang, ael, _apos, _aang, action, min_dists) = split_columns(
            samples, [1, 3, 4, 1, 3, 4, 1, len(VALID_LABELS)]
        )
        dists = min_dists.astype(np.float64)
        if class_label != "all":
            dists = dists[:, [VALID_LABELS.index(class_label)]]
        if known and class_label != "all":
            keep = dists[:, 0] <= reward_dist
            bel, ael, action, dists = bel[keep], ael[keep], action[keep], dists[keep]

        self.before_loc = bel[:, 0]
        self.after_loc = ael[:, 0]
        # the reference stores actions 1..3; labels are action - 1
        self.action = action[:, 0].astype(np.int32) - 1
        self.reward = (dists <= reward_dist).astype(np.float32)
        self.terminal = self.reward.copy()
        self.gt = np.power(gamma, dists).astype(np.float32)
        self.n = len(self.before_loc)

    def __len__(self) -> int:
        return self.n

    def _paths(self, loc) -> List[str]:
        base = os.path.join(self.image_root, str(loc))
        return [os.path.join(base, f"{o}.jpg") for o in range(self.num_frames)]

    def _states(self, locs: List) -> np.ndarray:
        """(len(locs), F, S, S, 3) uint8: one decode call for every distinct
        state not in the cache."""
        s, f = self.image_size, self.num_frames
        missing = [loc for loc in dict.fromkeys(locs)
                   if self._cache is None or loc not in self._cache]
        frames = load_images([p for loc in missing for p in self._paths(loc)], s)
        decoded = dict(zip(missing, frames.reshape(len(missing), f, s, s, 3)))
        if self._cache is not None:
            self._cache.update(decoded)
            decoded = self._cache
        return np.stack([decoded[loc] for loc in locs])

    def get_batch(self, indices: Optional[np.ndarray] = None,
                  batch_size: int = 128) -> Dict[str, np.ndarray]:
        if indices is None:
            indices = self._rng.integers(0, self.n, batch_size)
        b = len(indices)
        states = self._states([*self.before_loc[indices], *self.after_loc[indices]])
        return {
            "before": states[:b],
            "after": states[b:],
            "action": self.action[indices],
            "reward": self.reward[indices],
            "terminal": self.terminal[indices],
            "gt": self.gt[indices],
        }

    def index_stream(self, batch_size: int, epochs: Optional[int] = None
                     ) -> Iterator[np.ndarray]:
        """Shuffled row indices, a fresh permutation per epoch, drop_last."""
        epoch = 0
        while epochs is None or epoch < epochs:
            perm = self._rng.permutation(self.n)
            for i in range(0, self.n - batch_size + 1, batch_size):
                yield perm[i: i + batch_size]
            epoch += 1

    def batches(self, batch_size: int, epochs: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        for rows in self.index_stream(batch_size, epochs):
            yield self.get_batch(rows)

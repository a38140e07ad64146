"""Q-learning batch source over a quadruplet feather (counterpart of
video_dqn_tpu/data/qlearning.py:76-243 `QLearningBatcher`, with the
device tables of video_dqn_tpu/data/device_dataset.py:81-146).

The constructor's arguments and semantics are the JAX package's:
  * the label math, once at load: binary (detector score above the class
    threshold) or confidence reward; terminal equal to the reward, as the
    reference returns it in both modes; VALUE_LEARNING's gt = gamma^steps
    with NaN where the reward is never reached, else NaN; the
    inverse-action labels or the one-action zeros;
  * PREVIOUS_IMAGES stacks of 4 frames, ids counting down from the row's
    frame and clamped at im_start;
  * the optional RAM cache of decoded frames: `cache_bytes` caps it, and
    once full it stops inserting and never evicts;
  * `index_stream`/`batches`: a shuffled, drop_last row stream from
    np.random.default_rng(seed), the same permutations as the JAX batcher
    draws for the same seed.
The feather is read by data/feather.py and the frames are decoded by
data/jpeg.py (the port's JPEG stage), one call per batch for every frame
not in the cache, each distinct path once.

`tables()` gives the device dataset its tables (data/device_dataset.py):
every unique frame once, decoded in chunks of 512, and each row's before
and after stacks as indices into them, after a capacity check that runs
before the decode.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional

import numpy as np

from .device_dataset import check_capacity
from .feather import read_feather
from .jpeg import load_images
from .schema import DETECTION_THRESHOLDS, arrays_from_frame, validate_schema

DECODE_CHUNK = 512


class QLearningBatcher:
    """Random-batch source over a quadruplet feather."""

    def __init__(
        self,
        location: str,
        one_action: bool = False,
        value_learning: bool = False,
        inverse_actions: bool = False,
        previous_images: bool = False,
        confidence_reward: bool = False,
        gamma: float = 0.99,
        image_size: int = 224,
        seed: int = 0,
        cache_images: bool = False,
        cache_bytes: Optional[int] = None,
    ):
        raw = read_feather(location)
        validate_schema(raw)
        self.cols = arrays_from_frame(raw)
        self.n = len(self.cols["before_image"])
        self.image_size = image_size
        self.previous_images = previous_images
        self.num_frames = 4 if previous_images else 1
        self._rng = np.random.default_rng(seed)
        # RAM cache of decoded frames: cache_bytes caps it and a full cache
        # stops inserting (under uniform sampling the hit rate is the
        # cached share either way, with no eviction work); cache_images
        # alone means unbounded
        if cache_bytes is not None and cache_bytes > 0:
            self._image_cache: Optional[Dict[str, np.ndarray]] = {}
            self._cache_budget: Optional[int] = int(cache_bytes)
        else:
            self._image_cache = {} if cache_images else None
            self._cache_budget = None
        self._cache_used = 0

        scores = self.cols["detector_score"]  # (N, 5)
        if confidence_reward:
            self.reward = scores.astype(np.float32)
        else:
            self.reward = (scores > DETECTION_THRESHOLDS).astype(np.float32)
        # the reference returns the reward in the terminal slot in both
        # modes (its computed terminal is discarded), so in confidence mode
        # Q_a is attenuated by (1 - confidence)
        self.terminal = self.reward
        self.valid_mask = np.ones_like(self.reward)

        steps = self.cols["steps_to_reward"]
        if value_learning:
            with np.errstate(invalid="ignore"):
                gt = np.power(gamma, steps, dtype=np.float32)
            gt[np.isinf(steps)] = np.nan
            self.gt = gt
        else:
            self.gt = np.full_like(self.reward, np.nan)

        if inverse_actions:
            if "inverse_actions" not in self.cols:
                raise ValueError("feather has no inverse_actions column")
            self.action = self.cols["inverse_actions"].astype(np.int32)
        elif one_action:
            self.action = np.zeros(self.n, np.int32)
        else:
            raise NotImplementedError("need one_action or inverse_actions")

    def __len__(self) -> int:
        return self.n

    def reward_percentage(self) -> float:
        """Fraction of rows with a reward for any class."""
        return float((self.cols["sparse_reward"].max(axis=1) > 0).mean())

    # -- frames ------------------------------------------------------------
    def _history_paths(self, path: str, start: int) -> List[str]:
        m = re.match(r"(.*?)(\d+)\.jpg$", path)
        prefix, im_id, width = m.group(1), int(m.group(2)), len(m.group(2))
        return [f"{prefix}{max(im_id - i, start):0{width}d}.jpg"
                for i in range(self.num_frames)]

    def _stack_paths(self, path: str, start: int) -> List[str]:
        return self._history_paths(path, start) if self.previous_images else [path]

    def _images(self, paths: List[str]) -> np.ndarray:
        """(len(paths), S, S, 3) uint8: one decode call for every distinct
        path not in the RAM cache."""
        if self._image_cache is None:
            uniq = list(dict.fromkeys(paths))
            if len(uniq) == len(paths):
                return load_images(paths, self.image_size)
            decoded = dict(zip(uniq, load_images(uniq, self.image_size)))
            return np.stack([decoded[p] for p in paths])
        cache = self._image_cache
        missing = [p for p in dict.fromkeys(paths) if p not in cache]
        decoded = dict(zip(missing, load_images(missing, self.image_size)))
        for p, img in decoded.items():
            if self._cache_budget is not None and \
                    self._cache_used + img.nbytes > self._cache_budget:
                continue  # full: stop inserting, never evict
            cache[p] = img
            self._cache_used += img.nbytes
        return np.stack([cache[p] if p in cache else decoded[p] for p in paths])

    def get_batch(self, indices: Optional[np.ndarray] = None,
                  batch_size: int = 16) -> Dict[str, np.ndarray]:
        """The rows `indices` (random ones if None): before/after (B, F, S,
        S, 3) uint8, action (B,) int32, reward, terminal, gt, valid_mask
        (B, 5) float32."""
        if indices is None:
            indices = self._rng.integers(0, self.n, batch_size)
        paths = [p for col in ("before_image", "after_image") for i in indices
                 for p in self._stack_paths(self.cols[col][i], self.cols["im_start"][i])]
        b, f, s = len(indices), self.num_frames, self.image_size
        imgs = self._images(paths).reshape(2, b, f, s, s, 3)
        return {
            "before": imgs[0],
            "after": imgs[1],
            "action": self.action[indices],
            "reward": self.reward[indices],
            "terminal": self.terminal[indices],
            "gt": self.gt[indices],
            "valid_mask": self.valid_mask[indices],
        }

    def index_stream(self, batch_size: int) -> Iterator[np.ndarray]:
        """Endless shuffled row indices: a fresh permutation per epoch,
        drop_last."""
        if batch_size > self.n:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {self.n}; "
                f"drop_last semantics would yield no batches")
        while True:
            perm = self._rng.permutation(self.n)
            for i in range(0, self.n - batch_size + 1, batch_size):
                yield perm[i:i + batch_size]

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        for rows in self.index_stream(batch_size):
            yield self.get_batch(rows)

    def tables(self, memory_limit_bytes: Optional[int] = None, data_shards: int = 1,
               sharded: bool = False) -> Dict[str, np.ndarray]:
        """The device dataset's tables: each unique frame once (the paths of
        every row's before and after stacks, in first-seen order), the
        rows' stacks as indices into them, and the labels. The capacity
        check against `memory_limit_bytes` a device (check_capacity: the
        table `sharded` over `data_shards` devices or not) runs before the
        decode."""
        uniq: Dict[str, int] = {}
        stacks = {}
        for col in ("before_image", "after_image"):
            idx = np.empty((self.n, self.num_frames), np.int32)
            for i in range(self.n):
                for f, p in enumerate(self._stack_paths(self.cols[col][i],
                                                        self.cols["im_start"][i])):
                    idx[i, f] = uniq.setdefault(p, len(uniq))
            stacks[col] = idx
        check_capacity(len(uniq), self.image_size, memory_limit_bytes, data_shards, sharded)
        paths = list(uniq)
        frames = np.empty((len(paths), self.image_size, self.image_size, 3), np.uint8)
        for i in range(0, len(paths), DECODE_CHUNK):
            frames[i:i + DECODE_CHUNK] = load_images(paths[i:i + DECODE_CHUNK], self.image_size)
        return {"frames": frames, "before_idx": stacks["before_image"],
                "after_idx": stacks["after_image"], "action": self.action,
                "reward": self.reward, "terminal": self.terminal, "gt": self.gt,
                "valid_mask": self.valid_mask}

"""Whole-video reward labelling (counterpart of video_dqn_tpu/ops/scans.py
`steps_to_reward`, `steps_to_reward_negative` and `label_video_host`).

Host data prep, so numpy: prefix and suffix cumulative extrema over the
frame axis, O(N) per class, in float32 as the JAX scans compute them.

  * steps_to_reward(r)[i]     = distance to the nearest rewarded index >= i
                                (inclusive), +inf if none ahead;
  * steps_to_reward_neg(r)[i] = signed offset to the nearest rewarded index
                                in either direction; a tie goes to the
                                earlier index (the negative offset); all
                                +inf when the video has no reward.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _nearest(rewards: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx, next hit at or after i, previous hit at or before i) over axis
    0 of an (N,) or (N, C) reward array, float32 (+-inf where none)."""
    hit = np.asarray(rewards).astype(bool)
    idx = np.arange(hit.shape[0], dtype=np.float32).reshape((-1,) + (1,) * (hit.ndim - 1))
    nxt = np.minimum.accumulate(np.where(hit, idx, np.float32(np.inf))[::-1], axis=0)[::-1]
    prv = np.maximum.accumulate(np.where(hit, idx, np.float32(-np.inf)), axis=0)
    return idx, nxt, prv


def steps_to_reward(rewards: np.ndarray) -> np.ndarray:
    """rewards: (N,) or (N, C) bool/int -> float32 distances (inf when none)."""
    idx, nxt, _ = _nearest(rewards)
    return nxt - idx


def steps_to_reward_negative(rewards: np.ndarray) -> np.ndarray:
    """Signed nearest-hit offsets with the earlier index winning a tie."""
    idx, nxt, prv = _nearest(rewards)
    d_fwd, d_bwd = nxt - idx, prv - idx
    out = np.where(np.abs(d_bwd) <= np.abs(d_fwd), d_bwd, d_fwd)
    any_hit = np.asarray(rewards).astype(bool).any(axis=0)
    return np.where(any_hit, out, np.float32(np.inf)).astype(np.float32)


def label_video_host(rewards) -> Tuple[np.ndarray, np.ndarray]:
    """Both scans of one video's (N, C) reward matrix, per class:
    (steps_to_reward, steps_to_reward_neg) as float32 (N, C) arrays."""
    r = np.asarray(rewards)
    return steps_to_reward(r), steps_to_reward_negative(r)

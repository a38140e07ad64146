"""Synthetic dataset fixtures (counterpart of
video_dqn_tpu/data/synthetic.py): a tree of noise JPEG frames and a
quadruplet feather with the reference schema, and a batch in memory.

`make_synthetic_dataset` writes the JAX package's tree byte for byte from
the same seed: the same draws in the same order, each frame through
data/jpeg.py `save_images` (PIL's default quality, 75, byte-equal to
PIL's file), the rows and labels through data/schema.py and
ops/scans.py, and the feather through data/feather.py `write_feather`
(pandas reads the same columns back). It needs neither PIL nor pandas.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..ops.scans import label_video_host
from .feather import write_feather
from .jpeg import save_images
from .schema import DETECTION_THRESHOLDS, multi_add

PIL_QUALITY = 75  # PIL's Image.save default, which the JAX package writes with


def make_synthetic_dataset(root: str, num_videos: int = 2, frames_per_video: int = 24,
                           image_size: int = 96, num_classes: int = 5, seed: int = 0,
                           stride: int = 3) -> str:
    """Write frames/<vid>/%04d.jpg and data.feather under `root`; returns
    the feather's path. Rows pair frame i with frame i + stride of each
    video; the detector scores are noise below 0.6 with spikes of 0.98."""
    rng = np.random.default_rng(seed)
    rows, all_scores, all_actions = [], [], []
    for v in range(num_videos):
        vid = f"vid{v:03d}"
        fdir = os.path.join(root, "frames", vid)
        os.makedirs(fdir, exist_ok=True)
        frames = [rng.integers(0, 256, (image_size, image_size, 3), np.uint8)
                  for _ in range(frames_per_video)]
        save_images([os.path.join(fdir, f"{i:04d}.jpg") for i in range(1, frames_per_video + 1)],
                    np.stack(frames), quality=PIL_QUALITY)
        scores = rng.random((frames_per_video, num_classes)) * 0.6
        spikes = rng.random((frames_per_video, num_classes)) < 0.1
        scores[spikes] = 0.98
        start, stop = 1, frames_per_video + 1
        for i in range(start, stop - stride):
            rows.append((os.path.join(fdir, f"{i:04d}.jpg"),
                         os.path.join(fdir, f"{i + stride:04d}.jpg"), vid, start, stop))
            all_scores.append(scores[i + stride - 1])
            all_actions.append(rng.integers(0, 3))

    names = ("before_image", "after_image", "ep_id", "im_start", "im_stop")
    cols: Dict[str, np.ndarray] = {
        name: np.array([r[k] for r in rows], object if k < 3 else np.int64)
        for k, name in enumerate(names)}
    ds = np.stack(all_scores)
    multi_add(cols, ds, "detector_score")
    sparse = (ds > DETECTION_THRESHOLDS).astype(np.int64)
    multi_add(cols, sparse, "sparse_reward")
    fwd, neg = label_video_host(sparse)
    multi_add(cols, fwd, "steps_to_reward")
    multi_add(cols, neg, "steps_to_reward_neg")
    cols["inverse_actions"] = np.array(all_actions, np.int64)
    path = os.path.join(root, "data.feather")
    write_feather(cols, path)
    return path


def synthetic_batch(batch_size: int = 16, num_frames: int = 1, image_size: int = 224,
                    num_classes: int = 5, seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch in memory with QLearningBatcher.get_batch's keys, as the
    JAX package draws it from `seed`."""
    rng = np.random.default_rng(seed)
    shape = (batch_size, num_frames, image_size, image_size, 3)
    return {
        "before": rng.integers(0, 256, shape, dtype=np.uint8),
        "after": rng.integers(0, 256, shape, dtype=np.uint8),
        "action": rng.integers(0, 3, batch_size).astype(np.int32),
        "reward": (rng.random((batch_size, num_classes)) < 0.1).astype(np.float32),
        "terminal": (rng.random((batch_size, num_classes)) < 0.1).astype(np.float32),
        "gt": rng.random((batch_size, num_classes)).astype(np.float32),
        "valid_mask": np.ones((batch_size, num_classes), np.float32),
    }

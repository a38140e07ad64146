"""The Q-learning quadruplet feather's schema (counterpart of
video_dqn_tpu/data/schema.py:22-87, over {column name: numpy array} as
data/feather.py reads and writes it in place of a pandas DataFrame).

Columns: before_image, after_image, ep_id, im_start, im_stop,
detector_score0..4, sparse_reward0..4, steps_to_reward0..4,
steps_to_reward_neg0..4 and, optionally, inverse_actions.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from .feather import write_feather  # noqa: F401  (the JAX schema module's writer)

# Per-class detector-confidence thresholds of the 5 sorted COCO classes
# ['bed', 'chair', 'couch', 'dining table', 'toilet']: the reward contract
DETECTION_THRESHOLDS = np.array(
    [
        0.9700177907943726,
        0.9738382697105408,
        0.9512060284614563,
        0.7334915995597839,
        0.7058018445968628,
    ],
    dtype=np.float64,
)

CLASS_LABELS = ["bed", "chair", "couch", "dining table", "toilet"]

WIDE_COLUMNS = ("detector_score", "sparse_reward", "steps_to_reward", "steps_to_reward_neg")


def multi_add(cols: Dict[str, np.ndarray], arr: np.ndarray, name: str) -> None:
    """Spread an (N, C) array into columns name0..name{C-1}, in place."""
    for c in range(arr.shape[1]):
        cols[f"{name}{c}"] = arr[:, c]


def multi_get(cols: Dict[str, np.ndarray], name: str) -> np.ndarray:
    """Gather columns name0..name{C-1} into an (N, C) array."""
    n = len([c for c in cols if re.fullmatch(f"{re.escape(name)}\\d+", c)])
    return np.stack([cols[f"{name}{c}"] for c in range(n)], axis=1)


def validate_schema(cols: Dict[str, np.ndarray], num_classes: int = 5) -> None:
    required = ["before_image", "after_image", "ep_id", "im_start", "im_stop"]
    for name in WIDE_COLUMNS:
        required += [f"{name}{c}" for c in range(num_classes)]
    missing = [c for c in required if c not in cols]
    if missing:
        raise ValueError(f"feather missing columns: {missing}")


def arrays_from_frame(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batcher's columnar arrays, in the JAX package's dtypes: float32
    wide columns, int64 im_start and im_stop, int32 inverse_actions."""
    out = {
        "before_image": cols["before_image"],
        "after_image": cols["after_image"],
        "im_start": cols["im_start"].astype(np.int64),
        "im_stop": cols["im_stop"].astype(np.int64),
        **{name: multi_get(cols, name).astype(np.float32) for name in WIDE_COLUMNS},
    }
    if "inverse_actions" in cols:
        out["inverse_actions"] = cols["inverse_actions"].astype(np.int32)
    return out

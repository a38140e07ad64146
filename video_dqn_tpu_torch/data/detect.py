"""Detections as the dataset reads them (counterpart of
video_dqn_tpu/data/detect.py `score_vals`; the detector itself is a later
slice, ROADMAP.md queue 1 item 7).

A frame's detections are a (5, 2) object array: per target class
['bed', 'chair', 'couch', 'dining table', 'toilet'], its boxes (N, 4) and
scores (N,), or None and None when the class was not detected.
"""

from __future__ import annotations

import numpy as np


def score_vals(class_array: np.ndarray) -> np.ndarray:
    """(5, 2) class array -> (5,) float64 best score per class, 0 when none."""
    out = np.zeros(len(class_array), np.float64)
    for i, s in enumerate(class_array[:, 1]):
        if s is not None and len(s):
            out[i] = float(np.max(s))
    return out

"""Binary morphology with the disk(1) structuring element (the 3x3 plus),
in numpy on the host (counterpart of the numpy forms in
video_dqn_tpu/ops/morphology.py, `binary_dilation_disk1_np`,
`binary_erosion_disk1_np`, `open_n_np`: the only forms the mapper uses).
Out-of-border neighbours count as False."""

from __future__ import annotations

import numpy as np


def binary_dilation_disk1_np(mask: np.ndarray) -> np.ndarray:
    """True wherever the plus-neighbourhood holds a True."""
    m = np.asarray(mask, bool)
    out = m.copy()
    out[1:, :] |= m[:-1, :]
    out[:-1, :] |= m[1:, :]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return out


def binary_erosion_disk1_np(mask: np.ndarray) -> np.ndarray:
    """True only where the whole plus-neighbourhood is True."""
    m = np.asarray(mask, bool)
    out = m.copy()
    out[1:, :] &= m[:-1, :]
    out[0, :] = False
    out[:-1, :] &= m[1:, :]
    out[-1, :] = False
    out[:, 1:] &= m[:, :-1]
    out[:, 0] = False
    out[:, :-1] &= m[:, 1:]
    out[:, -1] = False
    return out


def open_n_np(mask: np.ndarray, n: int) -> np.ndarray:
    """n erosions then n dilations: the mapper's close_small_openings step."""
    m = np.asarray(mask, bool)
    for _ in range(n):
        m = binary_erosion_disk1_np(m)
    for _ in range(n):
        m = binary_dilation_disk1_np(m)
    return m

"""Binary morphology with the disk(1) structuring element (the 3x3 plus)
(counterpart of video_dqn_tpu/ops/morphology.py): numpy forms on the host,
`binary_dilation_disk1_np`, `binary_erosion_disk1_np` and `open_n_np`
(the ones the mapper uses), and torch forms of a tensor on any device,
`binary_dilation_disk1`, `binary_erosion_disk1` and `open_n` (the JAX
package's jitted forms), which give the numpy forms' result bit for bit.
Out-of-border neighbours count as False."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _plus_neighbours(m: torch.Tensor) -> torch.Tensor:
    """(5, H, W): the mask and its N, S, W, E neighbours, False beyond
    the border."""
    p = F.pad(m[None, None].to(torch.uint8), (1, 1, 1, 1))[0, 0]
    return torch.stack([m.to(torch.uint8), p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2],
                        p[1:-1, 2:]])


def binary_dilation_disk1(mask: torch.Tensor) -> torch.Tensor:
    """True wherever the plus-neighbourhood holds a True (bool, on the
    mask's device)."""
    return _plus_neighbours(mask).amax(dim=0) > 0


def binary_erosion_disk1(mask: torch.Tensor) -> torch.Tensor:
    """True only where the whole plus-neighbourhood is True."""
    return _plus_neighbours(mask).amin(dim=0) > 0


def open_n(mask: torch.Tensor, n: int) -> torch.Tensor:
    """n erosions then n dilations: the mapper's close_small_openings step."""
    m = mask.bool()
    for _ in range(n):
        m = binary_erosion_disk1(m)
    for _ in range(n):
        m = binary_dilation_disk1(m)
    return m


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

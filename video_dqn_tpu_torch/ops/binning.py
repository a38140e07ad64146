"""Point-cloud -> occupancy-count binning on the device (counterpart of
video_dqn_tpu/ops/binning.py).

xy rounds to cells (half to even, as jnp.round), z digitizes into
len(z_bins) + 1 buckets (searchsorted on the right of nan_to_num(z)), and
each valid point adds one to its (y, x, z-bucket) cell; NaN and out-of-map
points are dropped and batched inputs are summed. The counts accumulate as
int32 through `index_add_` (integers, so the order of the card's atomics
cannot change them) and become float32 once at the end. The JAX package
leaves this to XLA's scatter, not to a Pallas kernel, so plain torch is its
port.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .geometry import CameraMatrix, get_point_cloud_from_z, make_geocentric, transform_to_frame


def bin_points(xyz_cm: torch.Tensor, map_size: int, z_bins: Sequence[float],
               xy_resolution: float) -> torch.Tensor:
    """xyz_cm: float32 (..., H, W, 3) -> counts float32 (map_size,
    map_size, len(z_bins) + 1) on the same device, summed over every
    leading dimension."""
    device = xyz_cm.device
    bins = torch.tensor(list(z_bins), dtype=torch.float32, device=device)
    n_z = bins.shape[0] + 1
    pts = xyz_cm.reshape(-1, 3)
    isnotnan = ~torch.isnan(pts[:, 0])
    xb = torch.round(pts[:, 0] / xy_resolution).to(torch.int32)
    yb = torch.round(pts[:, 1] / xy_resolution).to(torch.int32)
    zb = torch.searchsorted(bins, torch.nan_to_num(pts[:, 2]).contiguous(),
                            right=True).to(torch.int32)
    valid = (xb >= 0) & (xb < map_size) & (yb >= 0) & (yb < map_size) & isnotnan
    flat = torch.where(valid, (yb * map_size + xb) * n_z + zb, 0)
    counts = torch.zeros(map_size * map_size * n_z, dtype=torch.int32, device=device)
    counts.index_add_(0, flat, valid.to(torch.int32))
    return counts.to(torch.float32).reshape(map_size, map_size, n_z)


def observations_to_map_delta(
    depths_cm: torch.Tensor,   # (V, H, W) depth in cm, NaN-invalidated
    locs: torch.Tensor,        # (V, 3) map poses (x_cm, y_cm, theta), any device
    camera: CameraMatrix,
    map_size: int,
    sensor_height: float,
    z_bins: Sequence[float],
    xy_resolution: float = 5.0,
    elevation_deg: float = 0.0,
) -> torch.Tensor:
    """A whole panorama's map delta in one call on the depths' device:
    unproject V depth views, rectify, place each at its pose, bin, sum.
    The poses' rotations are made where `locs` lies (the host, for the
    mapper)."""
    xyz = get_point_cloud_from_z(depths_cm, camera)
    xyz = make_geocentric(xyz, sensor_height, elevation_deg)
    xyz = transform_to_frame(xyz, locs)
    return bin_points(xyz, map_size, z_bins, xy_resolution)

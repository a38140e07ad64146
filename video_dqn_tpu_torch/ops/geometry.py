"""Depth-camera geometry on tensors (counterpart of
video_dqn_tpu/ops/geometry.py).

Pinhole camera matrix, depth -> point cloud (X right, Y into the image, Z
up), rectification by camera elevation plus sensor height, Rodrigues
rotations and the placement of a cloud at a map pose, in float32. The
points stay on their device. The 3x3 rotations are made on the device of
their angles, the host for a pose given on the CPU (some 40 scalar
operations each: one launch apiece on the card would cost more than the
points' own work), and are applied to the points as explicit
per-component float32 sums, never a matmul, so that no TF32 setting of
the card can move a point across a map cell's edge.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class CameraMatrix(NamedTuple):
    xc: float
    zc: float
    f: float


def get_camera_matrix(width: int, height: int, fov_deg: float) -> CameraMatrix:
    xc = (width - 1.0) / 2.0
    zc = (height - 1.0) / 2.0
    f = (width / 2.0) / np.tan(np.deg2rad(fov_deg / 2.0))
    return CameraMatrix(xc=float(xc), zc=float(zc), f=float(f))


def get_point_cloud_from_z(depth: torch.Tensor, cm: CameraMatrix) -> torch.Tensor:
    """depth: float32 (..., H, W) -> (..., H, W, 3); X right, Y forward
    (into the image), Z up. Row 0 of the image is the TOP (z counts
    down)."""
    h, w = depth.shape[-2], depth.shape[-1]
    x = torch.arange(w, dtype=torch.float32, device=depth.device).expand(h, w)
    z = ((h - 1) - torch.arange(h, dtype=torch.float32, device=depth.device))[:, None].expand(h, w)
    X = (x - cm.xc) * depth / cm.f
    Z = (z - cm.zc) * depth / cm.f
    return torch.stack([X, depth, Z], dim=-1)


def _matmul3(a, b):
    """a @ b for 3x3 nested lists of float32 tensors, summed k = 0, 1, 2."""
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def rodrigues(axis, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about `axis` (3 numbers) by `angle` (float32
    tensor of radians, any shape (...)) -> (..., 3, 3) float32:
    I + sin(angle) s_hat + (1 - cos(angle)) s_hat @ s_hat, in float32 as the
    JAX package computes it (no epsilon branch at angle 0)."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    ax = np.asarray(axis, np.float32)
    ax = ax / np.float32(np.linalg.norm(ax))
    zero = torch.zeros((), dtype=torch.float32, device=angle.device)
    a = [torch.tensor(float(v), dtype=torch.float32, device=angle.device) for v in ax]
    s_hat = [[zero, -a[2], a[1]], [a[2], zero, -a[0]], [-a[1], a[0], zero]]
    ss = _matmul3(s_hat, s_hat)
    sin, one_minus_cos = torch.sin(angle), 1.0 - torch.cos(angle)
    rows = [torch.stack([(1.0 if i == j else 0.0) + sin * s_hat[i][j] + one_minus_cos * ss[i][j]
                         for j in range(3)], dim=-1) for i in range(3)]
    return torch.stack(rows, dim=-2)


def _rotate(xyz: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """xyz @ r.T as per-component float32 sums; r: (3, 3) or (..., 3, 3)
    broadcast against xyz's leading dimensions."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack([x * r[..., i, 0] + y * r[..., i, 1] + z * r[..., i, 2]
                        for i in range(3)], dim=-1)


def make_geocentric(xyz: torch.Tensor, sensor_height: float,
                    camera_elevation_deg: float) -> torch.Tensor:
    """Rectify camera elevation and add sensor height (float32) to Z.
    xyz: (..., 3)."""
    angle = torch.tensor(camera_elevation_deg, dtype=torch.float32)
    r = rodrigues([1.0, 0.0, 0.0], torch.deg2rad(angle)).to(xyz.device)
    out = _rotate(xyz, r)
    out[..., 2] += float(np.float32(sensor_height))
    return out


def transform_to_frame(xyz: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Place an egocentric point cloud at map pose loc = (x, y, theta),
    float32 (..., 3) on any device, with one pose per cloud of xyz (..., H,
    W, 3): rotate about +z by (theta - pi/2) — the camera looks along +y,
    the map heading 0 is +x — then translate by (x, y)."""
    r = rodrigues([0.0, 0.0, 1.0], loc[..., 2] - math.pi / 2.0)  # (..., 3, 3)
    r, loc = r.to(xyz.device), loc.to(xyz.device)
    out = _rotate(xyz, r[..., None, None, :, :])
    out[..., 0] += loc[..., 0, None, None]
    out[..., 1] += loc[..., 1, None, None]
    return out

"""The fake env's C++ renderer (counterpart of
video_dqn_tpu/sim/native_render.py `render_views`): csrc/host/raycast.cc
in the port's host library, built at first use by _build.py. A failed
build or load raises; the env's Python renderer runs only when the
caller asks for it (FakeNavEnv(use_native=False))."""

from __future__ import annotations

import numpy as np

from .. import _build


def render_views(
    grid: np.ndarray,      # (gh, gw) bool/uint8, True = wall
    cell: float,
    poses: np.ndarray,     # (V, 3): x, z, theta
    size: int,
    cam,                   # CameraMatrix
    wall_height: float,
    camera_height: float,
    max_depth: float,
):
    """Returns (depth (V, size, size) float32, rgb (V, size, size, 3) uint8)."""
    lib = _build.load_host()
    g = np.ascontiguousarray(grid.astype(np.uint8))
    p = np.ascontiguousarray(np.asarray(poses, np.float64))
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"poses must be (V, 3), got {p.shape}")
    v = p.shape[0]
    depth = np.empty((v, size, size), np.float32)
    rgb = np.empty((v, size, size, 3), np.uint8)
    lib.vdqn_render_views(
        g.ctypes.data, g.shape[0], g.shape[1], float(cell), p.ctypes.data, v,
        int(size), float(cam.xc), float(cam.zc), float(cam.f),
        float(wall_height), float(camera_height), float(max_depth),
        depth.ctypes.data, rgb.ctypes.data,
    )
    return depth, rgb

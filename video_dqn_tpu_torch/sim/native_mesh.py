"""The mesh simulator's raycaster in the port's host library (counterpart of
video_dqn_tpu/sim/native_mesh.py `NativeMesh`): csrc/host/mesh.cc, a BVH
over the scene's triangles, built at first use by _build.py into
libvdqn_host.so. A failed build or load raises: there is no fallback. The
brute-force numpy twin (sim/mesh_twin.py) runs only when the caller asks
for it (MeshNavEnv(use_native=False))."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import _build


class NativeMesh:
    """BVH-backed triangle mesh; every query is one batched C call."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 colors: Optional[np.ndarray] = None):
        self._lib = _build.load_host()
        self._v = np.ascontiguousarray(vertices, np.float32)
        self._f = np.ascontiguousarray(faces, np.int32)
        self._c = (np.ascontiguousarray(colors, np.uint8)
                   if colors is not None else None)
        if self._v.ndim != 2 or self._v.shape[1] != 3 or self._f.ndim != 2 \
                or self._f.shape[1] != 3:
            raise ValueError(f"vertices and faces must be (N, 3) and (M, 3), got "
                             f"{self._v.shape} and {self._f.shape}")
        if self._c is not None and self._c.shape != self._v.shape:
            raise ValueError(f"colors must be {self._v.shape}, got {self._c.shape}")
        self._h = self._lib.vdqn_mesh_create(
            self._v.ctypes.data, len(self._v), self._f.ctypes.data, len(self._f),
            self._c.ctypes.data if self._c is not None else None)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vdqn_mesh_destroy(h)
            self._h = None

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        out = np.empty(6, np.float32)
        self._lib.vdqn_mesh_bounds(self._h, out.ctypes.data)
        return out[:3].copy(), out[3:].copy()

    def render(self, poses: np.ndarray, size: int, cam,
               max_depth: float) -> Tuple[np.ndarray, np.ndarray]:
        """poses (V,4): x, y, z, yaw. Returns (depth (V,S,S) f32 z-buffer,
        rgb (V,S,S,3) u8). The rows of a view are split across up to 16
        threads, each pixel written by one of them."""
        p = np.ascontiguousarray(poses, np.float64)
        v = p.shape[0]
        depth = np.empty((v, size, size), np.float32)
        rgb = np.empty((v, size, size, 3), np.uint8)
        self._lib.vdqn_mesh_render(
            self._h, p.ctypes.data, v, int(size), float(cam.xc), float(cam.zc),
            float(cam.f), float(max_depth), depth.ctypes.data, rgb.ctypes.data)
        return depth, rgb

    def floor_probe(self, xz: np.ndarray, y_from: float, max_drop: float,
                    clearance: float) -> Tuple[np.ndarray, np.ndarray]:
        """xz (N,2). Returns (floor_y (N,) f32 [NaN = no floor],
        ok (N,) bool [floor found, walkable slope, clearance above])."""
        q = np.ascontiguousarray(xz, np.float64)
        n = q.shape[0]
        y = np.empty(n, np.float32)
        ok = np.empty(n, np.uint8)
        self._lib.vdqn_mesh_floor_probe(
            self._h, q.ctypes.data, n, float(y_from), float(max_drop), float(clearance),
            y.ctypes.data, ok.ctypes.data)
        return y, ok.astype(bool)

    def floor_levels(self, xz: np.ndarray, y_from: float, y_min: float,
                     clearance: float, max_levels: int = 8):
        """Peel every surface under each (x, z) column from y_from down to
        y_min. Returns (y (N, L) f32, ok (N, L) bool, count (N,) i32);
        entries beyond count are undefined."""
        q = np.ascontiguousarray(xz, np.float64)
        n = q.shape[0]
        y = np.empty((n, max_levels), np.float32)
        ok = np.empty((n, max_levels), np.uint8)
        cnt = np.empty(n, np.int32)
        self._lib.vdqn_mesh_floor_levels(
            self._h, q.ctypes.data, n, float(y_from), float(y_min), float(clearance),
            int(max_levels), y.ctypes.data, ok.ctypes.data, cnt.ctypes.data)
        return y, ok.astype(bool), cnt

    def column_blocked(self, xz: np.ndarray, y_lo: np.ndarray,
                       y_hi: np.ndarray, radius: float) -> np.ndarray:
        """True where any triangle intersects the column box
        [x +- radius] x [y_lo, y_hi] x [z +- radius] (exact SAT test)."""
        q = np.ascontiguousarray(xz, np.float64)
        n = q.shape[0]
        lo = np.ascontiguousarray(np.broadcast_to(y_lo, (n,)), np.float32)
        hi = np.ascontiguousarray(np.broadcast_to(y_hi, (n,)), np.float32)
        out = np.empty(n, np.uint8)
        self._lib.vdqn_mesh_column_blocked(
            self._h, q.ctypes.data, lo.ctypes.data, hi.ctypes.data, n, float(radius),
            out.ctypes.data)
        return out.astype(bool)

    def raycast(self, origins: np.ndarray, dirs: np.ndarray):
        """Returns (t (N,) f32 [+inf = miss], tri (N,) i32 [-1 = miss])."""
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        n = o.shape[0]
        t = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        self._lib.vdqn_mesh_raycast(
            self._h, o.ctypes.data, d.ctypes.data, n, t.ctypes.data, tri.ctypes.data)
        return t, tri

"""Brute-force numpy twin of the mesh raycaster (counterpart of
video_dqn_tpu/sim/mesh_twin.py `TwinMesh`): the plain version of
csrc/host/mesh.cc and the tests' oracle.

The same math in float64: Moller-Trumbore over every triangle (no BVH),
the same camera model, shading and probe semantics, so the host library
must match it to float32 tolerance. Rays are traced in blocks against all
triangles at once, which keeps a 224 px render to seconds. MeshNavEnv
uses it only when the caller passes use_native=False.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# rays x triangles per traced block: a few float64 arrays of 8 MB each
_BLOCK = 1 << 20


class TwinMesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 colors: Optional[np.ndarray] = None):
        self.v = np.asarray(vertices, np.float32)
        self.f = np.asarray(faces, np.int32)
        self.c = np.asarray(colors, np.uint8) if colors is not None else None
        self.p0 = self.v[self.f[:, 0]].astype(np.float64)
        self.e1 = self.v[self.f[:, 1]].astype(np.float64) - self.p0
        self.e2 = self.v[self.f[:, 2]].astype(np.float64) - self.p0
        n = np.cross(self.e1, self.e2)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = np.where(ln > 0, n / np.maximum(ln, 1e-30), [0, 1, 0])

    def bounds(self):
        return self.v.min(axis=0).copy(), self.v.max(axis=0).copy()

    def _trace_rays(self, o: np.ndarray, d: np.ndarray, tie_tol: Optional[float] = None):
        """Rays (P, 3) origins and (P, 3) directions against every triangle.
        Returns (t, tri, u, v), each (P,): the nearest hit's distance along
        d (+inf on a miss), its triangle (-1) and barycentrics (0). With
        `tie_tol`, also (tri2, u2, v2): another triangle hit within tie_tol
        of the nearest, the highest-numbered one or, where that is tri, the
        lowest (tri itself where no other is)."""
        o = np.asarray(o, np.float64).reshape(-1, 3)
        d = np.asarray(d, np.float64).reshape(-1, 3)
        n = len(o)
        step = max(1, _BLOCK // max(1, len(self.f)))
        out = [np.full(n, np.inf), np.full(n, -1, np.int64), np.zeros(n), np.zeros(n)]
        if tie_tol is not None:
            out += [np.full(n, -1, np.int64), np.zeros(n), np.zeros(n)]
        for s in range(0, n, step):
            ob, db = o[s:s + step], d[s:s + step]
            pv = np.cross(db[:, None, :], self.e2[None])
            det = np.einsum("mk,pmk->pm", self.e1, pv)
            ok = np.abs(det) >= 1e-9
            inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            tv = ob[:, None, :] - self.p0[None]
            u = np.einsum("pmk,pmk->pm", tv, pv) * inv
            qv = np.cross(tv, self.e1[None])
            v = np.einsum("pmk,pk->pm", qv, db) * inv
            t = np.einsum("mk,pmk->pm", self.e2, qv) * inv
            good = (ok & (u >= -1e-6) & (u <= 1 + 1e-6) & (v >= -1e-6)
                    & (u + v <= 1 + 1e-6) & (t > 1e-6))
            t = np.where(good, t, np.inf)
            i = np.argmin(t, axis=1)
            rows = np.arange(len(ob))
            tb = t[rows, i]
            hit = np.isfinite(tb)
            found = [tb, np.where(hit, i, -1), np.where(hit, u[rows, i], 0.0),
                     np.where(hit, v[rows, i], 0.0)]
            if tie_tol is not None:
                near = t <= (tb + tie_tol)[:, None]
                last = t.shape[1] - 1 - np.argmax(near[:, ::-1], axis=1)
                j = np.where(last != i, last, np.argmax(near, axis=1))
                found += [np.where(hit, j, -1), np.where(hit, u[rows, j], 0.0),
                          np.where(hit, v[rows, j], 0.0)]
            for dst, src in zip(out, found):
                dst[s:s + step] = src
        return tuple(out)

    def _trace(self, o: np.ndarray, d: np.ndarray):
        """Single ray against all triangles. Returns (t, tri, u, v)."""
        t, tri, u, v = self._trace_rays(o, d)
        return float(t[0]), int(tri[0]), float(u[0]), float(v[0])

    def raycast(self, origins: np.ndarray, dirs: np.ndarray):
        t, tri, _, _ = self._trace_rays(np.atleast_2d(origins), np.atleast_2d(dirs))
        return t.astype(np.float32), tri.astype(np.int32)

    def _shade(self, tri: np.ndarray, bu: np.ndarray, bv: np.ndarray,
               miss: np.ndarray) -> np.ndarray:
        """(P, 3) uint8: the Lambert-shaded vertex colour (or the triangle's
        hashed albedo) at each hit, the background where `miss`."""
        light = np.array([0.4, 0.8, 0.45])
        tri = np.where(miss, 0, tri)
        lam = 0.35 + 0.65 * np.abs(self.normals[tri] @ light)
        if self.c is not None:
            i0, i1, i2 = self.f[tri].T
            col = ((1 - bu - bv)[:, None] * self.c[i0].astype(np.float64)
                   + bu[:, None] * self.c[i1] + bv[:, None] * self.c[i2])
        else:
            h = (tri.astype(np.int64) * 2654435761) & 0xFFFFFFFF
            col = np.stack([60 + (h & 127), 60 + ((h >> 7) & 127),
                            60 + ((h >> 14) & 127)], axis=1).astype(np.float64)
        px = np.minimum(255, col * lam[:, None]).astype(np.uint8)
        px[miss] = (20, 40, 60)
        return px

    def render(self, poses: np.ndarray, size: int, cam, max_depth: float,
               tie_tol: Optional[float] = None):
        """poses (V,4): x, y, z, yaw. Returns (depth (V,S,S) f32 z-buffer,
        rgb (V,S,S,3) u8). With `tie_tol`, also rgb2 (V,S,S,3): the colour
        of another surface hit within tie_tol of the nearest one (coplanar
        faces, whose order a BVH decides), or rgb where there is none."""
        poses = np.atleast_2d(np.asarray(poses, np.float64))
        views = poses.shape[0]
        depth = np.empty((views, size, size), np.float32)
        rgb = np.empty((views, size, size, 3), np.uint8)
        rgb2 = np.empty_like(rgb)
        vv = (cam.zc - np.arange(size, dtype=np.float64)) / cam.f   # per row
        uu = (np.arange(size, dtype=np.float64) - cam.xc) / cam.f   # per column
        for view in range(views):
            x, y, z, a = poses[view]
            fwd = np.array([-np.sin(a), 0.0, -np.cos(a)])
            right = np.array([np.cos(a), 0.0, -np.sin(a)])
            up = np.array([0.0, 1.0, 0.0])
            d = (fwd[None, None] + right[None, None] * uu[None, :, None]
                 + up[None, None] * vv[:, None, None]).reshape(-1, 3)
            o = np.broadcast_to(np.array([x, y, z]), d.shape)
            hits = self._trace_rays(o, d, tie_tol)
            t = hits[0]
            miss = ~np.isfinite(t) | (t > max_depth)
            depth[view] = np.where(miss, max_depth, t).reshape(size, size)
            rgb[view] = self._shade(*hits[1:4], miss).reshape(size, size, 3)
            if tie_tol is not None:
                rgb2[view] = self._shade(*hits[4:7], miss).reshape(size, size, 3)
        return (depth, rgb) if tie_tol is None else (depth, rgb, rgb2)

    def floor_levels(self, xz: np.ndarray, y_from: float, y_min: float,
                     clearance: float, max_levels: int = 8):
        xz = np.atleast_2d(xz)
        n = xz.shape[0]
        ys = np.zeros((n, max_levels), np.float32)
        oks = np.zeros((n, max_levels), bool)
        cnt = np.zeros(n, np.int32)
        down = np.array([0.0, -1.0, 0.0])
        upd = np.array([0.0, 1.0, 0.0])
        for i, (x, z) in enumerate(xz.astype(np.float64)):
            y = y_from
            found = 0
            while found < max_levels and y > y_min:
                t, tri, _, _ = self._trace(np.array([x, y, z]), down)
                if not np.isfinite(t) or t > y - y_min:
                    break
                fy = y - t
                ok = False
                if abs(self.normals[tri][1]) >= 0.7:
                    t2, _, _, _ = self._trace(np.array([x, fy + 0.05, z]), upd)
                    ok = (not np.isfinite(t2)) or t2 > clearance
                ys[i, found] = fy
                oks[i, found] = ok
                found += 1
                y = fy - 0.05
            cnt[i] = found
        return ys, oks, cnt

    def column_blocked(self, xz: np.ndarray, y_lo, y_hi,
                       radius: float) -> np.ndarray:
        """Exact SAT triangle/AABB overlap, brute force over triangles."""
        xz = np.atleast_2d(xz)
        n = xz.shape[0]
        y_lo = np.broadcast_to(np.asarray(y_lo, np.float64), (n,))
        y_hi = np.broadcast_to(np.asarray(y_hi, np.float64), (n,))
        out = np.zeros(n, bool)
        tri = np.stack(
            [self.p0, self.p0 + self.e1, self.p0 + self.e2], axis=1
        )  # (M, 3, 3)
        for i in range(n):
            c = np.array([xz[i, 0], 0.5 * (y_lo[i] + y_hi[i]), xz[i, 1]])
            half = np.array([radius, 0.5 * (y_hi[i] - y_lo[i]), radius])
            out[i] = _any_tri_box(tri, c, half)
        return out

    def floor_probe(self, xz: np.ndarray, y_from: float, max_drop: float,
                    clearance: float):
        xz = np.atleast_2d(xz)
        n = xz.shape[0]
        ys = np.empty(n, np.float32)
        ok = np.zeros(n, bool)
        down = np.array([0.0, -1.0, 0.0])
        upd = np.array([0.0, 1.0, 0.0])
        for i, (x, z) in enumerate(xz.astype(np.float64)):
            t, tri, _, _ = self._trace(np.array([x, y_from, z]), down)
            if not np.isfinite(t) or t > max_drop:
                ys[i] = np.nan
                continue
            floor_y = y_from - t
            ys[i] = floor_y
            if abs(self.normals[tri][1]) < 0.7:
                continue
            t2, _, _, _ = self._trace(np.array([x, floor_y + 0.05, z]), upd)
            ok[i] = (not np.isfinite(t2)) or t2 > clearance
        return ys, ok


def _any_tri_box(tri: np.ndarray, c: np.ndarray, half: np.ndarray) -> bool:
    """Vectorized Akenine-Moller SAT over all triangles (tri (M,3,3))."""
    v = tri - c  # (M, 3 verts, 3)
    e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1], v[:, 0] - v[:, 2]],
                 axis=1)  # (M, 3 edges, 3)
    alive = np.ones(len(tri), bool)

    # box-axis tests
    for ax in range(3):
        mn = v[:, :, ax].min(axis=1)
        mx = v[:, :, ax].max(axis=1)
        alive &= ~((mn > half[ax]) | (mx < -half[ax]))
    if not alive.any():
        return False

    # 9 cross axes
    units = np.eye(3)
    for ei in range(3):
        for ax in range(3):
            axis = np.cross(units[ax], e[:, ei])  # (M, 3)
            p = np.einsum("mvk,mk->mv", v, axis)  # (M, 3)
            r = np.abs(axis) @ half
            alive &= ~((p.min(axis=1) > r) | (p.max(axis=1) < -r))
        if not alive.any():
            return False

    # plane test
    n = np.cross(e[:, 0], e[:, 1])
    d = -np.einsum("mk,mk->m", n, v[:, 0])
    r = np.abs(n) @ half
    alive &= np.abs(d) <= r
    return bool(alive.any())

"""Mesh-scene navigation environment (counterpart of
video_dqn_tpu/sim/mesh_env.py `MeshNavEnv`): BVH-raycast RGB-D rendering,
probe-derived navigability, FMM geodesics, multi-floor inference and the
stair-climb undo, over the port's host library (sim/native_mesh.py):

  * rendering: pinhole RGB-D, a 4-view panorama in one native call;
  * navigability: a per-floor occupancy grid from batched peeling floor
    probes (down-rays, clearance and slope tests) in place of a navmesh;
    navigable-point sampling draws from it;
  * geodesic distance: the port's FMM (ops/fmm.py) over the floor's
    navigable grid, per floor, as the harness only asks same-floor
    queries (sim/gibson.py relevant_locations keeps a goal on the agent's
    floor);
  * floor heights: the most common walkable heights of the probe sweep;
  * step(): forward 0.25 m with a wall ray and a floor-continuity test,
    and stair rejection, which undoes a move whose floor height lies more
    than 0.2 m from every known floor unless allow_stairs.

Scenes load from PLY/OBJ/GLB files (sim/ply.py) or in-memory arrays; the
generators in sim/meshgen.py make scenes without assets. use_native=None
(the default) or True renders with the host library, whose failed build
raises; use_native=False picks the numpy twin (sim/mesh_twin.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.fmm import fmm_distance
from ..ops.geometry import get_camera_matrix
from .mesh_twin import TwinMesh
from .native_mesh import NativeMesh
from .ply import load_mesh


class MeshNavEnv:
    def __init__(
        self,
        mesh=None,
        mesh_path: Optional[str] = None,
        image_size: int = 224,
        fov_deg: float = 90.0,
        turn_angle_deg: float = 30.0,
        forward_step: float = 0.25,
        goals: Sequence = (),
        camera_height: float = 1.25,
        max_depth: float = 10.0,
        seed: int = 0,
        panorama: bool = False,
        nav_resolution: float = 0.1,
        agent_radius: float = 0.1,
        agent_height: float = 1.25,
        allow_stairs: bool = False,
        num_floors: Optional[int] = None,
        floor_samples: int = 10000,
        max_climb: float = 0.15,
        use_native: Optional[bool] = None,
    ):
        if mesh is None:
            if mesh_path is None:
                raise ValueError("MeshNavEnv needs a mesh or a mesh_path")
            mesh = load_mesh(mesh_path)
        if isinstance(mesh, tuple):
            verts, faces, colors = mesh
            # None (the default) or True: the host library; False: the twin
            mesh = (TwinMesh if use_native is False else NativeMesh)(verts, faces, colors)
        self.mesh = mesh
        self.size = image_size
        self.cam = get_camera_matrix(image_size, image_size, fov_deg)
        self.fov_deg = fov_deg
        self.turn = math.radians(turn_angle_deg)
        self.fwd = forward_step
        self.camera_height = camera_height
        self.agent_height = agent_height
        self.agent_radius = agent_radius
        self.max_depth = max_depth
        self.max_climb = max_climb
        self.allow_stairs = allow_stairs
        self.goals = [np.asarray(g, np.float64) for g in goals]
        self.panorama = panorama
        self._rng = np.random.default_rng(seed)
        self.steps = 0

        lo, hi = self.mesh.bounds()
        self._lo, self._hi = lo, hi
        self._y_top = float(hi[1]) + 0.5
        self._y_min = float(lo[1]) - 0.5
        self.nav_res = nav_resolution
        self._build_nav_grids(num_floors, floor_samples)

        # start at the center of the largest floor's navigable area
        self._pos = self._default_start()
        self._ang = 0.0
        self._fmm_cache: Dict = {}

    # -- navigability -----------------------------------------------------
    def _probe_levels(self, xz: np.ndarray):
        ys, oks, cnt = self.mesh.floor_levels(
            xz, self._y_top, self._y_min, self.agent_height, max_levels=8
        )
        # Probe slots beyond each column's hit count come back NaN from the
        # native peeling probe. NaN comparisons are silently False (which was
        # correct) but raise RuntimeWarning in the product loop — make the
        # missing-slot semantics explicit with +inf sentinels, which every
        # consumer's |ys - h| <= tol band test rejects without warnings.
        return np.where(np.isnan(ys), np.inf, ys), oks, cnt

    def _build_nav_grids(self, num_floors, floor_samples) -> None:
        """Infer the floor heights (the most common walkable heights) and
        rasterize one navigable grid per floor."""
        lo, hi = self._lo, self._hi
        nx = max(2, int(math.ceil((hi[0] - lo[0]) / self.nav_res)))
        nz = max(2, int(math.ceil((hi[2] - lo[2]) / self.nav_res)))
        xs = lo[0] + (np.arange(nx) + 0.5) * self.nav_res
        zs = lo[2] + (np.arange(nz) + 0.5) * self.nav_res
        xx, zz = np.meshgrid(xs, zs)  # [zi, xi]
        cols = np.stack([xx.ravel(), zz.ravel()], axis=1)
        ys, oks, cnt = self._probe_levels(cols)

        # floor heights: histogram of walkable surface heights (0.05 m bins),
        # peaks in descending mass
        walk_y = ys[oks & (np.arange(ys.shape[1])[None, :] < cnt[:, None])]
        if len(walk_y) == 0:
            raise ValueError("mesh has no walkable surface")
        binned = np.round(walk_y / 0.05) * 0.05
        vals, counts = np.unique(binned, return_counts=True)
        candidates: List[float] = []
        for k in np.argsort(-counts):
            v, c = float(vals[k]), int(counts[k])
            if num_floors is None and c < 0.02 * len(walk_y):
                break  # counts are descending: the rest are smaller
            if all(abs(v - h) > 0.5 for h in candidates):
                candidates.append(v)
        if not candidates:
            candidates = [float(vals[np.argmax(counts)])]

        # A candidate floor's navigable grid: columns with a walkable
        # surface within 0.2 m of the height AND no geometry crossing the
        # agent band above it (the Recast voxelization analogue — see
        # mesh_column_blocked); then keep the largest connected component,
        # which drops enclosed voids (hollow wall interiors) and isolated
        # islands like wall tops, as a navmesh would.
        self._grid_shape = (nz, nx)
        level_axis = np.arange(ys.shape[1])[None, :] < cnt[:, None]
        floors: List[Tuple[float, np.ndarray, int]] = []
        for h in candidates:
            near = level_axis & (np.abs(ys - h) <= 0.2)
            level_ok = (oks & near).any(axis=1)
            if not level_ok.any():
                continue
            # walkable height per column for the band test
            col_y = np.max(np.where(near & oks, ys, -np.inf), axis=1)
            blocked = np.zeros(len(cols), bool)
            idx = np.nonzero(level_ok)[0]
            blocked[idx] = self.mesh.column_blocked(
                cols[idx], col_y[idx] + 0.2, col_y[idx] + self.agent_height,
                self.nav_res / 2,
            )
            grid = (level_ok & ~blocked).reshape(nz, nx)
            grid = _largest_component(grid)
            grid = _erode(grid, max(0, int(round(self.agent_radius / self.nav_res))))
            area = int(grid.sum())
            if area > 0:
                floors.append((h, grid, area))

        # floor filter: drop candidates whose connected area is tiny
        # relative to the largest (wall tops, counters, single furniture)
        if floors:
            best = max(a for _, _, a in floors)
            min_area = max(
                int(1.0 / self.nav_res**2),  # 1 m^2 absolute floor
                int(0.05 * best),
            )
            floors = [
                (h, g, a) for h, g, a in floors
                if a >= min_area or len(floors) == 1
            ]
        if num_floors is not None:
            floors = sorted(floors, key=lambda t: -t[2])[:num_floors]
        if not floors:
            raise ValueError("no walkable floor of sufficient area found")
        floors.sort(key=lambda t: t[0])
        self.floor_heights = [h for h, _, _ in floors]
        self._grids = [g for _, g, _ in floors]
        # the floor count, which walks that alternate floors read
        self.num_floors = len(floors)

        # exact walkable height per column per floor (for agent y updates)
        self._ys, self._oks, self._cnt = ys, oks, cnt

    def _floor_of(self, y: float) -> int:
        return int(np.argmin([abs(y - h) for h in self.floor_heights]))

    def _cell_of(self, x: float, z: float) -> Tuple[int, int]:
        zi = int((z - self._lo[2]) / self.nav_res)
        xi = int((x - self._lo[0]) / self.nav_res)
        return zi, xi

    def _cell_center(self, zi: int, xi: int, floor: int) -> np.ndarray:
        return np.array([
            self._lo[0] + (xi + 0.5) * self.nav_res,
            self.floor_heights[floor],
            self._lo[2] + (zi + 0.5) * self.nav_res,
        ])

    def _navigable(self, x: float, z: float, floor: int) -> bool:
        zi, xi = self._cell_of(x, z)
        nz, nx = self._grid_shape
        if zi < 0 or zi >= nz or xi < 0 or xi >= nx:
            return False
        return bool(self._grids[floor][zi, xi])

    def navigable_grid(self, floor: int) -> np.ndarray:
        """(nz, nx) bool navigable cells; origin self._lo, res self.nav_res."""
        return self._grids[floor]

    def _blocked(self, x: float, z: float) -> bool:
        """Non-navigable test on the agent's current floor (the grid-world
        interface viz/render_grid consumes)."""
        return not self._navigable(x, z, self._floor_of(self._pos[1]))

    def topdown_extent(self) -> float:
        """Max dimension (meters) of the current floor's navigable area (the
        episode's map size derives from it)."""
        grid = self._grids[self._floor_of(self._pos[1])]
        zi, xi = np.nonzero(grid)
        if len(zi) == 0:
            return float(max(self._hi[0] - self._lo[0], self._hi[2] - self._lo[2]))
        return float(
            max(zi.max() - zi.min() + 1, xi.max() - xi.min() + 1) * self.nav_res
        )

    def _default_start(self) -> np.ndarray:
        areas = [g.sum() for g in self._grids]
        floor = int(np.argmax(areas))
        zi, xi = np.nonzero(self._grids[floor])
        k = len(zi) // 2
        return self._cell_center(zi[k], xi[k], floor)

    # -- interface (sim/interface.py NavEnv) -------------------------------
    @property
    def camera_attrs(self) -> Tuple[int, int, float]:
        return (self.size, self.size, self.fov_deg)

    def agent_state(self):
        return self._pos.copy(), self._ang

    def set_agent_state(self, pos, rot) -> None:
        self._pos = np.asarray(pos, np.float64).copy()
        self._ang = float(rot)

    @property
    def pos(self) -> np.ndarray:
        return self._pos.copy()

    @property
    def rot(self) -> float:
        return self._ang

    @property
    def angle(self) -> float:
        return self._ang % (2 * math.pi)

    def set_agent_position(self, pos) -> None:
        self._pos = np.asarray(pos, np.float64).copy()

    def set_agent_rotation(self, rot) -> None:
        self._ang = float(rot)

    def sample_start_state(self, fixed_floor: Optional[int] = None):
        """A navigable cell's centre on the requested floor (any floor
        when None) and a uniform heading."""
        floors = (
            [int(fixed_floor)] if fixed_floor is not None
            else list(range(len(self.floor_heights)))
        )
        while True:
            floor = floors[self._rng.integers(0, len(floors))]
            zi_all, xi_all = np.nonzero(self._grids[floor])
            if len(zi_all) == 0:
                continue
            k = self._rng.integers(0, len(zi_all))
            pos = self._cell_center(zi_all[k], xi_all[k], floor)
            ang = float(self._rng.uniform(0, 2 * math.pi))
            return pos, ang

    def sample_reachable_goal(self, fixed_floor: Optional[int] = None):
        while True:
            g, _ = self.sample_start_state(fixed_floor)
            if self.geodesic_distance(self._pos, g) != float("inf"):
                return g

    def _snap(self, zi: int, xi: int, floor: int,
              max_snap_m: float = 0.5) -> Optional[Tuple[int, int]]:
        """Nearest navigable cell within max_snap_m: agent positions
        legitimately sit closer to walls than the eroded grid allows, so an
        off-grid query point snaps to the grid."""
        grid = self._grids[floor]
        nz, nx = self._grid_shape
        zi = min(max(zi, 0), nz - 1)
        xi = min(max(xi, 0), nx - 1)
        if grid[zi, xi]:
            return zi, xi
        r = int(math.ceil(max_snap_m / self.nav_res))
        z0, z1 = max(0, zi - r), min(nz, zi + r + 1)
        x0, x1 = max(0, xi - r), min(nx, xi + r + 1)
        sub = grid[z0:z1, x0:x1]
        zs, xs = np.nonzero(sub)
        if len(zs) == 0:
            return None
        d2 = (zs + z0 - zi) ** 2 + (xs + x0 - xi) ** 2
        k = int(np.argmin(d2))
        if d2[k] > r * r:
            return None
        return int(zs[k] + z0), int(xs[k] + x0)

    def geodesic_distance(self, a, b) -> float:
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        fa, fb = self._floor_of(a[1]), self._floor_of(b[1])
        if fa != fb:
            return float("inf")  # cross-floor queries: out of scope (module doc)
        grid = self._grids[fa]
        ca = self._snap(*self._cell_of(a[0], a[2]), fa)
        cb = self._snap(*self._cell_of(b[0], b[2]), fa)
        if ca is None or cb is None:
            return float("inf")
        za, xa = ca
        zb, xb = cb
        key = (fa, zb, xb)
        d = self._fmm_cache.get(key)
        if d is None:
            d = fmm_distance(grid, [(zb, xb)])
            if len(self._fmm_cache) > 32:
                self._fmm_cache.clear()
            self._fmm_cache[key] = d
        val = d[za, xa]
        return float(val * self.nav_res) if np.isfinite(val) else float("inf")

    def _dist_to_goal(self, point) -> float:
        if not self.goals:
            return float("inf")
        return min(self.geodesic_distance(point, g) for g in self.goals)

    def distance_to_goal(self) -> float:
        return self._dist_to_goal(self._pos)

    def reset(self, fixed_floor: Optional[int] = None, reachable: bool = True) -> Dict:
        self.steps = 0
        while True:
            pos, ang = self.sample_start_state(fixed_floor)
            self.set_agent_state(pos, ang)
            if not reachable or not self.goals or self.distance_to_goal() != float("inf"):
                break
        return self.get_observation()

    # -- stepping ----------------------------------------------------------
    def clone(self, seed: int = 0) -> "MeshNavEnv":
        """Cheap per-episode copy: shares the immutable mesh, BVH, nav
        grids and floor heights; fresh agent state, RNG, goals and FMM
        cache. Concurrent (batched) episodes each need their own instance
        but not a scene reload and probe sweep."""
        import copy

        new = copy.copy(self)
        new._rng = np.random.default_rng(seed)
        new._fmm_cache = {}
        new._pos = self._pos.copy()
        new._ang = float(self._ang)
        new.goals = [g.copy() for g in self.goals]
        new.steps = 0
        return new

    def step(self, action: int):
        """0 = forward 0.25 m, 1 = left, 2 = right. Forward blocks on
        walls (horizontal ray at knee height) and on floor discontinuities
        > max_climb per substep; after a successful move, stair rejection
        undoes it when the new floor height deviates > 0.2 m from every
        known floor and stairs are disallowed."""
        self.steps += 1
        if action == 1:
            self._ang += self.turn
        elif action == 2:
            self._ang -= self.turn
        elif action == 0:
            prev_pos, prev_ang = self.agent_state()
            dx = -math.sin(self._ang) * self.fwd
            dz = -math.cos(self._ang) * self.fwd
            # wall test: chest-height ray along the move. Chest (y + 1.0)
            # clears any per-step ramp/stair rise but hits real walls;
            # sub-chest obstacles are caught by the climb limit below.
            o = np.array([[self._pos[0], self._pos[1] + 1.0, self._pos[2]]],
                         np.float32)
            d = np.array([[dx, 0.0, dz]], np.float32) / self.fwd
            t, tri = self.mesh.raycast(o, d)
            blocked = bool(tri[0] >= 0 and t[0] <= self.fwd + self.agent_radius)
            y = float(self._pos[1])
            if not blocked:
                # walkable-floor continuity along 5 substeps, all probe
                # columns in one native call
                fr = np.linspace(0.2, 1.0, 5)
                cols = np.stack(
                    [self._pos[0] + dx * fr, self._pos[2] + dz * fr], axis=1
                )
                ys, oks, cnt = self._probe_levels(cols)
                lv = np.arange(ys.shape[1])[None, :] < cnt[:, None]
                for i in range(len(fr)):
                    cand = ys[i]
                    good = oks[i] & lv[i] & (np.abs(cand - y) <= self.max_climb)
                    if not good.any():
                        blocked = True
                        break
                    y = float(cand[good].max())
            if not blocked:
                self._pos = np.array(
                    [self._pos[0] + dx, y, self._pos[2] + dz]
                )
                # stair rejection
                deviations = [
                    abs(self._pos[1] - h) > 0.2 for h in self.floor_heights
                ]
                if all(deviations) and not self.allow_stairs:
                    self.set_agent_state(prev_pos, prev_ang)
        done = self.distance_to_goal() <= 2
        return self.get_observation(), 0, done, None

    # -- rendering ----------------------------------------------------------
    def _poses(self, views: int) -> np.ndarray:
        x, y, z = self._pos
        cam_y = y + self.camera_height
        return np.array([
            [x, cam_y, z, self._ang + k * math.pi / 2] for k in range(views)
        ])

    def get_observation(self, force_panorama: bool = False) -> Dict:
        n_views = 4 if (self.panorama or force_panorama) else 1
        depth, rgb = self.mesh.render(
            self._poses(n_views), self.size, self.cam, self.max_depth
        )
        if n_views == 1:
            return {"rgb": rgb[0], "depth": depth[0][..., None]}
        return {"rgb": rgb, "depth": depth[..., None]}

    def close(self) -> None:
        pass


def _largest_component(grid: np.ndarray) -> np.ndarray:
    """Keep only the largest 4-connected True component (BFS flood fill)."""
    from collections import deque

    nz, nx = grid.shape
    labels = np.zeros((nz, nx), np.int32)
    sizes = [0]  # label 0 = background
    nxt = 0
    for sz in range(nz):
        for sx in range(nx):
            if not grid[sz, sx] or labels[sz, sx]:
                continue
            nxt += 1
            count = 0
            q = deque([(sz, sx)])
            labels[sz, sx] = nxt
            while q:
                cz, cx = q.popleft()
                count += 1
                for dz, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    tz, tx = cz + dz, cx + dx
                    if (0 <= tz < nz and 0 <= tx < nx and grid[tz, tx]
                            and not labels[tz, tx]):
                        labels[tz, tx] = nxt
                        q.append((tz, tx))
            sizes.append(count)
    if nxt == 0:
        return grid
    return labels == int(np.argmax(sizes))


def _erode(grid: np.ndarray, r: int) -> np.ndarray:
    """Binary erosion with a (2r+1)-square structuring element."""
    if r <= 0:
        return grid
    out = grid.copy()
    for _ in range(r):
        g = out
        shrunk = g.copy()
        shrunk[1:, :] &= g[:-1, :]
        shrunk[:-1, :] &= g[1:, :]
        shrunk[:, 1:] &= g[:, :-1]
        shrunk[:, :-1] &= g[:, 1:]
        out = shrunk
    return out

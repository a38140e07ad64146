"""Fake navigation environment: a 2-D occupancy-grid world with a
raycasting RGB-D renderer and FMM geodesics (counterpart of
video_dqn_tpu/sim/fake_env.py `FakeNavEnv`, `DEFAULT_MAZE`).

The NavEnv interface (sim/interface.py): steps of 0.25 m forward or
30-degree turns with a collision stop, the panorama as 4 views at
90-degree offsets, sample_start_state's rejection sampling, geodesic
distance through the port's FMM, floor_heights.

The renderer: per column, a DDA grid raycast gives the wall distance;
depth is z-depth (ray length * cos(lateral angle), a pinhole z-buffer),
constant down the column; rows outside the wall's angular height render at
max range. RGB is a deterministic pattern of the hit, so that a model sees
consistent, position-dependent images. By default it runs in the port's
C++ (sim/native_render.py, whose failed build raises); use_native=False
picks the Python renderer, the oracle.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops.fmm import fmm_distance
from ..ops.geometry import get_camera_matrix
from . import native_render


DEFAULT_MAZE = [
    "####################",
    "#........#.........#",
    "#........#.........#",
    "#...##...#....###..#",
    "#...##........#....#",
    "#...##........#....#",
    "#.............#....#",
    "#......###.........#",
    "#......#...........#",
    "#......#......##...#",
    "#..................#",
    "#..###.............#",
    "#....#.......####..#",
    "#....#.......#.....#",
    "#............#.....#",
    "#............#.....#",
    "#...####.....#.....#",
    "#.............. ...#",
    "#..................#",
    "####################",
]


class FakeNavEnv:
    def __init__(
        self,
        maze: Optional[Sequence[str]] = None,
        cell_size: float = 0.5,
        image_size: int = 224,
        fov_deg: float = 90.0,
        turn_angle_deg: float = 30.0,
        forward_step: float = 0.25,
        goals: Sequence = (),
        wall_height: float = 2.5,
        camera_height: float = 1.25,
        max_depth: float = 10.0,
        seed: int = 0,
        panorama: bool = False,
        use_native: Optional[bool] = None,
    ):
        maze = maze if maze is not None else DEFAULT_MAZE
        self.grid = np.array(
            [[c == "#" for c in row] for row in maze], bool
        )  # True = wall; indexed [zi][xi]
        self.cell = cell_size
        self.size = image_size
        self.cam = get_camera_matrix(image_size, image_size, fov_deg)
        self.fov_deg = fov_deg
        self.turn = math.radians(turn_angle_deg)
        self.fwd = forward_step
        self.wall_height = wall_height
        self.camera_height = camera_height
        self.max_depth = max_depth
        self.goals = [np.asarray(g, np.float64) for g in goals]
        self.floor_heights = [0.0]
        self.panorama = panorama
        self._rng = np.random.default_rng(seed)
        self.steps = 0
        self._pos = np.array([1.0 * cell_size, 0.0, 1.0 * cell_size])
        self._ang = 0.0
        # free-space geodesic base grid (cells)
        self._free = ~self.grid
        # None (the default) or True: the C++ renderer; False: Python's
        self.use_native = use_native is None or bool(use_native)

    @property
    def camera_attrs(self) -> Tuple[int, int, float]:
        """(width, height, fov) for the mapper's camera model."""
        return (self.size, self.size, self.fov_deg)

    # -- geometry helpers -------------------------------------------------
    def _cell_of(self, x: float, z: float) -> Tuple[int, int]:
        return int(z // self.cell), int(x // self.cell)

    def _blocked(self, x: float, z: float) -> bool:
        zi, xi = self._cell_of(x, z)
        if zi < 0 or zi >= self.grid.shape[0] or xi < 0 or xi >= self.grid.shape[1]:
            return True
        return bool(self.grid[zi, xi])

    # -- interface --------------------------------------------------------
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

    def sample_reachable_goal(self, fixed_floor: Optional[int] = None):
        """Random navigable point with finite geodesic distance from the
        agent."""
        while True:
            g, _ = self.sample_start_state(fixed_floor)
            if self.geodesic_distance(self._pos, g) != float("inf"):
                return g

    def sample_start_state(self, fixed_floor: Optional[int] = None):
        while True:
            zi = self._rng.integers(0, self.grid.shape[0])
            xi = self._rng.integers(0, self.grid.shape[1])
            if not self.grid[zi, xi]:
                pos = np.array(
                    [(xi + 0.5) * self.cell, 0.0, (zi + 0.5) * self.cell]
                )
                ang = float(self._rng.uniform(0, 2 * math.pi))
                return pos, ang

    def geodesic_distance(self, a, b) -> float:
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        za, xa = self._cell_of(a[0], a[2])
        zb, xb = self._cell_of(b[0], b[2])
        gh, gw = self.grid.shape
        if not (0 <= za < gh and 0 <= xa < gw and 0 <= zb < gh and 0 <= xb < gw):
            return float("inf")  # off-map query (e.g. a goal-corner offset)
        if self.grid[za, xa] or self.grid[zb, xb]:
            return float("inf")
        d = fmm_distance(self._free, [(zb, xb)])
        val = d[za, xa]
        return float(val * self.cell) if np.isfinite(val) else float("inf")

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

    def step(self, action: int):
        self.steps += 1
        if action == 0:
            dx = -math.sin(self._ang) * self.fwd
            dz = -math.cos(self._ang) * self.fwd
            nx, nz = self._pos[0] + dx, self._pos[2] + dz
            # interpolated collision check; blocked -> stay (collision)
            blocked = any(
                self._blocked(
                    self._pos[0] + dx * t, self._pos[2] + dz * t
                )
                for t in np.linspace(0.1, 1.0, 10)
            )
            if not blocked:
                self._pos[0], self._pos[2] = nx, nz
        elif action == 1:
            self._ang += self.turn
        elif action == 2:
            self._ang -= self.turn
        done = self.distance_to_goal() <= 2
        return self.get_observation(), 0, done, None

    # -- rendering --------------------------------------------------------
    def _raycast_column_depths(self, ang: float) -> np.ndarray:
        """Ray length to the nearest wall for each image column."""
        cols = np.arange(self.size)
        alphas = np.arctan((cols - self.cam.xc) / self.cam.f)  # right positive
        out = np.empty(self.size)
        fx, fz = -math.sin(ang), -math.cos(ang)
        rx, rz = -math.sin(ang - math.pi / 2), -math.cos(ang - math.pi / 2)
        for i, a in enumerate(alphas):
            dx = fx * math.cos(a) + rx * math.sin(a)
            dz = fz * math.cos(a) + rz * math.sin(a)
            out[i] = self._ray(self._pos[0], self._pos[2], dx, dz)
        return out, alphas

    def _ray(self, x: float, z: float, dx: float, dz: float) -> float:
        # DDA over the occupancy grid
        t = 0.0
        step = self.cell / 4
        while t < self.max_depth:
            t += step
            if self._blocked(x + dx * t, z + dz * t):
                return t
        return self.max_depth

    def _render_views_native(self, poses: np.ndarray) -> list:
        """Batch-render V poses through the C++ renderer (one call)."""
        depth, rgb = native_render.render_views(
            self.grid, self.cell, poses, self.size, self.cam,
            self.wall_height, self.camera_height, self.max_depth,
        )
        return [
            {"rgb": rgb[i], "depth": depth[i][..., None]}
            for i in range(poses.shape[0])
        ]

    def _render_one(self) -> Dict[str, np.ndarray]:
        ray_len, alphas = self._raycast_column_depths(self._ang)
        zdepth = ray_len * np.cos(alphas)  # z-buffer depth
        s = self.size
        rows = np.arange(s)
        # vertical angle per row (row 0 = top)
        betas = np.arctan((self.cam.zc - rows) / self.cam.f)
        # wall spans [0, wall_height]; camera at camera_height
        top = self.wall_height - self.camera_height
        bot = -self.camera_height
        h_at = zdepth[None, :] * np.tan(betas[:, None])
        on_wall = (h_at <= top) & (h_at >= bot)
        depth = np.where(on_wall, zdepth[None, :], self.max_depth)
        depth = np.minimum(depth, self.max_depth).astype(np.float32)

        # deterministic rgb from hit cell + distance shading
        hit_x = self._pos[0] - np.sin(self._ang) * ray_len  # approx
        hue = (
            np.abs(np.sin(hit_x * 7.3) + np.cos(ray_len * 3.1)) * 127
        ).astype(np.uint8)
        rgb = np.zeros((s, s, 3), np.uint8)
        shade = np.clip(255 - zdepth * 24, 30, 255).astype(np.uint8)
        rgb[..., 0] = np.where(on_wall, shade[None, :], 20)
        rgb[..., 1] = np.where(on_wall, hue[None, :], 40)
        rgb[..., 2] = np.where(on_wall, 255 - hue[None, :], 60)
        return {"rgb": rgb, "depth": depth[..., None]}

    def get_observation(self, force_panorama: bool = False) -> Dict:
        if self.panorama or force_panorama:
            pos, ang = self.agent_state()
            if self.use_native:
                poses = np.array(
                    [[pos[0], pos[2], ang + k * math.pi / 2] for k in range(4)]
                )
                views = self._render_views_native(poses)
            else:
                views = []
                for k in range(4):
                    self.set_agent_state(pos, ang + k * math.pi / 2)
                    views.append(self._render_one())
                self.set_agent_state(pos, ang)
            return {
                k: np.stack([v[k] for v in views]) for k in views[0].keys()
            }
        if self.use_native:
            return self._render_views_native(
                np.array([[self._pos[0], self._pos[2], self._ang]])
            )[0]
        return self._render_one()

    def close(self) -> None:
        pass

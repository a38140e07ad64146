"""Occupancy mapper + fast-marching waypoint planner (counterpart of
video_dqn_tpu/plan/mapper.py `DepthMapperAndPlanner`).

Mapping is fed the simulator's true poses (the reference's "SLAM" is
mapping only): a 5 cm/cell count map with z-bins [20, upper_lim],
obstacle = channel-1 count >= point_cnt, traversible = NOT dilated(obstacle)
with the agent's cell forced free; FMM distance fields cached per goal,
with the close-small-openings erosion/dilation fallback; collisions paint
a synthetic obstacle arc; committed actions guard against thrashing; and
the [stop] + up-to-2-step {rotate^k, forward} action search is scored by
the FMM distance delta + 0.1 per action with 10-point traversibility
interpolation, as one vectorized numpy evaluation in the reference's
enumeration order.

A whole panorama (or one view) maps in one call on the planner's device
(ops/binning.py `observations_to_map_delta`); the delta comes back to the
host and adds into the map, which stays a float32 numpy array as in the
JAX package. FMM runs in the port's C++ (ops/fmm.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.binning import observations_to_map_delta
from ..ops.fmm import fmm_distance
from ..ops.geometry import get_camera_matrix
from ..ops.morphology import binary_dilation_disk1_np, open_n_np
from .visualize import log_frame

ACT_FORWARD, ACT_LEFT, ACT_RIGHT, ACT_STOP = 0, 1, 2, 3


def _build_sequences(max_rots: int) -> List[List[int]]:
    """[stop] + {rot^k, fwd} x {<=2 steps}, in the reference planner's
    enumeration order — order matters for argmin ties."""

    def with_next_step(arr):
        ret = [arr + [ACT_FORWARD]]
        for i in range(1, max_rots + 1):
            ret += [arr + [ACT_LEFT] * i + [ACT_FORWARD]]
            ret += [arr + [ACT_RIGHT] * i + [ACT_FORWARD]]
        return ret

    sequences = [[ACT_STOP]] + with_next_step([])
    for seq in with_next_step([]):
        sequences += with_next_step(seq)
    return sequences


class DepthMapperAndPlanner:
    """The eval policy's mapper and planner. `device` (None: the card) is
    where each observation's map delta is computed."""

    def __init__(
        self,
        dt: int = 30,
        camera_height: float = 125.0,
        upper_lim: float = 125.0,
        map_size_cm: int = 6000,
        mark_locs: bool = False,
        close_small_openings: bool = False,
        goal_f: float = 1.1,
        point_cnt: int = 2,
        forward_step_size: float = 0.25,
        log_visualization: bool = False,
        fix_thrashing: bool = False,
        device=None,
    ):
        self.log_visualization = log_visualization
        self.device = resolve_device(device)
        self.dt = dt
        self.camera_height = camera_height
        self.upper_lim = upper_lim
        self.lower_lim = 20.0  # navmesh max-climb
        self.map_size_cm = map_size_cm
        self.mark_locs = mark_locs
        self.close_small_openings = close_small_openings
        self.num_erosions = 2
        self.goal_f = goal_f
        self.point_cnt = point_cnt
        self.forward_step_size = forward_step_size * 100.0  # cm
        self.elevation = 0.0
        self.resolution = 5
        self.fix_thrashing = fix_thrashing
        self._fmm_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._trav_cache: Optional[Tuple[Tuple[int, int], np.ndarray]] = None
        self._sequences = _build_sequences(180 // dt)
        self._seq_plan = self._compile_sequences()

    # -- lifecycle --------------------------------------------------------
    def _reset(
        self,
        goal_dist: float,
        start_pos,
        start_ang: float,
        global_goals: Sequence = (),
        camera_attrs: Optional[Tuple[int, int, float]] = None,
    ) -> None:
        res = self.resolution
        self.z_bins = (self.lower_lim, self.upper_lim)
        map_size_cm = int(
            (max(self.map_size_cm, goal_dist * 2 * self.goal_f) // res) * res
        )
        m = map_size_cm // res + 1
        self.map = np.zeros((m, m, len(self.z_bins) + 1), np.float32)
        self.current_loc = np.array(
            [(m - 1) / 2 * res, (m - 1) / 2 * res, start_ang], np.float32
        )
        self.start_loc = self.current_loc.copy()
        self.start_pos = np.asarray(start_pos, np.float64)
        self.start_ang = start_ang
        w, h, fov = camera_attrs if camera_attrs is not None else (224, 224, 90)
        self.camera = get_camera_matrix(w, h, fov)
        self.goal_loc = None
        self.last_act = ACT_STOP
        self.locs: List[np.ndarray] = []
        self.acts: List[int] = []
        self.reasoning_locs: List[np.ndarray] = []
        self.committed_actions: Optional[Tuple[np.ndarray, List[int]]] = None
        self.global_goals = [
            [self.pos_to_loc(e) for e in pts] for pts in global_goals
        ]
        self._fmm_cache = None
        # the episode's last frame when log_visualization is on
        # (plan/visualize.py), and the last stop's captioned strip
        self.last_frame = None
        self.current_pan = None
        self.current_open = None

    # -- coordinate transforms -------------------------------------------
    def pos_to_loc(self, pos) -> np.ndarray:
        """Habitat world position -> map cm coordinates (displacement
        [-dz, -dx] * 100)."""
        diff = np.asarray(pos, np.float64) - self.start_pos
        return np.array([-diff[2], -diff[0]]) * 100.0 + self.start_loc[:2]

    def loc_to_map(self, loc) -> np.ndarray:
        """cm coords -> (row, col) map cell (y, x flip + floor-div)."""
        return np.flip(
            np.floor_divide(np.asarray(loc)[:2], self.resolution)
        ).astype(np.int64)

    def new_update_loc(self, pos, ang: float) -> None:
        self.current_loc[:2] = self.pos_to_loc(pos)
        self.current_loc[2] = ang
        self.locs.append(self.current_loc.copy())

    def log_reasoning(self) -> None:
        self.reasoning_locs.append(self.current_loc.copy())

    # -- mapping ----------------------------------------------------------
    def _clean_depth_cm(self, depth_cm: np.ndarray) -> np.ndarray:
        d = np.array(depth_cm, np.float32)
        if d.ndim == 3:
            d = d[:, :, 0]
        d[d > 990] = np.nan
        d[d == 0] = np.nan
        return d

    def add_observation(self, depth_cm, loc=None, height=None) -> None:
        loc = self.current_loc if loc is None else loc
        self.add_observations_batch(
            np.asarray(self._clean_depth_cm(depth_cm))[None], np.asarray(loc)[None],
            height=height,
        )

    def add_observations_batch(self, depths_cm, locs, height=None) -> None:
        """Multi-view mapping: (V, H, W) depths + (V, 3) poses in one call
        on the planner's device; the delta is copied back and added into
        the host map."""
        height = self.camera_height if height is None else height
        depths = np.stack([self._clean_depth_cm(d) for d in np.asarray(depths_cm)])
        delta = observations_to_map_delta(
            torch.from_numpy(depths).to(self.device),
            torch.from_numpy(np.asarray(locs, np.float32)),
            self.camera,
            self.map.shape[0],
            float(height),
            self.z_bins,
            float(self.resolution),
            float(self.elevation),
        )
        self.map += delta.cpu().numpy()
        self._fmm_cache = None
        self._trav_cache = None

    # -- traversibility + FMM --------------------------------------------
    def get_traversible(self) -> np.ndarray:
        """Dilated-obstacle complement with the agent's cell forced free.
        Cached per (map version, agent cell): the eval inner loop asks
        2+ times per step."""
        loc = self.loc_to_map(self.current_loc)
        key = (int(loc[0]), int(loc[1]))
        if self._trav_cache is not None and self._trav_cache[0] == key:
            return self._trav_cache[1]
        obstacle = self.map[:, :, 1] >= self.point_cnt
        if self.mark_locs:
            obstacle[loc[0], loc[1]] = False
        traversible = ~binary_dilation_disk1_np(obstacle)
        traversible[loc[0], loc[1]] = True
        self._trav_cache = (key, traversible)
        self._opened_cache = {}
        return traversible

    def _opened(self, traversible: np.ndarray, n: int) -> np.ndarray:
        """open_n(traversible, n), cached per traversibility grid — the
        nav loop recomputes fmm_map every step but n and the grid repeat."""
        if n <= 0:
            return traversible
        cached = getattr(self, "_opened_cache", None)
        if cached is None:
            self._opened_cache = cached = {}
        if cached.get("_src") is not traversible:
            cached.clear()
            cached["_src"] = traversible
        out = cached.get(n)
        if out is None:
            out = open_n_np(traversible, n)
            cached[n] = out
        return out

    # Wavefront bound for FMM solves, in cells (= 3.3 m at 5 cm/cell).
    # Every consumer reads cells within this band of the agent: the action
    # search looks <= ~12 cells out, fmm_distance_m reads the agent cell,
    # reachable_nearby thresholds at 3 m (60 cells). Cells beyond the band
    # read +inf, which consumers already treat as "worse than any finite
    # option", so waypoint selection and reachability decisions are
    # IDENTICAL to full solves — the solver just stops exploring the
    # 1201x1201 grid ~2-100x earlier (test_fmm_bounded asserts equality).
    FMM_MARGIN_CELLS = 66.0

    def _distances(self, traversible: np.ndarray, map_loc) -> np.ndarray:
        gy, gx = int(map_loc[1]), int(map_loc[0])  # map_loc is (x, y) cells
        if gy < 0 or gy >= traversible.shape[0] or gx < 0 or gx >= traversible.shape[1]:
            return np.full(traversible.shape, np.inf)
        agent = self.loc_to_map(self.current_loc)
        return fmm_distance(
            traversible, [(gy, gx)],
            early_stop=(int(agent[0]), int(agent[1])),
            margin=self.FMM_MARGIN_CELLS,
        )

    def fmm_map(self, pos=None, loc=None, close: bool = True) -> np.ndarray:
        if pos is not None:
            goal_loc = self.pos_to_loc(pos)
        elif loc is not None:
            goal_loc = np.asarray(loc, np.float64)
        else:
            goal_loc = self.current_loc
        map_loc = (goal_loc.astype(np.int64) // self.resolution)[:2]  # (x, y)

        if self._fmm_cache is not None and (map_loc == self._fmm_cache[0]).all():
            return self._fmm_cache[1]

        traversible = self.get_traversible()
        if self.close_small_openings and close:
            n = self.num_erosions
            dists = None
            while n >= 0:
                opened = self._opened(traversible, n)
                dists = self._distances(opened, map_loc)
                cur = self.loc_to_map(self.current_loc)
                if np.isfinite(dists[cur[0], cur[1]]):
                    break
                n -= 1
        else:
            dists = self._distances(traversible, map_loc)
        self._fmm_cache = (map_loc, dists)
        return dists

    fmmMap = fmm_map  # reference-API alias

    def fmm_distance_m(self, point) -> float:
        """FMM distance from the agent to `point`, meters."""
        dists = self.fmm_map(pos=point)
        cur = self.loc_to_map(self.current_loc)
        return float(dists[cur[0], cur[1]] * self.resolution / 100.0)

    fmmDistance = fmm_distance_m  # reference-API alias

    def reachable_nearby(self, points, max_dist_m: float = 3.0) -> Optional[int]:
        """First index of `points` with FMM distance-from-agent < 3 m."""
        dists = self.fmm_map(loc=self.current_loc, close=True)
        pts = np.array(
            [self.pos_to_loc(p) // self.resolution for p in points]
        ).astype(np.int64)  # (N, 2) as (x, y) cells
        oob = (
            (pts[:, 0] < 0)
            | (pts[:, 0] >= dists.shape[1])
            | (pts[:, 1] < 0)
            | (pts[:, 1] >= dists.shape[0])
        )
        pts[oob] = 0
        d = dists[pts[:, 1], pts[:, 0]] * self.resolution / 100.0
        d[oob] = np.inf
        ok = d < max_dist_m
        return int(np.argmax(ok)) if ok.any() else None

    # -- action search ----------------------------------------------------
    def _compile_sequences(self):
        """Precompute per-sequence (rotations, forward flags) for the
        vectorized scorer. Each sequence is <= 2 (rotate^k, forward)
        steps; encode as (d1, d2) signed rotation counts and whether a
        second step exists. Stop is index 0."""
        plan = []
        for seq in self._sequences:
            if seq == [ACT_STOP]:
                plan.append((0, 0, 0))  # (d1, d2, n_steps)
                continue
            steps = []
            rot = 0
            for a in seq:
                if a == ACT_LEFT:
                    rot += 1
                elif a == ACT_RIGHT:
                    rot -= 1
                elif a == ACT_FORWARD:
                    steps.append(rot)
                    rot = 0
            if len(steps) == 1:
                plan.append((steps[0], 0, 1))
            else:
                plan.append((steps[0], steps[1], 2))
        d1 = np.array([p[0] for p in plan])
        d2 = np.array([p[1] for p in plan])
        ns = np.array([p[2] for p in plan])
        lens = np.array([len(s) for s in self._sequences])
        return d1, d2, ns, lens

    def get_action_toward(self, pos) -> int:
        # committed-action replay (anti-thrash)
        if (
            self.committed_actions is not None
            and np.array_equal(self.committed_actions[0], np.asarray(pos))
            and len(self.committed_actions[1]) > 0
        ):
            return self.committed_actions[1][0]
        self.committed_actions = None

        traversible = self.get_traversible()
        distances = self.fmm_map(pos=pos)
        d1, d2, ns, lens = self._seq_plan
        rads = np.pi * self.dt / 180.0
        step = self.forward_step_size

        pos0 = self.current_loc[:2]
        rot0 = self.current_loc[2]

        rot1 = rot0 + d1 * rads
        disp1 = np.stack([np.cos(rot1), np.sin(rot1)], -1) * step
        p1 = np.where(ns[:, None] >= 1, pos0 + disp1, pos0)
        rot2 = rot1 + d2 * rads
        disp2 = np.stack([np.cos(rot2), np.sin(rot2)], -1) * step
        p2 = np.where(ns[:, None] >= 2, p1 + disp2, p1)

        # 10-point interpolation collision check per forward step
        def collides(start, disp, active):
            props = np.linspace(0, 1, 10)
            pts = start[:, None, :] + disp[:, None, :] * props[None, :, None]
            cells = np.flip(
                np.floor_divide(pts, self.resolution).astype(np.int64), axis=-1
            )
            cy = np.clip(cells[..., 0], 0, traversible.shape[0] - 1)
            cx = np.clip(cells[..., 1], 0, traversible.shape[1] - 1)
            blocked = ~traversible[cy, cx]
            oob = (cells[..., 0] != cy) | (cells[..., 1] != cx)
            return active & (blocked | oob).any(axis=1)

        col1 = collides(np.broadcast_to(pos0, disp1.shape), disp1, ns >= 1)
        col2 = collides(p1, disp2, ns >= 2) & ~col1
        collided = col1 | col2

        final_cells = np.flip(
            np.floor_divide(p2, self.resolution).astype(np.int64), axis=-1
        )
        fy = np.clip(final_cells[:, 0], 0, distances.shape[0] - 1)
        fx = np.clip(final_cells[:, 1], 0, distances.shape[1] - 1)
        start_cell = self.loc_to_map(self.current_loc)
        with np.errstate(invalid="ignore"):  # inf - inf when unreachable
            score = (
                distances[fy, fx]
                - distances[start_cell[0], start_cell[1]]
                + lens * 0.1
            )
        score = np.where(collided | np.isnan(score), 1.0, score)
        best = int(np.argmin(score))
        act = self._sequences[best][0]
        # anti-thrash: when the chosen action reverses the previous
        # rotation, commit to the whole sequence so the agent cannot
        # oscillate left/right forever (the canonical planner's machinery)
        if self.fix_thrashing and (
            (act == ACT_LEFT and self.last_act == ACT_RIGHT)
            or (act == ACT_RIGHT and self.last_act == ACT_LEFT)
        ):
            self.committed_actions = (np.asarray(pos), list(self._sequences[best]))
        return act

    @staticmethod
    def check_thrashing(n: int, acts) -> bool:
        """True when the last n actions alternate left/right."""
        if len(acts) <= n:
            return False
        last = acts[-1]
        thrashing = last in (ACT_LEFT, ACT_RIGHT)
        for i in range(2, n + 1):
            if not thrashing:
                break
            thrashing = acts[-i] == 3 - last
            last = acts[-i]
        return thrashing

    def action_toward(self, goal_pos) -> bool:
        return self.get_action_toward(goal_pos) != ACT_STOP

    # -- step logging + collision injection ------------------------------
    def log_act(self, obs, pos, ang: float, action: int) -> None:
        old_loc = self.current_loc.copy()
        self.new_update_loc(pos, ang)
        self._fmm_cache = None
        self._trav_cache = None
        depth = obs["depth"]
        if depth.ndim == 4:
            depth = depth[0]
        self.add_observation(np.asarray(depth) * 1000.0)

        if action == ACT_FORWARD:
            dist = float(np.linalg.norm((self.current_loc - old_loc)[:2]))
            if dist <= 24.0:
                # collision: paint an obstacle arc ahead
                collision_radius = np.pi / 6
                angles = np.linspace(-collision_radius / 2, collision_radius / 2, 25)
                for block_dist in range(10, 15):
                    for angle_offset in angles:
                        ox = self.current_loc[0] + block_dist * math.cos(
                            self.current_loc[2] + angle_offset
                        )
                        oy = self.current_loc[1] + block_dist * math.sin(
                            self.current_loc[2] + angle_offset
                        )
                        cell = self.loc_to_map((ox, oy))
                        if (
                            0 <= cell[0] < self.map.shape[0]
                            and 0 <= cell[1] < self.map.shape[1]
                        ):
                            self.map[cell[0], cell[1], 1] += self.point_cnt
                self._fmm_cache = None
                self._trav_cache = None

        if self.committed_actions is not None:
            if self.committed_actions[1] and action == self.committed_actions[1][0]:
                self.committed_actions[1].pop(0)
            else:
                raise RuntimeError("committed-action mismatch")
        self.last_act = action
        self.acts.append(action)
        if self.log_visualization:
            log_frame(self, obs, action)

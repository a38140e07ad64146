"""Episode visualisation: the last rgb | depth | map frame and the strip
file (counterpart of video_dqn_tpu/plan/visualize.py).

`log_frame` keeps each agent step's rgb, 8-bit depth and a copy of what
the map drawing reads in one slot on the planner; `write_combined` draws
that map and writes the rgb | depth | map strip as `<name>.png`: the file
JAX writes where imageio cannot write its mp4 (neither machine has an
encoder for it). JAX keeps every frame for the mp4 and draws each step's
map as it logs it; with no video writer only the last frame is read, so
the port keeps that one and draws its map once.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.png import save_png


def map_layers(planner) -> tuple:
    """What `draw_map` reads, copied off the planner: the obstacle mask
    (counts > point_cnt, as in JAX's drawing; the mapper's obstacle test
    is >=), the marks in JAX's drawing order as (locs (N, >=2) cm, colour,
    half-size), and the map's cm a cell."""
    obstacle = planner.map[:, :, 1] > planner.point_cnt
    marks = [(np.array(planner.locs), (0, 0, 0), 0),
             (np.array(planner.reasoning_locs), (0, 0, 0), 1)]
    if planner.current_open:
        marks.append((np.array([planner.pos_to_loc(pos) for _, pos in planner.current_open]),
                      (28, 164, 252), 1))
    if planner.goal_loc is not None:
        marks.append((np.array(planner.goal_loc)[None], (255, 0, 0), 2))
    return obstacle, marks, planner.resolution


def draw_map(obstacle: np.ndarray, marks: list, resolution) -> np.ndarray:
    """The obstacle map with its marks as an HWC uint8 image (origin
    lower). Each group of marks is drawn in one pass (JAX draws mark by
    mark; marks of one colour commute, and the groups go in JAX's order,
    so the pixels are JAX's)."""
    h, w = obstacle.shape
    img = np.full((h, w, 3), 255, np.uint8)
    img[obstacle] = (53, 166, 85)  # the reference's light green obstacles
    for locs_cm, color, size in marks:
        if len(locs_cm) == 0:
            continue
        cells = np.floor_divide(locs_cm[:, :2], resolution)
        ys, xs = cells[:, 1].astype(np.int64), cells[:, 0].astype(np.int64)
        for dy in range(-size, size + 1):
            for dx in range(-size, size + 1):
                y, x = ys + dy, xs + dx
                inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
                img[y[inside], x[inside]] = color
    return img[::-1]  # origin='lower'


def render_map_rgb(planner) -> np.ndarray:
    """Obstacle map with trajectory overlay as an HWC uint8 image, equal
    to JAX's `render_map_rgb`."""
    return draw_map(*map_layers(planner))


def log_frame(planner, obs, action: int) -> None:
    """Keep the current rgb, depth and map layers as the planner's
    `last_frame` (JAX appends them, twice for a rotation)."""
    rgb = np.asarray(obs["rgb"]).astype(np.uint8)
    depth = np.asarray(obs["depth"])
    if rgb.ndim == 4:
        rgb = rgb[0]
    if depth.ndim == 4:
        depth = depth[0]
    d8 = (np.clip(depth[..., 0], 0, 1) * 255).astype(np.uint8)
    planner.last_frame = (rgb, d8, map_layers(planner))


def _fit(img: np.ndarray, h: int) -> np.ndarray:
    """Nearest-neighbour resize to height h preserving aspect."""
    ih, iw = img.shape[:2]
    w = max(1, int(round(iw * h / ih)))
    ys = (np.arange(h) * ih // h).clip(0, ih - 1)
    xs = (np.arange(w) * iw // w).clip(0, iw - 1)
    return img[ys][:, xs]


def write_combined(planner, out_dir: str, name: str = "episode") -> Optional[str]:
    """Write the last logged rgb | depth | map strip to
    `<out_dir>/<name>.png`; returns its path (None when nothing was
    logged)."""
    if planner.last_frame is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    rgb, d8, layers = planner.last_frame
    h = rgb.shape[0]
    depth_rgb = np.repeat(d8[..., None], 3, axis=-1)
    strip = np.concatenate([rgb, _fit(depth_rgb, h), _fit(draw_map(*layers), h)], axis=1)
    path = os.path.join(out_dir, f"{name}.png")
    save_png(path, strip)
    return path

"""Pre-render a visualisation grid from a nav env (counterpart of
video_dqn_tpu/viz/render_grid.py): the `<row>-<col>-<orientation>.jpg`
files and `info.npy` that viz/value_map.py reads, the JPEGs written by
data/jpeg.py save_images at quality 75, PIL's default and so byte for
byte the files the JAX package writes."""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ..data.jpeg import save_images

WRITE_BATCH = 256  # views a save_images call


def render_grid(env, out_dir: str, resolution: int = 64,
                world_extent: Optional[float] = None, agent_location=None) -> int:
    """Render 4 orientations at every navigable cell of a resolution x
    resolution grid over `env`'s world extent; returns the number of
    cells rendered. Grid rows and columns index the extent uniformly."""
    os.makedirs(out_dir, exist_ok=True)
    if world_extent is None:
        if hasattr(env, "grid"):  # occupancy-grid backend
            gh, gw = env.grid.shape
            world_extent = max(gh, gw) * env.cell
        else:  # mesh backend: navigable extent
            world_extent = float(env.topdown_extent())
    paths, frames = [], []

    def flush():
        if paths:
            save_images(paths, np.stack(frames))
            paths.clear()
            frames.clear()

    cells = 0
    for r in range(resolution):
        for c in range(resolution):
            z = (r + 0.5) / resolution * world_extent
            x = (c + 0.5) / resolution * world_extent
            if env._blocked(x, z):
                continue
            pos = np.array([x, 0.0, z])
            for o in range(4):
                env.set_agent_state(pos, o * math.pi / 2)
                frames.append(np.asarray(env.get_observation()["rgb"]))
                paths.append(os.path.join(out_dir, f"{r}-{c}-{o}.jpg"))
            cells += 1
            if len(paths) >= WRITE_BATCH:
                flush()
    flush()
    info = {
        "agent_location": np.asarray(
            agent_location if agent_location is not None else [0.0, 0.0, 0.0]),
        "map_resolution": resolution,
        "world_extent": world_extent,
    }
    np.save(os.path.join(out_dir, "info.npy"), info, allow_pickle=True)
    return cells

"""Value maps: per-class Q-value heatmaps over a pre-rendered house grid
(counterpart of video_dqn_tpu/viz/value_map.py).

A grid folder holds `<row>-<col>-<orientation>.jpg`, four orientations a
cell (viz/render_grid.py writes them). `build_value_maps` scores every
cell's four orientations with the all-class scorer, one forward a batch of
cells: single-frame nets see each orientation alone, panorama nets the
four-frame stack rolled to start at each orientation. The maps are
float64 numpy arrays on the host, as in the JAX package.
`render_value_map` draws one class's map in viridis, normalised over the
free cells, marks red, cropped to the free extent: byte-equal to JAX's.
"""

from __future__ import annotations

import os
import re
from functools import reduce
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.jpeg import load_images
from ..sim.gibson import CLASS_LABELS, relevant_locations
from . import colormaps
from .panorama import make_allclass_scorer

ORIENTATIONS = 4


class VisualizationGrid:
    """Pre-rendered grid reader: `<row>-<col>-<orientation>.jpg`, decoded by
    the port's JPEG stage to `image_size` (the smaller edge resized, then
    centre-cropped, as the trainer's frames)."""

    def __init__(self, data_folder: str, image_size: int = 224):
        self.data_folder = data_folder
        self.image_size = image_size
        cells = set()
        for f in os.listdir(data_folder):
            m = re.search(r"(\d+)-(\d+)-\d+\.jpg$", f)
            if m:
                cells.add((int(m.group(1)), int(m.group(2))))
        self.cells: List[Tuple[int, int]] = sorted(cells)

    def __len__(self) -> int:
        return len(self.cells)

    def _paths(self, row: int, col: int) -> List[str]:
        return [os.path.join(self.data_folder, f"{row}-{col}-{o}.jpg")
                for o in range(ORIENTATIONS)]

    def load_cell(self, row: int, col: int) -> np.ndarray:
        """(4, S, S, 3) uint8: the four orientations of one cell."""
        return load_images(self._paths(row, col), self.image_size)

    def batches(self, batch_size: int = 64):
        """Yield (rows, cols, images (B, 4, S, S, 3)), each batch decoded in
        one call."""
        s = self.image_size
        for i in range(0, len(self.cells), batch_size):
            chunk = self.cells[i:i + batch_size]
            paths = [p for r, c in chunk for p in self._paths(r, c)]
            images = load_images(paths, s).reshape(len(chunk), ORIENTATIONS, s, s, 3)
            yield np.array([r for r, _ in chunk]), np.array([c for _, c in chunk]), images


def orientation_views(images: np.ndarray, panorama: bool) -> np.ndarray:
    """(B, 4, S, S, 3) cells -> the (4 * B, F, S, S, 3) views of every
    orientation, orientation-major: one frame each (F = 1), or with
    `panorama` the four frames rolled to start at the orientation
    (frame k is orientation (o + k) % 4, F = 4)."""
    if panorama:
        roll = (np.arange(ORIENTATIONS)[:, None] + np.arange(ORIENTATIONS)) % ORIENTATIONS
        views = images[:, roll]  # (B, 4 orientations, 4 frames, S, S, 3)
        return views.swapaxes(0, 1).reshape((-1, ORIENTATIONS) + images.shape[2:])
    return images.swapaxes(0, 1).reshape((-1, 1) + images.shape[2:])


def build_value_maps(model, data_root: str, panorama: bool, resolution: int = 1500,
                     num_classes: int = 5, batch_size: int = 64, image_size: int = 224,
                     device=None):
    """Returns (maps [4 x (R, R, num_classes)], agg_map, free_map): per
    orientation the max-over-actions Q of each class at each grid cell,
    their max over orientations, and 1 at every cell of the grid. `model`
    is the port's Q-net, moved to `device` (None: the card); every batch
    of cells is one forward of 4 * batch_size views."""
    scorer = make_allclass_scorer(model, image_size=image_size, device=device)
    grid = VisualizationGrid(data_root, image_size)
    maps = [np.zeros((resolution, resolution, num_classes)) for _ in range(ORIENTATIONS)]
    free = np.zeros((resolution, resolution))
    for rows, cols, images in grid.batches(batch_size):
        vals = scorer(orientation_views(images, panorama))
        vals = vals.reshape(ORIENTATIONS, len(rows), num_classes)
        for ori in range(ORIENTATIONS):
            maps[ori][rows, cols] = vals[ori]
        free[rows, cols] = 1
    agg = reduce(np.maximum, maps)  # JAX's np.stack(maps).max(0), without the stack
    return maps, agg, free


def crop_range(mask: np.ndarray):
    """Bounding rows and columns of the occupied region."""
    rows = np.where(mask.any(axis=1))[0]
    cols = np.where(mask.any(axis=0))[0]
    if len(rows) == 0:
        return (0, mask.shape[0]), (0, mask.shape[1])
    return (rows[0], rows[-1] + 1), (cols[0], cols[-1] + 1)


def render_value_map(value_map: np.ndarray, free_map: np.ndarray,
                     mark_cells: Optional[List[Tuple[int, int]]] = None,
                     crop: bool = True) -> np.ndarray:
    """Viridis heatmap (normalised over the free cells), marks red,
    cropped to the free extent. Returns HWC uint8."""
    values = value_map[free_map == 1]
    vmin = float(values.min()) if len(values) else 0.0
    vmax = float(values.max()) if len(values) else 1.0
    x = colormaps.normalize(values, vmin, vmax if vmax > vmin else vmin + 1)
    out = np.zeros(value_map.shape + (3,))
    out[free_map == 1] = colormaps.apply(colormaps.VIRIDIS, x)
    for r, c in mark_cells or []:
        if 0 <= r < out.shape[0] and 0 <= c < out.shape[1]:
            out[r, c] = [1, 0, 0]
    if crop:
        (r0, r1), (c0, c1) = crop_range(free_map)
        out = out[r0:r1, c0:c1]
    return (out * 255).astype(np.uint8)


def build_map_figures(model, house, floor: int, data_root: str, panorama: bool,
                      class_labels=None, resolution: int = 1500, image_size: int = 224,
                      agent_location=None, device=None) -> Dict[str, np.ndarray]:
    """Rendered maps keyed '<label>_<direction>' for each class and
    direction 0-3 and 'max', the class's goal locations (relevant to the
    grid's agent_location, from its info.npy unless given) marked."""
    class_labels = class_labels or CLASS_LABELS
    info_path = os.path.join(data_root, "info.npy")
    if agent_location is None and os.path.exists(info_path):
        agent_location = np.load(info_path, allow_pickle=True)[()]["agent_location"]

    maps, agg, free = build_value_maps(model, data_root, panorama, resolution=resolution,
                                       image_size=image_size, device=device)
    out = {}
    for direct in [0, 1, 2, 3, "max"]:
        for i, label in enumerate(class_labels):
            marks = []
            if agent_location is not None:
                locs = relevant_locations(
                    agent_location, house.object_locations_for_habitat_dest[label])
                marks = [to_grid(loc, resolution) for loc in locs]
            cur = agg[:, :, i] if direct == "max" else maps[direct][:, :, i]
            out[f"{label}_{direct}"] = render_value_map(cur, free, marks)
    return out


def to_grid(point, resolution: int, world_extent: float = 50.0):
    """World xz -> grid cell: [-extent/2, extent/2) onto the grid."""
    p = np.asarray(point, np.float64)
    cell = ((p[[2, 0]] + world_extent / 2) / world_extent) * resolution
    return tuple(np.clip(cell.astype(int), 0, resolution - 1))

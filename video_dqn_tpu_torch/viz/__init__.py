"""Visualisation (counterpart of video_dqn_tpu/viz): value maps over
pre-rendered grids, the grid renderer, captioned panorama strips and the
value/distance analysis. Images are uint8 numpy arrays, written by
data/png.py; text is drawn by viz/text.py."""

from .panorama import join_images, panorama_strip
from .render_grid import render_grid
from .value_map import VisualizationGrid, build_map_figures, build_value_maps, render_value_map

__all__ = [
    "VisualizationGrid",
    "build_value_maps",
    "render_value_map",
    "build_map_figures",
    "join_images",
    "panorama_strip",
    "render_grid",
]

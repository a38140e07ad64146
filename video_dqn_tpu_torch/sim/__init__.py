"""Simulators of the eval harness (counterpart of video_dqn_tpu/sim): the
NavEnv interface, the fake raycasting env and the Gibson house metadata.
The mesh simulators wait for ROADMAP.md queue 1, item 6b."""

from .interface import NavEnv
from .fake_env import FakeNavEnv, DEFAULT_MAZE
from .gibson import (
    CLASS_LABELS,
    MEDIUM_INVERSE_TRAIN_NAMES,
    TINY_VAL_HOUSES,
    GibsonHouse,
    get_house,
    get_house_split,
    get_houses,
    gibson_to_habitat_coordinates,
    make_synthetic_scene_graph,
    relevant_locations,
    relevant_objects,
)

__all__ = [
    "NavEnv",
    "FakeNavEnv",
    "DEFAULT_MAZE",
    "CLASS_LABELS",
    "MEDIUM_INVERSE_TRAIN_NAMES",
    "TINY_VAL_HOUSES",
    "GibsonHouse",
    "get_house",
    "get_house_split",
    "get_houses",
    "gibson_to_habitat_coordinates",
    "make_synthetic_scene_graph",
    "relevant_locations",
    "relevant_objects",
]

"""Simulators of the eval harness (counterpart of video_dqn_tpu/sim): the
NavEnv interface, the fake raycasting env, the mesh simulator over scene
files and generated scenes, the sim task config and the Gibson house
metadata."""

from .interface import NavEnv
from .fake_env import FakeNavEnv, DEFAULT_MAZE
from .config import env_kwargs_from_config, get_config, get_sim_defaults
from .mesh_env import MeshNavEnv
from .mesh_twin import TwinMesh
from .meshgen import furnished_house_mesh, maze_mesh, ramp_house_mesh, wall_scene
from .native_mesh import NativeMesh
from .ply import load_mesh, read_glb, read_obj, read_ply, write_glb, write_ply
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
    "MeshNavEnv",
    "NativeMesh",
    "TwinMesh",
    "env_kwargs_from_config",
    "furnished_house_mesh",
    "get_config",
    "get_sim_defaults",
    "load_mesh",
    "maze_mesh",
    "ramp_house_mesh",
    "read_glb",
    "read_obj",
    "read_ply",
    "wall_scene",
    "write_glb",
    "write_ply",
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

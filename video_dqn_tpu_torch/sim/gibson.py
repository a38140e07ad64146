"""Gibson house metadata and 3DSceneGraph object locations (counterpart
of video_dqn_tpu/sim/gibson.py, copied whole):
  * CLASS_LABELS: the 5 sorted COCO target classes
  * GibsonHouse: lazy 3DSceneGraph npz loading via SCENE_GRAPH_LOCATION_TINY,
    per-class object locations and corner polygons with the
    gibson -> habitat coordinate rotation [x, z, -y]
  * house splits from GIBSON_LOCATION/metadata.json: tiny / medium / the
    fixed 15-house medium_inverse_train list
  * relevant_locations / relevant_objects same-floor filters (y-delta in
    [0, 1))
The per-house floor tables and class colours come from the repo's
data/gibson/house_metadata.json. GibsonHouse.get_env opens the house's
mesh under GIBSON_LOCATION with the mesh simulator, or calls the factory
the caller passes.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

CLASS_LABELS = sorted(["bed", "chair", "couch", "dining table", "toilet"])


def class_colors() -> Dict[str, tuple]:
    """Per-class display colours."""
    return {k: tuple(v) for k, v in _house_tables()["colors"].items()}

# Gibson tiny validation houses used by the published evaluation
# (evaluation/val_episodes.npy episode table)
TINY_VAL_HOUSES = ["Collierville", "Corozal", "Darden", "Markleeville", "Wiconisco"]

_METADATA_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "data", "gibson", "house_metadata.json"
)


def _house_tables() -> Dict:
    """The per-house floor-count tables and class colours."""
    import json

    with open(_METADATA_PATH) as f:
        return json.load(f)


# Fixed 15-house split for inverse-model training
MEDIUM_INVERSE_TRAIN_NAMES = [
    "Maugansville", "Sussex", "Andover", "Annona", "Goodfield",
    "Kemblesville", "Goodwine", "Adairsville", "Nuevo", "Stilwell",
    "Eagan", "Touhy", "Springerville", "Brown", "Castor",
]


def gibson_to_habitat_coordinates(point) -> np.ndarray:
    """Rotate gibson's +y-up frame into habitat's: [x, z, -y] (as habitat's
    datatool does)."""
    p = np.asarray(point, np.float64)
    return np.array([p[0], p[2], -p[1]])


class GibsonHouse:
    def __init__(self, dataobj: Dict, scene_graph_dir: Optional[str] = None):
        self.name = dataobj["id"]
        self.data = dataobj
        self._semantics = None
        self._scene_graph_dir = scene_graph_dir

    @property
    def semantics(self) -> Dict:
        if self._semantics is None:
            folder = self._scene_graph_dir
            if folder is None:
                if self.data.get("split_tiny", "none") == "none":
                    raise RuntimeError(f"no annotations for {self.name}")
                folder = os.path.join(
                    os.environ["SCENE_GRAPH_LOCATION_TINY"], "verified_graph"
                )
            path = os.path.join(folder, f"3DSceneGraph_{self.name}.npz")
            self._semantics = np.load(path, allow_pickle=True)["output"][()]
        return self._semantics

    def _objects_of(self, cls: str) -> List[Dict]:
        return [o for o in self.semantics["object"].values() if o["class_"] == cls]

    @property
    def toilets(self) -> List[Dict]:
        return self._objects_of("toilet")

    @property
    def toilet_locations_habitat(self) -> List[np.ndarray]:
        return [gibson_to_habitat_coordinates(t["location"]) for t in self.toilets]

    @property
    def object_locations(self) -> Dict[str, List[np.ndarray]]:
        return {
            c: [gibson_to_habitat_coordinates(o["location"]) for o in self._objects_of(c)]
            for c in CLASS_LABELS
        }

    @property
    def objects(self) -> Dict[str, List[List[np.ndarray]]]:
        """Per class: list of 4-corner polygons (xz bbox corners at object
        height) — the goal regions for SPL success."""
        out = {}
        for cls in CLASS_LABELS:
            polys = []
            for o in self._objects_of(cls):
                loc = gibson_to_habitat_coordinates(o["location"])
                size = gibson_to_habitat_coordinates(o["size"])
                corners = []
                for x, y in [(0.5, 0.5), (0.5, -0.5), (-0.5, -0.5), (-0.5, 0.5)]:
                    corners.append(
                        np.array(
                            [loc[0] + x * size[0], loc[1], loc[2] + y * size[2]]
                        )
                    )
                polys.append(corners)
            out[cls] = polys
        return out

    @property
    def object_locations_for_habitat_dest(self) -> Dict[str, List[np.ndarray]]:
        """Flat corner-point lists per class — navigation destinations."""
        out = {}
        for cls, polys in self.objects.items():
            out[cls] = [pt for poly in polys for pt in poly]
        return out

    @property
    def num_floors(self) -> int:
        """Scene-graph floor count, falling back to the vendored override
        table and then gibson stats."""
        b = self.semantics.get("building", {}) if self._has_semantics() else {}
        if "num_floors" in b:
            return int(b["num_floors"])
        tables = _house_tables()
        override = tables["level_override"].get(self.name)
        if override is not None:
            return int(override)
        stats = int(self.data.get("stats", {}).get("floor", 1))
        env_levels = tables["levels_from_env"].get(self.name)
        if env_levels is not None:
            return min(stats, int(env_levels))
        return stats

    def _has_semantics(self) -> bool:
        if self._semantics is not None:
            return True
        try:
            self.semantics
            return True
        except Exception:
            return False

    def get_env(self, env_factory: Optional[Callable] = None, **kwargs):
        """Build the navigation env for this house. env_factory receives
        (scene_path, **kwargs); the default looks for the house's mesh
        under GIBSON_LOCATION (.glb/.ply/.obj) and opens it with the mesh
        simulator (sim/mesh_env.py MeshNavEnv), passing the house's floor
        count."""
        root = os.environ.get("GIBSON_LOCATION", "")
        scene = None
        for ext in (".glb", ".ply", ".obj"):
            cand = os.path.join(root, f"{self.name}{ext}")
            if os.path.exists(cand):
                scene = cand
                break
        if env_factory is not None:
            return env_factory(
                scene or os.path.join(root, f"{self.name}.glb"), **kwargs
            )
        if scene is None:
            raise RuntimeError(
                f"no scene mesh for {self.name} under GIBSON_LOCATION="
                f"{root!r} (.glb/.ply/.obj) and no env_factory given; the "
                "licensed Gibson download provides the meshes"
            )
        from .mesh_env import MeshNavEnv

        if "num_floors" not in kwargs:
            kwargs["num_floors"] = self.num_floors
        return MeshNavEnv(mesh_path=scene, **kwargs)


def _load_metadata(gibson_location: Optional[str] = None) -> List[Dict]:
    root = gibson_location or os.environ["GIBSON_LOCATION"]
    with open(os.path.join(root, "metadata.json")) as f:
        return json.load(f)


def get_houses(split: Sequence[str] = ("train", "val"), gibson_location=None,
               scene_graph_dir=None) -> List[GibsonHouse]:
    data = _load_metadata(gibson_location)
    return [
        GibsonHouse(d, scene_graph_dir) for d in data if d.get("split_tiny") in split
    ]


def get_house(name: str, gibson_location=None, scene_graph_dir=None) -> GibsonHouse:
    data = _load_metadata(gibson_location)
    matches = [d for d in data if d["id"] == name]
    if not matches:
        raise KeyError(name)
    return GibsonHouse(matches[0], scene_graph_dir)


def get_house_split(split: str, gibson_location=None, scene_graph_dir=None) -> List[GibsonHouse]:
    data = _load_metadata(gibson_location)
    if split == "medium_inverse_train":
        houses = [
            GibsonHouse(d, scene_graph_dir)
            for d in data
            if d["id"] in MEDIUM_INVERSE_TRAIN_NAMES
        ]
        if len(houses) != 15:
            raise RuntimeError(f"expected 15 houses, got {len(houses)}")
        return houses
    if split == "medium_train":
        return [
            GibsonHouse(d, scene_graph_dir)
            for d in data
            if d.get("split_medium") == "train" and d.get("split_tiny") == "none"
        ]
    if split in ("tiny_train", "tiny_val"):
        want = split.split("_")[1]
        return [
            GibsonHouse(d, scene_graph_dir) for d in data if d.get("split_tiny") == want
        ]
    raise ValueError(split)


def relevant_locations(agent_pos, locs) -> List[np.ndarray]:
    """Same-floor filter: keep points whose height is within [0, 1) above
    the agent."""
    out = []
    for t in locs:
        d = t[1] - agent_pos[1]
        if 0 <= d < 1:
            out.append(t)
    return out


def relevant_objects(agent_pos, objects) -> List:
    """Same-floor filter on corner polygons (first corner's height)."""
    out = []
    for poly in objects:
        d = poly[0][1] - agent_pos[1]
        if 0 <= d < 1:
            out.append(poly)
    return out


def make_synthetic_scene_graph(
    path: str, name: str, objects_per_class: int = 2, seed: int = 0
) -> str:
    """Test fixture: write a 3DSceneGraph-format npz with random objects,
    in place of the licensed download."""
    rng = np.random.default_rng(seed)
    objs = {}
    idx = 0
    for cls in CLASS_LABELS:
        for _ in range(objects_per_class):
            objs[idx] = {
                "class_": cls,
                "location": rng.uniform(0, 8, 3),
                "size": rng.uniform(0.5, 2.0, 3),
            }
            idx += 1
    output = {
        "building": {"num_floors": 1},
        "object": objs,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, output=output)
    return path

"""Eval fixtures (counterpart of video_dqn_tpu/eval/fixtures.py):
GibsonHouse-shaped stubs and episodes that need no licensed scene assets,
on the fake raycasting env, on the mesh simulator over a scene file or the
extruded default maze, and in the furnished two-floor house, whose goals
are its own furniture of every target class."""

from __future__ import annotations

import numpy as np

from ..sim.fake_env import DEFAULT_MAZE, FakeNavEnv
from ..sim.gibson import CLASS_LABELS, relevant_locations
from ..sim.mesh_env import MeshNavEnv
from ..sim.meshgen import furnished_house_mesh, maze_mesh


class FakeHouse:
    """GibsonHouse stand-in: one object of every class at `goal_pos`."""

    def __init__(self, goal_pos):
        self.name = "FakeHouse"
        corners = [
            np.asarray(goal_pos) + np.array([dx, 0, dz]) * 0.2
            for dx, dz in [(1, 1), (1, -1), (-1, -1), (-1, 1)]
        ]
        self.objects = {c: [corners] for c in CLASS_LABELS}
        self.object_locations_for_habitat_dest = {c: list(corners) for c in CLASS_LABELS}
        self.num_floors = 1


class MeshHouse:
    """GibsonHouse stand-in built from a generated scene's object map
    (class -> [(x, y, z) centres]): corner polygons and destination points
    per class, as GibsonHouse.objects and object_locations_for_habitat_dest
    give them."""

    def __init__(self, name, objects, num_floors=2):
        self.name = name
        self.num_floors = num_floors
        self.objects = {}
        self.object_locations_for_habitat_dest = {}
        for cls in CLASS_LABELS:
            polys, dests = [], []
            for center in objects.get(cls, []):
                center = np.asarray(center, np.float64)
                corners = [
                    center + np.array([dx, 0, dz]) * 0.45
                    for dx, dz in [(1, 1), (1, -1), (-1, -1), (-1, 1)]
                ]
                polys.append(corners)
                dests.extend(corners)
            self.objects[cls] = polys
            self.object_locations_for_habitat_dest[cls] = dests


def make_furnished_house(size_px: int = 48, seed: int = 0,
                         allow_stairs: bool = False):
    """(env, house) on the furnished two-floor generated house, the closest
    asset-free stand-in for a real Gibson house: rooms, doors, furniture of
    every target class on both floors, and a ramp between them."""
    v, f, c, objects = furnished_house_mesh()
    env = MeshNavEnv(mesh=(v, f, c), image_size=size_px, num_floors=2,
                     seed=seed, allow_stairs=allow_stairs)
    house = MeshHouse("FurnishedHouse", objects, num_floors=2)
    return env, house


def make_env_and_episode(goal_cells=(6, 6), start_cells=(2, 2), size=32):
    """(env, house, episode-tuple) with a same-room goal in the default maze."""
    env = FakeNavEnv(image_size=size)
    goal = np.array([goal_cells[0] * env.cell, 0.0, goal_cells[1] * env.cell])
    start = np.array([start_cells[0] * env.cell, 0.0, start_cells[1] * env.cell])
    env.goals = [goal]
    env.set_agent_state(start, 0.0)
    gd = env.geodesic_distance(start, goal)
    house = FakeHouse(goal)
    ep = ("FakeHouse", 0, "toilet", gd, start, 0.0)
    return env, house, ep


def make_episode_set(n: int, size: int = 48, seed: int = 0,
                     backend: str = "fake", mesh_path=None, panorama=False,
                     fresh_envs: bool = False):
    """An n-episode workload on one shared env of `backend`: "fake" (the
    fake env) or "mesh" (the mesh simulator over `mesh_path`, or the
    extruded default maze without one) with random navigable starts and
    reachable goals and one FakeHouse per episode (distinct house names,
    so the runner's house switch takes its real path); or "furnished" (the
    furnished house, episodes of a random floor and class whose goals are
    that class's furniture on the start's floor). Returns (episodes
    ndarray, env_factory, house_factory), the rows as in val_episodes.npy
    (house, floor, class, geodesic_dist, pos, rot). `fresh_envs` gives each
    episode an env of its own (concurrent episodes cannot share one); a
    mesh env's copies share its mesh and navigable grids (clone)."""
    if backend not in ("fake", "mesh", "furnished"):
        raise ValueError(f"unknown backend {backend!r}: fake, mesh or furnished")
    rng = np.random.default_rng(seed)
    episodes = []
    if backend == "furnished":
        env, house = make_furnished_house(size_px=size, seed=seed)
        for _ in range(n):
            for _ in range(1000):
                floor = int(rng.integers(0, len(env.floor_heights)))
                cls = CLASS_LABELS[int(rng.integers(0, len(CLASS_LABELS)))]
                start, ang = env.sample_start_state(floor)
                goals = relevant_locations(
                    start, house.object_locations_for_habitat_dest[cls])
                if not goals:
                    continue
                gd = min(env.geodesic_distance(start, g) for g in goals)
                if np.isfinite(gd) and gd > 1.5:
                    break
            else:
                raise RuntimeError("could not sample a reachable episode")
            episodes.append(("FurnishedHouse", floor, cls, gd, start, ang))
        houses = {"FurnishedHouse": house}
    else:
        if backend == "mesh" and mesh_path is not None:
            env = MeshNavEnv(mesh_path=mesh_path, image_size=size,
                             panorama=panorama, seed=seed)
        elif backend == "mesh":
            env = MeshNavEnv(mesh=maze_mesh(DEFAULT_MAZE), image_size=size,
                             num_floors=1, panorama=panorama, seed=seed)
        else:
            env = FakeNavEnv(image_size=size, panorama=panorama, seed=seed)
        houses = {}
        for i in range(n):
            start, ang = env.sample_start_state(0)
            env.set_agent_state(start, ang)
            goal = env.sample_reachable_goal(0)
            gd = env.geodesic_distance(start, goal)
            cls = CLASS_LABELS[int(rng.integers(0, len(CLASS_LABELS)))]
            hn = f"House{i:04d}"
            houses[hn] = FakeHouse(goal)
            episodes.append((hn, 0, cls, gd, start, ang))

    if fresh_envs:
        counter = [seed]
        if backend == "fake":
            def fresh(s):
                return FakeNavEnv(image_size=size, panorama=panorama, seed=s)
        else:
            fresh = env.clone  # shares the mesh and grids: no reload or probe sweep

        def env_factory(house, model_config, config):
            counter[0] += 1
            return fresh(counter[0])
    else:
        def env_factory(house, model_config, config):
            return env

    def house_factory(name):
        return houses[name]

    return np.array(episodes, dtype=object), env_factory, house_factory


def make_mesh_env_and_episode(goal_cells=(6, 6), start_cells=(2, 2), size=224,
                              mesh_path=None, panorama=False, seed=0,
                              allow_stairs=False):
    """(env, house, episode) on the mesh simulator: a scene file
    (PLY/OBJ/GLB, the CLI's --mesh-scene) with a random start and reachable
    goal, or the extruded default maze with the given cells. The mesh
    counterpart of make_env_and_episode, with the same episode row."""
    if mesh_path is not None:
        env = MeshNavEnv(mesh_path=mesh_path, image_size=size,
                         panorama=panorama, seed=seed,
                         allow_stairs=allow_stairs)
        start, ang = env.sample_start_state(0)
        env.set_agent_state(start, ang)
        goal = env.sample_reachable_goal(0)
    else:
        cell = 0.5
        env = MeshNavEnv(mesh=maze_mesh(DEFAULT_MAZE, cell=cell),
                         image_size=size, num_floors=1, panorama=panorama,
                         seed=seed, allow_stairs=allow_stairs)
        # cell centres: exact multiples land on wall corners in the mesh
        goal = np.array([(goal_cells[0] + 0.5) * cell, 0.0,
                         (goal_cells[1] + 0.5) * cell])
        start = np.array([(start_cells[0] + 0.5) * cell, 0.0,
                          (start_cells[1] + 0.5) * cell])
        ang = 0.0
        env.set_agent_state(start, ang)
    env.goals = [np.asarray(goal, np.float64)]
    gd = env.geodesic_distance(start, goal)
    house = FakeHouse(goal)
    ep = ("MeshHouse", 0, "toilet", gd, np.asarray(start, np.float64), ang)
    return env, house, ep

"""Eval fixtures on the fake raycasting env (counterpart of
video_dqn_tpu/eval/fixtures.py `FakeHouse`, `make_env_and_episode`,
`make_episode_set`): a GibsonHouse-shaped stub and episodes that need no
scene assets. The mesh and furnished-house backends wait for ROADMAP.md
queue 1, item 6b."""

from __future__ import annotations

import numpy as np

from ..sim.fake_env import FakeNavEnv
from ..sim.gibson import CLASS_LABELS


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
    """An n-episode workload on the fake env: random navigable starts and
    reachable goals, one FakeHouse per episode (distinct house names, so
    the runner's house switch takes its real path). Returns (episodes
    ndarray, env_factory, house_factory), the rows as in val_episodes.npy
    (house, floor, class, geodesic_dist, pos, rot). `fresh_envs` gives each
    episode an env of its own (concurrent episodes cannot share one)."""
    if backend != "fake" or mesh_path is not None:
        raise NotImplementedError(
            f"backend {backend!r}: the mesh and furnished-house simulators are "
            "not ported to video_dqn_tpu_torch yet (ROADMAP.md, queue 1, item 6b)")
    rng = np.random.default_rng(seed)

    def build_env(s):
        return FakeNavEnv(image_size=size, panorama=panorama, seed=s)

    env = build_env(seed)
    episodes = []
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

        def env_factory(house, model_config, config):
            counter[0] += 1
            return build_env(counter[0])
    else:
        def env_factory(house, model_config, config):
            return env

    def house_factory(name):
        return houses[name]

    return np.array(episodes, dtype=object), env_factory, house_factory

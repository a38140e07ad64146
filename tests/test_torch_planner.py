"""The port's DepthMapperAndPlanner against the JAX package's, fed the same
fake-env renders along a scripted trajectory: a reasoning stop's panorama,
forward steps into a wall (collisions, which paint an obstacle arc), then
planned steps toward a goal. At every step the traversible grid, the FMM
distance in meters, reachable_nearby and the chosen action must be equal;
the close-small-openings fallback must have run."""

import math

import numpy as np
import pytest

from video_dqn_tpu.plan.mapper import DepthMapperAndPlanner as JaxPlanner
from video_dqn_tpu_torch.plan.mapper import DepthMapperAndPlanner
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from tests import torch_port_util  # caps torch threads per worker

SIZE = 48


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()


def planners():
    kw = dict(dt=30, map_size_cm=2500, mark_locs=True, close_small_openings=True)
    return JaxPlanner(**kw), DepthMapperAndPlanner(**kw, device="cpu")


def candidates(env, rng, n=30):
    """Points 0.5-3.5 m around the agent, as check_movement samples them."""
    out = []
    for _ in range(n):
        ang = rng.uniform(0, 2 * math.pi)
        out.append(env.pos + np.array([-math.sin(ang), 0.0, -math.cos(ang)])
                   * rng.uniform(0.5, 3.5))
    return out


def check_equal(jp, pp, env, goal, rng):
    np.testing.assert_array_equal(pp.map, jp.map)
    np.testing.assert_array_equal(pp.get_traversible(), jp.get_traversible())
    assert pp.fmm_distance_m(goal) == jp.fmm_distance_m(goal)
    pts = candidates(env, rng)
    assert pp.reachable_nearby(pts) == jp.reachable_nearby(pts)
    np.testing.assert_array_equal(pp.fmm_map(loc=pp.current_loc),
                                  jp.fmm_map(loc=jp.current_loc))
    act = pp.get_action_toward(goal)
    assert act == jp.get_action_toward(goal)
    return act


def log_act(jp, pp, env, action):
    obs, _, _, _ = env.step(action)
    for p in (jp, pp):
        p.log_act(obs, env.pos, env.angle, action)


@pytest.mark.parametrize("fix_thrashing", [False, True])
def test_planner_matches_jax_along_a_scripted_trajectory(fix_thrashing):
    env = FakeNavEnv(image_size=SIZE)
    start, goal = np.array([1.0, 0.0, 1.0]), np.array([6.25, 0.0, 7.25])
    env.set_agent_state(start, 0.0)
    env.goals = [goal]
    jp, pp = planners()
    jp.fix_thrashing = pp.fix_thrashing = fix_thrashing
    opened = []
    real_opened = pp._opened
    pp._opened = lambda trav, n: (opened.append(n), real_opened(trav, n))[1]
    for p in (jp, pp):
        p._reset(env.geodesic_distance(start, goal), start_pos=env.pos,
                 start_ang=env.angle, camera_attrs=env.camera_attrs)
    rng = np.random.default_rng(7)

    # a reasoning stop: 12 left turns, mapped in one call
    views, locs = [], []
    for _ in range(12):
        obs, _, _, _ = env.step(1)
        views.append(obs["depth"][..., 0] * 1000.0)
        locs.append([*pp.pos_to_loc(env.pos), env.angle])
    for p in (jp, pp):
        p.log_reasoning()
        p.add_observations_batch(np.stack(views), np.array(locs, np.float32))
    check_equal(jp, pp, env, goal, rng)

    # facing the wall at z = 0.5: the third forward step and later collide
    collisions = 0
    for _ in range(5):
        before = env.pos
        log_act(jp, pp, env, 0)
        collisions += bool(np.array_equal(before, env.pos))
        check_equal(jp, pp, env, goal, rng)
    assert collisions >= 2
    assert (pp.map[:, :, 1] != jp.map[:, :, 1]).sum() == 0

    # planned steps toward the goal
    for _ in range(40):
        act = check_equal(jp, pp, env, goal, rng)
        if act == 3:
            break
        log_act(jp, pp, env, act)
    assert len(pp.acts) > 10
    assert pp.acts == jp.acts

    # a corridor 5 cells wide painted around the agent, 1 cell wide once the
    # obstacles dilate: opening the grid twice cuts the agent off, so the
    # close-small-openings fallback solves on a grid opened fewer times
    row = int(pp.loc_to_map(pp.current_loc)[0])
    for p in (jp, pp):
        p.map[:, :, 1] = p.point_cnt
        p.map[row - 2:row + 3, :, 1] = 0
        p._fmm_cache = p._trav_cache = None
    ahead = pp.current_loc[:2] + np.array([200.0, 0.0])  # 40 cells along the row
    target = pp.start_pos + np.array([-(ahead[1] - pp.start_loc[1]) / 100, 0.0,
                                      -(ahead[0] - pp.start_loc[0]) / 100])
    del opened[:]
    assert check_equal(jp, pp, env, target, rng) != 3
    assert np.isfinite(pp.fmm_distance_m(target))
    assert min(opened) < pp.num_erosions


def test_planner_refuses_visualisation_and_needs_cuda_by_default(monkeypatch):
    """log_visualization raised until item 8a; now the planner takes it and
    starts each episode with no frame logged."""
    planner = DepthMapperAndPlanner(log_visualization=True, device="cpu")
    planner._reset(1.0, start_pos=np.zeros(3), start_ang=0.0)
    assert planner.log_visualization
    assert planner.last_frame is None
    assert planner.current_pan is None and planner.current_open is None
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DepthMapperAndPlanner()

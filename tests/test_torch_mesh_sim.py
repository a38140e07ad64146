"""The port's mesh simulator against the JAX package's: the scene readers
and writers (PLY, OBJ, GLB), the generated scenes, the BVH raycaster in
the port's host library (against the numpy twin and the JAX package's
native library), the floor probes, MeshNavEnv's navigable grids, floors,
geodesics, steps, stair rejection, renders and seeded states, clone,
GibsonHouse.get_env on a mesh, the sim task config, and geodesic episodes
in the furnished house through run_policy. Each test mirrors one of
tests/test_mesh_sim.py or tests/test_sim_config.py, or adds a comparison."""

import glob
import json
import math
import os
import struct
import warnings

import numpy as np
import pytest

from video_dqn_tpu.core.disk_logger import DiskReader as JaxDiskReader
from video_dqn_tpu.eval import get_eval_defaults as jax_eval_defaults
from video_dqn_tpu.eval import run_policy as jax_run_policy
from video_dqn_tpu.eval.fixtures import make_furnished_house as jax_furnished_house
from video_dqn_tpu.eval.fixtures import make_mesh_env_and_episode as jax_mesh_episode
from video_dqn_tpu.ops.geometry import get_camera_matrix as jax_camera
from video_dqn_tpu.sim import config as jax_sim_config
from video_dqn_tpu.sim import gibson as jax_gibson
from video_dqn_tpu.sim import meshgen as jax_meshgen
from video_dqn_tpu.sim import native_mesh as jax_native_mesh
from video_dqn_tpu.sim import ply as jax_ply
from video_dqn_tpu.sim.fake_env import FakeNavEnv as JaxFakeNavEnv
from video_dqn_tpu.sim.mesh_env import MeshNavEnv as JaxMeshNavEnv
from video_dqn_tpu.sim.mesh_twin import TwinMesh as JaxTwinMesh
from video_dqn_tpu_torch import _build
from video_dqn_tpu_torch.core.disk_logger import DiskReader
from video_dqn_tpu_torch.eval.evaluate import make_geodesic_scorer
from video_dqn_tpu_torch.eval.fixtures import make_furnished_house, make_mesh_env_and_episode
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults, name_from_config
from video_dqn_tpu_torch.eval.runner import run_policy
from video_dqn_tpu_torch.ops.geometry import get_camera_matrix
from video_dqn_tpu_torch.sim import config as sim_config
from video_dqn_tpu_torch.sim import gibson, meshgen, ply
from video_dqn_tpu_torch.sim.fake_env import DEFAULT_MAZE
from video_dqn_tpu_torch.sim.mesh_env import MeshNavEnv
from video_dqn_tpu_torch.sim.mesh_twin import TwinMesh
from video_dqn_tpu_torch.sim.native_mesh import NativeMesh
from tests import torch_port_util  # caps torch threads per worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MAZE = [
    "########",
    "#......#",
    "#..##..#",
    "#..##..#",
    "#......#",
    "########",
]
# host library against the numpy twin: float32 against float64 arithmetic
DEPTH_ATOL = 1e-4
RGB_SHARE = 0.999          # pixels within +-1 of the twin's colour
# two surfaces this close along a ray are coplanar faces (a wall's end
# against another wall, a slab against the foot of a wall on it): which of
# them a pixel shows is the BVH's order, and either colour is right
TIE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()
    jax_native_mesh._tried = jax_native_mesh._lib is not None
    assert jax_native_mesh.available()


def both(fn_name, *args, **kw):
    """The same generator in both packages, checked equal; the port's."""
    got, want = getattr(meshgen, fn_name)(*args, **kw), getattr(jax_meshgen, fn_name)(*args, **kw)
    assert len(got) == len(want)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got


def assert_same_env(got, want):
    assert got.floor_heights == want.floor_heights and got.num_floors == want.num_floors
    assert got._grid_shape == want._grid_shape
    np.testing.assert_array_equal(got._lo, want._lo)
    np.testing.assert_array_equal(got._hi, want._hi)
    for f in range(got.num_floors):
        np.testing.assert_array_equal(got.navigable_grid(f), want.navigable_grid(f))
    # the probe sweep's surfaces (slots past each column's count are undefined)
    np.testing.assert_array_equal(got._cnt, want._cnt)
    live = np.arange(got._ys.shape[1])[None, :] < got._cnt[:, None]
    np.testing.assert_array_equal(got._ys[live], want._ys[live])
    np.testing.assert_array_equal(got._oks[live], want._oks[live])
    np.testing.assert_array_equal(got.pos, want.pos)


def assert_same_obs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def rgb_share(got, want, alt=None):
    """Share of pixels whose RGB lies within +-1 of `want` (or of `alt`)."""
    near = np.abs(got.astype(int) - want).max(-1) <= 1
    if alt is not None:
        near |= np.abs(got.astype(int) - alt).max(-1) <= 1
    return float(near.mean())


@pytest.mark.parametrize("scene", ["wall", "furnished"])
def test_render_host_library_matches_twin_and_jax(scene):
    if scene == "wall":
        v, f, c = both("wall_scene", distance=2.0)
        poses = np.array([[0.0, 0.0, 0.0, 0.0], [0.3, 0.1, 0.5, 0.7]])
    else:
        v, f, c, _ = both("furnished_house_mesh")
        poses = np.array([[4.45, 1.25 + h, 5.95 - h, 0.4 + k * math.pi / 6]
                          for h in (0.0, 3.0) for k in range(6)])
    size = 24
    cam = get_camera_matrix(size, size, 90.0)
    assert cam == jax_camera(size, size, 90.0)
    dn, rn = NativeMesh(v, f, c).render(poses, size, cam, 10.0)
    dt, rt, rt2 = TwinMesh(v, f, c).render(poses, size, cam, 10.0, tie_tol=TIE_TOL)
    np.testing.assert_allclose(dn, dt, rtol=0, atol=DEPTH_ATOL)
    assert rgb_share(rn, rt, rt2) > RGB_SHARE
    # the JAX package's host library: the same source, the same bits
    dj, rj = jax_native_mesh.NativeMesh(v, f, c).render(poses, size, cam, 10.0)
    np.testing.assert_array_equal(dn, dj)
    np.testing.assert_array_equal(rn, rj)
    # the twins: equal depths; the Lambert dot of a matrix product moves a
    # colour by one where it lands on an integer
    dw, rw = JaxTwinMesh(v, f, c).render(poses, size, cam, 10.0)
    np.testing.assert_array_equal(dt, dw)
    assert np.abs(rt.astype(int) - rw).max() <= 1
    if scene == "furnished":   # coplanar faces: the tie colours are needed
        assert (rt2 != rt).any() and rgb_share(rn, rt) < 1.0


def test_render_depth_analytic():
    """Flat wall perpendicular to the view at 2 m: z-buffer depth is 2.0
    across the whole wall (not the euclidean ray length)."""
    nm = NativeMesh(*meshgen.wall_scene(distance=2.0))
    cam = get_camera_matrix(33, 33, 90.0)
    d, _ = nm.render(np.array([[0.0, 0.0, 0.0, 0.0]]), 33, cam, 10.0)
    assert abs(d[0, 16, 16] - 2.0) < 1e-3
    assert abs(d[0, 16, 2] - 2.0) < 1e-3  # edge column, same z-depth
    assert abs(d[0, 4, 16] - 2.0) < 1e-3


def test_floor_levels_and_column_blocked_match_jax():
    v, f, c = both("maze_mesh", SMALL_MAZE)
    nm, tm, jm = NativeMesh(v, f, c), TwinMesh(v, f, c), jax_native_mesh.NativeMesh(v, f, c)
    rng = np.random.default_rng(0)
    xz = rng.uniform(0.05, 3.95, size=(40, 2))
    yn, okn, cn = nm.floor_levels(xz, 4.0, -1.0, 1.25)
    yt, okt, ct = tm.floor_levels(xz, 4.0, -1.0, 1.25)
    yj, okj, cj = jm.floor_levels(xz, 4.0, -1.0, 1.25)
    np.testing.assert_array_equal(cn, ct)
    np.testing.assert_array_equal(cn, cj)
    for i in range(len(xz)):
        np.testing.assert_allclose(yn[i, :cn[i]], yt[i, :ct[i]], atol=1e-4)
        np.testing.assert_array_equal(okn[i, :cn[i]], okt[i, :ct[i]])
        np.testing.assert_array_equal(yn[i, :cn[i]], yj[i, :cj[i]])
        np.testing.assert_array_equal(okn[i, :cn[i]], okj[i, :cj[i]])
    lo, hi = np.full(40, 0.2, np.float32), np.full(40, 1.25, np.float32)
    bn = nm.column_blocked(xz, lo, hi, 0.05)
    np.testing.assert_array_equal(bn, tm.column_blocked(xz, np.full(40, 0.2),
                                                        np.full(40, 1.25), 0.05))
    np.testing.assert_array_equal(bn, jm.column_blocked(xz, lo, hi, 0.05))
    assert bn.any() and not bn.all()
    # the single drop probe
    for got, want in zip(nm.floor_probe(xz, 4.0, 5.0, 1.25), jm.floor_probe(xz, 4.0, 5.0, 1.25)):
        np.testing.assert_array_equal(got, want)
    yt1, okt1 = tm.floor_probe(xz, 4.0, 5.0, 1.25)
    np.testing.assert_allclose(nm.floor_probe(xz, 4.0, 5.0, 1.25)[0], yt1, atol=1e-4)


def test_raycast_and_bounds_match_jax():
    v, f, c = both("maze_mesh", SMALL_MAZE)
    nm, tm, jm = NativeMesh(v, f, c), TwinMesh(v, f, c), jax_native_mesh.NativeMesh(v, f, c)
    for got, want in ((nm.bounds(), tm.bounds()), (nm.bounds(), jm.bounds())):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    o = np.array([[1.2, 0.5, 1.2]] * 4, np.float32)
    d = np.array([[1, 0, 0], [0, -1, 0], [0.7, 0.1, 0.7], [0, 1, 0]], np.float32)
    tn, trin = nm.raycast(o, d)
    tt, trit = tm.raycast(o, d)
    np.testing.assert_allclose(tn[:3], tt[:3], rtol=1e-4)
    assert (trin[:3] >= 0).all() and trin[3] == -1 and np.isinf(tn[3])
    np.testing.assert_array_equal(trin, trit)
    tj, trij = jm.raycast(o, d)
    np.testing.assert_array_equal(tn, tj)
    np.testing.assert_array_equal(trin, trij)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_ply_roundtrip_matches_jax(tmp_path, binary):
    v, f, c = both("maze_mesh", SMALL_MAZE)
    for colors in (c, None):
        mine, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
        ply.write_ply(mine, v, f, colors=colors, binary=binary)
        jax_ply.write_ply(theirs, v, f, colors=colors, binary=binary)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        v2, f2, c2 = ply.read_ply(theirs)
        np.testing.assert_allclose(v2, v, rtol=1e-6)
        np.testing.assert_array_equal(f2, f)
        for got, want in zip((v2, f2, c2), jax_ply.read_ply(theirs)):
            np.testing.assert_array_equal(got, want)
        if colors is None:
            assert c2 is None
        else:
            np.testing.assert_array_equal(c2, c)


def test_obj_read_matches_jax(tmp_path):
    p = str(tmp_path / "tri.obj")
    with open(p, "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2/1 4/2 3/3\n"
                 "f -4 -3 -2 -1\n")
    v, f, c = ply.load_mesh(p)
    assert v.shape == (4, 3) and f.shape == (4, 3) and c is None
    np.testing.assert_array_equal(f[1], [1, 3, 2])
    jv, jf, jc = jax_ply.load_mesh(p)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert jc is None


@pytest.fixture(scope="module")
def maze_envs():
    """(port, JAX) MeshNavEnv over the extruded default maze, 32 px."""
    mesh = both("maze_mesh", DEFAULT_MAZE)
    return (MeshNavEnv(mesh=mesh, image_size=32, seed=0, num_floors=1),
            JaxMeshNavEnv(mesh=mesh, image_size=32, seed=0, num_floors=1))


def test_maze_env_navigability_matches_jax(maze_envs):
    env, jenv = maze_envs
    assert isinstance(env.mesh, NativeMesh)
    assert_same_env(env, jenv)
    assert env.floor_heights == [0.0]
    assert not env._navigable(0.25, 0.25, 0)   # wall cell
    assert env._navigable(1.25, 1.25, 0)       # open cell
    # movement + collision, in both packages
    for e in (env, jenv):
        e.set_agent_state(np.array([1.25, 0.0, 1.25]), math.pi)
        e.step(0)
    np.testing.assert_allclose(env.pos, [1.25, 0.0, 1.5], atol=1e-6)
    np.testing.assert_array_equal(env.pos, jenv.pos)
    for e in (env, jenv):
        e.set_agent_state(np.array([0.75, 0.0, 1.25]), math.pi / 2)
        e.step(0)  # west wall ahead
    np.testing.assert_allclose(env.pos, [0.75, 0.0, 1.25], atol=1e-6)
    np.testing.assert_array_equal(env.pos, jenv.pos)
    assert env.topdown_extent() == jenv.topdown_extent()
    assert env._blocked(0.25, 0.25) and not env._blocked(1.25, 1.25)


def test_maze_env_geodesics_match_jax(maze_envs):
    """The port's FMM over the port's grid gives the JAX package's
    geodesics bit for bit (both libraries built with FMA contraction,
    -march=native); and the mesh-probed navigability reproduces the
    occupancy-grid world's geodesics within a grid resolution."""
    env, jenv = maze_envs
    rng = np.random.default_rng(5)
    pts = [env._cell_center(zi, xi, 0) for zi, xi in
           zip(*[a[rng.permutation(len(a))[:6]] for a in np.nonzero(env.navigable_grid(0))])]
    pts += [np.array([0.3, 0.0, 0.3]), np.array([9.2, 0.0, 8.6])]   # off the grid: snapped
    for a in pts:
        for b in pts[:4]:
            assert env.geodesic_distance(a, b) == jenv.geodesic_distance(a, b)
    a, b = np.array([1.25, 0.0, 1.25]), np.array([8.25, 0.0, 8.25])
    gm, gf = env.geodesic_distance(a, b), JaxFakeNavEnv(image_size=16).geodesic_distance(a, b)
    assert np.isfinite(gm) and np.isfinite(gf) and abs(gm - gf) < 0.8
    env.goals, jenv.goals = [b], [b]
    env.set_agent_state(a, 0.0)
    jenv.set_agent_state(a, 0.0)
    assert env.distance_to_goal() == jenv.distance_to_goal()
    env.goals, jenv.goals = [], []


def test_maze_env_panorama_and_obs_match_jax(maze_envs):
    env, jenv = maze_envs
    for e in (env, jenv):
        e.set_agent_state(np.array([1.25, 0.0, 1.25]), 0.3)
    obs = env.get_observation()
    assert obs["rgb"].shape == (32, 32, 3) and obs["depth"].shape == (32, 32, 1)
    assert obs["depth"].min() > 0
    assert_same_obs(obs, jenv.get_observation())
    pano = env.get_observation(force_panorama=True)
    assert pano["rgb"].shape == (4, 32, 32, 3)
    assert pano["depth"].shape == (4, 32, 32, 1)
    assert_same_obs(pano, jenv.get_observation(force_panorama=True))
    for action in (1, 0, 0, 2, 0):
        g, w = env.step(action), jenv.step(action)
        assert_same_obs(g[0], w[0])
        assert g[1:] == w[1:]
        np.testing.assert_array_equal(env.pos, jenv.pos)


def test_sample_start_states_match_jax(maze_envs):
    env, jenv = maze_envs
    for e in (env, jenv):
        e._rng = np.random.default_rng(17)
    for _ in range(5):
        (pos, ang), (jpos, jang) = env.sample_start_state(0), jenv.sample_start_state(0)
        np.testing.assert_array_equal(pos, jpos)
        assert ang == jang
        assert abs(pos[1] - 0.0) < 1e-6
        assert env._navigable(pos[0], pos[2], 0)
        assert 0 <= ang < 2 * math.pi
    for e in (env, jenv):
        e.set_agent_state(np.array([1.25, 0.0, 1.25]), 0.0)
    np.testing.assert_array_equal(env.sample_reachable_goal(0), jenv.sample_reachable_goal(0))


@pytest.fixture(scope="module")
def ramp_envs():
    """(port, JAX) pairs of ramp-house envs, stairs refused and allowed."""
    mesh = both("ramp_house_mesh")
    return [(MeshNavEnv(mesh=mesh, image_size=24, seed=1, allow_stairs=stairs),
             JaxMeshNavEnv(mesh=mesh, image_size=24, seed=1, allow_stairs=stairs))
            for stairs in (False, True)]


def test_ramp_house_two_floors_match_jax(ramp_envs):
    (env, jenv), _ = ramp_envs
    assert_same_env(env, jenv)
    assert len(env.floor_heights) == 2
    assert abs(env.floor_heights[0] - 0.0) < 0.1
    assert abs(env.floor_heights[1] - 3.0) < 0.1
    assert env.navigable_grid(0).sum() > 100
    assert env.navigable_grid(1).sum() > 100
    # cross-floor geodesics are inf (the documented same-floor scope)
    a, _ = env.sample_start_state(0)
    b, _ = env.sample_start_state(1)
    assert env.geodesic_distance(a, b) == jenv.geodesic_distance(a, b) == float("inf")


def climb(pair, steps):
    """Walk both envs up the ramp from its foot; equal positions each step."""
    env, jenv = pair
    x_ramp = 12 * 0.5 - 0.4
    for e in pair:
        e.set_agent_state(np.array([x_ramp, 0.0, 0.3]), math.pi)
    for _ in range(steps):
        g, w = env.step(0), jenv.step(0)
        np.testing.assert_array_equal(env.pos, jenv.pos)
        assert_same_obs(g[0], w[0])
    return env


def test_stair_rejection_undo_matches_jax(ramp_envs):
    """Climbing the ramp without allow_stairs: once the floor height under
    the agent deviates > 0.2 m from every known floor, the move is undone."""
    env = climb(ramp_envs[0], 10)
    assert env.pos[1] <= 0.2 + 1e-6        # never beyond the tolerance
    assert env.pos[2] < 1.5                 # stuck near the ramp base


def test_nav_grid_build_and_step_warning_free():
    """Columns with no floor (outside the maze walls, over void) give NaN
    probe slots from the peeling probe; the env holds them as +inf, never
    through NaN comparisons that warn."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        env = MeshNavEnv(mesh=meshgen.maze_mesh(SMALL_MAZE), image_size=24, seed=3)
        pos, ang = env.sample_start_state(0)
        env.set_agent_state(pos, ang)
        for a in (0, 1, 0, 2, 0, 0):  # forward probes hit no-floor columns
            env.step(a)
        ys, oks, cnt = env._probe_levels(np.array([[-50.0, -50.0]]))
        assert np.isfinite(ys[oks]).all()
        assert not np.isnan(ys).any()


def test_stairs_allowed_climbs_like_jax(ramp_envs):
    env = climb(ramp_envs[1], 30)
    assert abs(env.pos[1] - env.floor_heights[1]) < 0.2
    assert env._floor_of(env.pos[1]) == 1


def run_both(tmp_path, episodes, jax_episodes, env_factories, house_factories, **over):
    """The same geodesic episodes through both packages' run_policy; the
    results each wrote, (port, JAX)."""
    out = []
    for tag, defaults, runner, eps, env_f, house_f, reader, kw in (
            ("jax", jax_eval_defaults, jax_run_policy, jax_episodes, env_factories[1],
             house_factories[1], JaxDiskReader, {"visualize_every": 10 ** 9}),
            ("port", get_eval_defaults, run_policy, episodes, env_factories[0],
             house_factories[0], DiskReader,
             {"scorer_factory": lambda env, ci: make_geodesic_scorer(env),
              "visualize_every": 0, "device": "cpu"})):
        cfg = defaults()
        cfg.SCORE, cfg.SLAM, cfg.SEED = "geodesic", True, 1
        for k, v in over.items():
            cfg[k] = v
        cfg.RESULT_LOCATION = str(tmp_path / tag)
        cfg.VIDEO_LOCATION = str(tmp_path / f"videos_{tag}")  # JAX's episode 0 is visualised
        runner(cfg, episodes=eps, env_factory=env_f, house_factory=house_f, **kw)
        out.append(reader(str(tmp_path / tag / name_from_config(cfg))).data())
    return out


def assert_same_logs(got, want):
    assert set(got) == set(want) and len(want) > 0
    for k in want:
        assert len(got[k]) == len(want[k]) > 0
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g[0], w[0])      # position
            assert list(g[1:]) == list(w[1:])              # rot, travel, dist, first


def test_eval_episode_on_mesh_scene_matches_jax(tmp_path):
    """A whole geodesic episode (SLAM planner, macro-step policy) on the
    extruded maze in both packages: the same episode row and SPL."""
    env, house, ep = make_mesh_env_and_episode(goal_cells=(6, 6), start_cells=(2, 2), size=48)
    jenv, jhouse, jep = jax_mesh_episode(goal_cells=(6, 6), start_cells=(2, 2), size=48)
    assert list(ep[:4]) == list(jep[:4]) and np.array_equal(ep[4], jep[4]) and ep[5] == jep[5]
    assert np.isfinite(ep[3])
    got, want = run_both(tmp_path, np.array([ep], dtype=object), np.array([jep], dtype=object),
                         (lambda h, mc, c: env, lambda h, mc, c: jenv),
                         (lambda name: house, lambda name: jhouse))
    assert got == want and 0.5 < got[0] <= 1.0


def test_eval_episode_from_ply_file_matches_jax(tmp_path):
    """A scene loaded from a PLY file on disk (the real-scene code path)."""
    v, f, c = both("maze_mesh", SMALL_MAZE)
    p = str(tmp_path / "scene.ply")
    ply.write_ply(p, v, f, colors=c)
    env, house, ep = make_mesh_env_and_episode(size=24, mesh_path=p, seed=3)
    jenv, _, jep = jax_mesh_episode(size=24, mesh_path=p, seed=3)
    assert_same_env(env, jenv)
    assert list(ep[:4]) == list(jep[:4]) and np.array_equal(ep[4], jep[4]) and ep[5] == jep[5]
    obs = env.get_observation()
    assert obs["rgb"].shape == (24, 24, 3)
    assert_same_obs(obs, jenv.get_observation())
    assert np.isfinite(ep[3])


def test_glb_roundtrip_matches_jax(tmp_path):
    """write_glb -> read_glb keeps geometry and colours; load_mesh takes
    the .glb extension (the format Gibson scenes ship in)."""
    v, f, c = both("maze_mesh", SMALL_MAZE)
    for colors in (c, None):
        mine, theirs = str(tmp_path / "port.glb"), str(tmp_path / "jax.glb")
        ply.write_glb(mine, v, f, colors=colors)
        jax_ply.write_glb(theirs, v, f, colors=colors)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        v2, f2, c2 = ply.read_glb(theirs)
        np.testing.assert_allclose(v2, v, rtol=1e-6)
        np.testing.assert_array_equal(f2.reshape(-1), f.reshape(-1))
        if colors is None:
            assert c2 is None
        else:
            np.testing.assert_array_equal(c2, c)
        v3, f3, _ = ply.load_mesh(theirs)
        jv3, jf3, _ = jax_ply.load_mesh(theirs)
        np.testing.assert_array_equal(v3, jv3)
        np.testing.assert_array_equal(f3, jf3)


def test_glb_node_transform_matches_jax(tmp_path):
    """Node TRS transforms apply to primitive positions."""
    v, f, c = both("maze_mesh", SMALL_MAZE)
    p = str(tmp_path / "t.glb")
    ply.write_glb(p, v, f)
    with open(p, "rb") as fh:
        data = fh.read()
    jlen, = struct.unpack_from("<I", data, 12)
    doc = json.loads(data[20:20 + jlen])
    doc["nodes"][0]["translation"] = [1.0, 2.0, 3.0]
    doc["nodes"][0]["scale"] = [1.0, 0.5, 2.0]
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    rest = data[20 + jlen:]
    with open(p, "wb") as fh:
        fh.write(struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + len(rest)))
        fh.write(struct.pack("<I4s", len(js), b"JSON"))
        fh.write(js)
        fh.write(rest)
    v2, _, _ = ply.read_glb(p)
    np.testing.assert_allclose(v2, v * np.array([1, 0.5, 2], np.float32)
                               + np.array([1, 2, 3], np.float32), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(v2, jax_ply.read_glb(p)[0])


def write_house(root, name="TestHouse"):
    v, f, c = both("maze_mesh", SMALL_MAZE)
    ply.write_glb(str(root / f"{name}.glb"), v, f, colors=c)


def test_gibson_get_env_opens_the_mesh_like_jax(tmp_path, monkeypatch):
    """GibsonHouse.get_env finds <name>.glb under GIBSON_LOCATION and opens
    the mesh simulator with the house's floor count; without a mesh it
    raises the JAX package's RuntimeError."""
    monkeypatch.setenv("GIBSON_LOCATION", str(tmp_path))
    house = gibson.GibsonHouse.__new__(gibson.GibsonHouse)
    house.name = "TestHouse"
    jhouse = jax_gibson.GibsonHouse.__new__(jax_gibson.GibsonHouse)
    jhouse.name = "TestHouse"
    with pytest.raises(RuntimeError, match="no scene mesh for TestHouse"):
        gibson.GibsonHouse.get_env(house, num_floors=1)
    write_house(tmp_path)
    env = gibson.GibsonHouse.get_env(house, num_floors=1, image_size=24)
    jenv = jax_gibson.GibsonHouse.get_env(jhouse, num_floors=1, image_size=24)
    assert isinstance(env, MeshNavEnv) and isinstance(env.mesh, NativeMesh)
    obs = env.get_observation()
    assert obs["rgb"].shape == (24, 24, 3)
    assert len(env.floor_heights) == 1
    assert_same_env(env, jenv)
    assert_same_obs(obs, jenv.get_observation())


def test_gibson_get_env_passes_the_house_floor_count(tmp_path, monkeypatch):
    """Without num_floors, get_env passes GibsonHouse.num_floors (here the
    scene graph's) as the JAX package does."""
    monkeypatch.setenv("GIBSON_LOCATION", str(tmp_path))
    graphs = tmp_path / "graphs"
    gibson.make_synthetic_scene_graph(str(graphs / "3DSceneGraph_TestHouse.npz"), "TestHouse")
    write_house(tmp_path)
    house = gibson.GibsonHouse({"id": "TestHouse", "split_tiny": "val"},
                               scene_graph_dir=str(graphs))
    jhouse = jax_gibson.GibsonHouse({"id": "TestHouse", "split_tiny": "val"},
                                    scene_graph_dir=str(graphs))
    assert house.num_floors == jhouse.num_floors == 1
    env = house.get_env(image_size=16)
    assert_same_env(env, jhouse.get_env(image_size=16))
    assert env.num_floors == 1
    assert house.get_env(env_factory=lambda path, **kw: (path, kw), image_size=8) == \
        (str(tmp_path / "TestHouse.glb"), {"image_size": 8})


def test_render_grid_sees_the_same_mesh_env(tmp_path, maze_envs):
    """The JAX package's visualisation-grid producer (viz/render_grid.py)
    reads the port's mesh env through the NavEnv interface and writes what
    it writes from the JAX package's env (the port's own render_grid is
    held to JAX's in tests/test_torch_viz.py)."""
    from video_dqn_tpu.viz.render_grid import render_grid

    counts = []
    for tag, env in zip(("port", "jax"), maze_envs):
        env.set_agent_state(np.array([1.25, 0.0, 1.25]), 0.0)
        counts.append(render_grid(env, str(tmp_path / tag), resolution=6))
    assert counts[0] == counts[1] > 4
    files = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "port" / "*.jpg")))
    assert len(files) == 4 * counts[0]
    for name in files:
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read()
    info = np.load(str(tmp_path / "port" / "info.npy"), allow_pickle=True).item()
    assert info["map_resolution"] == 6


@pytest.fixture(scope="module")
def furnished():
    """((port env, house), (JAX env, house)) in the furnished house, 48 px."""
    return make_furnished_house(seed=2), jax_furnished_house(seed=2)


def furnished_episodes(env, house):
    episodes = []
    for floor, cls in ((0, "bed"), (1, "chair")):
        start, ang = env.sample_start_state(floor)
        goals = gibson.relevant_locations(start, house.object_locations_for_habitat_dest[cls])
        assert goals, f"no same-floor goals for {cls} on floor {floor}"
        gd = min(env.geodesic_distance(start, g) for g in goals)
        assert np.isfinite(gd)
        episodes.append(("FurnishedHouse", floor, cls, gd, start, ang))
    return np.array(episodes, dtype=object)


@pytest.mark.parametrize("stop", [True, False], ids=["step_logs", "spl"])
def test_furnished_house_episodes_match_jax(tmp_path, furnished, stop):
    """The closest asset-free stand-in for a Gibson evaluation: the
    two-floor furnished house, per-class furniture goals, rooms and doors,
    one episode on each floor through both packages' run_policy: equal
    step logs (STOP mode runs each to MAX_STEPS) and equal SPL."""
    (env, house), (jenv, jhouse) = furnished
    assert_same_env(env, jenv)
    assert house.object_locations_for_habitat_dest.keys() == \
        jhouse.object_locations_for_habitat_dest.keys()
    for cls, pts in house.object_locations_for_habitat_dest.items():
        np.testing.assert_array_equal(pts, jhouse.object_locations_for_habitat_dest[cls])
    for e in (env, jenv):
        e._rng = np.random.default_rng(8)
    episodes, jax_episodes = furnished_episodes(env, house), furnished_episodes(jenv, jhouse)
    for g, w in zip(episodes, jax_episodes):
        assert list(g[:4]) == list(w[:4]) and np.array_equal(g[4], w[4]) and g[5] == w[5]
    got, want = run_both(tmp_path, episodes, jax_episodes,
                         (lambda h, mc, c: env, lambda h, mc, c: jenv),
                         (lambda name: house, lambda name: jhouse), STOP=stop)
    if stop:
        assert_same_logs(got, want)
    else:
        assert got == want and max(got.values()) > 0.0


def test_clone_shares_geometry_but_not_state(maze_envs):
    """clone() shares the BVH and nav grids (no re-probe) but gives each
    episode its own agent state, goals, RNG and caches, as the JAX
    package's clone does."""
    env, jenv = maze_envs
    for e in (env, jenv):
        e.set_agent_state(np.array([1.25, 0.0, 1.25]), 0.0)
    c, jc = env.clone(seed=9), jenv.clone(seed=9)
    assert c.mesh is env.mesh
    assert c.navigable_grid(0) is env.navigable_grid(0)
    np.testing.assert_array_equal(c.sample_start_state(0)[0], jc.sample_start_state(0)[0])
    c.set_agent_state(np.array([3.25, 0.0, 3.25]), 1.0)
    c.goals = [np.array([5.0, 0.0, 5.0])]
    assert not np.allclose(c.pos, env.pos)
    assert env.goals != c.goals
    c.step(0)
    assert np.allclose(env.pos, [1.25, 0.0, 1.25])  # original untouched


# ---- foreign GLB files (not written by either package's writer) ------------

def _build_glb(doc: dict, bin_bytes: bytes) -> bytes:
    """Pack a spec-conformant GLB: header + padded JSON chunk + BIN chunk."""
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    bb = bin_bytes + b"\x00" * ((-len(bin_bytes)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bb)
    out = struct.pack("<4sII", b"glTF", 2, total)
    out += struct.pack("<I4s", len(js), b"JSON") + js
    out += struct.pack("<I4s", len(bb), b"BIN\x00") + bb
    return out


def test_read_glb_foreign_layouts_match_jax(tmp_path):
    """Spec features the writer never emits: interleaved byteStride views,
    uint16 indices and colours, a TRS node hierarchy, COLOR_0 present in
    one primitive and absent in another, a non-indexed primitive."""
    pos1 = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    col1 = np.array([[65535, 0, 0], [0, 65535, 0], [0, 0, 65535],
                     [65535, 65535, 0]], np.uint16)
    idx1 = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    pos2 = np.array([[2, 0, 0], [3, 0, 0], [2, 1, 0]], np.float32)
    inter = b""
    for p, c in zip(pos1, col1):   # pos (12 B) + colour (6 B) + 2 B pad: stride 20
        inter += p.tobytes() + c.tobytes() + b"\x00\x00"
    off_idx = len(inter)
    binb = inter + idx1.tobytes()
    binb += b"\x00" * ((-len(binb)) % 4)
    off_pos2 = len(binb)
    binb += pos2.tobytes()
    s2 = float(np.sqrt(0.5))
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"translation": [1.0, 0.0, 0.0], "children": [1]},
            # 90 deg about +Y, scale x2 in x: TRS composes as T*R*S
            {"rotation": [0.0, s2, 0.0, s2], "scale": [2.0, 1.0, 1.0], "mesh": 0},
        ],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "COLOR_0": 1}, "indices": 2},
            {"attributes": {"POSITION": 3}},  # non-indexed, no colour
        ]}],
        "buffers": [{"byteLength": len(binb)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(inter), "byteStride": 20},
            {"buffer": 0, "byteOffset": off_idx, "byteLength": idx1.nbytes},
            {"buffer": 0, "byteOffset": off_pos2, "byteLength": pos2.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126,
             "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5123,
             "count": 4, "type": "VEC3", "normalized": True},
            {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": 3, "type": "VEC3"},
        ],
    }
    p = tmp_path / "foreign.glb"
    p.write_bytes(_build_glb(doc, binb))
    verts, faces, colors = ply.read_glb(str(p))
    rot = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float64)
    m3 = rot @ np.diag([2.0, 1.0, 1.0])
    t = np.array([1.0, 0.0, 0.0])
    want = np.concatenate([pos1 @ m3.T + t, pos2 @ m3.T + t]).astype(np.float32)
    assert verts.shape == (7, 3)
    np.testing.assert_allclose(verts, want, atol=1e-5)
    np.testing.assert_array_equal(
        faces, np.concatenate([idx1.reshape(-1, 3), np.arange(3).reshape(1, 3) + 4]))
    assert colors is None  # mixed presence: no colour channel
    jverts, jfaces, jcolors = jax_ply.read_glb(str(p))
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    assert jcolors is None
    # with colour in every primitive, uint16 colours scale to uint8
    doc["meshes"][0]["primitives"] = doc["meshes"][0]["primitives"][:1]
    p.write_bytes(_build_glb(doc, binb))
    got, want = ply.read_glb(str(p)), jax_ply.read_glb(str(p))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]])


def test_read_glb_unsupported_fail_loudly_like_jax(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    base = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "buffers": [{"byteLength": pos.nbytes}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"}],
    }
    sparse = {**base, "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}]}
    sparse["accessors"] = [dict(base["accessors"][0],
                                sparse={"count": 1, "indices": {}, "values": {}})]
    draco = {**base, "meshes": [{"primitives": [
        {"attributes": {"POSITION": 0},
         "extensions": {"KHR_draco_mesh_compression": {"bufferView": 0}}}]}]}
    for name, doc, match in (("sparse", sparse, "sparse"), ("draco", draco, "Draco")):
        p = tmp_path / f"{name}.glb"
        p.write_bytes(_build_glb(doc, pos.tobytes()))
        for reader in (ply.read_glb, jax_ply.read_glb):
            with pytest.raises(NotImplementedError, match=match):
                reader(str(p))
    p = tmp_path / "not.glb"
    p.write_bytes(b"glTX" + bytes(20))
    with pytest.raises(AssertionError, match="not a GLB"):
        ply.read_glb(str(p))


@pytest.mark.parametrize("name,args", [
    ("maze_mesh", (SMALL_MAZE,)), ("ramp_house_mesh", ()), ("wall_scene", ()),
    ("furnished_house_mesh", ())], ids=["maze", "ramp", "wall", "furnished"])
def test_generators_match_jax(name, args):
    got = both(name, *args)
    if name == "furnished_house_mesh":
        want = jax_meshgen.furnished_house_mesh()[3]
        assert got[3].keys() == want.keys() == set(gibson.CLASS_LABELS)
        for cls in want:
            np.testing.assert_array_equal(got[3][cls], want[cls])
    assert meshgen._FURNITURE == jax_meshgen._FURNITURE


def test_env_uses_the_host_library_and_never_falls_back(monkeypatch):
    """use_native None or True: the host library, whose failed load
    raises; False: the numpy twin, whose grids are the JAX twin's (float64
    probes: columns that touch a wall exactly can fall the other way than
    in the host library's float32)."""
    mesh = meshgen.maze_mesh(SMALL_MAZE)
    twin = MeshNavEnv(mesh=mesh, image_size=16, seed=3, use_native=False)
    native = MeshNavEnv(mesh=mesh, image_size=16, seed=3, use_native=True)
    assert isinstance(twin.mesh, TwinMesh) and isinstance(native.mesh, NativeMesh)
    assert_same_env(twin, JaxMeshNavEnv(mesh=mesh, image_size=16, seed=3, use_native=False))
    assert twin.floor_heights == native.floor_heights

    def broken():
        raise RuntimeError("building libvdqn_host.so failed")

    monkeypatch.setattr(_build, "load_host", broken)
    with pytest.raises(RuntimeError, match="libvdqn_host"):
        MeshNavEnv(mesh=mesh, image_size=16)
    with pytest.raises(ValueError, match="mesh or a mesh_path"):
        MeshNavEnv()


# ---- the sim task config (tests/test_sim_config.py) ------------------------

def test_sim_defaults_and_yaml_merge_match_jax():
    path = os.path.join(ROOT, "configs/tasks/pointnav_rgbd.yml")
    cfg, jcfg = sim_config.get_config(path), jax_sim_config.get_config(path)
    assert cfg.to_dict() == jcfg.to_dict()
    assert sim_config.get_sim_defaults().to_dict() == jax_sim_config.get_sim_defaults().to_dict()
    assert cfg.SIMULATOR.RGB_SENSOR.WIDTH == 224
    assert cfg.SIMULATOR.TURN_ANGLE == 30
    assert cfg.ENVIRONMENT.MAX_EPISODE_STEPS == 1000000
    assert cfg.is_frozen and jcfg.is_frozen
    kw = sim_config.env_kwargs_from_config(cfg)
    assert kw == jax_sim_config.env_kwargs_from_config(jcfg)
    assert kw["image_size"] == 224 and kw["forward_step"] == 0.25


def test_multi_file_merge_matches_jax(tmp_path):
    a = tmp_path / "a.yml"
    a.write_text("SIMULATOR:\n  TURN_ANGLE: 10\n")
    b = tmp_path / "b.yml"
    b.write_text("SIMULATOR:\n  TURN_ANGLE: 15\n  FORWARD_STEP_SIZE: 0.5\n")
    opts = ["TASK.SUCCESS_DISTANCE", "0.3", "SIMULATOR.ALLOW_STAIRS", "False"]
    cfg = sim_config.get_config(f"{a},{b}", opts)
    assert cfg.SIMULATOR.TURN_ANGLE == 15  # later file wins
    assert cfg.TASK.SUCCESS_DISTANCE == 0.3 and cfg.SIMULATOR.ALLOW_STAIRS is False
    assert cfg.to_dict() == jax_sim_config.get_config(f"{a},{b}", opts).to_dict()
    with pytest.raises(Exception, match="unknown config key"):
        sim_config.get_config(None, ["SIMULATOR.NO_SUCH_KEY", "1"])


def test_class_colors_table_matches_jax():
    colors = gibson.class_colors()
    assert set(colors) == {"bed", "chair", "couch", "dining table", "toilet"}
    assert colors["bed"] == (175, 124, 222)
    assert colors == jax_gibson.class_colors()


def test_house_floor_override_fallback_matches_jax(tmp_path):
    # no scene graph: the floor count falls back to the override table
    d = {"id": "Allensville", "split_tiny": "none", "stats": {"floor": 9}}
    assert gibson.GibsonHouse(d).num_floors == jax_gibson.GibsonHouse(d).num_floors == 1
    # a scene graph wins when there is one
    sg = tmp_path / "graphs"
    gibson.make_synthetic_scene_graph(str(sg / "3DSceneGraph_Fake.npz"), "Fake")
    h2 = gibson.GibsonHouse({"id": "Fake", "split_tiny": "val"}, scene_graph_dir=str(sg))
    j2 = jax_gibson.GibsonHouse({"id": "Fake", "split_tiny": "val"}, scene_graph_dir=str(sg))
    assert h2.num_floors == j2.num_floors == 1
    locs = h2.object_locations
    assert len(locs["toilet"]) == 2
    for cls in gibson.CLASS_LABELS:
        np.testing.assert_array_equal(locs[cls], j2.object_locations[cls])
    assert len(h2.objects["toilet"][0]) == 4

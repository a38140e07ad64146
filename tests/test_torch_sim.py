"""The port's simulators against the JAX package's: the fake env's
renders (C++ and Python renderers), steps, collisions and geodesics, the
Gibson house metadata and scene-graph objects, and the canonical FMM
planner's action search."""

import json

import numpy as np
import pytest

from video_dqn_tpu.plan.fmm_planner import FMMPlanner as JaxFMMPlanner
from video_dqn_tpu.sim import fake_env as jax_fake_env
from video_dqn_tpu.sim import gibson as jax_gibson
from video_dqn_tpu_torch.plan.fmm_planner import FMMPlanner
from video_dqn_tpu_torch.sim import fake_env, gibson
from tests import torch_port_util  # caps torch threads per worker


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "python"])
def test_fake_env_renders_and_steps_like_jax(native):
    want = jax_fake_env.FakeNavEnv(image_size=40, seed=3, use_native=native)
    got = fake_env.FakeNavEnv(image_size=40, seed=3, use_native=native)
    assert got.use_native is native
    for env in (want, got):
        env.set_agent_state(np.array([1.0, 0.0, 1.0]), 0.0)
        env.goals = [np.array([6.25, 0.0, 7.25])]
    for action in (0, 0, 0, 0, 1, 0, 0, 2, 2, 0, 1, 1):  # into the wall, then away
        w, g = want.step(action), got.step(action)
        np.testing.assert_array_equal(g[0]["rgb"], w[0]["rgb"])
        np.testing.assert_array_equal(g[0]["depth"], w[0]["depth"])
        assert g[2] == w[2]
        np.testing.assert_array_equal(got.pos, want.pos)
        assert got.angle == want.angle and got.distance_to_goal() == want.distance_to_goal()
    pan_w, pan_g = want.get_observation(True), got.get_observation(True)
    assert pan_g["rgb"].shape == (4, 40, 40, 3)
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(pan_g[k], pan_w[k])
    for env in (want, got):
        env._rng = np.random.default_rng(11)
    assert [tuple(got.sample_start_state()[0]) for _ in range(5)] == \
        [tuple(want.sample_start_state()[0]) for _ in range(5)]
    assert got.geodesic_distance([0.1, 0, 0.1], [1, 0, 1]) == float("inf")  # a wall


def test_the_cpp_renderer_follows_the_python_oracle():
    cpp, py = (fake_env.FakeNavEnv(image_size=32, use_native=n) for n in (True, False))
    for env in (cpp, py):
        env.set_agent_state(np.array([4.3, 0.0, 2.2]), 0.7)
    a, b = cpp.get_observation(), py.get_observation()
    np.testing.assert_allclose(a["depth"], b["depth"], rtol=0, atol=1e-5)
    assert (a["rgb"].astype(int) - b["rgb"]).max() <= 1


def test_gibson_metadata_and_scene_graphs_match_jax(tmp_path, monkeypatch):
    assert gibson.CLASS_LABELS == jax_gibson.CLASS_LABELS
    assert gibson.class_colors() == jax_gibson.class_colors()
    assert gibson.MEDIUM_INVERSE_TRAIN_NAMES == jax_gibson.MEDIUM_INVERSE_TRAIN_NAMES
    graph, jax_graph = tmp_path / "graphs", tmp_path / "jax_graphs"
    for name in ("Adrian", "Corozal"):
        gibson.make_synthetic_scene_graph(str(graph / f"3DSceneGraph_{name}.npz"), name,
                                          seed=len(name))
        jax_gibson.make_synthetic_scene_graph(str(jax_graph / f"3DSceneGraph_{name}.npz"),
                                              name, seed=len(name))
    meta = [{"id": "Adrian", "split_tiny": "train", "stats": {"floor": 3}},
            {"id": "Corozal", "split_tiny": "val", "split_medium": "val"}]
    (tmp_path / "metadata.json").write_text(json.dumps(meta))
    monkeypatch.setenv("GIBSON_LOCATION", str(tmp_path))
    for name in ("Adrian", "Corozal"):
        got = gibson.get_house(name, scene_graph_dir=str(graph))
        want = jax_gibson.get_house(name, scene_graph_dir=str(jax_graph))
        assert got.num_floors == want.num_floors
        for cls in gibson.CLASS_LABELS:
            np.testing.assert_array_equal(got.objects[cls], want.objects[cls])
            np.testing.assert_array_equal(got.object_locations_for_habitat_dest[cls],
                                          want.object_locations_for_habitat_dest[cls])
        agent = got.object_locations_for_habitat_dest["bed"][0] - np.array([0, 0.5, 0])
        pts = got.object_locations_for_habitat_dest["chair"]
        np.testing.assert_array_equal(gibson.relevant_locations(agent, pts),
                                      jax_gibson.relevant_locations(agent, pts))
        assert len(gibson.relevant_objects(agent, got.objects["toilet"])) == \
            len(jax_gibson.relevant_objects(agent, want.objects["toilet"]))
    assert [h.name for h in gibson.get_house_split("tiny_val")] == ["Corozal"]
    with pytest.raises(KeyError):
        gibson.get_house("Nowhere")
    # no mesh under GIBSON_LOCATION: both packages raise the same error
    for package in (gibson, jax_gibson):
        with pytest.raises(RuntimeError, match="no scene mesh for Adrian under GIBSON_LOCATION"):
            package.get_house("Adrian").get_env()
    assert gibson.get_house("Adrian").get_env(env_factory=lambda path: path).endswith(
        "Adrian.glb")


@pytest.mark.parametrize("goal", [(12, 8), (3, 30), (30, 30)])
def test_fmm_planner_matches_jax(goal):
    rng = np.random.default_rng(sum(goal))
    trav = rng.random((40, 40)) < 0.85
    trav[18:22, :] = True
    got, want = FMMPlanner(trav, 12), JaxFMMPlanner(trav, 12)
    assert got.action_list == want.action_list
    np.testing.assert_array_equal(got.set_goal(goal), want.set_goal(goal))
    np.testing.assert_array_equal(got.fmm_dist, want.fmm_dist)
    for state in ([20.5, 20.5, 0.0], [5.2, 19.0, 1.3], [35.0, 21.0, -2.0]):
        g, w = got.get_action(state), want.get_action(state)
        assert g[0] == w[0] and g[2] == w[2]
        np.testing.assert_array_equal(g[1], w[1])
        assert got.compare_goal(state) == want.compare_goal(state)
    assert np.isinf(got.distances((50, 3))).all()

"""The port's evaluation harness against the JAX package's on the same
fake-env episodes: the sequential runner with the geodesic oracle (equal
step logs and SPL), result shards read across the packages, run names,
config loading, the evaluate and results CLIs (the mesh flags too), the
mesh and furnished-house workloads, and what the port refuses.
The model-scored batched runs are in tests/test_torch_eval_episode.py."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from video_dqn_tpu.core.disk_logger import DiskLogger as JaxDiskLogger
from video_dqn_tpu.core.disk_logger import DiskReader as JaxDiskReader
from video_dqn_tpu.eval import get_eval_defaults as jax_eval_defaults
from video_dqn_tpu.eval import load_file as jax_load_file
from video_dqn_tpu.eval import make_geodesic_scorer as jax_geodesic
from video_dqn_tpu.eval import name_from_config as jax_name
from video_dqn_tpu.eval import run_policy as jax_run_policy
from video_dqn_tpu.eval.fixtures import make_episode_set as jax_episode_set
from video_dqn_tpu_torch import evaluate as evaluate_cli
from video_dqn_tpu_torch import results as results_cli
from video_dqn_tpu_torch.core.disk_logger import DiskLogger, DiskReader
from video_dqn_tpu_torch.data.png import read_png
from video_dqn_tpu_torch.eval.batched_runner import run_policy_batched
from video_dqn_tpu_torch.eval.evaluate import make_geodesic_scorer, ours_evaluate
from video_dqn_tpu_torch.eval.fixtures import make_env_and_episode, make_episode_set
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults, load_file, name_from_config
from video_dqn_tpu_torch.eval.runner import build_detector_from_config, run_policy
from tests.test_batched_eval import SIZE, build_fixtures
from tests import torch_port_util  # caps torch threads per worker

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()


def cfgs(**over):
    """The same eval config in both packages."""
    out = []
    for defaults in (jax_eval_defaults, get_eval_defaults):
        cfg = defaults()
        for k, v in over.items():
            cfg[k] = v
        out.append(cfg)
    return out


NAMED = [
    {},
    {"SCORE": "model", "MODEL_NAME": "vlv", "SLAM": True, "BACKTRACK_REJECTION": True,
     "CONSISTENCY_WEIGHT": 0.5, "COMBINE_DETECTOR": True, "CONFIDENCE_THRESHOLD": 0.9,
     "SEED": 2, "STAIRS": True},
    {"TOTAL_RANDOM": True, "DATASET": "test"},
    {"HABITAT_POLICY": True, "HABITAT_FRAMES": 5e6, "HABITAT_LOG": True},
    {"HABITAT_POLICY": True, "HABITAT_CHECKPOINT": 12},
    {"ACT_ON_Q": True, "MODEL_NAME": "m", "Q_STOCHASTIC": True},
    {"BEHAVIOR_CLONING": True, "STOP": True, "BEHAVIOR_LOG": True, "BEHAVIOR_REAL": True,
     "BEHAVIOR_FINETUNE": True, "BEHAVIOR_NONEG": True, "BEHAVIOR_MASK": True},
    {"BEHAVIOR_CLONING": True, "BEHAVIOR_PANORAMA": True},
    {"CHASE_DETECTOR": True, "FORWARD_SCORE": True, "PREVIOUS_IMAGES_REPLICATE": True,
     "PREVIOUS_IMAGES_ROTATE": True, "FORWARD_IMAGES": True, "FORWARD_IMAGE_STEPS": 6,
     "HALLUCINATE": True, "SINGLE_MODEL_PANORAMA": True, "MODEL_NUMBER": 150000},
]


@pytest.mark.parametrize("over", NAMED, ids=range(len(NAMED)))
def test_run_names_are_byte_equal(over):
    want, got = cfgs(**over)
    assert name_from_config(got).encode() == jax_name(want).encode()
    assert set(got) == set(want)
    assert {k: got[k] for k in got if k != "MODEL_CONFIG"} == \
        {k: want[k] for k in want if k != "MODEL_CONFIG"}


def test_load_file_matches_jax(tmp_path):
    model_dir = tmp_path / "model_exp"
    model_dir.mkdir()
    (model_dir / "config.yml").write_text("PANORAMA: False\nGAMMA: 0.9\nTPU:\n  IMAGE_SIZE: 64\n")
    base = tmp_path / "base.yml"
    base.write_text("SLAM: True\nSEED: 3\nCONSISTENCY_WEIGHT: 0.25\n")
    child = tmp_path / "child.yml"
    child.write_text(f"INHERIT: '{base}'\nSCORE: 'model'\n"
                     f"MODEL_CONFIG_LOCATION: '{model_dir}'\nSEED: 5\n")
    want, got = jax_load_file(str(child)), load_file(str(child))
    assert got.to_dict() == want.to_dict()
    assert got.SEED == 5 and got.SLAM is True and got.MODEL_CONFIG.TPU.IMAGE_SIZE == 64
    assert name_from_config(got) == jax_name(want)


def test_result_shards_read_across_packages(tmp_path):
    values = {0: 0.5, 3: np.array([[np.zeros(3), 0.1, 0.25, 1.5, True]], dtype=object)}
    for writer, reader in ((JaxDiskLogger, DiskReader), (DiskLogger, JaxDiskReader)):
        folder = tmp_path / writer.__module__
        log = writer(str(folder))
        for k, v in values.items():
            log.write(k, v)
        writer(str(folder)).write(7, 1.0)  # a second shard
        got = reader(str(folder)).data()
        assert set(got) == {0, 3, 7} and got[0] == 0.5
        assert got[3][0][2] == 0.25
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / "x.npy").write_bytes(b"not a shard")
    assert DiskReader(str(tmp_path / "torn")).data() == {}


def read_results(cfg, reader):
    return reader(str(Path(cfg.RESULT_LOCATION) / name_from_config(cfg))).data()


def assert_same_logs(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], dtype=object), np.asarray(want[k], dtype=object)
        assert g.shape == w.shape and len(w) > 0
        for gr, wr in zip(g, w):
            np.testing.assert_array_equal(gr[0], wr[0])          # position
            assert list(gr[1:]) == list(wr[1:])                  # rot, travel, dist, first


@pytest.mark.parametrize("stop,batched", [(True, True), (False, True), (False, False)],
                         ids=["step_logs", "spl", "spl_reference_order"])
def test_sequential_geodesic_runs_match_jax(tmp_path, stop, batched):
    """BATCHED_REASONING False maps and scores a stop's views one at a time,
    in the reference's order."""
    want_cfg, got_cfg = cfgs(SLAM=True, SEED=1, STOP=stop, BATCHED_REASONING=batched)
    want_cfg.RESULT_LOCATION = str(tmp_path / "jax")
    got_cfg.RESULT_LOCATION = str(tmp_path / "port")
    want_cfg.VIDEO_LOCATION = str(tmp_path / "videos")  # JAX's episode 0 is visualised
    # in STOP mode an episode runs on past its goal to MAX_STEPS: one will do
    n = 1 if stop else 2
    want_eps, want_env, want_house = jax_episode_set(n, size=32, seed=4)
    got_eps, got_env, got_house = make_episode_set(n, size=32, seed=4)
    for g, w in zip(got_eps, want_eps):
        assert list(g[:4]) == list(w[:4]) and np.array_equal(g[4], w[4]) and g[5] == w[5]
    jax_run_policy(want_cfg, want_eps, env_factory=want_env, house_factory=want_house,
                   scorer_factory=lambda env, ci: jax_geodesic(env), visualize_every=10 ** 9)
    run_policy(got_cfg, got_eps, env_factory=got_env, house_factory=got_house,
               scorer_factory=lambda env, ci: make_geodesic_scorer(env), visualize_every=0,
               device="cpu")
    want = read_results(want_cfg, JaxDiskReader)
    got = read_results(got_cfg, DiskReader)
    if stop:
        assert_same_logs(got, want)
    else:
        assert got == want and max(got.values()) > 0


def port_fresh_env(house, config=None):
    env, _, _ = make_env_and_episode(size=SIZE)
    env.goals = []
    return env


def test_batched_gather_watchdog_raises_on_stall(tmp_path):
    episodes, houses = build_fixtures()
    _, cfg = cfgs(SLAM=True, SEED=1, RESULT_LOCATION=str(tmp_path))
    gathers = []

    def gather(handle):
        gathers.append(1)
        if len(gathers) > 1:
            import time

            time.sleep(5.0)  # a stalled device
        return handle

    stalling = lambda images, cls: gather(np.zeros(len(images)))  # noqa: E731
    stalling.dispatch = lambda images, cls: np.zeros(len(images))
    stalling.gather = gather
    with pytest.raises(RuntimeError, match="stalled past .*resume"):
        run_policy_batched(cfg, episodes, env_factory=port_fresh_env,
                           house_factory=lambda name: houses[name], scorer=stalling,
                           class_index_of=True, max_concurrent=2, gather_timeout=1.0,
                           debug=True, device="cpu")


def load_jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli", ROOT / "evaluation" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_evaluate_cli_writes_what_the_jax_cli_writes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    # without -v both CLIs visualise episode 0: its strip goes under tmp_path
    videos = f"VIDEO_LOCATION: '{tmp_path / 'videos'}'\n"
    for tag in ("jax", "port"):
        (tmp_path / f"{tag}.yml").write_text(
            f"SLAM: True\nSEED: 1\nSTOP: True\nRESULT_LOCATION: '{tmp_path / tag}'\n" + videos)
    monkeypatch.setattr(sys, "argv", ["run.py", "--fake-env", str(tmp_path / "jax.yml")])
    load_jax_cli("run").main()
    evaluate_cli.main(["--fake-env", str(tmp_path / "port.yml")], device="cpu")
    want_cfg, got_cfg = jax_load_file(str(tmp_path / "jax.yml")), load_file(str(tmp_path / "port.yml"))
    assert_same_logs(read_results(got_cfg, DiskReader), read_results(want_cfg, JaxDiskReader))
    capsys.readouterr()
    # the results CLIs print the same lines over the same shards
    spl_cfg = tmp_path / "spl.yml"
    spl_cfg.write_text(f"SLAM: True\nSEED: 1\nRESULT_LOCATION: '{tmp_path / 'spl'}'\n"
                       + videos)
    evaluate_cli.main(["--fake-env", str(spl_cfg)], device="cpu")
    capsys.readouterr()
    assert results_cli.main([str(spl_cfg)], device="cpu") > 0
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["results.py", str(spl_cfg)])
    load_jax_cli("results").main()
    assert capsys.readouterr().out == mine
    assert results_cli.main([str(tmp_path / "spl" / name_from_config(load_file(str(spl_cfg)))),
                             "--folder"], device="cpu") > 0


@pytest.mark.parametrize("flags", [["--mesh-env"], ["--mesh-scene", "scene.ply"],
                                   ["--furnished-env", "--workload", "1"], ["-v", "--fake-env"]],
                         ids=["mesh_env", "mesh_scene", "furnished_env", "visualize"])
def test_evaluate_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, flags):
    """The mesh flags and -v refused until their items were ported; now
    each runs one episode as the JAX CLI does, with the same SPL, and -v
    writes the episode's strip under the same name with the same pixels."""
    from video_dqn_tpu.sim.meshgen import maze_mesh
    from video_dqn_tpu.sim.ply import write_ply

    monkeypatch.chdir(tmp_path)  # no evaluation/val_episodes.npy here
    write_ply(str(tmp_path / "scene.ply"), *maze_mesh(["#######", "#.....#", "#..#..#",
                                                       "#.....#", "#######"]))
    for tag in ("jax", "port"):
        (tmp_path / f"{tag}.yml").write_text(
            f"SLAM: True\nSEED: 1\nRESULT_LOCATION: '{tmp_path / tag}'\n"
            f"VIDEO_LOCATION: '{tmp_path / ('videos_' + tag)}'\n")
    monkeypatch.setattr(sys, "argv", ["run.py", *flags, str(tmp_path / "jax.yml")])
    load_jax_cli("run").main()
    assert evaluate_cli.main([*flags, str(tmp_path / "port.yml")], device="cpu") is not None
    got = read_results(load_file(str(tmp_path / "port.yml")), DiskReader)
    want = read_results(jax_load_file(str(tmp_path / "jax.yml")), JaxDiskReader)
    assert got == want and list(got) == [0]
    strips = [sorted(p.relative_to(tmp_path / f"videos_{tag}")
                     for p in (tmp_path / f"videos_{tag}").rglob("*.png"))
              for tag in ("port", "jax")]
    assert strips[0] == strips[1] and len(strips[0]) == 1  # episode 0, with -v or without
    got = read_png(str(tmp_path / "videos_port" / strips[0][0]))
    want = np.asarray(Image.open(tmp_path / "videos_jax" / strips[1][0]))
    if "-v" in flags:  # the fake env renders bit-equal
        np.testing.assert_array_equal(got, want)
    else:  # a mesh pixel on two coplanar faces may show either (test_torch_mesh_sim.py)
        assert got.shape == want.shape and (got != want).any(axis=-1).mean() < 1e-3


@pytest.mark.parametrize("over", [{"SCORE": "detector"}, {"COMBINE_DETECTOR": True},
                                  {"CHASE_DETECTOR": True}, {"DETECTOR_WEIGHTS": "stub"}],
                         ids=["score", "combine", "chase", "weights"])
def test_detector_configs_raise_naming_item_7(over, tmp_path, capsys):
    """Detector configs raised until ROADMAP item 7 was ported. Now each
    builds what the JAX package builds: the stub for DETECTOR_WEIGHTS:
    'stub' with SCORE: detector or COMBINE_DETECTOR, nothing for
    CHASE_DETECTOR (it only names the run) or the weights alone; the
    episode's step log and the "Detector calls" line equal JAX's. A
    detector mode without DETECTOR_WEIGHTS raises ValueError in both."""
    from video_dqn_tpu.eval import build_detector_from_config as jax_build_detector

    want_cfg, got_cfg = cfgs(**{"SLAM": True, "SEED": 1, "STOP": True,
                                "DETECTOR_WEIGHTS": "stub", **over})
    got_det, want_det = build_detector_from_config(got_cfg, "cpu"), jax_build_detector(want_cfg)
    assert type(got_det).__name__ == type(want_det).__name__
    assert (got_det is None) == ("SCORE" not in over and "COMBINE_DETECTOR" not in over)
    want_cfg.RESULT_LOCATION = str(tmp_path / "jax")
    got_cfg.RESULT_LOCATION = str(tmp_path / "port")
    want_cfg.VIDEO_LOCATION = str(tmp_path / "videos")  # JAX's episode 0 is visualised
    want_eps, want_env, want_house = jax_episode_set(1, size=32, seed=4)
    got_eps, got_env, got_house = make_episode_set(1, size=32, seed=4)
    calls = []
    capsys.readouterr()
    jax_run_policy(want_cfg, want_eps, env_factory=want_env, house_factory=want_house,
                   scorer_factory=lambda env, ci: jax_geodesic(env), visualize_every=10 ** 9)
    calls.append([ln for ln in capsys.readouterr().out.splitlines() if "Detector" in ln])
    run_policy(got_cfg, got_eps, env_factory=got_env, house_factory=got_house,
               scorer_factory=lambda env, ci: make_geodesic_scorer(env), visualize_every=0,
               device="cpu")
    calls.append([ln for ln in capsys.readouterr().out.splitlines() if "Detector" in ln])
    assert_same_logs(read_results(got_cfg, DiskReader), read_results(want_cfg, JaxDiskReader))
    assert calls[0] == calls[1] and len(calls[0]) == (got_det is not None)
    if got_det is not None:
        want_cfg.DETECTOR_WEIGHTS = got_cfg.DETECTOR_WEIGHTS = ""
        for build in (lambda: build_detector_from_config(got_cfg, "cpu"),
                      lambda: jax_build_detector(want_cfg)):
            with pytest.raises(ValueError, match="DETECTOR_WEIGHTS"):
                build()
    assert build_detector_from_config(get_eval_defaults()) is None


def test_mesh_backends_raise_naming_item_6b():
    """The mesh and furnished backends build the JAX package's 1-episode
    sets (they raised until the mesh simulators were ported)."""
    for backend in ("mesh", "furnished"):
        got, _, got_house = make_episode_set(1, size=24, seed=3, backend=backend)
        want, _, want_house = jax_episode_set(1, size=24, seed=3, backend=backend)
        assert len(got) == len(want) == 1
        assert list(got[0][:4]) == list(want[0][:4]) and got[0][5] == want[0][5]
        np.testing.assert_array_equal(got[0][4], want[0][4])
        got_pts = got_house(got[0][0]).object_locations_for_habitat_dest
        want_pts = want_house(want[0][0]).object_locations_for_habitat_dest
        for cls in want_pts:
            np.testing.assert_array_equal(got_pts[cls], want_pts[cls])
    with pytest.raises(ValueError, match="unknown backend"):
        make_episode_set(1, backend="habitat")


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfgs(RESULT_LOCATION=str(tmp_path))
    env, house, ep = make_env_and_episode()
    for call in (lambda: run_policy(cfg, np.array([ep], dtype=object)),
                 lambda: run_policy_batched(cfg, [ep], None, None, None),
                 lambda: ours_evaluate(cfg, env, ep, house, 0, make_geodesic_scorer(env)),
                 lambda: evaluate_cli.main(["--fake-env", "no.yml"]),
                 lambda: evaluate_cli.main(["--mesh-env", "no.yml"]),
                 lambda: evaluate_cli.main(["--mesh-scene", "no.ply", "no.yml"]),
                 lambda: results_cli.main(["no.yml"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_evaluate_cli_model_scored_batched_equals_sequential(tmp_path, monkeypatch, capsys):
    """The CLI's two model-scored paths over the same generated workload:
    --batched (fused cross-episode scoring, 2 cohorts) and sequential
    (a scorer per episode) end with the same SPL."""
    from video_dqn_tpu_torch.models.qnet import HabitatDQN, init_qnet

    monkeypatch.chdir(tmp_path)  # no evaluation/val_episodes.npy here
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.yml").write_text(
        "ARCHITECTURE: 'basic'\nPANORAMA: False\nTPU:\n  IMAGE_SIZE: 32\n")
    model = init_qnet(HabitatDQN(action_dim=3, extra_capacity=False, panorama=False,
                                 image_size=32), torch.Generator().manual_seed(4))
    torch.save({"model_state_dict": model.state_dict()}, tmp_path / "qnet.torch")
    videos = f"VIDEO_LOCATION: '{tmp_path / 'videos'}'\n"  # the sequential run's episode 0
    spl = {}
    for tag, flags in (("batched", ["--batched", "2", "--pipeline-depth", "2"]),
                       ("sequential", [])):
        (tmp_path / f"{tag}.yml").write_text(
            f"SCORE: 'model'\nSLAM: True\nSEED: 1\nMODEL_CONFIG_LOCATION: '{model_dir}'\n"
            f"PRETRAINED_MODEL_LOCATION: '{tmp_path / 'qnet.torch'}'\n"
            f"RESULT_LOCATION: '{tmp_path / tag}'\n" + videos)
        evaluate_cli.main([str(tmp_path / f"{tag}.yml"), "--workload", "2", *flags],
                          device="cpu")
        cfg = load_file(str(tmp_path / f"{tag}.yml"))
        spl[tag] = read_results(cfg, DiskReader)
    assert "running sequentially" not in capsys.readouterr().out
    assert spl["batched"].keys() == spl["sequential"].keys() == {0, 1}
    for k in (0, 1):
        np.testing.assert_allclose(spl["batched"][k], spl["sequential"][k], rtol=0, atol=1e-5)

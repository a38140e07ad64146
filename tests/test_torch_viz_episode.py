"""The port's episode visualisation and visualisation CLIs against the JAX
package's: the planner's per-step frames (render_map_rgb exactly, after
every agent step of geodesic fake-env episodes) and each stop's captioned
strip (`current_pan`) pixel for pixel, the strip run_policy
writes under VIDEO_LOCATION (the same name, the same pixels), results
unchanged by visualising, and the visualize_value and visualize_panorama
CLIs against the root JAX CLIs (each value-map pixel within one of
viridis' 256 levels of JAX's, since the float32 maps, within 1e-4, may
cross a step of the colormap's index; the strip exactly; the analysis's
correlations within the JAX CLI's printed precision)."""

import importlib.util
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from video_dqn_tpu.core.disk_logger import DiskReader as JaxDiskReader
from video_dqn_tpu.data import qlearning as jax_qlearning
from video_dqn_tpu.eval import evaluate as jax_evaluate_mod
from video_dqn_tpu.eval import make_geodesic_scorer as jax_geodesic
from video_dqn_tpu.eval import run_policy as jax_run_policy
from video_dqn_tpu.eval.fixtures import make_episode_set as jax_episode_set
from video_dqn_tpu.sim.fake_env import FakeNavEnv as JaxFakeNavEnv
from video_dqn_tpu.viz.panorama import join_images as jax_join_images
from video_dqn_tpu.viz.render_grid import render_grid as jax_render_grid
from video_dqn_tpu_torch import visualize_panorama, visualize_value
from video_dqn_tpu_torch.core.checkpoint import save_checkpoint
from video_dqn_tpu_torch.core.disk_logger import DiskReader
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.data.jpeg import load_images
from video_dqn_tpu_torch.data.png import read_png
from video_dqn_tpu_torch.eval import evaluate as evaluate_mod
from video_dqn_tpu_torch.eval.evaluate import make_geodesic_scorer
from video_dqn_tpu_torch.eval.fixtures import make_episode_set
from video_dqn_tpu_torch.eval.runner import run_policy
from video_dqn_tpu_torch.plan import mapper as mapper_mod
from video_dqn_tpu_torch.plan.visualize import draw_map
from video_dqn_tpu_torch.sim.gibson import CLASS_LABELS
from video_dqn_tpu_torch.train.dqn import create_train_state, flax_state_dict
from video_dqn_tpu_torch.viz import colormaps
from tests import torch_port_util
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)
from tests.test_torch_eval_harness import assert_same_logs, cfgs, read_results

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()


def recording_planners(monkeypatch):
    """Record every planner each package's episode makes: [port, JAX]. Each
    port planner's `frames` lists every logged frame as JAX's planner
    lists them (rgbs, depths, maps; a rotation twice), its map drawn
    from the layers `log_frame` kept; each planner's `stop_pans` lists every
    strip its stops set as `current_pan`."""
    made = [[], []]
    log_frame = mapper_mod.log_frame

    def recording_log_frame(planner, obs, action):
        log_frame(planner, obs, action)
        rgb, d8, layers = planner.last_frame
        planner.frames += [(rgb, d8, draw_map(*layers))] * (2 if action in (1, 2) else 1)

    monkeypatch.setattr(mapper_mod, "log_frame", recording_log_frame)
    for module, store in ((evaluate_mod, made[0]), (jax_evaluate_mod, made[1])):
        base = module.DepthMapperAndPlanner

        class Recording(base):
            def __init__(self, *a, _store=store, **kw):
                self.stop_pans = []
                super().__init__(*a, **kw)
                self.frames = []
                _store.append(self)

            @property
            def current_pan(self):
                return self._pan

            @current_pan.setter
            def current_pan(self, pan):
                self._pan = pan
                if pan is not None:
                    self.stop_pans.append(pan)

        monkeypatch.setattr(module, "DepthMapperAndPlanner", Recording)
    return made


@pytest.mark.parametrize("stop", [True, False], ids=["step_logs", "spl"])
def test_run_policy_visualises_as_jax(tmp_path, monkeypatch, stop):
    """visualize_every=1 with SLAM: every agent step's rgb, depth and map
    equal JAX's, the episode's strip lands under the same name with the
    same pixels, and the step logs (STOP mode) or SPL equal JAX's and
    those of the port's run without visualisation."""
    made = recording_planners(monkeypatch)
    n = 1 if stop else 2
    want_cfg, got_cfg = cfgs(SLAM=True, SEED=1, STOP=stop)
    for cfg, tag in ((want_cfg, "jax"), (got_cfg, "port")):
        cfg.RESULT_LOCATION = str(tmp_path / tag)
        cfg.VIDEO_LOCATION = str(tmp_path / f"videos_{tag}")
    want_eps, want_env, want_house = jax_episode_set(n, size=32, seed=4)
    got_eps, got_env, got_house = make_episode_set(n, size=32, seed=4)
    jax_run_policy(want_cfg, want_eps, env_factory=want_env, house_factory=want_house,
                   scorer_factory=lambda env, ci: jax_geodesic(env), visualize_every=1)
    run_policy(got_cfg, got_eps, env_factory=got_env, house_factory=got_house,
               scorer_factory=lambda env, ci: make_geodesic_scorer(env), visualize_every=1,
               device="cpu")
    got, want = read_results(got_cfg, DiskReader), read_results(want_cfg, JaxDiskReader)
    if stop:
        assert_same_logs(got, want)
    else:
        assert got == want and len(got) == n

    assert len(made[0]) == len(made[1]) == n
    for p, j in zip(*made):
        assert p.log_visualization and j.log_visualization
        assert len(p.frames) == len(j.maps) == len(j.rgbs) == len(j.depths) > 0
        for mine, theirs in zip(p.frames, zip(j.rgbs, j.depths, j.maps)):
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)
        # each stop's captioned strip, as JAX's
        assert len(p.stop_pans) == len(j.stop_pans) > 0
        for mine, theirs in zip(p.stop_pans, j.stop_pans):
            assert mine.shape == theirs.shape
            np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(p.current_pan, j.current_pan)

    names = [sorted(x.relative_to(tmp_path / f"videos_{tag}")
                    for x in (tmp_path / f"videos_{tag}").rglob("*.png"))
             for tag in ("port", "jax")]
    assert names[0] == names[1] and len(names[0]) == n
    for name in names[0]:
        np.testing.assert_array_equal(read_png(str(tmp_path / "videos_port" / name)),
                                      np.asarray(Image.open(tmp_path / "videos_jax" / name)))

    # the same run without visualisation gives the same results
    got_cfg.RESULT_LOCATION = str(tmp_path / "port_plain")
    run_policy(got_cfg, got_eps, env_factory=got_env, house_factory=got_house,
               scorer_factory=lambda env, ci: make_geodesic_scorer(env), visualize_every=0,
               device="cpu")
    plain = read_results(got_cfg, DiskReader)
    if stop:
        assert_same_logs(plain, got)
    else:
        assert plain == got
    assert not made[0][-1].log_visualization and made[0][-1].last_frame is None
    assert made[0][-1].frames == []


def load_root_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """An experiment folder of the basic single-frame net with a port-written
    sample7.ckpt, which both packages load."""
    folder = tmp_path_factory.mktemp("exp")
    (folder / "config.yml").write_text(
        "ARCHITECTURE: 'basic'\nPANORAMA: False\nSEED: 3\nTPU:\n  IMAGE_SIZE: 64\n"
        "  COMPUTE_DTYPE: 'float32'\n")  # the JAX package's eval net computes in it
    state = create_train_state(ExperimentConfig(str(folder)), device="cpu")
    state.step = 7
    save_checkpoint(str(folder / "models"), 7, flax_state_dict(state))
    return str(folder)


def viridis_levels(img: np.ndarray) -> np.ndarray:
    """(lowest, highest) level in viridis (0-255) each pixel's colour has
    (two pairs of neighbouring levels round to one uint8 colour), -1 where
    it is black (no cell); raises on any other colour."""
    table = (colormaps.VIRIDIS * 255).astype(np.uint8)
    levels = {(0, 0, 0): (-1, -1)}
    for i, rgb in enumerate(map(tuple, table)):
        levels[rgb] = (levels.get(rgb, (i, i))[0], i)
    return np.array([[levels[tuple(p)] for p in row] for row in img]).transpose(2, 0, 1)


def test_visualize_value_cli_matches_jaxs(experiment, tmp_path, monkeypatch, capsys):
    grid = str(tmp_path / "grid")
    jax_render_grid(JaxFakeNavEnv(image_size=64, seed=3), grid, resolution=5)
    # both CLIs score the same decoded pixels (the two JPEG decoders differ)
    monkeypatch.setattr(jax_qlearning, "_load_image",
                        lambda path, size: load_images([path], size)[0])
    flags = ["--data-root", grid, "--resolution", "5", "--image-size", "64"]
    monkeypatch.setattr(sys, "argv", ["visualize_value.py", experiment, *flags,
                                      "--out", str(tmp_path / "jax")])
    load_root_cli("visualize_value").main()
    want_out = capsys.readouterr().out
    written = visualize_value.main([experiment, *flags, "--out", str(tmp_path / "port")],
                                   device="cpu")
    assert capsys.readouterr().out.replace("port", "jax") == want_out
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert sorted(Path(p).name for p in written) == names and len(names) == 25
    for name in names:
        (lo, hi), (want_lo, want_hi) = (
            viridis_levels(read_png(str(tmp_path / "port" / name))),
            viridis_levels(np.asarray(Image.open(tmp_path / "jax" / name))))
        assert lo.shape == want_lo.shape
        assert (lo - want_hi).max() <= 1 and (want_lo - hi).max() <= 1, name
        np.testing.assert_array_equal(lo < 0, want_lo < 0)  # the cells off the grid
    # --model-number picks that checkpoint; another is not there
    with pytest.raises(FileNotFoundError):
        visualize_value.main([experiment, *flags, "--model-number", "8", "--out",
                              str(tmp_path / "none")], device="cpu")


def test_visualize_panorama_cli_matches_jaxs(experiment, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["visualize_panorama.py", "--size", "48", "--out",
                                      str(tmp_path / "jax.png")])
    jax_cli = load_root_cli("visualize_panorama")
    jax_cli.main()
    strip = visualize_panorama.main(["--size", "48", "--out", str(tmp_path / "port.png")],
                                    device="cpu")
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), strip)
    capsys.readouterr()

    flags = ["--size", "48", "--model-config", experiment]
    monkeypatch.setattr(sys, "argv", ["visualize_panorama.py", *flags, "--analysis",
                                      str(tmp_path / "jax_corr.png")])
    jax_cli.main()
    want = [float(v) for v in re.findall(r"corr\[.*\] = (\S+)", capsys.readouterr().out)]
    corrs = visualize_panorama.main([*flags, "--analysis", str(tmp_path / "port_corr.png")],
                                    device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[:5] == [f"corr[{c}] = {v:.3f}" for c, v in zip(CLASS_LABELS, corrs)]
    assert len(want) == 5 and np.isfinite(want).all()
    # JAX prints 3 decimals; the two float32 forwards agree within 1e-4
    np.testing.assert_allclose(corrs, want, rtol=0, atol=5e-4 + 1e-4)
    figure = read_png(str(tmp_path / "port_corr.png"))
    env = JaxFakeNavEnv(image_size=48)
    env.reset(reachable=False)
    pos, rot = env.agent_state()
    views = []
    for k in range(12):
        env.set_agent_state(pos, rot + 2 * math.pi * k / 12)
        views.append(env.get_observation()["rgb"])
    strip = jax_join_images(views)
    margin = figure.shape[1] - strip.shape[1]  # the class labels' column
    assert margin > 0 and (figure[:48, :margin] == 255).all()
    np.testing.assert_array_equal(figure[:48, margin:], strip)

    # without --model-config: a seeded extra_capacity net (the JAX CLI's flagship)
    corrs = visualize_panorama.main(["--size", "96", "--analysis",
                                     str(tmp_path / "seeded.png")], device="cpu")
    assert corrs.shape == (5,) and read_png(str(tmp_path / "seeded.png")).shape[0] > 96

"""The port's training CLI (python -m video_dqn_tpu_torch.train_q_network)
on the CPU, from the committed real-data fixture: it trains, writes
sample<N>.ckpt that the JAX package restores, resumes with -r, deletes old
runs with -d, writes the JAX package's `log` text, and its EMA loss tracks
the JAX CLI's on the same folder and the same rows."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

import train_q_network as jax_cli
from video_dqn_tpu.core import ExperimentConfig as JaxExperimentConfig
from video_dqn_tpu.core.checkpoint import restore_checkpoint as jax_restore
from video_dqn_tpu.parallel import make_mesh
from video_dqn_tpu.train import dqn as jax_dqn
from video_dqn_tpu_torch import train_q_network
from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.train.dqn import flax_state_dict
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from video_dqn_tpu_torch.sim.gibson import CLASS_LABELS
from video_dqn_tpu_torch.viz.render_grid import render_grid
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)
from tests.test_torch_checkpoint import jax_template, leaves_equal

ROOT = Path(__file__).resolve().parents[1]
# The EMA losses of the two CLIs after 2 and 4 steps from one checkpoint on
# the same rows, the JAX CLI decoding through PIL (VDQN_NATIVE_JPEG=0), whose
# transform the port's JPEG stage reproduces: the frames differ by decode
# rounding only (about 0.02 grey levels on average at 96 px), and the losses
# were 4.8e-4 apart (relative) when measured. Decoding both runs' frames with
# the port's stage brings them within 1.7e-7, so the gap is the frames';
# through the JAX package's native stage (swscale's resize) it is 2.1e-3.
EMA_RTOL = 2e-3

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)  # DATASET and its frame paths are relative to the repo root


def folder_with(path: Path, num_steps=4, extra="") -> str:
    """The published config cut to the CPU: 96 px, B = 4, float32."""
    path.mkdir(parents=True)
    (path / "config.yml").write_text(f"""DATASET: 'tests/data/torch_qdata/data.feather'
PANORAMA: False
CLASS_LABEL: 'all'
LOSS_CLIP: 'rect'
ARCHITECTURE: "extra_capacity"
LEARNING_RATE: 0.0001
GAMMA: 0.99
CHECKPOINT_INTERVAL: 2
NUM_STEPS: {num_steps}
TARGET_UPDATE_INTERVAL: 3
USE_INVERSE_ACTIONS: True
SEED: 4
{extra}TPU:
  BATCH_SIZE: 4
  IMAGE_SIZE: 96
  COMPUTE_DTYPE: float32
  MESH_DATA: 1
""")
    return str(path)


def test_cli_trains_resumes_deletes_and_logs(tmp_path, capsys):
    folder = folder_with(tmp_path / "exp")
    state, loss = train_q_network.main([folder, "--log-every", "2", "-g", "3"], device="cpu")
    out = capsys.readouterr().out
    assert "Load data from tests/data/torch_qdata/data.feather" in out and "Reward Ratio: " in out
    assert state.step == 4 and np.isfinite(loss)
    models = Path(folder) / "models"
    assert sorted(p.name for p in models.iterdir()) == ["sample2.ckpt", "sample4.ckpt"]
    # the JAX package restores the port's checkpoint, leaf for leaf
    tree = restore_checkpoint(str(models), 4)
    leaves_equal(tree, flax_state_dict(state))
    jcfg = JaxExperimentConfig(folder, resume=True, tensorboard=False)
    restored = jax_restore(str(models), 4, jax.device_get(jax_template(jcfg, tree)))
    assert int(restored.step) == 4
    # the log is the JAX package's text for the same folder
    ours = (Path(folder) / "log").read_text()
    jcfg.write_config_log()
    assert ours == (Path(folder) / "log").read_text()
    assert ours.startswith("Running with config (") and "IMAGE_SIZE: 96" in ours

    # -r: on from the latest checkpoint, in the same run folder
    text = (Path(folder) / "config.yml").read_text()
    (Path(folder) / "config.yml").write_text(text.replace("NUM_STEPS: 4", "NUM_STEPS: 6"))
    state, _ = train_q_network.main(["-r", folder, "--log-every", "2"], device="cpu")
    assert "Resuming from: 4" in capsys.readouterr().out and state.step == 6
    assert (models / "sample6.ckpt").exists()
    assert [r["step"] for r in read_metrics(f"{folder}/run1", "avg_q_loss/train")] == [2, 4, 6]

    # -d: the old runs go, the new run is run1 again
    (Path(folder) / "run7").mkdir()
    train_q_network.main(["-d", folder, "--log-every", "2"], device="cpu")
    assert sorted(p.name for p in Path(folder).glob("run*")) == ["run1"]


def test_cli_loss_tracks_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs BOOTSTRAP from one port checkpoint and draw the same rows
    (host-fed, the same seeded permutations)."""
    donor = folder_with(tmp_path / "donor", num_steps=2)
    train_q_network.main([donor, "--log-every", "2"], device="cpu")
    boot = f"BOOTSTRAP: True\nBOOTSTRAP_LOCATION: '{donor}/models'\n"
    ours = folder_with(tmp_path / "port", extra=boot)
    theirs = folder_with(tmp_path / "jax", extra=boot)
    train_q_network.main([ours, "--log-every", "2"], device="cpu")
    # TPU.MESH_DATA 1 on one of the harness's 8 virtual CPU devices, as on
    # a one-device host
    monkeypatch.setattr(jax_dqn, "make_mesh",
                        lambda data, model: make_mesh(data, model, devices=jax.devices()[:1]))
    monkeypatch.setenv("VDQN_NATIVE_JPEG", "0")
    monkeypatch.setattr(sys, "argv", ["train_q_network.py", theirs, "--log-every", "2"])
    jax_cli.main()
    got = read_metrics(f"{ours}/run1", "avg_q_loss/train")
    want = read_metrics(f"{theirs}/run1", "avg_q_loss/train")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want],
                               rtol=EMA_RTOL)
    assert (Path(ours) / "log").read_text() == (Path(theirs) / "log").read_text()


def test_cli_refuses_the_value_map_hook(tmp_path):
    """VISUALIZATION_DATA_ROOT raised until item 8a. Now each checkpoint is
    followed by one value map a class for every grid folder under it,
    under the JAX CLI's add_image names, and the run's checkpoints are
    bit-equal to those of the same run without it."""
    viz = tmp_path / "grids"
    cells = render_grid(FakeNavEnv(image_size=96, seed=3), str(viz / "fake_house"),
                        resolution=4)
    (viz / "notes.txt").write_text("not a grid folder")
    plain = folder_with(tmp_path / "plain")
    hooked = folder_with(tmp_path / "hooked", extra=f"VISUALIZATION_DATA_ROOT: '{viz}'\n")
    train_q_network.main([plain], device="cpu")
    train_q_network.main([hooked], device="cpu")
    pngs = sorted(p.name for p in (Path(hooked) / "run1").glob("*.png"))
    assert pngs == sorted(f"value_map_fake_house_{label}_{step}.png"
                          for label in CLASS_LABELS for step in (2, 4))
    assert not list((Path(plain) / "run1").glob("*.png"))
    for name in pngs:  # one pixel a grid cell, cropped to the grid's cells
        img = np.asarray(Image.open(Path(hooked) / "run1" / name))
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[0] * img.shape[1] >= cells
    for step in (2, 4):
        leaves_equal(restore_checkpoint(str(Path(hooked) / "models"), step),
                     restore_checkpoint(str(Path(plain) / "models"), step))

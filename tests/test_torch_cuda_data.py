"""The port's real-data training path on the card: the committed fixture
(tests/data/torch_qdata) read and decoded as its oracle says (the check of
tests/torch_qdata.py that the CPU tests and chip_smoke.py also run), and
the training CLI at B = 256, 224 px, bf16 in both data modes on the wide
feather, whose batches name nearly 512 distinct frame files each.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax, the JAX package, PIL nor pandas, so it runs where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_data.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch import train_q_network
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.ops import resize_normalize as rn
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)
import torch_qdata

ROOT = Path(__file__).resolve().parents[1]  # the fixture's paths are relative to it


@pytest.fixture(autouse=True)
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step's kernel has no CPU mode")
    monkeypatch.chdir(ROOT)


@pytest.mark.cuda
def test_fixture_reads_and_decodes_as_its_oracle():
    result = torch_qdata.check_oracle()  # raises where the port and the oracle differ
    assert result["frames"] == 32 and result["frame_mean_abs_diff_max"] < torch_qdata.MEAN_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("device_dataset", [True, False], ids=["device_dataset", "host_fed"])
def test_cli_trains_on_the_card_from_the_fixture(tmp_path, device_dataset):
    torch_qdata.link_wide_frames()
    folder = tmp_path / "exp"
    folder.mkdir()
    (folder / "config.yml").write_text(
        (ROOT / "configs/experiments/real_data/config.yml").read_text()
        .replace("dataset/data.feather", torch_qdata.WIDE_FEATHER)
        .replace("CHECKPOINT_INTERVAL: 25000", "CHECKPOINT_INTERVAL: 2")
        .replace("NUM_STEPS: 300000", "NUM_STEPS: 4")
        + f"TARGET_UPDATE_INTERVAL: 3\nTPU:\n  DEVICE_DATASET: {device_dataset}\n")
    rn.LAUNCHES.clear()
    # the card named: with no device the CLI takes every card of a machine of several
    state, loss = train_q_network.main([str(folder), "--log-every", "2"], device="cuda:0")
    assert state.step == 4 and np.isfinite(loss)
    assert dict(rn.LAUNCHES) == {("identity", "bfloat16"): 8}  # 2 a step, B = 256 at 224 px
    assert sorted(p.name for p in (folder / "models").iterdir()) == \
        ["sample2.ckpt", "sample4.ckpt"]
    assert [r["step"] for r in read_metrics(str(folder / "run1"), "avg_q_loss/train")] == [2, 4]

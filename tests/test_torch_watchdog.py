"""The port's stall watchdog (core/watchdog.py) and its arming in
run_train, as the JAX package arms it: VDQN_TRAIN_WATCHDOG_S over
TPU.STALL_TIMEOUT_S, the first deadline from TPU.STALL_FIRST_TIMEOUT_S or
max(timeout, 2700) on the card, a beat every step."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.core.watchdog import StallWatchdog
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.train import dqn
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)


def wait_for(pred, seconds):
    end = time.monotonic() + seconds
    while time.monotonic() < end and not pred():
        time.sleep(0.05)
    return pred()


def test_fires_after_beats_cease_and_reports_the_elapsed_time():
    fired = []
    wd = StallWatchdog(2.0, first_timeout_s=2.0, on_stall=fired.append)
    try:
        for _ in range(10):  # beats well inside the deadline
            time.sleep(0.05)
            wd.beat()
        assert not fired
        assert wait_for(lambda: fired, 30.0), "the watchdog never fired"
        assert fired[0] >= 2.0
    finally:
        wd.stop()


def test_first_deadline_grace_then_steady_deadline():
    fired = []
    wd = StallWatchdog(0.5, first_timeout_s=30.0, on_stall=fired.append)
    try:
        time.sleep(1.2)
        assert not fired, "fired during the first deadline"
        wd.beat()
        assert wait_for(lambda: fired, 20.0), "the steady deadline never fired"
    finally:
        wd.stop()


def test_stop_disarms():
    fired = []
    wd = StallWatchdog(0.2, on_stall=fired.append)
    wd.stop()
    time.sleep(0.8)
    assert not fired


def tpu(timeout=0, first=0):
    return SimpleNamespace(TPU=SimpleNamespace(STALL_TIMEOUT_S=timeout,
                                               STALL_FIRST_TIMEOUT_S=first))


@pytest.mark.parametrize("env,timeout,first,device,want", [
    ("", 0, 0, "cpu", None),
    ("0", 60, 0, "cpu", None),             # the variable turns it off
    ("", 60, 0, "cpu", (60.0, 60.0)),
    ("", 60, 0, "cuda", (60.0, 2700.0)),   # start-up grace on the card
    ("", 3000, 0, "cuda", (3000.0, 3000.0)),
    ("", 60, 90, "cuda", (60.0, 90.0)),
    (" 600 ", 0, 0, "cpu", (600.0, 600.0)),  # the variable alone arms it
    ("600", 60, 0, "cuda", (600.0, 2700.0)),
])
def test_arming_follows_the_reference(monkeypatch, env, timeout, first, device, want):
    monkeypatch.setenv("VDQN_TRAIN_WATCHDOG_S", env)
    wd = dqn.stall_watchdog(tpu(timeout, first), torch.device(device))
    try:
        got = None if wd is None else (wd.timeout_s, wd.first_timeout_s)
        assert got == want
    finally:
        if wd is not None:
            wd.stop()


def test_a_bad_variable_raises_the_reference_error(monkeypatch):
    monkeypatch.setenv("VDQN_TRAIN_WATCHDOG_S", "ten minutes")
    with pytest.raises(ValueError, match=r"VDQN_TRAIN_WATCHDOG_S='ten minutes' is not a "
                                         r"number .*\(0 disables the watchdog\)"):
        dqn.stall_watchdog(tpu(), torch.device("cpu"))


class StallingSource(TableSource):
    """A batch source that stalls after its first batch until released."""

    def __init__(self, tables):
        super().__init__(tables)
        self.stalled = threading.Event()
        self.release = threading.Event()

    def batches(self, batch_size):
        for i, batch in enumerate(super().batches(batch_size)):
            if i == 1:
                self.stalled.set()
                self.release.wait(60.0)
                self.stalled.clear()
            yield batch


@pytest.mark.parametrize("armed_by", ["variable", "config"])
def test_run_train_arms_the_watchdog(tmp_path, monkeypatch, armed_by):
    """A source that stalls after one batch: the armed watchdog fires (an
    injected on_stall releases the source), and the run then finishes.
    TPU.STALL_TIMEOUT_S no longer raises."""
    folder = tmp_path / "exp"
    folder.mkdir()
    (folder / "config.yml").write_text(f"""PANORAMA: False
ARCHITECTURE: "basic"
USE_INVERSE_ACTIONS: True
NUM_STEPS: 3
CHECKPOINT_INTERVAL: 100
TPU:
  BATCH_SIZE: 4
  IMAGE_SIZE: 32
  COMPUTE_DTYPE: float32
  STALL_FIRST_TIMEOUT_S: 60
  STALL_TIMEOUT_S: {3 if armed_by == "config" else 0}
""")
    if armed_by == "variable":
        monkeypatch.setenv("VDQN_TRAIN_WATCHDOG_S", "3")
    else:
        monkeypatch.delenv("VDQN_TRAIN_WATCHDOG_S", raising=False)
    source = StallingSource(synthetic_video_tables(8, 16, 32))
    fired = []

    def on_stall(elapsed):
        fired.append((elapsed, source.stalled.is_set()))
        source.release.set()

    class Injected(StallWatchdog):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw, on_stall=on_stall)

    monkeypatch.setattr(dqn, "StallWatchdog", Injected)
    state, _ = dqn.run_train(ExperimentConfig(str(folder)), batcher=source, log_every=1,
                             device="cpu")
    assert state.step == 3
    assert len(fired) == 1 and fired[0][0] >= 3.0 and fired[0][1]
    assert np.isfinite(state.ema_loss.item())

"""The training CLI's fleet flags (video_dqn_tpu_torch/train_q_network.py,
the JAX CLI's --coordinator, --num-processes, --process-id,
--multihost-platform and --local-devices): two processes of one gloo rank
each form the 2x1 mesh of the basic arch and train the committed fixture
(tests/data/torch_qdata/data.feather) as one process trains it at the same
global batch; only process 0 writes (each process gets a folder of its
own, as in the JAX package's fleet test). jax-free.

The loss trace is held to one process's within rtol 1e-4 plus twice that
trace's own spread: rtol 1e-4 alone is below the noise of 24 free-running
float32 steps on the CPU. Two one-process runs that differ only in
torch's thread count (the order of their reductions) part by 5.8e-4 of
the loss by step 17 for basic (2.8e-4 by step 24 for extra_capacity),
where the 2x1 fleet parted from one process by 5.8e-4. The test measures
that spread itself (1 thread against 4) each run. The first step, before
any update, is held at 1e-5: a wrong slice of the batch shows there."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.parallel.multihost import free_port
from video_dqn_tpu_torch.train_q_network import main
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

ROOT = Path(__file__).resolve().parents[1]
STEPS, EVERY, SYNC = 24, 8, 10
LOSS_RTOL = 1e-4

CONFIG = f"""DATASET: 'tests/data/torch_qdata/data.feather'
PANORAMA: False
LOSS_CLIP: 'rect'
ARCHITECTURE: 'basic'
LEARNING_RATE: 0.0001
GAMMA: 0.99
CHECKPOINT_INTERVAL: {EVERY}
NUM_STEPS: {STEPS}
TARGET_UPDATE_INTERVAL: {SYNC}
USE_INVERSE_ACTIONS: True
SEED: 4
TPU:
  BATCH_SIZE: 8
  IMAGE_SIZE: 96
  COMPUTE_DTYPE: float32
  DEVICE_DATASET: True
  SHARD_DATASET: True
  MESH_DATA: -1
"""


def experiment(folder: Path, every: int = EVERY) -> str:
    """The fixture's config; checkpoints every `every` steps (~180 MB each)."""
    folder.mkdir()
    (folder / "config.yml").write_text(CONFIG.replace(f"CHECKPOINT_INTERVAL: {EVERY}",
                                                      f"CHECKPOINT_INTERVAL: {every}"))
    return str(folder)


def fleet(folders, local: int, timeout: float = 240) -> None:
    """One CLI process a folder, `local` gloo ranks each, one torch thread
    a rank, on a free localhost port."""
    processes = len(folders)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "video_dqn_tpu_torch.train_q_network", "--coordinator",
         coordinator, "--num-processes", str(processes), "--process-id", str(i),
         "--multihost-platform", "cpu", "--local-devices", str(local), folder,
         "--log-every", "1"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i, folder in enumerate(folders)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-8000:] for o in outs)


def trace(folder: str) -> np.ndarray:
    return np.array([r["value"] for r in read_metrics(f"{folder}/run1", "avg_q_loss/train")])


def one_process(folder: str, threads: int) -> None:
    saved, cwd = torch.get_num_threads(), os.getcwd()
    torch.set_num_threads(threads)
    os.chdir(ROOT)  # the fixture's frame paths are relative to the repo's root
    try:
        main([folder, "--log-every", "1"], device="cpu")
    finally:
        os.chdir(cwd)
        torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    ones = [experiment(tmp / f"one{t}", every=STEPS) for t in (1, 4)]
    for folder, threads in zip(ones, (1, 4)):
        one_process(folder, threads)
    two = [experiment(tmp / f"two{i}") for i in range(2)]
    fleet(two, 1)
    yield ones, two, tmp
    for f in tmp.glob("*/models/*.ckpt"):
        f.unlink()


def test_fleet_matches_one_process(runs):
    """The 2x1 fleet's EMA loss at every step against one process's at the
    same global batch (BatchNorm over the global batch, gradients and loss
    averaged over the data group): the first step within 1e-5, every step
    within 1e-4 plus twice the one-process trace's own spread (see the
    module's docstring); its last checkpoint holds the whole state."""
    ones, two, _ = runs
    a, a4, b = trace(ones[0]), trace(ones[1]), trace(two[0])
    assert len(a) == len(a4) == len(b) == STEPS
    spread = np.abs(a - a4).max()
    np.testing.assert_allclose(b[0], a[0], rtol=1e-5)
    np.testing.assert_allclose(b, a, rtol=LOSS_RTOL, atol=2 * spread)
    got = restore_checkpoint(f"{two[0]}/models", STEPS)
    want = restore_checkpoint(f"{ones[0]}/models", STEPS)
    assert int(got["step"]) == STEPS
    for g, w in zip(jax_free_leaves(got["params"]), jax_free_leaves(want["params"])):
        assert g.shape == w.shape


def jax_free_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_free_leaves(tree[k])]
    return [np.asarray(tree)]


def test_only_process_zero_writes(runs):
    """Process 0's folder: one run dir, each step's scalars once, the
    config log, and the checkpoints of the cadence. Process 1's: its
    config.yml alone."""
    _, two, _ = runs
    folder = Path(two[0])
    assert sorted(p.name for p in folder.iterdir()) == ["config.yml", "log", "models", "run1"]
    steps = [r["step"] for r in read_metrics(f"{two[0]}/run1", "avg_q_loss/train")]
    assert steps == list(range(1, STEPS + 1))
    assert sorted(p.name for p in (folder / "models").iterdir()) == \
        [f"sample{k}.ckpt" for k in (16, 24, 8)]
    assert (folder / "log").read_text().startswith("Running with config (")
    assert [p.name for p in Path(two[1]).iterdir()] == ["config.yml"]


def test_spawned_ranks_match_two_processes(runs):
    """One process spawning both ranks (--local-devices 2) forms the same
    mesh as two processes of one rank: the same trace, bit for bit."""
    _, two, tmp = runs
    spawned = experiment(tmp / "spawned", every=STEPS)
    fleet([spawned], 2)
    np.testing.assert_array_equal(trace(spawned), trace(two[0]))


@pytest.mark.parametrize("flags", [["--num-processes", "2"], ["--process-id", "0"]])
def test_coordinator_needs_the_fleet_flags(tmp_path, flags):
    """As in the JAX CLI, --coordinator without --num-processes or
    --process-id dies in argparse."""
    with pytest.raises(SystemExit) as e:
        main(["--coordinator", "127.0.0.1:1", *flags, str(tmp_path)], device="cpu")
    assert e.value.code == 2

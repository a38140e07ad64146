"""The inverse CLI on every card (video_dqn_tpu_torch/train_inverse_model.py):
with no device named on a machine of several cards, main() spawns one NCCL
rank a card through parallel/multihost.py initialize, as JAX's CLI takes
every local device. Here the CLI's module-level rank function runs through
that launcher on the CPU (2 spawned gloo ranks in a subprocess, one torch
thread a rank) against one process of the same flags on a tiny pair set:
96 px, B = 8, 16 steps, validating every 8 steps over 2 batches. jax-free.

Both sides run the model in float32 (the CLI's COMPUTE_DTYPE, bf16, set
to float32 here): in bf16 each rank's half batch rounds otherwise than the
whole batch, 16 Adam steps carry that to 3% of the training loss, and the
CPU's bf16 runs at 1 and 4 threads agree exactly, so no spread the test
can measure would bound it (chip_smoke.py phase 16 (d) holds the card's
bf16 fleet to one card within 5% + 1e-3). Every logged scalar and the
final accuracy are held to one process's within rtol 1e-4 plus twice the
spread between two one-process runs that differ only in torch's thread
count (1 against 4), which the test measures each run, as
tests/test_torch_parallel_cli.py does. Only rank 0 makes the
output folder, writes the metrics and the checkpoints and prints the
final line; its last checkpoint loads equal to the state it trained, and
rank 1's trained tensors equal rank 0's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch import train_inverse_model as cli
from video_dqn_tpu_torch.core.metrics import read_metrics
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)
from tests import torch_qdata

ROOT = Path(__file__).resolve().parents[1]
STEPS, EVERY, VAL_BATCHES = 16, 8, 2
TAGS = ("Loss/train", "Loss/val", "Accuracy/train", "Accuracy/val")
RTOL = 1e-4
DTYPE = "float32"

FLEET = """
import json, sys
from video_dqn_tpu_torch import train_inverse_model
from video_dqn_tpu_torch.parallel import multihost
from tests.torch_parallel_ranks import inverse_cli_rank
args = train_inverse_model.parse_args(json.loads(sys.argv[1]))
multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, "cpu", 2, inverse_cli_rank,
                     (args, int(sys.argv[3]), int(sys.argv[4]), sys.argv[2], sys.argv[5]))
"""


def flags(npy: str, root: str, out_dir: str) -> list:
    return ["--train_data", npy, "--val_data", npy, "--image_root", root, "--image_size", "96",
            "--batch_size", "8", "--num_steps", str(STEPS), "--lr_decay_every", "0.5",
            "--out_dir", out_dir]


def one_process(argv: list, threads: int) -> float:
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(cli, "COMPUTE_DTYPE", getattr(torch, DTYPE))
            return cli.main(argv, device="cpu", validate_every=EVERY,
                            val_batches=VAL_BATCHES)[1]
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inverse_fleet")
    npy, root = torch_qdata.make_pairs(tmp / "pairs", rows=64, states=32, seed=5)
    ones = {t: (str(tmp / f"one{t}"), one_process(flags(npy, root, str(tmp / f"one{t}")), t))
            for t in (1, 4)}
    fleet = tmp / "fleet"
    fleet.mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", FLEET, json.dumps(flags(npy, root, "out")), str(fleet),
         str(EVERY), str(VAL_BATCHES), DTYPE], cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    yield ones, fleet, proc.stdout
    for f in tmp.glob("**/*.ckpt"):
        f.unlink()  # ~130 MB each


def test_fleet_matches_one_process(runs):
    """The 2-rank fleet's scalars at steps 8 and 16 and its final accuracy
    against one process's, within rtol 1e-4 plus twice the one-process
    runs' own spread; both ranks end with the same trained tensors and the
    same final accuracy."""
    ones, fleet, _ = runs
    (one, accuracy), (four, accuracy4) = ones[1], ones[4]
    for tag in TAGS:
        a, a4, b = ([r["value"] for r in read_metrics(folder, tag)]
                    for folder in (one, four, str(fleet / "rank0" / "out")))
        assert len(a) == len(a4) == len(b) == STEPS // EVERY, tag
        spread = np.abs(np.subtract(a, a4)).max()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=2 * spread, err_msg=tag)
    said = [json.loads((fleet / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert [s["step"] for s in said] == [STEPS, STEPS]
    assert said[1]["diff_to_rank0"] == 0.0
    assert said[0]["accuracy"] == said[1]["accuracy"]
    np.testing.assert_allclose(said[0]["accuracy"], accuracy, rtol=RTOL,
                               atol=2 * abs(accuracy - accuracy4))


def test_only_rank_zero_writes(runs):
    """Rank 0's working folder holds the output folder, with the metrics
    (each tag once a validation step) and the checkpoints, the last of
    which loads equal to the trained state; rank 1's folder stays empty;
    the final line is printed once."""
    _, fleet, stdout = runs
    out = fleet / "rank0" / "out"
    assert sorted(p.name for p in out.iterdir()) == \
        ["metrics.jsonl", f"sample{STEPS}.ckpt", f"sample{EVERY}.ckpt"]
    for tag in TAGS:
        assert [r["step"] for r in read_metrics(str(out), tag)] == [EVERY, STEPS]
    assert json.loads((fleet / "rank0.json").read_text())["checkpoint_equal"]
    assert list((fleet / "rank1").iterdir()) == []
    lines = [line for line in stdout.splitlines() if line.startswith("Final val accuracy: ")]
    assert len(lines) == 1, stdout


def test_main_spawns_a_rank_a_card(monkeypatch):
    """With no device and two cards, main() hands the module-level rank
    function to initialize on the 'native' platform, one rank a card, and
    returns None, as the train CLI does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli.multihost, "initialize", lambda *a: calls.append(a))
    assert cli.main(["--batch_size", "8"]) is None
    (args,) = calls
    coordinator, processes, process_id, platform, ranks, fn, (flags_, every, batches) = args
    assert coordinator.startswith("127.0.0.1:")
    assert (processes, process_id, platform, ranks) == (1, 0, "native", 2)
    assert fn is cli._rank_fn and (every, batches) == (100, 25)
    assert flags_.batch_size == 8


def test_main_with_a_device_runs_one_rank(monkeypatch):
    """A device named (here cuda:0 of two cards) runs the one rank in this
    process, without the launcher, and returns its (state, accuracy)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli.multihost, "initialize", lambda *a: calls.append("initialize"))
    monkeypatch.setattr(cli, "_rank_fn", lambda device, args, every, batches:
                        calls.append(device) or ("state", 0.5))
    assert cli.main(["--batch_size", "8"], device="cuda:0") == ("state", 0.5)
    assert calls == [torch.device("cuda:0")]

"""The port's inverse-action trainer and labeler on the card, held to the
same code on the CPU; the CLI's fleet on every card of a machine of two
or more.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, PIL nor pandas, so it also runs where
only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_inverse.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch import train_inverse_model
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.data.episodes import make_inverse_labeler, process_episodes
from video_dqn_tpu_torch.data.feather import read_feather
from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher
from video_dqn_tpu_torch.models.bridge import (flax_from_inverse_state_dict,
                                               inverse_state_dict_from_flax)
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.train.inverse import (create_inverse_state, exponential_decay,
                                               flax_state_dict, make_inverse_step)
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # caps torch threads per worker
import torch_qdata

LR = 1e-3
ATOL = 1e-4  # float32 sums in another order on the two devices
# An element whose gradient lies below the float32 noise of its sum can
# take Adam's ~lr step the other way on the other device, at any step: a
# few may lie beyond ATOL, none beyond twice the sum of the steps' rates
# (one such element parted by 2.2e-3 after 3 steps at lr 1e-3).
BEYOND_MAX = 1000
MARGIN = 1e-3      # float32 card and CPU labels compared where the margin is this wide
BF16_MARGIN = 0.05  # bf16 and float32 card labels compared where it is this wide


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the inverse step's kernel has no CPU mode")


class no_tf32:
    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_card_steps_match_cpu_steps(tmp_path, weight_decay):
    """Three float32 steps at 192 px (the VALID head), B = 8, the rate
    decaying after the second, from the same seeded state, batches of the
    pairs fixture and dropout masks: losses within ATOL, parameters within
    ATOL but for at most BEYOND_MAX values, none beyond twice the summed
    rates; one float32 identity launch a step on the card; Adam leaves the
    trunk bit-unchanged."""
    cap = 2 * sum(exponential_decay(LR, 0.9, 2)(k) for k in range(3))
    npy, root = torch_qdata.make_pairs(tmp_path, rows=64, states=32)
    pairs = GibsonPairBatcher(npy, image_root=root, image_size=192, seed=4)
    batches = [pairs.get_batch(batch_size=8) for _ in range(3)]
    rng = np.random.default_rng(0)
    masks = [torch.from_numpy(rng.random((8, 128)) < 0.5) for _ in range(3)]
    out = {}
    with no_tf32():
        for device in ("cuda", "cpu"):
            state = create_inverse_state(LR, 0.9, 2, weight_decay, seed=4, image_size=192,
                                         device=device)
            trunk = [p.detach().clone() for p in state.model.trunk_parameters()]
            step_fn = make_inverse_step(state.model, torch.float32)
            losses = []
            for b, mask in zip(batches, masks):
                before = rn.LAUNCHES.copy()
                losses.append(float(step_fn(state, {k: torch.from_numpy(v).to(device)
                                                    for k, v in b.items()},
                                            dropout_mask=mask.to(device))["loss"]))
                want = {("identity", "float32"): 1} if device == "cuda" else {}
                assert dict(rn.LAUNCHES - before) == want
            if not weight_decay:
                assert all(torch.equal(a, b) for a, b in
                           zip(trunk, state.model.trunk_parameters()))
            out[device] = losses, flax_state_dict(state)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=ATOL)
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in
                            zip(leaves(out["cuda"][1]["params"]), leaves(out["cpu"][1]["params"]))])
    beyond = int((diffs > ATOL).sum())
    assert diffs.max() <= cap and beyond <= BEYOND_MAX, (diffs.max(), beyond)


def margins(logits):
    top2 = np.sort(logits, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.cuda
def test_card_labels_match_cpu_labels(tmp_path):
    """The labeler on the episode fixture at 128 px: float32 card labels
    equal the CPU's where the margin is at least MARGIN, bf16 card labels
    the float32 ones where it is at least BF16_MARGIN; one identity launch
    a batch; process_episodes writes them."""
    location = torch_qdata.make_episodes(tmp_path, videos=3, frames=40)
    cols = read_feather(process_episodes(location))
    before, after = list(cols["before_image"]), list(cols["after_image"])
    model = create_inverse_state(image_size=128, device="cpu").model
    params, stats = flax_from_inverse_state_dict(model.state_dict(), 128)
    rng = np.random.default_rng(0)
    model.load_state_dict(inverse_state_dict_from_flax(
        torch_port_util.randomize_tree(params, rng), torch_port_util.randomize_tree(stats, rng),
        128))
    logits = {}
    with no_tf32():
        for key, device, dtype in (("cpu", "cpu", torch.float32),
                                   ("cuda", "cuda", torch.float32),
                                   ("bf16", "cuda", torch.bfloat16)):
            labeler = make_inverse_labeler(model, batch_size=32, dtype=dtype, device=device)
            launched = rn.LAUNCHES.copy()
            logits[key] = labeler.logits_rows(before, after, 128)
            if device == "cuda":
                batches = sum(-(-n // 32) for n in np.unique(
                    [p.rsplit("/", 1)[0] for p in before], return_counts=True)[1])
                assert dict(rn.LAUNCHES - launched) == {("identity", str(dtype)[6:]): batches}
    wide = margins(logits["cpu"]) >= MARGIN
    assert wide.mean() > 0.9 and len(set(logits["cpu"].argmax(1))) > 1
    np.testing.assert_array_equal(logits["cuda"].argmax(1)[wide], logits["cpu"].argmax(1)[wide])
    wide = margins(logits["cuda"]) >= BF16_MARGIN
    np.testing.assert_array_equal(logits["bf16"].argmax(1)[wide], logits["cuda"].argmax(1)[wide])

    out = read_feather(process_episodes(location, inverse_labeler=make_inverse_labeler(
        model, batch_size=32, dtype=torch.float32, device="cuda"), image_size=128))
    np.testing.assert_array_equal(out["inverse_actions"], logits["cuda"].argmax(1))


@pytest.mark.cuda
def test_cli_trains_on_the_card(tmp_path):
    """The training CLI at 64 px, B = 16, 6 steps, validating every 3, on
    cuda:0 (with no device named it would take every card): the
    checkpoints, finite scalars, one bf16 identity launch a train step."""
    npy, root = torch_qdata.make_pairs(tmp_path, rows=64, states=32)
    rn.LAUNCHES.clear()
    state, accuracy = train_inverse_model.main(
        ["--train_data", npy, "--val_data", npy, "--image_root", root, "--image_size", "64",
         "--batch_size", "16", "--num_steps", "6", "--out_dir", str(tmp_path / "run"),
         "--cache-images"], device="cuda:0", validate_every=3, val_batches=2)
    assert state.step == 6 and 0.0 <= accuracy <= 1.0
    assert sorted(p.name for p in (tmp_path / "run").glob("sample*.ckpt")) == \
        ["sample3.ckpt", "sample6.ckpt"]
    scalars = read_metrics(str(tmp_path / "run"))
    assert len(scalars) == 8 and all(np.isfinite(r["value"]) for r in scalars)
    # 6 steps, 2 validations of 2 batches, 10 final batches
    assert dict(rn.LAUNCHES) == {("identity", "bfloat16"): 6 + 4 + 10}


FLEET = """
import json, sys
from video_dqn_tpu_torch import train_inverse_model
assert train_inverse_model.main(json.loads(sys.argv[1]), validate_every=3,
                                val_batches=4) is None
"""


@pytest.mark.cuda
def test_cli_fleet_on_every_card(tmp_path, monkeypatch):
    """With no device named on a machine of two cards or more, the CLI
    spawns one NCCL rank a card (in a process of its own here, whose
    output the test reads): 64 px, B = 64, 6 steps, validating every 3
    over 4 batches, bf16, against cuda:0 alone; each scalar and the final
    accuracy within 5% + 1e-3 of one card's, or within twice a float32
    one-card run's largest distance from it over the scalars of their kind
    where that is wider (each rank's bf16 step rounds its own rows, and
    near-tied predictions flip: chip_smoke.py phase 16 (d)); logged once,
    the checkpoints of the cadence, one final line."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"the fleet needs two cards or more; {cards} visible")
    npy, root = torch_qdata.make_pairs(tmp_path, rows=256, states=64)

    def flags(out):
        return ["--train_data", npy, "--val_data", npy, "--image_root", root, "--image_size",
                "64", "--batch_size", "64", "--num_steps", "6", "--out_dir", str(out),
                "--cache-images"]

    proc = subprocess.run([sys.executable, "-c", FLEET, json.dumps(flags(tmp_path / "fleet"))],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    finals = [line for line in proc.stdout.splitlines()
              if line.startswith("Final val accuracy: ")]
    accuracy = {}
    for run, dtype in (("one", torch.bfloat16), ("f32", torch.float32)):
        monkeypatch.setattr(train_inverse_model, "COMPUTE_DTYPE", dtype)
        _, accuracy[run] = train_inverse_model.main(flags(tmp_path / run), device="cuda:0",
                                                    validate_every=3, val_batches=4)
    assert len(finals) == 1
    rows = {"final": ([float(finals[0].split()[-1])], [accuracy["one"]], [accuracy["f32"]])}
    for tag in ("Loss/train", "Loss/val", "Accuracy/train", "Accuracy/val"):
        runs = [read_metrics(str(tmp_path / run), tag) for run in ("fleet", "one", "f32")]
        assert all([r["step"] for r in got] == [3, 6] for got in runs), tag
        rows[tag] = [[r["value"] for r in got] for got in runs]
    # the float32 run's largest distance from one card's, losses and accuracies apart
    spread = {kind: max(abs(c - b) for tag, (_, one, f32) in rows.items()
                        if tag.startswith("Loss") == kind for b, c in zip(one, f32))
              for kind in (True, False)}
    for tag, (fleet, one, _) in rows.items():
        for a, b in zip(fleet, one):
            assert abs(a - b) <= max(0.05 * abs(b) + 1e-3, 2 * spread[tag.startswith("Loss")]), \
                (tag, spread, rows)
    assert sorted(p.name for p in (tmp_path / "fleet").glob("sample*.ckpt")) == \
        ["sample3.ckpt", "sample6.ckpt"]

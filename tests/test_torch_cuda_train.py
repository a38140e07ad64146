"""The port's train step, device dataset and prefetch on the card, held to
the same code on the CPU.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_train.py
"""

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.core.prefetch import prefetch_to_device
from video_dqn_tpu_torch.data.device_dataset import DeviceDataset
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.train.dqn import create_train_state, flax_state_dict, make_train_step
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)

ATOL = 1e-4  # float32 sums in another order on the two devices
# An element whose gradient lies below the float32 noise of its sum can
# take Adam's ~lr step the other way on the other device: a few hundred of
# the 23.3M params and target params do (chip_smoke.py's card_vs_cpu).
# A few such may lie beyond ATOL, none beyond 2 lr.
BEYOND_MAX, CAP_LR = 1000, 2


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step's kernel has no CPU mode")


def config():
    """The published run's keys at 96 px, B = 8, float32, syncing every 2."""
    cfg = get_cfg_defaults()
    cfg.merge_from_dict({"PANORAMA": False, "ARCHITECTURE": "extra_capacity",
                         "USE_INVERSE_ACTIONS": True, "LOSS_CLIP": "rect", "GAMMA": 0.99,
                         "LEARNING_RATE": 1e-4, "SEED": 4, "TARGET_UPDATE_INTERVAL": 2,
                         "TPU": {"IMAGE_SIZE": 96, "BATCH_SIZE": 8, "COMPUTE_DTYPE": "float32"}})
    return cfg


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.cuda
def test_card_steps_match_cpu_steps():
    """Two float32 steps (the second after a target sync) from the same
    seeded state and batches: losses within ATOL, parameters and running
    statistics within ATOL but for at most BEYOND_MAX values, none beyond
    CAP_LR lr, and exactly 2 float32 identity launches a step on the
    card."""
    card()
    cfg = config()
    tables = synthetic_video_tables(32, 64, 96, seed=0)
    rng = np.random.default_rng(0)
    batches = [TableSource(tables).get_batch(rng.integers(0, 64, 8)) for _ in range(2)]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            state = create_train_state(cfg, device=device)
            step_fn = make_train_step(state.model, cfg)
            losses = []
            for b in batches:
                before = rn.LAUNCHES.copy()
                losses.append(float(step_fn(state, {k: torch.from_numpy(v).to(device)
                                                    for k, v in b.items()})["loss"]))
                want = {("identity", "float32"): 2} if device == "cuda" else {}
                assert dict(rn.LAUNCHES - before) == want
            out[device] = losses, flax_state_dict(state)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=ATOL)
    diffs = np.concatenate([np.abs(a - b).ravel()
                            for field in ("params", "target_params", "batch_stats")
                            for a, b in zip(leaves(out["cuda"][1][field]),
                                            leaves(out["cpu"][1][field]))])
    assert diffs.max() <= CAP_LR * cfg.LEARNING_RATE, diffs.max()
    assert (diffs > ATOL).sum() <= BEYOND_MAX, (diffs > ATOL).sum()


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["epoch", "uniform"])
def test_device_dataset_on_the_card_samples_the_host_batch(sampling):
    card()
    tables = synthetic_video_tables(16, 40, 32, seed=1)
    dds = DeviceDataset(tables, 8, seed=2, sampling=sampling)
    host = TableSource(tables)
    for step in (0, 4, 9):
        got = dds.sample(step)
        want = host.get_batch(dds.rows(step).numpy())
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), v, err_msg=k)


@pytest.mark.cuda
def test_prefetch_hands_out_the_host_batches():
    card()
    tables = synthetic_video_tables(16, 40, 32, seed=1)
    stream = TableSource(tables, seed=3).batches(8)
    want = TableSource(tables, seed=3).batches(8)
    fed = prefetch_to_device(stream, torch.device("cuda"), depth=2)
    for _ in range(6):
        got, host = next(fed), next(want)
        for k, v in host.items():
            np.testing.assert_array_equal(got[k].cpu().numpy(), v, err_msg=k)
    fed.close()

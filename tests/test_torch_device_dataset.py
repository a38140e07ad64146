"""The port's device-resident dataset and its host twin against the JAX
package's QLearningBatcher on a 64 px synthetic dataset, the purity of the
sample stream, the capacity guard, and the port's run_train on the CPU in
both data modes through checkpoint and resume."""

import numpy as np
import pytest
import torch

from video_dqn_tpu.data.qlearning import QLearningBatcher, load_images
from video_dqn_tpu.data.synthetic import make_synthetic_dataset
from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.data.device_dataset import TABLE_KEYS, DeviceDataset
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.train.dqn import run_train
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)

SIZE, BATCH = 64, 8


def tables_from_batcher(batcher):
    """The JAX DeviceDataset's tables (device_dataset.py:81-95, 178-187)
    as numpy: each unique frame once, per-row stacks into it, the labels."""
    uniq, stacks = {}, {}
    for col in ("before_image", "after_image"):
        idx = np.empty((len(batcher), batcher.num_frames), np.int32)
        for i in range(len(batcher)):
            paths = batcher._stack_paths(batcher.cols[col][i], batcher.cols["im_start"][i])
            for f, p in enumerate(paths):
                idx[i, f] = uniq.setdefault(p, len(uniq))
        stacks[col] = idx
    return {"frames": load_images(list(uniq), batcher.image_size),
            "before_idx": stacks["before_image"], "after_idx": stacks["after_image"],
            "action": batcher.action.astype(np.int32), "reward": batcher.reward,
            "terminal": batcher.terminal, "gt": batcher.gt, "valid_mask": batcher.valid_mask}


@pytest.fixture(scope="module")
def feather(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("ds")), num_videos=2,
                                  frames_per_video=20, image_size=SIZE)


@pytest.fixture(scope="module", params=[False, True], ids=["single", "previous_images"])
def source(request, feather):
    batcher = QLearningBatcher(feather, one_action=True, inverse_actions=True,
                               previous_images=request.param, image_size=SIZE, seed=0)
    return batcher, tables_from_batcher(batcher)


def assert_batch_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize("sampling", ["epoch", "uniform"])
def test_sample_equals_get_batch_of_its_rows(source, sampling):
    batcher, tables = source
    dds = DeviceDataset(tables, BATCH, seed=3, sampling=sampling, device="cpu")
    for step in (0, 1, 5, 11):
        rows = dds.rows(step).numpy()
        assert rows.shape == (BATCH,) and rows.min() >= 0 and rows.max() < len(batcher)
        assert_batch_equal(dds.sample(step), batcher.get_batch(rows))


def test_table_source_equals_get_batch(source):
    batcher, tables = source
    rows = np.array([3, 0, 7, 7, 1])
    assert_batch_equal(TableSource(tables).get_batch(rows), batcher.get_batch(rows))


def test_an_epoch_draws_each_row_once(source):
    _, tables = source
    dds = DeviceDataset(tables, BATCH, seed=3, device="cpu")
    n = len(tables["action"])
    for epoch in range(2):
        rows = torch.cat([dds.rows(epoch * dds.steps_per_epoch + j)
                          for j in range(dds.steps_per_epoch)]).numpy()
        assert len(rows) == (n // BATCH) * BATCH  # drop_last
        assert len(np.unique(rows)) == len(rows)
    assert not torch.equal(dds.rows(0), dds.rows(dds.steps_per_epoch))


def test_stream_is_a_function_of_seed_and_step(source):
    _, tables = source
    for sampling in ("epoch", "uniform"):
        first = DeviceDataset(tables, BATCH, seed=3, sampling=sampling, device="cpu")
        again = DeviceDataset(tables, BATCH, seed=3, sampling=sampling, device="cpu")
        other = DeviceDataset(tables, BATCH, seed=4, sampling=sampling, device="cpu")
        steps = [0, 1, 2, 9, 3]
        want = [first.rows(k) for k in steps]
        # a rebuilt dataset, asked out of order (as a resumed run asks)
        for k, w in reversed(list(zip(steps, want))):
            assert torch.equal(again.rows(k), w), (sampling, k)
        resumed = again.batches(start_step=2)
        assert torch.equal(next(resumed)["action"], first.sample(2)["action"])
        assert any(not torch.equal(other.rows(k), w) for k, w in zip(steps, want))


def test_capacity_guard_raises_before_upload(source, monkeypatch):
    _, tables = source
    uploads = []
    monkeypatch.setattr(torch, "from_numpy", lambda a: uploads.append(a))
    with pytest.raises(ValueError, match="DEVICE_DATASET"):
        DeviceDataset(tables, BATCH, device="cpu",
                      memory_limit_bytes=int(tables["frames"].nbytes / 0.6) - 1)
    assert uploads == []


def test_dataset_refuses_bad_arguments(source):
    _, tables = source
    with pytest.raises(ValueError, match="exceeds"):
        DeviceDataset(tables, len(tables["action"]) + 1, device="cpu")
    with pytest.raises(ValueError, match="DEVICE_SAMPLING"):
        DeviceDataset(tables, BATCH, sampling="shuffle", device="cpu")
    with pytest.raises(ValueError, match="lack"):
        DeviceDataset({k: tables[k] for k in TABLE_KEYS[1:]}, BATCH, device="cpu")


def write_config(folder, device_dataset):
    folder.mkdir()
    (folder / "config.yml").write_text(f"""# the published config, cut to size
PANORAMA: False
LOSS_CLIP: 'rect'
ARCHITECTURE: "extra_capacity"
LEARNING_RATE: 0.0001
GAMMA: 0.99
CHECKPOINT_INTERVAL: 2
NUM_STEPS: 4
TARGET_UPDATE_INTERVAL: 3
USE_INVERSE_ACTIONS: True
SEED: 4
TPU:
  BATCH_SIZE: 4
  IMAGE_SIZE: 96
  COMPUTE_DTYPE: float32
  DEVICE_DATASET: {device_dataset}
""")
    return str(folder)


@pytest.mark.parametrize("device_dataset", [True, False], ids=["device_dataset", "host_fed"])
def test_run_train_checkpoints_and_resumes(tmp_path, device_dataset):
    """4 steps with checkpoints at 2 and 4, then a resume from 2 to 4: the
    device dataset's resumed run draws the same batches, so its state
    ends equal; the host-fed stream restarts, so only the cadence holds."""
    folder = write_config(tmp_path / "exp", device_dataset)
    tables = synthetic_video_tables(12, 16, 96, seed=1)
    config = ExperimentConfig(folder)
    state, loss = run_train(config, batcher=TableSource(tables, seed=4), log_every=2,
                            device="cpu")
    assert state.step == 4 and np.isfinite(loss)
    assert sorted(f.name for f in (tmp_path / "exp" / "models").iterdir()) == \
        ["sample2.ckpt", "sample4.ckpt"]
    logged = read_metrics(config.run_dir, "avg_q_loss/train")
    assert [r["step"] for r in logged] == [2, 4] and logged[-1]["value"] == loss
    assert len(read_metrics(config.run_dir, "frames_per_sec/train")) == 2

    first = restore_checkpoint(config.models_dir, 4)
    config2 = ExperimentConfig(folder, resume=True)
    assert config2.run_dir == config.run_dir
    resumed, loss2 = run_train(config2, resume_from=2, batcher=TableSource(tables, seed=4),
                               log_every=2, device="cpu")
    assert resumed.step == 4 and np.isfinite(loss2)
    if device_dataset:
        assert loss2 == loss
        again = restore_checkpoint(config.models_dir, 4)
        for field in ("params", "target_params"):
            np.testing.assert_array_equal(again[field]["top_dense3"]["kernel"],
                                          first[field]["top_dense3"]["kernel"])


def test_run_train_needs_a_batcher_and_refuses_unported_keys(tmp_path):
    """Without a batcher run_train reads the config's DATASET, which must
    exist (the default 'none' does not)."""
    folder = write_config(tmp_path / "exp", False)
    with pytest.raises(FileNotFoundError, match="none"):
        run_train(ExperimentConfig(folder), device="cpu")
    with open(f"{folder}/config.yml", "a") as f:
        f.write("  SHARD_DATASET: True\n  MESH_MODEL: 2\n")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*SHARD_DATASET.*MESH"):
        run_train(ExperimentConfig(folder), batcher=object(), device="cpu")


def test_bootstrap_loads_weights_and_restarts_the_count(tmp_path):
    """BOOTSTRAP: the donor's weights, a fresh step count, and the target
    re-synced to the loaded net (not the donor's target)."""
    tables = synthetic_video_tables(12, 16, 96, seed=1)
    donor = ExperimentConfig(write_config(tmp_path / "donor", True))
    donor_state, _ = run_train(donor, batcher=TableSource(tables), max_steps=2,
                               log_every=2, device="cpu")
    folder = write_config(tmp_path / "boot", True)
    with open(f"{folder}/config.yml", "a") as f:
        f.write(f"BOOTSTRAP: True\nBOOTSTRAP_LOCATION: '{donor.models_dir}'\n")
    state, _ = run_train(ExperimentConfig(folder), batcher=TableSource(tables), max_steps=0,
                         device="cpu")
    assert state.step == 0
    for (name, p), q, t in zip(state.model.named_parameters(), donor_state.model.parameters(),
                               state.target.parameters()):
        assert torch.equal(p, q) and torch.equal(t, p), name

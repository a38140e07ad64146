"""The port's QLearningBatcher against the JAX package's on the committed
real-data fixture (tests/data/torch_qdata, made by tests/make_torch_qdata.py):
labels bit-equal, frames within the decode bound, the same index stream,
and tables() equal to the JAX DeviceDataset's; and the wide feather's
batches name as many distinct frames as the published dataset's."""

from pathlib import Path

import numpy as np
import pytest

from video_dqn_tpu.data.device_dataset import DeviceDataset as JaxDeviceDataset
from video_dqn_tpu.data.qlearning import QLearningBatcher as JaxBatcher
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests import torch_qdata

ROOT = Path(__file__).resolve().parents[1]
FEATHER = torch_qdata.FEATHER  # its frame paths are relative to ROOT
SIZE = 64
MEAN_BOUND = torch_qdata.MEAN_BOUND
LABELS = torch_qdata.LABELS

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)


def pair(feather=FEATHER, **kw):
    kw = {"image_size": SIZE, "seed": 3, **kw}
    return QLearningBatcher(feather, **kw), JaxBatcher(feather, **kw)


def assert_batches_match(got, want):
    assert set(got) == set(want)
    for k in LABELS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("before", "after"):
        assert got[k].dtype == np.uint8 and got[k].shape == want[k].shape, k
        diff = np.abs(got[k].astype(np.int16) - want[k].astype(np.int16))
        assert diff.mean() < MEAN_BOUND, (k, diff.mean())


@pytest.mark.parametrize("options", [
    {"one_action": True, "inverse_actions": True},
    {"one_action": True},
    {"one_action": True, "confidence_reward": True, "value_learning": True},
    {"inverse_actions": True, "value_learning": True, "gamma": 0.9, "previous_images": True},
    {"one_action": True, "previous_images": True, "cache_images": True},
    {"inverse_actions": True, "cache_bytes": 3 * SIZE * SIZE * 3},
], ids=["published", "one_action", "confidence_value", "previous_images_value",
        "previous_images_cached", "cache_budget"])
def test_get_batch_matches_jax(options):
    mine, jax_batcher = pair(**options)
    assert len(mine) == len(jax_batcher) == 512
    assert mine.reward_percentage() == jax_batcher.reward_percentage()
    rows = np.array([0, 511, 7, 7, 130, 256, 3, 400])
    for _ in range(2):  # the second time from the cache, where there is one
        assert_batches_match(mine.get_batch(rows), jax_batcher.get_batch(rows))
    if "cache_bytes" in options:  # full at 3 frames: stops inserting, never evicts
        assert len(mine._image_cache) == 3 and mine._cache_used <= options["cache_bytes"]


def test_index_stream_and_random_rows_follow_the_seed():
    mine, jax_batcher = pair(one_action=True)
    ours, theirs = mine.index_stream(100), jax_batcher.index_stream(100)
    for _ in range(12):  # two epochs of 5 batches, then into the third
        np.testing.assert_array_equal(next(ours), next(theirs))
    np.testing.assert_array_equal(mine.get_batch(batch_size=4)["action"],
                                  jax_batcher.get_batch(batch_size=4)["action"])
    with pytest.raises(ValueError, match="exceeds dataset size"):
        next(mine.index_stream(513))


@pytest.mark.parametrize("previous_images", [False, True], ids=["single", "previous_images"])
def test_tables_equal_the_jax_device_dataset(previous_images):
    mine, jax_batcher = pair(inverse_actions=True, previous_images=previous_images)
    tables = mine.tables()
    dds = JaxDeviceDataset(jax_batcher, 8, seed=0)
    for k in ("before_idx", "after_idx", *LABELS):
        want = np.asarray(dds._tables[k])
        assert tables[k].dtype == want.dtype, k
        np.testing.assert_array_equal(tables[k], want, err_msg=k)
    diff = np.abs(tables["frames"].astype(np.int16) - np.asarray(dds._tables["frames"], np.int16))
    assert tables["frames"].shape == (32, SIZE, SIZE, 3) and diff.mean() < MEAN_BOUND
    rows = np.arange(0, 512, 37)
    got = mine.get_batch(rows)
    np.testing.assert_array_equal(tables["frames"][tables["before_idx"][rows]], got["before"])


def test_wide_fixture_batches_name_distinct_frames_as_published_ones_do():
    """wide.feather's rows as the JAX batcher reads them, a batch of 256
    naming nearly 512 distinct frame files, and frames decoded through the
    links as PIL decodes them."""
    assert torch_qdata.link_wide_frames() == 4320
    mine, jax_batcher = pair(torch_qdata.WIDE_FEATHER, **torch_qdata.PUBLISHED)
    assert len(mine) == len(jax_batcher) == 4096
    for k in LABELS:
        np.testing.assert_array_equal(getattr(mine, k), getattr(jax_batcher, k), err_msg=k)
    rows = next(mine.index_stream(256))
    np.testing.assert_array_equal(rows, next(jax_batcher.index_stream(256)))
    names = set(mine.cols["before_image"][rows]) | set(mine.cols["after_image"][rows])
    assert len(names) >= 480 and all("/wide/" in n for n in names)
    assert_batches_match(mine.get_batch(rows[:8]), jax_batcher.get_batch(rows[:8]))


def test_capacity_check_runs_before_the_decode(monkeypatch):
    mine, _ = pair(inverse_actions=True)
    monkeypatch.setattr("video_dqn_tpu_torch.data.qlearning.load_images",
                        lambda *a: pytest.fail("decoded before the capacity check"))
    with pytest.raises(ValueError, match="DEVICE_DATASET"):
        mine.tables(memory_limit_bytes=32 * SIZE * SIZE * 3)


def test_refuses_labels_it_cannot_make(tmp_path):
    with pytest.raises(NotImplementedError, match="one_action or inverse_actions"):
        QLearningBatcher(FEATHER)
    with pytest.raises(FileNotFoundError):
        QLearningBatcher(str(tmp_path / "missing.feather"), one_action=True)

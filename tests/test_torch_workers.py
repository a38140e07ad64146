"""The port's decode workers (video_dqn_tpu_torch/data/workers.py
`parallel_batches`, TPU.DECODE_WORKERS) against the JAX package's
(video_dqn_tpu/data/workers.py) on the same synthetic dataset: the same
stream of labels (the rows drawn by np.random.default_rng(seed)), frames
bit-equal to the port's in-process decode of those rows whatever the
worker count, a worker's error raised in the parent with
the file's path, no child left alive, and run_train over the workers
stepping as it does over the same stream decoded in process; the device
dataset ignores the key, as JAX's does."""

import itertools
import multiprocessing as mp
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic_dataset
from video_dqn_tpu.data.workers import parallel_batches as jax_parallel_batches
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.data.feather import read_feather, write_feather
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from video_dqn_tpu_torch.data.workers import LABEL_KEYS, parallel_batches
from video_dqn_tpu_torch.train.dqn import run_train
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)

SIZE, BATCH, SEED, SAMPLES = 32, 4, 7, 5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX package's synthetic dataset (PIL's JPEGs): 2 videos of 16
    frames, 26 rows; and the batcher arguments both packages take."""
    root = tmp_path_factory.mktemp("ds")
    feather = jax_make_synthetic_dataset(str(root), num_videos=2, frames_per_video=16,
                                         image_size=SIZE)
    return root, dict(location=feather, one_action=True, inverse_actions=True,
                      image_size=SIZE, seed=5)


def in_process(kwargs, n=SAMPLES, seed=SEED):
    """The rows np.random.default_rng(seed) draws, B a batch, decoded by
    the port's batcher in this process."""
    batcher = QLearningBatcher(**kwargs)
    rng = np.random.default_rng(seed)
    return [batcher.get_batch(rng.integers(0, len(batcher), BATCH)) for _ in range(n)]


def no_children():
    return not mp.active_children()


def first(kwargs, n=SAMPLES, **kw):
    """The first n batches of the port's stream over QLearningBatcher(**kwargs),
    the stream closed after them."""
    with parallel_batches(QLearningBatcher(**kwargs), BATCH, seed=SEED, **kw) as stream:
        return list(itertools.islice(stream, n))


def test_stream_equals_jaxs_and_the_in_process_decode(dataset):
    _, kwargs = dataset
    want = list(jax_parallel_batches(kwargs, BATCH, num_workers=2, seed=SEED,
                                     n_samples=SAMPLES))
    got = first(kwargs, num_workers=2)
    ref = in_process(kwargs)
    assert len(got) == len(want) == SAMPLES
    for g, w, r in zip(got, want, ref):
        for key in LABEL_KEYS:  # the same rows, so the same labels
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
            assert g[key].dtype == r[key].dtype
        for key in ("before", "after"):  # the port's own decoder, bit for bit
            assert g[key].shape == (BATCH, 1, SIZE, SIZE, 3) == w[key].shape
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    assert no_children()


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_worker_counts_and_transports_give_one_stream(dataset, workers):
    _, kwargs = dataset
    got = first(kwargs, num_workers=workers)
    for g, r in zip(got, in_process(kwargs), strict=True):
        assert g.keys() == r.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    assert no_children()


def test_a_workers_error_names_the_file(dataset, tmp_path):
    root, kwargs = dataset
    # a copy of the frames with one file cut short, and a feather naming it
    frames = sorted((root / "frames").rglob("*.jpg"))
    broken = tmp_path / "frames"
    for f in frames:
        dst = broken / f.relative_to(root / "frames")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(f.read_bytes())
    victim = broken / frames[3].relative_to(root / "frames")
    victim.write_bytes(victim.read_bytes()[:200])
    cols = read_feather(kwargs["location"])
    for key in ("before_image", "after_image"):
        cols[key] = np.array([p.replace(str(root / "frames"), str(broken))
                              for p in cols[key]], object)
    write_feather(cols, str(tmp_path / "data.feather"))
    batcher = QLearningBatcher(**{**kwargs, "location": str(tmp_path / "data.feather")})
    stream = parallel_batches(batcher, 26, num_workers=2, seed=SEED)
    with pytest.raises(RuntimeError, match=re.escape(str(victim))):
        list(itertools.islice(stream, 4))
    assert no_children()


def test_closing_the_stream_leaves_no_child(dataset):
    _, kwargs = dataset
    batcher = QLearningBatcher(**kwargs)
    stream = parallel_batches(batcher, BATCH, num_workers=3, seed=SEED)
    procs = list(stream.procs)
    assert all(p.is_alive() for p in procs)
    stream.close()  # never started
    assert not any(p.is_alive() for p in procs) and no_children()
    stream = parallel_batches(batcher, BATCH, num_workers=2, seed=SEED)
    batch = next(stream)
    np.testing.assert_array_equal(batch["before"], in_process(kwargs, 1)[0]["before"])
    stream.close()
    assert no_children()
    with pytest.raises(StopIteration):
        next(stream)


def write_config(folder: Path, feather: str, **tpu) -> str:
    folder.mkdir()
    tpu_lines = "".join(f"  {k}: {v}\n" for k, v in tpu.items())
    (folder / "config.yml").write_text(f"""PANORAMA: False
LOSS_CLIP: 'rect'
ARCHITECTURE: "basic"
LEARNING_RATE: 0.0001
GAMMA: 0.99
CHECKPOINT_INTERVAL: 100
NUM_STEPS: 3
TARGET_UPDATE_INTERVAL: 2
USE_INVERSE_ACTIONS: True
SEED: {SEED}
DATASET: '{feather}'
TPU:
  BATCH_SIZE: {BATCH}
  IMAGE_SIZE: {SIZE}
  COMPUTE_DTYPE: float32
{tpu_lines}""")
    return str(folder)


class Replay:
    """A batcher whose stream is the workers' stream, decoded in process."""

    def __init__(self, kwargs):
        self.kwargs = kwargs

    def batches(self, batch_size):
        batcher = QLearningBatcher(**self.kwargs)
        rng = np.random.default_rng(SEED)
        while True:
            yield batcher.get_batch(rng.integers(0, len(batcher), batch_size))


def test_run_train_steps_over_the_workers(dataset, tmp_path, capsys):
    _, kwargs = dataset
    feather = kwargs["location"]
    config = ExperimentConfig(write_config(tmp_path / "workers", feather, DECODE_WORKERS=2))
    state, _ = run_train(config, log_every=1, device="cpu")
    assert "Decode workers: 2" in capsys.readouterr().out
    assert state.step == 3 and no_children()
    # the same stream decoded in process trains the same net, bit for bit
    replay = ExperimentConfig(write_config(tmp_path / "replay", feather))
    want, _ = run_train(replay, batcher=Replay({**kwargs, "seed": SEED}), log_every=1,
                        device="cpu")
    for (name, g), w in zip(state.model.state_dict().items(),
                            want.model.state_dict().values()):
        assert torch.equal(g, w), name

    # the device dataset decodes once and says that it ignores the key
    device = ExperimentConfig(write_config(tmp_path / "device", feather, DECODE_WORKERS=2,
                                           DEVICE_DATASET=True))
    state, _ = run_train(device, log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert state.step == 3 and "TPU.DECODE_WORKERS: 2 ignored" in out
    assert "Decode workers" not in out and no_children()
    assert os.path.exists(feather)

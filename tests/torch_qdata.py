"""The committed real-data fixture, tests/data/torch_qdata (written by
tests/make_torch_qdata.py), and the one check that holds the port to its
oracle, shared by the port's tests and chip_smoke.py phase 6. It imports
numpy and the port only (no jax, PIL or pandas), so it runs on a machine
that has only the port. Its paths, like the fixture's, are relative to the
repo root, which must be the working directory.

* data.feather: 512 rows over the 32 committed frames. expected.npz holds
  the JAX package's labels, index stream and device-table index maps for
  it, and PIL's decode of each frame at 224.
* wide.feather: 4,096 rows over 4,320 frame files, so that a batch of 256
  rows names about 496 distinct files, as a batch of the published
  ~10^5-row dataset names up to 512. The files are links to the committed
  frames, which `link_wide_frames` makes under the gitignored wide/.
"""

import os
import shutil
from pathlib import Path

import numpy as np

from video_dqn_tpu_torch.data.jpeg import load_images
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher

FIXTURE = "tests/data/torch_qdata"
FEATHER = f"{FIXTURE}/data.feather"
WIDE_FEATHER = f"{FIXTURE}/wide.feather"
# the batcher of the published config (configs/experiments/real_data/config.yml)
PUBLISHED = {"one_action": True, "inverse_actions": True, "seed": 4}
LABELS = ("action", "reward", "terminal", "gt", "valid_mask")
MEAN_BOUND = 3.0  # the JAX package's bound for its native decode stage


def expected():
    return np.load(f"{FIXTURE}/expected.npz")


def link_wide_frames() -> int:
    """Make wide.feather's frame files: hard links to the committed frames,
    or copies where the file system has no hard links. Safe to run in
    several processes at once. Returns the number of files."""
    want = expected()
    for link, source in zip(want["wide_links"], want["wide_sources"]):
        link = Path(link)
        if link.exists():
            continue
        link.parent.mkdir(parents=True, exist_ok=True)
        tmp = link.with_name(f".{link.name}.{os.getpid()}")
        try:
            os.link(source, tmp)
        except OSError:
            shutil.copyfile(source, tmp)
        os.replace(tmp, link)
    return len(want["wide_links"])


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_oracle() -> dict:
    """data.feather through the port against expected.npz: the labels,
    reward ratio, first index batches and tables() index maps exactly, and
    each frame's decode at 224 within a mean |difference| of MEAN_BOUND of
    PIL's. Raises AssertionError; returns the decode's per-frame mean
    |difference| (largest and overall) and its largest |difference|."""
    want = expected()
    batcher = QLearningBatcher(FEATHER, image_size=224, **PUBLISHED)
    for k in LABELS:
        got = getattr(batcher, k)
        _require(got.dtype == want[k].dtype and np.array_equal(got, want[k], equal_nan=True),
                 f"label {k} read from {FEATHER} differs from expected.npz")
    _require(batcher.reward_percentage() == float(want["reward_percentage"]),
             "the reward percentage differs from expected.npz")
    stream = batcher.index_stream(want["stream"].shape[1])
    _require(all(np.array_equal(next(stream), rows) for rows in want["stream"]),
             "the index stream differs from the JAX batcher's")
    tables = batcher.tables()
    _require(np.array_equal(tables["before_idx"], want["before_idx"])
             and np.array_equal(tables["after_idx"], want["after_idx"]),
             "tables() index maps differ from the JAX DeviceDataset's")
    frames = load_images([str(p) for p in want["paths"]], 224)
    diff = np.abs(frames.astype(np.int16) - want["frames224"].astype(np.int16))
    per_frame = diff.reshape(len(diff), -1).mean(axis=1)
    _require(per_frame.max() < MEAN_BOUND,
             f"a decoded frame's mean |difference| to PIL's is {per_frame.max()}")
    return {"rows": len(batcher), "frames": len(frames),
            "frame_mean_abs_diff_max": float(per_frame.max()),
            "mean_abs_diff": float(diff.mean()), "max_abs_diff": int(diff.max())}

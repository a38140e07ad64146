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

Two fixtures of the inverse-model slice are made at run time, in a folder
the caller names (tests use tmp_path; chip_smoke.py the gitignored
PAIRS_ROOT and EPISODES_ROOT), from links to the committed frames:
* `make_pairs`: the inverse trainer's 22-column object npy of simulator
  pairs (video_dqn_tpu/data/gibson_pairs.py's layout) over state folders
  `<loc>/0.jpg`;
* `make_episodes`: a dataset folder as process_episodes reads it: frames
  under 4-digit names, seeded detections and indoor/person filters, with
  short ranges, missing files and a video without detections.
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
PAIRS_ROOT = f"{FIXTURE}/pairs"
EPISODES_ROOT = f"{FIXTURE}/episodes"
FRAMES = Path(__file__).resolve().parent / "data" / "torch_qdata" / "frames"
# the batcher of the published config (configs/experiments/real_data/config.yml)
PUBLISHED = {"one_action": True, "inverse_actions": True, "seed": 4}
LABELS = ("action", "reward", "terminal", "gt", "valid_mask")
MEAN_BOUND = 3.0  # the JAX package's bound for its native decode stage


def expected():
    return np.load(f"{FIXTURE}/expected.npz")


def _link(source, link) -> None:
    """A hard link to `source` at `link`, or a copy where the file system
    has no hard links. Safe to run in several processes at once."""
    link = Path(link)
    if link.exists():
        return
    link.parent.mkdir(parents=True, exist_ok=True)
    tmp = link.with_name(f".{link.name}.{os.getpid()}")
    try:
        os.link(source, tmp)
    except OSError:
        shutil.copyfile(source, tmp)
    os.replace(tmp, link)


def link_wide_frames() -> int:
    """Make wide.feather's frame files. Returns the number of files."""
    want = expected()
    for link, source in zip(want["wide_links"], want["wide_sources"]):
        _link(source, link)
    return len(want["wide_links"])


def committed_frames() -> list:
    """The 32 committed frames, sorted."""
    return sorted(FRAMES.glob("*/*.jpg"))


def make_pairs(root, rows: int = 2048, states: int = 512, seed: int = 0,
               name: str = "pairs.npy"):
    """A pairs npy of `rows` rows over `states` state folders
    `<root>/states/s<k>/0.jpg` (links to seeded committed frames): [before
    loc, pos (3), quaternion (4), after loc, pos, quaternion, action 1..3,
    5 class distances in [0, 5)]. The action is a function of the after
    state's frame (its index among the committed frames, mod 3), so that
    a model can learn it. Returns (npy path, image root)."""
    rng = np.random.default_rng(seed)
    sources = committed_frames()
    image_root = Path(root) / "states"
    source_of = rng.integers(0, len(sources), states)
    for k in range(states):
        _link(sources[source_of[k]], image_root / f"s{k:04d}" / "0.jpg")
    table = []
    for _ in range(rows):
        b, a = rng.integers(0, states, 2)
        table.append([f"s{b:04d}", *rng.uniform(-5, 5, 3), *rng.uniform(-1, 1, 4),
                      f"s{a:04d}", *rng.uniform(-5, 5, 3), *rng.uniform(-1, 1, 4),
                      int(1 + source_of[a] % 3), *rng.uniform(0, 5, 5)])
    path = Path(root) / name
    np.save(path, np.array(table, dtype=object))
    return str(path), str(image_root)


def _detections(rng) -> np.ndarray:
    """One frame's (5, 2) object array: per class None and None, or boxes
    (k, 4) and scores (k,) float32, k in 0..3."""
    out = np.empty((5, 2), object)
    for c in range(5):
        if rng.random() < 0.5:
            out[c] = None, None
            continue
        k = int(rng.integers(0, 4))
        out[c, 0] = rng.uniform(0, 224, (k, 4)).astype(np.float32)
        out[c, 1] = rng.uniform(0.5, 1.0, k).astype(np.float32)
    return out


def make_episodes(root, videos: int = 3, frames: int = 40, seed: int = 0) -> str:
    """A dataset folder under `root` as process_episodes reads it:
    frames/<vid>/%04d.jpg (links to seeded committed frames, about 1 in 50
    missing), frames/real_detections_raw.npy (seeded detections of every
    frame id) and filter_out/<vid>_filters.npy (about 1 in 25 frames not
    indoor, 1 in 50 with a person), so that ranges come out long, short
    (dropped) and cut by missing files; plus a video without detections.
    Returns the folder."""
    rng = np.random.default_rng(seed)
    sources = committed_frames()
    root = Path(root)
    for sub in ("frames", "filter_out"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    detections = {}
    for v in range(videos + 1):
        vid = f"vid{v:02d}"
        n = frames if v < videos else 0
        ids = np.arange(1, n + 1)
        for i in ids:
            if rng.random() >= 0.02:
                _link(sources[rng.integers(len(sources))], root / "frames" / vid / f"{i:04d}.jpg")
        detections[vid] = {int(i): _detections(rng) for i in ids}
        np.save(root / "filter_out" / f"{vid}_filters.npy",
                {"indoor_locs": ids[rng.random(n) >= 0.04],
                 "person_locs": ids[rng.random(n) < 0.02]})
    np.save(root / "frames" / "real_detections_raw.npy", detections)
    return str(root)


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

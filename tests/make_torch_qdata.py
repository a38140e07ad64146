"""Write the real-data fixture of the port's training path,
tests/data/torch_qdata/ (committed; rerun only to change it):

    JAX_PLATFORMS=cpu python -m tests.make_torch_qdata

It needs PIL, pandas and the JAX package, and writes:
  frames/vid<k>/<NNNNN>.jpg  JPEG frames as a video's frame dump gives them:
      baseline, quality 90, 4:2:0; vid000 at 1280x720, vid001 at 1280x720
      with optimized Huffman tables, vid002 at 640x360, and vid003 with one
      frame each of 4:4:4, 4:2:2 and grayscale at 640x360 and one with
      restart markers at 1280x720. Smooth moving patterns with mild noise.
  data.feather  the quadruplet schema (video_dqn_tpu/data/schema.py), written
      by the JAX package's write_feather, with frame paths relative to the
      repo root as the published config's are: 512 rows of episodes over
      the four videos (episodes reuse frame files), seeded detector scores
      and inverse actions, and steps_to_reward from label_video_host.
  expected.npz  the oracle for machines with neither PIL nor pandas:
      paths (the unique frames, sorted) and frames224, the JAX package's
      PIL `_load_image` of each at 224; the JAX QLearningBatcher's labels for
      the published config (configs/experiments/real_data/config.yml:
      inverse actions, binary rewards, SEED 4) -- action, reward, terminal,
      gt, valid_mask, reward_percentage -- and its VALUE_LEARNING gt
      (gamma 0.99) as gt_value_learning; its first 4 index_stream batches
      of 256 (stream); the JAX DeviceDataset's before_idx and after_idx;
      and wide.feather's frame files as wide_links and wide_sources.
  wide.feather  the published dataset's decode traffic at a committable
      size: 4,096 rows in episodes of 16-48 frames, every episode in a
      folder of its own (wide/e<k>/), so that a batch of 256 rows names
      nearly 512 distinct frame files, as a batch of the published ~10^5-row
      dataset does. Its frame files are links to the committed frames
      (wide_links -> wide_sources), made at run time by
      tests/torch_qdata.py link_wide_frames into the gitignored wide/.
"""

import os
from pathlib import Path

import numpy as np
import pandas as pd
from PIL import Image

from video_dqn_tpu.data.device_dataset import DeviceDataset
from video_dqn_tpu.data.qlearning import QLearningBatcher, _load_image
from video_dqn_tpu.data.schema import DETECTION_THRESHOLDS, multi_add, write_feather
from video_dqn_tpu.ops.scans import label_video_host

ROOT = Path(__file__).resolve().parents[1]
OUT = Path("tests/data/torch_qdata")
ROWS = 512
WIDE_ROWS = 4096
SEED = 4
# (video, frames, (width, height), save options)
VIDEOS = [
    ("vid000", 14, (1280, 720), {}),
    ("vid001", 10, (1280, 720), {"optimize": True}),
    ("vid002", 4, (640, 360), {}),
]
WIDE_VIDEOS = ("vid000", "vid001", "vid000", "vid002")
SPECIAL = [((640, 360), {"subsampling": 0}), ((640, 360), {"subsampling": 1}),
           ((640, 360), {"gray": True}), ((1280, 720), {"restart_marker_rows": 1})]


def frame(width: int, height: int, k: int, rng) -> np.ndarray:
    """A smooth pattern that drifts with frame k, plus mild noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32) * (1280 / width)
    g = (128 + 70 * np.sin((xx + 9 * k) / 61.0) * np.cos(yy / 47.0 + 0.2 * k)
         + 40 * np.cos((xx - yy) / 113.0 + 0.1 * k))
    img = np.stack([g, 0.8 * np.roll(g, 5, 0) + 20, 0.6 * np.roll(g, 11, 1) + 50], -1)
    return (img + rng.normal(0, 1.5, img.shape)).clip(0, 255).astype(np.uint8)


def save(path: Path, arr: np.ndarray, options: dict) -> None:
    options = dict(options)
    im = Image.fromarray(arr[..., 0] if options.pop("gray", False) else arr)
    path.parent.mkdir(parents=True, exist_ok=True)
    im.save(path, quality=90, **options)


def write_frames(rng) -> dict:
    """{video: number of frames}."""
    counts = {}
    k = 0
    for vid, n, (w, h), options in VIDEOS:
        for i in range(1, n + 1):
            save(OUT / "frames" / vid / f"{i:05d}.jpg", frame(w, h, k, rng), options)
            k += 1
        counts[vid] = n
    for i, ((w, h), options) in enumerate(SPECIAL, 1):
        save(OUT / "frames" / "vid003" / f"{i:05d}.jpg", frame(w, h, k, rng), options)
        k += 1
    counts["vid003"] = len(SPECIAL)
    return counts


def fixture_episodes(counts: dict, rng):
    """data.feather's episodes over the committed videos: (frame directory,
    episode id, start, stop, stride), frames [start, stop) at random."""
    videos = sorted(counts)
    e = 0
    while True:
        vid = videos[e % len(videos)]
        n = counts[vid]
        stride = 1 + e % 2 if n > 4 else 1
        start = int(rng.integers(1, n - stride + 1))
        stop = int(rng.integers(start + stride + 1, n + 2))  # exclusive, as im_stop is
        yield OUT / "frames" / vid, f"{vid}_{e}", start, stop, stride
        e += 1


def wide_episodes(counts: dict, links: dict, rng):
    """wide.feather's episodes: 16-48 frames each, in a directory of its own
    whose frames are links to one video's frames (1280x720 in three episodes
    of four, 640x360 in the fourth); `links` gets {link: committed frame}."""
    e = 0
    while True:
        vid = WIDE_VIDEOS[e % len(WIDE_VIDEOS)]
        n = int(rng.integers(16, 49))
        folder = OUT / "wide" / f"e{e:04d}"
        for i in range(1, n + 1):
            links[str(folder / f"{i:05d}.jpg")] = \
                str(OUT / "frames" / vid / f"{(i - 1) % counts[vid] + 1:05d}.jpg")
        yield folder, f"wide_{e}", 1, n + 1, 1 + e % 2
        e += 1


def write_quadruplets(path: Path, episodes, n_rows: int, rng) -> None:
    """The first n_rows rows of `episodes` (each drawn only when a row is
    still missing) with seeded detector scores, their steps_to_reward and
    inverse actions, through the JAX package's write_feather."""
    rows, scores, fwd, neg = [], [], [], []
    episodes = iter(episodes)
    while len(rows) < n_rows:
        frames, ep_id, start, stop, stride = next(episodes)
        ep = [(i, i + stride) for i in range(start, stop - stride)]
        s = rng.random((len(ep), 5)) * 0.6
        s[rng.random(s.shape) < 0.1] = 0.98
        sparse = (s > DETECTION_THRESHOLDS).astype(np.int64)
        f, g = label_video_host(sparse)
        for (b, a), sc, fw, ng in zip(ep, s, f, g):
            rows.append((str(frames / f"{b:05d}.jpg"), str(frames / f"{a:05d}.jpg"),
                         ep_id, start, stop))
            scores.append(sc)
            fwd.append(fw)
            neg.append(ng)
    df = pd.DataFrame(rows[:n_rows], columns=["before_image", "after_image", "ep_id",
                                              "im_start", "im_stop"])
    scores = np.stack(scores[:n_rows])
    multi_add(df, scores, "detector_score")
    multi_add(df, (scores > DETECTION_THRESHOLDS).astype(np.int64), "sparse_reward")
    multi_add(df, np.stack(fwd[:n_rows]).astype(np.float64), "steps_to_reward")
    multi_add(df, np.stack(neg[:n_rows]).astype(np.float64), "steps_to_reward_neg")
    df["inverse_actions"] = rng.integers(0, 3, n_rows).astype(np.int64)
    write_feather(df, str(path))


def main() -> None:
    os.chdir(ROOT)
    rng = np.random.default_rng(SEED)
    counts = write_frames(rng)
    feather = str(OUT / "data.feather")
    write_quadruplets(Path(feather), fixture_episodes(counts, rng), ROWS, rng)
    links: dict = {}
    wide = str(OUT / "wide.feather")
    write_quadruplets(Path(wide), wide_episodes(counts, links, np.random.default_rng(SEED + 1)),
                      WIDE_ROWS, np.random.default_rng(SEED + 2))
    published = dict(one_action=True, inverse_actions=True, seed=SEED, image_size=224)
    batcher = QLearningBatcher(feather, **published)
    paths = sorted(set(batcher.cols["before_image"]) | set(batcher.cols["after_image"]))
    stream = batcher.index_stream(256)
    dds = DeviceDataset(QLearningBatcher(feather, **published), 256, seed=SEED)
    value = QLearningBatcher(feather, value_learning=True, gamma=0.99, **published)
    np.savez_compressed(
        OUT / "expected.npz", paths=np.array(paths),
        frames224=np.stack([_load_image(p, 224) for p in paths]),
        action=batcher.action, reward=batcher.reward, terminal=batcher.terminal,
        gt=batcher.gt, valid_mask=batcher.valid_mask,
        reward_percentage=np.float64(batcher.reward_percentage()),
        gt_value_learning=value.gt, stream=np.stack([next(stream) for _ in range(4)]),
        before_idx=np.asarray(dds._tables["before_idx"]),
        after_idx=np.asarray(dds._tables["after_idx"]),
        wide_links=np.array(list(links)), wide_sources=np.array(list(links.values())))
    total = sum(f.stat().st_size for f in OUT.rglob("*") if f.is_file() and "wide" not in f.parts)
    print(f"{OUT}: {len(paths)} frames, {len(batcher)} rows, {total / 1e6:.2f} MB")
    wide_batcher = QLearningBatcher(wide, **published)
    stream = wide_batcher.index_stream(256)
    distinct = [len(set(wide_batcher.cols["before_image"][rows])
                    | set(wide_batcher.cols["after_image"][rows])) for rows in
                (next(stream) for _ in range(8))]
    print(f"{wide}: {len(wide_batcher)} rows over {len(links)} linked frames; distinct "
          f"frames in the first 8 batches of 256: {distinct}")


if __name__ == "__main__":
    main()

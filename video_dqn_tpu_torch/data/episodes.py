"""Episode assembly: filtered frames and detections -> the Q-learning
quadruplet feather (counterpart of video_dqn_tpu/data/episodes.py:32-289
`valid_frame_ranges`, `assemble_episodes`, `TableInverseLabeler`,
`make_inverse_labeler`, `process_episodes`), over {column name: numpy
array} in place of a pandas DataFrame.

Per video: contiguous ranges of valid frames (indoor, no person, the jpg
exists), ranges of at most `stride` + 1 frames dropped, rows (i, i +
stride) with the after frame's detector scores, sparse rewards over the
class thresholds, steps_to_reward and steps_to_reward_neg per class
(ops/scans.py), and optionally the inverse model's action labels. The
columns and their dtypes are the JAX frame's (data/schema.py).

`TableInverseLabeler` labels rows the decode-once way: rows grouped by
video folder, each distinct frame decoded once (data/jpeg.py, in chunks of
DECODE_CHUNK) into a uint8 table on the device, then `batch_size` rows at
a time an index_select of the before and after frames, one identity launch
of the resize+normalize kernel over the 2B of them, the model and the
argmax of its calibrated logits. The JAX labeler pads tables and batches
to fixed shapes for XLA's compile cache; eager torch needs neither.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..models.inverse import InverseActionModel
from ..ops.resize_normalize import resize_normalize
from ..ops.scans import label_video_host
from .detect import score_vals
from .jpeg import load_images
from .qlearning import DECODE_CHUNK
from .schema import DETECTION_THRESHOLDS, multi_add, write_feather


def valid_frame_ranges(
    max_frame: int,
    indoor_locs,
    person_locs,
    frame_exists: Callable[[int], bool],
):
    """Contiguous [start, stop) ranges of valid frames (1-based ids)."""
    indoor = set(int(x) for x in indoor_locs)
    person = set(int(x) for x in person_locs)

    def valid(i):
        return i in indoor and i not in person and frame_exists(i)

    ranges = []
    started = None
    for i in range(1, max_frame + 2):
        if valid(i) and started is None:
            started = i
        elif started is not None and not valid(i):
            ranges.append((started, i))
            started = None
    if started is not None:
        raise RuntimeError("bad start")
    return ranges


def assemble_episodes(
    detections: Dict[str, Dict[int, np.ndarray]],
    filters_dir: str,
    frames_root: str,
    stride: int = 3,
    inverse_labeler: Optional[Callable] = None,
    inverse_batch: int = 64,
    image_size: int = 224,
) -> Dict[str, np.ndarray]:
    """The quadruplet columns for all videos ({} when no range qualifies).

    detections:      {vid: {frame_id: (5, 2) class array}}
    filters_dir:     <vid>_filters.npy files
    inverse_labeler: (before_uint8 (B,H,W,3), after_uint8) -> (B,) actions,
                     or a TableInverseLabeler; omitted -> no
                     inverse_actions column
    """
    parts: List[Dict[str, np.ndarray]] = []
    for vid, res in detections.items():
        filt = np.load(os.path.join(filters_dir, f"{vid}_filters.npy"), allow_pickle=True)[()]
        im_ids = sorted(res.keys())
        if not im_ids:
            continue

        def filename(i):
            return os.path.join(frames_root, vid, f"{i:04d}.jpg")

        ranges = valid_frame_ranges(max(im_ids), filt["indoor_locs"], filt["person_locs"],
                                    lambda i: os.path.exists(filename(i)))
        for start, stop in ranges:
            if stop <= start + stride:
                continue
            ids = range(start, stop - stride)
            n = len(ids)
            cols = {"before_image": np.array([filename(i) for i in ids], object),
                    "after_image": np.array([filename(i + stride) for i in ids], object),
                    "ep_id": np.array([vid] * n, object),
                    "im_start": np.full(n, start, np.int64),
                    "im_stop": np.full(n, stop, np.int64)}
            ds = np.stack([score_vals(res[i + stride]) for i in ids])
            multi_add(cols, ds, "detector_score")
            sparse = (ds > DETECTION_THRESHOLDS).astype(np.int64)
            multi_add(cols, sparse, "sparse_reward")
            fwd, neg = label_video_host(sparse)
            multi_add(cols, fwd.astype(np.float64), "steps_to_reward")
            multi_add(cols, neg.astype(np.float64), "steps_to_reward_neg")
            parts.append(cols)

    if not parts:
        return {}
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    if inverse_labeler is not None:
        before, after = list(out["before_image"]), list(out["after_image"])
        if getattr(inverse_labeler, "supports_table", False):
            out["inverse_actions"] = inverse_labeler.label_rows(before, after, image_size)
        else:
            # a plain callable: decode each pair per batch
            acts = []
            for i in range(0, len(before), inverse_batch):
                rows = slice(i, i + inverse_batch)
                acts.append(np.asarray(inverse_labeler(load_images(before[rows], image_size),
                                                       load_images(after[rows], image_size))))
            out["inverse_actions"] = np.concatenate(acts).astype(np.int64)
    return out


class TableInverseLabeler:
    """Batched inverse-action labeler (argmax of the calibrated logits)
    with the decode-once frame table. Also a plain callable `(before_uint8,
    after_uint8) -> actions` for assemble_episodes' pairwise contract.
    `timing` sums the seconds spent decoding and on the device (upload,
    model, copy back) and the rows labelled."""

    supports_table = True

    def __init__(self, model: InverseActionModel, batch_size: int = 512,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.batch_size = int(batch_size)
        self.dtype = dtype
        self.timing = {"decode_s": 0.0, "device_s": 0.0, "rows": 0}

    @torch.no_grad()
    def _logits(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 (2B, S, S, 3) device frames, the before ones first -> the
        float32 (B, 3) calibrated logits."""
        pair = resize_normalize(frames, frames.shape[1], self.dtype)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return self.model.forward_pair(pair, False)[1]

    def __call__(self, before: np.ndarray, after: np.ndarray) -> np.ndarray:
        frames = torch.from_numpy(np.concatenate([before, after])).to(self.device)
        return self._logits(frames).argmax(-1).cpu().numpy()

    def logits_rows(self, before_paths: Sequence[str], after_paths: Sequence[str],
                    image_size: int) -> np.ndarray:
        """The float32 (N, 3) calibrated logits of every (before, after)
        path pair."""
        n = len(before_paths)
        out = np.empty((n, 3), np.float32)
        groups: Dict[str, list] = {}
        for r, p in enumerate(before_paths):
            groups.setdefault(os.path.dirname(p), []).append(r)

        for rows in groups.values():
            uniq: Dict[str, int] = {}
            bidx = np.empty(len(rows), np.int64)
            aidx = np.empty(len(rows), np.int64)
            for j, r in enumerate(rows):
                bidx[j] = uniq.setdefault(before_paths[r], len(uniq))
                aidx[j] = uniq.setdefault(after_paths[r], len(uniq))
            paths = list(uniq)
            t0 = time.perf_counter()
            table = np.empty((len(paths), image_size, image_size, 3), np.uint8)
            for i in range(0, len(paths), DECODE_CHUNK):
                table[i:i + DECODE_CHUNK] = load_images(paths[i:i + DECODE_CHUNK], image_size)
            t1 = time.perf_counter()
            frames = torch.from_numpy(table).to(self.device)
            for i in range(0, len(rows), self.batch_size):
                pick = torch.from_numpy(np.concatenate([bidx[i:i + self.batch_size],
                                                        aidx[i:i + self.batch_size]]))
                logits = self._logits(frames.index_select(0, pick.to(self.device)))
                out[rows[i:i + self.batch_size]] = logits.cpu().numpy()
            self.timing["decode_s"] += t1 - t0
            self.timing["device_s"] += time.perf_counter() - t1
        self.timing["rows"] += n
        return out

    def label_rows(self, before_paths: Sequence[str], after_paths: Sequence[str],
                   image_size: int) -> np.ndarray:
        """Label every (before, after) path pair; returns (N,) int64."""
        return self.logits_rows(before_paths, after_paths, image_size).argmax(1).astype(np.int64)


def make_inverse_labeler(model: InverseActionModel, batch_size: int = 512,
                         dtype: torch.dtype = torch.bfloat16, device=None) -> TableInverseLabeler:
    """The batched labeler over `model` on `device` (None: the card; raises
    without CUDA), with the decode-once table path assemble_episodes uses."""
    return TableInverseLabeler(model, batch_size=batch_size, dtype=dtype, device=device)


def process_episodes(
    location: str = "dataset",
    detections_path: Optional[str] = None,
    inverse_labeler: Optional[Callable] = None,
    stride: int = 3,
    image_size: int = 224,
) -> str:
    """The whole stage: read frames/real_detections_raw.npy and filter_out/
    under `location`, write <location>/data.feather. Returns its path."""
    detections_path = detections_path or os.path.join(location, "frames",
                                                      "real_detections_raw.npy")
    detections = np.load(detections_path, allow_pickle=True)[()]
    cols = assemble_episodes(
        detections,
        filters_dir=os.path.join(location, "filter_out"),
        frames_root=os.path.join(location, "frames"),
        stride=stride,
        inverse_labeler=inverse_labeler,
        image_size=image_size,
    )
    out = os.path.join(location, "data.feather")
    write_feather(cols, out)
    return out

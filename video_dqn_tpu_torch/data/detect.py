"""The reward-detection pass (counterpart of video_dqn_tpu/data/detect.py):
run a detector over every extracted frame and keep, per frame, the boxes
and scores of the 5 target classes.

A frame's detections are a (5, 2) object array: per target class
['bed', 'chair', 'couch', 'dining table', 'toilet'], its boxes (N, 4) and
scores (N,) in descending score order, or None and None when the class
was not detected. `run_detection_pass` writes all videos' arrays to one
`frames/real_detections_raw.npy` dict {video: {frame id: array}}, which
process_episodes reads.

A detector is a callable `detector(images_uint8 (B, H, W, 3)) -> [{boxes
(N, 4), scores (N,), classes (N,)}]` with COCO class indices:
models/detector/inference.py TorchDetector, or StubDetector here for tests
and dry runs.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List

import numpy as np

from .jpeg import load_images

# torchvision's COCO indices of the 5 sorted target classes
# ['bed', 'chair', 'couch', 'dining table', 'toilet']
COCO_TARGET_IDS = {"bed": 65, "chair": 62, "couch": 63, "dining table": 67, "toilet": 70}
TARGET_CLASSES = sorted(COCO_TARGET_IDS.keys())


def detections_to_class_array(det: Dict) -> np.ndarray:
    """One image's detector output -> (5, 2) object array of (boxes,
    scores) per target class, score-sorted within a class."""
    boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
    scores = np.asarray(det["scores"], np.float32)
    classes = np.asarray(det["classes"], np.int64)
    out = np.empty((len(TARGET_CLASSES), 2), object)
    for ci, cname in enumerate(TARGET_CLASSES):
        mask = classes == COCO_TARGET_IDS[cname]
        if mask.any():
            order = np.argsort(-scores[mask])
            out[ci, 0] = boxes[mask][order]
            out[ci, 1] = scores[mask][order]
        else:
            out[ci, 0] = None
            out[ci, 1] = None
    return out


def score_vals(class_array: np.ndarray) -> np.ndarray:
    """(5, 2) class array -> (5,) float64 best score per class, 0 when none."""
    out = np.zeros(len(class_array), np.float64)
    for i, s in enumerate(class_array[:, 1]):
        if s is not None and len(s):
            out[i] = float(np.max(s))
    return out


def run_detection_pass(
    frames_root: str,
    detector: Callable,
    out_path: str = None,
    batch_size: int = 4,
    image_size: int = 224,
) -> Dict[str, Dict[int, np.ndarray]]:
    """Detect over frames_root/<video>/<digits>.jpg, `batch_size` frames a
    call, each decoded to image_size x image_size by the port's JPEG stage
    (data/jpeg.py); returns, and saves to `out_path` when given,
    {video: {frame id: (5, 2) class array}}."""
    results: Dict[str, Dict[int, np.ndarray]] = {}
    for vid in sorted(os.listdir(frames_root)):
        folder = os.path.join(frames_root, vid)
        if not os.path.isdir(folder):
            continue
        files = sorted(f for f in os.listdir(folder) if re.fullmatch(r"\d+\.jpg", f))
        per_video: Dict[int, np.ndarray] = {}
        for i in range(0, len(files), batch_size):
            chunk = files[i:i + batch_size]
            images = load_images([os.path.join(folder, f) for f in chunk], image_size)
            for fname, det in zip(chunk, detector(images)):
                per_video[int(fname.split(".")[0])] = detections_to_class_array(det)
        results[vid] = per_video
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, results, allow_pickle=True)
    return results


class StubDetector:
    """Deterministic synthetic detector for tests and dry runs: per image,
    keyed on a hash of its pixels, each target class is detected above
    threshold with probability `hit_rate`, else below it with probability
    1/2. Its outputs equal the JAX package's StubDetector's bit for bit."""

    def __init__(self, hit_rate: float = 0.15, seed: int = 0):
        self.hit_rate = hit_rate
        self.seed = seed
        self.calls = 0  # one call per fused reasoning stop

    def __call__(self, images, class_label: str = None) -> List[Dict]:
        self.calls += 1
        if class_label is not None:
            # the eval-fusion contract: one image, one class -> (boxes, scores)
            det = self._detect([np.asarray(images)])[0]
            mask = det["classes"] == COCO_TARGET_IDS[class_label]
            return det["boxes"][mask], det["scores"][mask]
        return self._detect(np.asarray(images))

    def _detect(self, images) -> List[Dict]:
        out = []
        for im in np.asarray(images):
            h = int(np.asarray(im, np.uint64).sum() + self.seed) % (2**32)
            rng = np.random.default_rng(h)
            boxes, scores, classes = [], [], []
            for cid in COCO_TARGET_IDS.values():
                if rng.random() < self.hit_rate:
                    boxes.append(rng.uniform(0, im.shape[1], 4))
                    scores.append(rng.uniform(0.95, 1.0))
                    classes.append(cid)
                elif rng.random() < 0.5:
                    boxes.append(rng.uniform(0, im.shape[1], 4))
                    scores.append(rng.uniform(0.1, 0.5))
                    classes.append(cid)
            out.append({"boxes": np.array(boxes, np.float32).reshape(-1, 4),
                        "scores": np.array(scores, np.float32),
                        "classes": np.array(classes, np.int64)})
        return out

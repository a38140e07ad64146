"""Frame filtering (counterpart of video_dqn_tpu/data/filters.py): the
indoor-scene probability of the Places365 AlexNet and the person flag of
the detector, smoothed, into each video's filter npy.

  * io map: label -> 1 if indoor (io_places.txt's column is 1 = indoor,
    2 = outdoor; the reference computes `2 - col`), over the committed
    tables in data/places365/;
  * indoor probability: the sum of the softmax probabilities of the top-10
    classes that are indoor; the top-10 is a stable descending sort, so
    ties break lower index first, as lax.top_k breaks them;
  * person flag: COCO class 1 among the detector's first 5 labels;
  * smoothing: a Gaussian of sigma 6 over the indoor probabilities, then
    round half to even, written in numpy as scipy.ndimage.gaussian_filter1d
    computes it; the person flags by the reference's sequential in-place
    rounded mean over the window v[i-3:i+3] (smoothed values feed later
    windows);
  * output: {'indoor_locs', 'person_locs'}, flat argwhere index arrays,
    saved as one pickled 0-d npy per video, read back with np.load(...)[()].

`make_indoor_classifier` runs the AlexNet over a batch of 224x224 frames
on the card: the frames are copied in pinned, normalized by one launch of
the identity resize+normalize kernel (bf16 out), the model runs under bf16
autocast in channels_last with fc8 in float32, and the softmax, top-10 and
mask dot run in float32. On the CPU everything is float32.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.alexnet_places import INPUT_SIZE
from ..ops.resize_normalize import resize_normalize
from .jpeg import load_images

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data", "places365")
TOP_K = 10


def load_io_map(path: Optional[str] = None) -> Dict[str, int]:
    """label -> 1 (indoor) / 0 (outdoor)."""
    path = path or os.path.join(_DATA_DIR, "io_places.txt")
    out = {}
    with open(path) as f:
        for line in f:
            label, val = line.split()
            out[label[3:]] = 2 - int(val)
    return out


def load_categories(path: Optional[str] = None):
    path = path or os.path.join(_DATA_DIR, "categories_places365.txt")
    classes = []
    with open(path) as f:
        for line in f:
            classes.append(line.strip().split(" ")[0][3:])
    return tuple(classes)


def indoor_mask_vector(categories=None, io_map=None) -> np.ndarray:
    """(365,) float mask: 1 where the class is indoor."""
    categories = categories or load_categories()
    io_map = io_map or load_io_map()
    return np.array([float(io_map[c]) for c in categories], np.float32)


class IndoorClassifier:
    """uint8 (B, 224, 224, 3) frames -> (B,) float32 numpy: the sum of the
    top-10 softmax probabilities over indoor classes. Computes in bf16 on
    the card and in float32 on the CPU; a test sets `dtype =
    torch.float32` to hold the card to the CPU."""

    def __init__(self, model, indoor_mask: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            self.model = self.model.to(memory_format=torch.channels_last)
        self.dtype = torch.bfloat16 if self.on_card else torch.float32
        mask = indoor_mask if indoor_mask is not None else indoor_mask_vector()
        self.mask = torch.tensor(np.asarray(mask, np.float32), device=self.device)

    @torch.no_grad()
    def logits(self, images) -> torch.Tensor:
        """The model's (B, 365) float32 logits on the device, computed in
        `dtype` (fc8 in float32 under bf16 autocast)."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        if x.ndim != 4 or tuple(x.shape[1:]) != (INPUT_SIZE, INPUT_SIZE, 3):
            raise ValueError(f"the indoor classifier takes uint8 (B, {INPUT_SIZE}, "
                             f"{INPUT_SIZE}, 3) frames, got {tuple(x.shape)}")
        if self.on_card:
            x = x.pin_memory().to(self.device, non_blocking=True)
        x = resize_normalize(x, INPUT_SIZE, self.dtype)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return self.model(x).float()

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        probs = torch.softmax(self.logits(images), dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        return (top_p[:, :TOP_K] * self.mask[top_i[:, :TOP_K]]).sum(-1).cpu().numpy()


def make_indoor_classifier(model, indoor_mask: Optional[np.ndarray] = None,
                           device=None) -> IndoorClassifier:
    """The batched indoor-probability scorer over an AlexNetPlaces365 on
    `device` (None: the card; raises without CUDA)."""
    return IndoorClassifier(model, indoor_mask, device)


PERSON_CLASS = 1  # torchvision-style COCO label index


def person_in_top5(labels) -> bool:
    """True if 'person' is among the detector's first 5 labels (detections
    are score-sorted; reference extract_frames.py:144-148)."""
    return PERSON_CLASS in list(labels)[:5]


def smooth_binary_inplace(values, window: int = 6) -> np.ndarray:
    """The reference's sequential in-place rounded-mean smoother
    (extract_frames.py:151-157): each position is replaced by the rounded
    mean of its window, and that replacement feeds later windows."""
    v = list(np.asarray(values, np.float64))
    half = window // 2
    for i in range(half, len(v) - half):
        v[i] = round(float(np.mean(v[i - half : i + half])))
    return np.array(v)


def gaussian_filter1d(values, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d(values, sigma) in float64, mode
    'reflect': scipy's normalized weights of radius int(truncate * sigma +
    0.5) (24 at sigma 6); the series extended half-sample symmetric with
    period 2n (reflected again where it is shorter than the radius); each
    output summed as scipy's correlation sums a symmetric kernel: the
    centre times its weight, then the pairs from the outermost in."""
    x = np.asarray(values, np.float64)
    n = len(x)
    if n == 0:
        return x.copy()
    radius = int(truncate * float(sigma) + 0.5)
    w = np.exp(-0.5 / (float(sigma) * float(sigma)) * np.arange(-radius, radius + 1) ** 2)
    w = w / w.sum()
    j = np.arange(-radius, n + radius) % (2 * n)
    ext = x[np.where(j < n, j, 2 * n - 1 - j)]
    out = ext[radius:radius + n] * w[radius]
    for k in range(radius, 0, -1):
        out = out + (ext[radius - k:radius - k + n] + ext[radius + k:radius + k + n]) * w[radius - k]
    return out


def gaussian_smooth_round(values, sigma: float = 6.0) -> np.ndarray:
    """gaussian_filter1d + per-element round (extract_frames.py:182-184)."""
    sm = gaussian_filter1d(values, sigma)
    return np.array([round(x) for x in sm])


def filter_frames(indoor_probs, person_flags, sigma: float = 6.0,
                  window: int = 6) -> Dict[str, np.ndarray]:
    """Per-video filter output {'indoor_locs', 'person_locs'}."""
    indoor = gaussian_smooth_round(indoor_probs, sigma)
    person = smooth_binary_inplace(np.asarray(person_flags, np.int64), window)
    return {"indoor_locs": np.argwhere(indoor).flatten(),
            "person_locs": np.argwhere(person).flatten()}


def run_filter_pass(frames_root: str, out_dir: str, indoor_scorer: Callable,
                    person_detector: Callable, batch_size: int = 32,
                    image_size: int = 224) -> Dict[str, str]:
    """Filter every video folder under frames_root into
    out_dir/<vid>_filters.npy, `batch_size` frames a call, each decoded to
    image_size x image_size by the port's JPEG stage (data/jpeg.py). A video
    whose output exists is skipped (resume, reference :208-209).
    `person_detector(images)` returns per-image label lists (score-sorted).
    Returns {video: path written}."""
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for vid in sorted(os.listdir(frames_root)):
        folder = os.path.join(frames_root, vid)
        if not os.path.isdir(folder):
            continue
        out_path = os.path.join(out_dir, f"{vid}_filters.npy")
        if os.path.exists(out_path):
            continue
        files = sorted(f for f in os.listdir(folder) if re.fullmatch(r"\d+\.jpg", f))
        if not files:
            continue
        indoor_probs, person_flags = [], []
        for i in range(0, len(files), batch_size):
            chunk = files[i:i + batch_size]
            images = load_images([os.path.join(folder, f) for f in chunk], image_size)
            indoor_probs.extend(np.asarray(indoor_scorer(images)).tolist())
            for labels in person_detector(images):
                person_flags.append(person_in_top5(labels))
        data = filter_frames(indoor_probs, person_flags)
        # stored as a 0-d object array; read back with np.load(...)[()]
        # (same contract as the reference's filter_out npy files)
        np.save(out_path, data, allow_pickle=True)
        written[vid] = out_path
    return written

"""The detector's test helpers, shared by the CPU parity tests, the card
tests and chip_smoke.py: seeded weights under torchvision's
maskrcnn_resnet50_fpn names, detections matched by class, score and box,
and NMS groups of identical or of disjoint boxes. Imports torch, numpy and the port only (no jax, no JAX package), so
that it also runs where only the port is installed."""

import re

import numpy as np
import torch

from video_dqn_tpu_torch.models.detector.maskrcnn import MaskRCNN


def seeded_maskrcnn_state_dict(seed: int = 0, with_masks: bool = True, legacy: bool = False):
    """Seeded weights under torchvision's maskrcnn_resnet50_fpn names (the
    >= 0.13 naming, or the flat legacy one): fan-in-scaled kernels, small
    biases and BatchNorm scales, variances in [0.5, 1), and class-score
    biases spread (N(0, 2)) so that a useful share of the softmax scores
    clears the 0.05 threshold (with zero-mean weights every class scores
    about 1/91). Float32 CPU tensors."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, v in MaskRCNN(with_masks=with_masks).state_dict().items():
        shape = tuple(v.shape)
        if name.endswith("running_var"):
            a = rng.uniform(0.5, 1.0, shape)
        elif name == "roi_heads.box_predictor.cls_score.bias":
            a = rng.standard_normal(shape) * 2.0
        elif len(shape) >= 2:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = rng.standard_normal(shape) * 0.1
        sd[name] = torch.from_numpy(a.astype(np.float32))
    if legacy:
        sd = {_legacy_name(k): v for k, v in sd.items()}
    return sd


def _legacy_name(name: str) -> str:
    """torchvision < 0.13's flat name of a >= 0.13 name."""
    name = re.sub(r"^(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.0\.", r"\1.", name)
    name = re.sub(r"^rpn\.head\.conv\.0\.0\.", "rpn.head.conv.", name)
    return re.sub(r"^roi_heads\.mask_head\.(\d)\.0\.",
                  lambda m: f"roi_heads.mask_head.mask_fcn{int(m[1]) + 1}.", name)


def unmatched_detections(got: dict, want: dict, score_atol: float, box_atol: float,
                         min_score: float = 0.0) -> list:
    """Detections of `got` ({boxes, scores, classes} of one image, numpy)
    above `min_score` with no distinct twin in `want` of the same class,
    a score within score_atol and a box within box_atol (rank order may
    differ where scores tie within noise). Also lists `want`'s detections
    above min_score + score_atol left over."""
    unused = [j for j in range(len(want["scores"])) if want["scores"][j] > min_score]
    missing = []
    for b, s, c in zip(got["boxes"], got["scores"], got["classes"]):
        if s <= min_score:
            continue
        match = [j for j in unused if want["classes"][j] == c
                 and abs(want["scores"][j] - s) <= score_atol
                 and np.abs(want["boxes"][j] - b).max() <= box_atol]
        if match:
            unused.remove(match[0])
        else:
            missing.append(("got", int(c), float(s), b.tolist()))
    return missing + [("want", int(want["classes"][j]), float(want["scores"][j]),
                       want["boxes"][j].tolist())
                      for j in unused if want["scores"][j] > min_score + score_atol]


def identical_boxes(groups: int, n: int) -> np.ndarray:
    """(groups, n, 4) float32, every box the same: NMS keeps the first."""
    return np.broadcast_to(np.float32([20.0, 30.0, 120.0, 150.0]), (groups, n, 4)).copy()


def disjoint_boxes(groups: int, n: int, seed: int) -> np.ndarray:
    """(groups, n, 4) float32 boxes of 8 px on a 10 px grid, shuffled in
    each group: no two overlap, so NMS keeps every one."""
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(seed)
    cells = np.stack([rng.permutation(side * side)[:n] for _ in range(groups)])
    xy = np.stack([cells % side, cells // side], -1) * 10.0
    return np.concatenate([xy, xy + 8.0], -1).astype(np.float32)

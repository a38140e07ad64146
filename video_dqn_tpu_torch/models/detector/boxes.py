"""Box utilities of the detector (counterpart of
video_dqn_tpu/models/detector/boxes.py): anchors, encode/decode, clip, IoU
and the fixed-shape NMS.

Box convention: (x1, y1, x2, y2) in image pixels, float32.

`nms` keeps the JAX contract (kept indices in score order, padded with 0,
and a valid mask). On a CUDA tensor it launches the hand-written kernels in
csrc/nms.cu (and counts the call in `LAUNCHES`) or raises; on a CPU
tensor it runs `nms_reference`, the JAX package's argmax-and-suppress
loop step for step. `nms_groups` is the batched form both call: G groups
of n candidates in one call. The kernels check each group's score order
on the card; `nms_groups` hands that status back unread, so that a caller
(the detector) reads it with its own outputs, in one copy, and `nms`
reads it at once.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Sequence, Tuple

import numpy as np
import torch

from ... import _build

# Kernel launches since the last clear, one a call (its mask and scan
# kernels); chip_smoke.py reads it to show that the detector's path went
# through the kernels.
LAUNCHES: Counter = Counter()

# log(1000 / 16): torchvision's clamp of dw and dh before exp
BBOX_CLAMP = math.log(1000.0 / 16)
# candidates a group may hold on the card: the scan stages two 64-row
# blocks of a group's IoU bitmask (a 64-bit word for every 64 candidates a
# row) in shared memory, 199,168 bytes at 12,288
MAX_GROUP = 12_288
ORDER_ERROR = ("nms: a group's scores are not in descending order (or hold NaN); "
               "sort each group first")


def generate_anchors(
    feat_h: int,
    feat_w: int,
    stride: int,
    sizes: Sequence[float],
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """(H*W*A, 4) float32 anchors centred on the feature grid (torchvision
    AnchorGenerator: zero-centred cell anchors of the given sqrt-area sizes
    and h/w ratios, shifted by the stride)."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            h = np.sqrt(area * ar)
            w = area / h
            cell.append([-w / 2, -h / 2, w / 2, h / 2])
    cell = np.array(cell)  # (A, 4)
    xs = (np.arange(feat_w) + 0.0) * stride
    ys = (np.arange(feat_h) + 0.0) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack(
        [shift_x.ravel(), shift_y.ravel(), shift_x.ravel(), shift_y.ravel()], 1
    )  # (H*W, 4)
    anchors = shifts[:, None, :] + cell[None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) regression deltas (..., 4) to anchors (..., 4)
    (the R-CNN parameterization, dw and dh clamped at log(1000/16))."""
    wx, wy, ww, wh = weights
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_CLAMP)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The inverse of decode_boxes with unit weights (training targets)."""
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    bx = (boxes[..., 0] + boxes[..., 2]) / 2
    by = (boxes[..., 1] + boxes[..., 3]) / 2
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp x to [0, width] and y to [0, height]."""
    return torch.stack([boxes[..., 0].clamp(0, width), boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width), boxes[..., 3].clamp(0, height)],
                       dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU, as
    inter / (area_a + area_b - inter + 1e-9). csrc/nms.cu computes the same
    float32 operations in the same order."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-9)


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                  max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the kernel: video_dqn_tpu's fori_loop of argmax and
    suppress, step for step, over G groups at once. boxes (G, n, 4), scores
    (G, n), in any order -> keep (G, max_out) int32 padded with 0, valid
    (G, max_out) bool."""
    g, n = scores.shape
    iou = box_iou(boxes, boxes)
    rows = torch.arange(g, device=scores.device)
    cols = torch.arange(n, device=scores.device)
    alive = torch.ones((g, n), dtype=torch.bool, device=scores.device)
    keep = torch.zeros((g, max_out), dtype=torch.int32, device=scores.device)
    valid = torch.zeros((g, max_out), dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(-math.inf, dtype=scores.dtype, device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked, dim=1)
        ok = masked[rows, best] > -math.inf
        keep[:, i] = torch.where(ok, best, 0).to(torch.int32)
        valid[:, i] = ok
        suppress = (iou[rows, best] > iou_threshold) | (cols[None, :] == best[:, None])
        alive = torch.where(ok[:, None], alive & ~suppress, alive)
    return keep, valid


class _NmsArgs(ctypes.Structure):
    """Arguments of vdqn_nms (csrc/nms.cu)."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("boxes", "scores", "keep", "valid", "status", "workspace", "stream")]
    _fields_ += [(name, ctypes.c_int) for name in ("groups", "n", "max_out")]
    _fields_ += [("iou_threshold", ctypes.c_float)]


def workspace_bytes(groups: int, n: int) -> int:
    """Bytes of the kernels' workspace: the IoU bitmask, a 64-bit word for
    every 64 candidates of each candidate's row, then an int a 64-candidate
    block (its order check and finite count)."""
    words = -(-n // 64)
    return groups * words * (n * 8 + 4)


def check_nms_status(status) -> None:
    """Raise ValueError where a group's status from nms_groups is set (its scores were out of descending order, or held NaN). status
    is a tensor or a numpy array; a tensor on the card is read back here,
    a synchronize."""
    if bool(status.any()):
        raise ValueError(ORDER_ERROR)


def nms_groups(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_out: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over G independent groups: boxes (G, n, 4) and scores
    (G, n), float32, each group in descending score order (-inf last; a
    -inf candidate is never kept). Returns keep (G, max_out) int32, the
    kept indices in score order padded with 0, valid (G, max_out) bool,
    and status (G,) int32.

    CUDA tensors go to the kernels, which check the order: a group out of
    order keeps nothing and sets its status to 1. The status stays on the
    device, unread, for the caller's check_nms_status, so that the call
    does not synchronize. CPU tensors go to nms_reference, which takes any
    order (status zero)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms takes boxes (G, n, 4) and scores (G, n), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms takes float32 boxes and scores, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if max_out < 1:
        raise ValueError(f"max_out must be positive, got {max_out}")
    g, n = scores.shape
    if boxes.device.type == "cpu":
        keep, valid = nms_reference(boxes, scores, iou_threshold, max_out)
        return keep, valid, torch.zeros(g, dtype=torch.int32)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"nms runs on cuda or cpu, not {boxes.device} / {scores.device}")
    if n > MAX_GROUP:
        raise ValueError(f"nms on the card takes at most {MAX_GROUP} candidates a group, "
                         f"got {n}")
    if boxes.device.index != torch.cuda.current_device():
        with torch.cuda.device(boxes.device):
            return nms_groups(boxes, scores, iou_threshold, max_out)
    boxes, scores = boxes.contiguous(), scores.contiguous()
    keep = torch.empty((g, max_out), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((g, max_out), dtype=torch.bool, device=boxes.device)
    status = torch.empty(g, dtype=torch.int32, device=boxes.device)
    if g == 0 or n == 0:
        keep.zero_(), valid.zero_(), status.zero_()
    else:  # the kernels write every entry
        lib = _build.load()
        workspace = torch.empty(-(-workspace_bytes(g, n) // 8), dtype=torch.int64,
                                device=boxes.device)
        args = _NmsArgs(boxes=boxes.data_ptr(), scores=scores.data_ptr(),
                        keep=keep.data_ptr(), valid=valid.data_ptr(),
                        status=status.data_ptr(), workspace=workspace.data_ptr(),
                        stream=torch.cuda.current_stream().cuda_stream, groups=g, n=n,
                        max_out=max_out, iou_threshold=iou_threshold)
        err = lib.vdqn_nms(ctypes.byref(args))
        if err != 0:
            raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
        LAUNCHES["nms"] += 1
    return keep, valid, status


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape NMS of one set, boxes (n, 4) and scores (n,): keep
    (max_out,) int32, the kept indices in score order padded with 0, and
    valid (max_out,) bool. The scores may come in any order: they are
    sorted (stable, descending, as lax.top_k breaks ties) before
    nms_groups and the indices mapped back. NaN scores raise ValueError
    (on the card, a synchronize)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    keep, valid, status = nms_groups(boxes[order][None], scores[order][None],
                                     iou_threshold, max_out)
    check_nms_status(status)
    keep = torch.where(valid[0], order[keep[0].long()], 0).to(torch.int32)
    return keep, valid[0]


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                      iou_threshold: float, max_out: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS by the coordinate offset (torchvision batched_nms):
    each class's boxes move to a region of their own, offset by
    class * (boxes.max() + 1), so one pass suppresses only within a class."""
    offset = classes.to(boxes.dtype)[:, None] * (boxes.max() + 1.0)
    return nms(boxes + offset, scores, iou_threshold, max_out)

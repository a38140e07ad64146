"""The detector on the card: the NMS kernels against their plain twin
(equal keep lists and valid flags, with ties, -inf rows, groups shorter
than the rest, one group of MAX_GROUP candidates, identical and disjoint
boxes, a max_out cut, and pairs whose IoUs lie within float noise of the
threshold), the normalize prologue at a frame size that is
not square, the whole detector in float32 on the card against the CPU at
128 px, its forward with no host synchronize, and a NaN objectness that
the call raises on after its one copy.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_detector.py
"""

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.models.detector import boxes as pb
from video_dqn_tpu_torch.models.detector.inference import TorchDetector
from video_dqn_tpu_torch.models.detector.maskrcnn import MaskRCNN
from video_dqn_tpu_torch.ops import resize_normalize as rn
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)
from torch_detector_util import (disjoint_boxes, identical_boxes, seeded_maskrcnn_state_dict,
                                 unmatched_detections)

# float32 card detections against the CPU's: both without TF32, so only the
# order of float32 sums differs
SCORE_ATOL, BOX_ATOL = 1e-4, 1e-2


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def sorted_groups(g, n, lengths, seed):
    """G groups of up to n boxes in descending score order: a third of the
    scores tied, near-duplicate boxes, each group padded with -inf past its
    length."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (g, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (g, n, 2))], -1)
    m = boxes[:, 1::3].shape[1]
    boxes[:, 1::3] = boxes[:, :3 * m:3] + rng.normal(0, 2, (g, m, 4))
    scores = rng.random((g, n))
    scores[rng.random((g, n)) < 0.3] = 0.5
    scores = -np.sort(-scores, axis=1)
    for i, m in enumerate(lengths):
        scores[i, m:] = -np.inf
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)))


def identical(boxes):
    return torch.from_numpy(identical_boxes(*boxes.shape[:2]))


def disjoint(boxes):
    return torch.from_numpy(disjoint_boxes(*boxes.shape[:2], seed=boxes.shape[1]))


def near_threshold(boxes):
    """Pairs 20 px apart: a 10 x 10 box in the first half (the higher
    scores), and a 10-wide box 7 +- k * 1e-6 high in the second. A pair's
    IoU steps by about two float32 ulps across 0.7, where the kernel's fast
    quotient cannot decide and the rounded division must; each decision
    shows in the keep list."""
    g, n, _ = boxes.shape
    m = n // 2
    h = 7.0 + (np.arange(m) - m // 2)[None, :] * 1e-6 + np.arange(g)[:, None] * 3e-7
    x = np.broadcast_to(np.arange(m) * 20.0, (g, m))
    out = np.zeros((g, n, 4), np.float32)
    out[:, :m, 0], out[:, :m, 2], out[:, :m, 3] = x, x + 10.0, 10.0
    out[:, m:2 * m, 0], out[:, m:2 * m, 2], out[:, m:2 * m, 3] = x, x + 10.0, h
    return torch.from_numpy(out)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,max_out,thr,layout", [
    pytest.param(20, 1000, 1000, 0.7, None, id="20-1000-1000-0.7"),
    pytest.param(60, 1000, 100, 0.5, None, id="60-1000-100-0.5"),
    pytest.param(7, 48, 48, 0.3, None, id="7-48-48-0.3"),
    pytest.param(3, 5000, 300, 0.7, None, id="3-5000-300-0.7"),
    pytest.param(1, pb.MAX_GROUP, 300, 0.7, None, id="max-group"),
    pytest.param(4, 700, 700, 0.7, identical, id="identical"),
    pytest.param(4, 700, 700, 0.5, disjoint, id="disjoint"),
    pytest.param(20, 1000, 37, 0.7, "cut", id="max-out-cut"),
    pytest.param(3, 400, 400, 0.7, near_threshold, id="near-threshold")])
def test_nms_kernel_matches_reference(g, n, max_out, thr, layout):
    dev = card()
    lengths = np.random.default_rng(g).integers(1, n + 1, g)
    lengths[0] = n
    if callable(layout):
        lengths[:] = n
    boxes, scores = sorted_groups(g, n, lengths, seed=n + g)
    if callable(layout):
        boxes = layout(boxes)
    before = pb.LAUNCHES["nms"]
    keep, valid, status = pb.nms_groups(boxes.to(dev), scores.to(dev), thr, max_out)
    torch.cuda.synchronize()
    assert pb.LAUNCHES["nms"] == before + 1
    assert status.tolist() == [0] * g
    want_keep, want_valid = pb.nms_reference(boxes, scores, thr, max_out)
    assert torch.equal(valid.cpu(), want_valid)
    assert torch.equal(keep.cpu(), want_keep)
    kept = valid.sum(1).cpu()
    assert int(kept.sum()) > 0
    if layout is identical:
        assert kept.tolist() == [1] * g
    elif layout is disjoint:
        assert kept.tolist() == [max_out] * g
    elif layout == "cut":  # the cut bites: the first group would keep more
        assert kept[0] == max_out
        assert int(pb.nms_reference(boxes[:1], scores[:1], thr, n)[1].sum()) > max_out
    elif layout is near_threshold:  # pairs' IoUs on both sides of the threshold
        m = n // 2
        iou = pb.box_iou(boxes[:, :m, None], boxes[:, m:, None])[..., 0, 0]
        assert bool((iou > thr).any()) and bool((iou <= thr).any())
        assert float((iou - thr).abs().min()) < 1e-6
        assert kept.tolist() == (m + (iou <= thr).sum(1)).tolist()


@pytest.mark.cuda
def test_nms_kernel_refuses_unsorted_scores():
    """A group out of order keeps nothing and sets its status, which
    check_nms_status raises on; nms raises at once on a NaN score."""
    dev = card()
    boxes, scores = sorted_groups(2, 64, (64, 64), seed=1)
    scores[1] = scores[1].flip(0)
    _, valid, status = pb.nms_groups(boxes.to(dev), scores.to(dev), 0.5, 10)
    assert not bool(valid[1].any()) and bool(valid[0].any())
    with pytest.raises(ValueError, match="descending"):
        pb.check_nms_status(status)
    scores = scores[0].clone()
    scores[3] = float("nan")
    with pytest.raises(ValueError, match="descending"):
        pb.nms(boxes[0].to(dev), scores.to(dev), 0.5, 10)


@pytest.mark.cuda
def test_nms_status_stays_on_the_card():
    """nms_groups reads nothing back: the status of each group, 1 where
    it is out of order, comes back on the card."""
    dev = card()
    boxes, scores = sorted_groups(3, 64, (64, 64, 64), seed=2)
    scores[1] = scores[1].flip(0)
    boxes, scores = boxes.to(dev), scores.to(dev)
    with torch.cuda.device(dev):
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, status = pb.nms_groups(boxes, scores, 0.5, 10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert status.device.type == "cuda" and status.tolist() == [0, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_normalize_u8_any_size(dtype):
    dev = card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (5, 100, 151, 3), dtype=torch.uint8, device=dev, generator=g)
    before = rn.LAUNCHES["identity", str(dtype)[6:]]
    got = rn.normalize_u8(x, dtype)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["identity", str(dtype)[6:]] == before + 1
    assert got.shape == (5, 3, 100, 151) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, rn.normalize_u8_reference(x).to(dtype))


class no_tf32:
    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


@pytest.mark.cuda
def test_detector_card_matches_cpu_at_128px():
    """float32 on the card, two NMS launches a call (the RPN's levels, the
    final class NMS), the CPU's detections."""
    dev = card()
    sd = seeded_maskrcnn_state_dict(seed=0, with_masks=False)
    models = [MaskRCNN(), MaskRCNN()]
    for m in models:
        m.load_state_dict(sd, strict=True)
    frames = np.random.default_rng(3).integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    want = TorchDetector(models[0], device="cpu")(frames)
    with no_tf32():
        detector = TorchDetector(models[1], device=dev)
        detector.dtype = torch.float32  # the card's bf16 default, off for this comparison
        before = pb.LAUNCHES["nms"]
        got = detector(frames)
        assert pb.LAUNCHES["nms"] == before + 2 and detector.calls == 1
    assert sum(len(d["scores"]) for d in want) > 10, "vacuous: few detections"
    for a, b in zip(got, want):
        assert unmatched_detections(a, b, SCORE_ATOL, BOX_ATOL) == []


def card_detector(dev) -> TorchDetector:
    model = MaskRCNN()
    model.load_state_dict(seeded_maskrcnn_state_dict(seed=0, with_masks=False), strict=True)
    return TorchDetector(model, device=dev)


@pytest.mark.cuda
def test_detector_forward_has_no_host_synchronize():
    """MaskRCNN.forward in bf16 as TorchDetector runs it, under the sync
    debug mode "error": any synchronize inside it (a status read, a host
    list copied to the card) raises. The first call made the per-shape
    tables (anchors, resize indices, ROIAlign's levels) on the card."""
    dev = card()
    detector = card_detector(dev)
    frames = np.random.default_rng(5).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    x = rn.normalize_u8(torch.from_numpy(frames).to(dev), detector.dtype)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        detector.model(x)
        torch.cuda.synchronize()
        before = pb.LAUNCHES["nms"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = detector.model(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert pb.LAUNCHES["nms"] == before + 2
    assert out["nms_status"].shape == (2, 6) and int(out["nms_status"].sum()) == 0
    assert bool(out["valid"].any())


@pytest.mark.cuda
def test_detector_run_raises_on_nan_objectness():
    """A NaN objectness sorts first in its level, so that RPN group is out
    of order: TorchDetector.run raises after its one copy."""
    dev = card()
    detector = card_detector(dev)
    frames = np.random.default_rng(6).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)

    def nan_objectness(module, inputs, output):
        logits, deltas = output
        logits = [t.clone() for t in logits]
        logits[0][:, 0, 0, 0] = float("nan")
        return logits, deltas

    handle = detector.model.rpn.head.register_forward_hook(nan_objectness)
    try:
        with pytest.raises(ValueError, match="descending"):
            detector.run(frames)
    finally:
        handle.remove()
    assert detector.run(frames)["valid"].any()

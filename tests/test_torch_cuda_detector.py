"""The detector on the card: the NMS kernel against its plain twin
(equal keep lists and valid flags, with ties, -inf rows and groups shorter
than the rest), the normalize prologue at a frame size that is not
square, and the whole detector in float32 on the card against the CPU at
128 px.

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
from torch_detector_util import seeded_maskrcnn_state_dict, unmatched_detections

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


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,max_out,thr", [(20, 1000, 1000, 0.7), (60, 1000, 100, 0.5),
                                             (7, 48, 48, 0.3), (3, 5000, 300, 0.7)])
def test_nms_kernel_matches_reference(g, n, max_out, thr):
    dev = card()
    lengths = np.random.default_rng(g).integers(1, n + 1, g)
    lengths[0] = n
    boxes, scores = sorted_groups(g, n, lengths, seed=n + g)
    before = pb.LAUNCHES["nms"]
    keep, valid = pb.nms_groups(boxes.to(dev), scores.to(dev), thr, max_out)
    torch.cuda.synchronize()
    assert pb.LAUNCHES["nms"] == before + 1
    want_keep, want_valid = pb.nms_reference(boxes, scores, thr, max_out)
    assert torch.equal(valid.cpu(), want_valid)
    assert torch.equal(keep.cpu(), want_keep)
    assert int(valid.sum()) > 0


@pytest.mark.cuda
def test_nms_kernel_refuses_unsorted_scores():
    dev = card()
    boxes, scores = sorted_groups(2, 64, (64, 64), seed=1)
    scores[1] = scores[1].flip(0)
    with pytest.raises(ValueError, match="descending"):
        pb.nms_groups(boxes.to(dev), scores.to(dev), 0.5, 10)


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

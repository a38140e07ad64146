"""The dataset front end on the card's machine: the JPEG writer there gives
the bytes PIL's `save` gives here (their SHA-256, pinned from PIL; that
machine has no PIL) and reads back through the port's decoder within its
bound; the indoor classifier on the card, bf16 and float32, against the
CPU, one bf16 identity launch a call; and the AlexNet's refusal of other
input sizes on the card.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_frontend.py
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.data import filters
from video_dqn_tpu_torch.data.jpeg import load_images, save_images
from video_dqn_tpu_torch.models.alexnet_places import AlexNetPlaces365
from video_dqn_tpu_torch.ops import resize_normalize as rn
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)
import torch_qdata
from torch_frontend_util import centred_alexnet_state_dict

# SHA-256 of PIL's files of three seeded 37 x 51 noise frames, one after
# another (Pillow 12.1 over libjpeg-turbo; tests/test_torch_jpeg_encode.py
# holds the writer to PIL byte for byte on the CPU)
PIL_SHA256 = {75: "ef828cc555ffd0b2053e14a7b8a0deb32fe392b8c8764698d250a6180b2cbd3d",
              95: "c4bf453df76790de547b5596976c64f3215cd2ec7d0c6964f29bb40fb3e0ddac"}
BF16_ATOL = 0.02    # bf16 card probabilities against float32 card ones
F32_ATOL = 1e-4     # float32 card probabilities against the CPU's (no TF32 on either)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quality", sorted(PIL_SHA256))
def test_writer_gives_pils_bytes_on_the_cards_machine(tmp_path, quality):
    card()
    noise = np.random.default_rng(7).integers(0, 256, (3, 37, 51, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{i}.jpg") for i in range(3)]
    save_images(paths, noise, quality=quality)
    digest = hashlib.sha256(b"".join(open(p, "rb").read() for p in paths)).hexdigest()
    assert digest == PIL_SHA256[quality]


@pytest.mark.cuda
def test_writer_round_trip(tmp_path):
    card()
    frames = load_images([str(p) for p in torch_qdata.committed_frames()[:8]], 224)
    paths = [str(tmp_path / f"{i:04d}.jpg") for i in range(len(frames))]
    save_images(paths, frames)
    back = load_images(paths, 224)
    for i in range(len(frames)):
        assert np.abs(back[i].astype(np.int16) - frames[i]).mean() < torch_qdata.MEAN_BOUND


@pytest.fixture(scope="module")
def classifier_model():
    card()
    frames = load_images([str(p) for p in torch_qdata.committed_frames()], 224)
    model = AlexNetPlaces365().eval()
    model.load_state_dict(centred_alexnet_state_dict(3, frames))
    return model, frames


@pytest.mark.cuda
def test_indoor_classifier_card_against_cpu(classifier_model):
    device = card()
    model, frames = classifier_model
    want = filters.make_indoor_classifier(model, device="cpu")(frames)
    clf = filters.make_indoor_classifier(copy.deepcopy(model), device=device)
    assert clf.dtype == torch.bfloat16
    before = rn.LAUNCHES["identity", "bfloat16"]
    got_bf16 = clf(frames)
    assert rn.LAUNCHES["identity", "bfloat16"] == before + 1
    clf.dtype = torch.float32
    before = rn.LAUNCHES["identity", "float32"]
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got_f32 = clf(frames)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    assert rn.LAUNCHES["identity", "float32"] == before + 1
    assert want.min() < 0.5 < want.max()
    np.testing.assert_allclose(got_f32, want, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got_bf16, got_f32, rtol=0, atol=BF16_ATOL)


@pytest.mark.cuda
def test_other_sizes_raise_on_the_card(classifier_model):
    device = card()
    model, _ = classifier_model
    clf = filters.make_indoor_classifier(copy.deepcopy(model), device=device)
    with pytest.raises(ValueError, match=r"\(B, 224, 224, 3\)"):
        clf(np.zeros((2, 256, 342, 3), np.uint8))
    with pytest.raises(ValueError, match="224x224"):
        clf.model(torch.zeros(1, 3, 160, 160, device=device))

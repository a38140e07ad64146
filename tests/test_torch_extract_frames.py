"""The port's frame-filter CLI (video_dqn_tpu_torch/extract_frames.py)
against the JAX package's (dataset/extract_frames.py) on the CPU: the
same refusals without weights; --allow-passthrough, alone and with
--stub-detector, writing JAX's npy dicts for the same frames (both read
through the port's decoder: the stub detector hashes pixels, and the two
decoders differ within a mean of 3.0); the Places365 weights and a
seeded Mask R-CNN through the CLI giving what the filter pass gives with
the same models; resume; and --dump raising without CUDA."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_dqn_tpu.data import qlearning as jax_qlearning
from video_dqn_tpu_torch import extract_frames
from video_dqn_tpu_torch.data import filters
from video_dqn_tpu_torch.data.detect import StubDetector
from video_dqn_tpu_torch.data.jpeg import load_images, save_images
from video_dqn_tpu_torch.models.alexnet_places import load_alexnet_places
from video_dqn_tpu_torch.models.detector.inference import load_detector
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests import torch_qdata
from tests.torch_detector_util import seeded_maskrcnn_state_dict
from tests.torch_frontend_util import seeded_alexnet_state_dict

ROOT = Path(__file__).resolve().parents[1]


def jax_cli():
    spec = importlib.util.spec_from_file_location("jax_extract_frames",
                                                  ROOT / "dataset" / "extract_frames.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Two videos of 14 and 9 frames at 224 x 224 (committed fixture
    frames, written by the port's writer)."""
    root = tmp_path_factory.mktemp("cli_frames")
    images = load_images([str(p) for p in torch_qdata.committed_frames()], 224)
    rng = np.random.default_rng(0)
    for v, n in enumerate((14, 9)):
        (root / f"v{v}").mkdir()
        save_images([str(root / f"v{v}" / f"{i:04d}.jpg") for i in range(1, n + 1)],
                    images[rng.integers(len(images), size=n)])
    return root


def read(written):
    return {vid: np.load(path, allow_pickle=True)[()] for vid, path in written.items()}


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for vid in want:
        assert got[vid].keys() == want[vid].keys() == {"indoor_locs", "person_locs"}
        for key in want[vid]:
            assert got[vid][key].dtype == want[vid][key].dtype
            assert np.array_equal(got[vid][key], want[vid][key]), (vid, key)


@pytest.mark.parametrize("flags,missing", [
    ([], "--places-weights and --detector-weights"),
    (["--stub-detector"], "--places-weights would"),
    (["--places-weights", "w.pth"], "--detector-weights would"),
])
def test_refuses_without_weights(frames_dir, tmp_path, monkeypatch, flags, missing):
    argv = ["--frames", str(frames_dir), "--out", str(tmp_path / "out"), *flags]
    with pytest.raises(SystemExit, match=f"filtering without {missing}"):
        extract_frames.main(argv, device="cpu")
    monkeypatch.setattr(sys, "argv", ["extract_frames.py", *argv])
    with pytest.raises(SystemExit, match=f"filtering without {missing}"):
        jax_cli().main()
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("flags", [["--allow-passthrough"],
                                   ["--allow-passthrough", "--stub-detector"]])
def test_passthrough_writes_what_jax_writes(frames_dir, tmp_path, monkeypatch, flags):
    monkeypatch.setattr(jax_qlearning, "load_images", load_images)
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    got = extract_frames.main(["--frames", str(frames_dir), "--out", str(port_out), *flags],
                              device="cpu")
    monkeypatch.setattr(sys, "argv", ["extract_frames.py", "--frames", str(frames_dir),
                                      "--out", str(jax_out), *flags])
    jax_cli().main()
    want = {p.name[:-len("_filters.npy")]: str(p) for p in jax_out.glob("*_filters.npy")}
    assert_same(read(got), read(want))
    assert all(len(d["indoor_locs"]) == n for d, n in zip(read(got).values(), (14, 9)))
    # resume: every output exists, so nothing is written
    assert extract_frames.main(["--frames", str(frames_dir), "--out", str(port_out), *flags],
                               device="cpu") == {}


def test_weights_through_the_cli(frames_dir, tmp_path):
    """--places-weights and --detector-weights: the CLI writes what the
    filter pass writes with the same models on the same frames."""
    places, maskrcnn = tmp_path / "places.pth.tar", tmp_path / "maskrcnn.pth"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in seeded_alexnet_state_dict(seed=1).items()}}, places)
    torch.save(seeded_maskrcnn_state_dict(seed=2, with_masks=False), maskrcnn)
    got = extract_frames.main(["--frames", str(frames_dir), "--out", str(tmp_path / "cli"),
                               "--places-weights", str(places),
                               "--detector-weights", str(maskrcnn)], device="cpu")
    detector = load_detector(str(maskrcnn), device="cpu")
    want = filters.run_filter_pass(
        str(frames_dir), str(tmp_path / "pass"),
        filters.make_indoor_classifier(load_alexnet_places(str(places), "cpu"), device="cpu"),
        lambda images: [d["classes"][np.argsort(-d["scores"])] for d in detector(images)])
    assert_same(read(got), read(want))


def test_stub_detector_labels(frames_dir, tmp_path):
    """--stub-detector: the stub's labels, score-sorted, feed person_in_top5."""
    places = tmp_path / "places.pth"
    torch.save(seeded_alexnet_state_dict(seed=1), places)
    got = extract_frames.main(["--frames", str(frames_dir), "--out", str(tmp_path / "cli"),
                               "--places-weights", str(places), "--stub-detector"],
                              device="cpu")
    stub = StubDetector()
    want = filters.run_filter_pass(
        str(frames_dir), str(tmp_path / "pass"),
        filters.make_indoor_classifier(load_alexnet_places(str(places), "cpu"), device="cpu"),
        lambda images: [d["classes"][np.argsort(-d["scores"])] for d in stub(images)])
    assert_same(read(got), read(want))


def test_dump_raises(tmp_path, monkeypatch):
    # --dump decodes on the host and converts on the card: without CUDA it
    # raises (it runs with device="cpu": tests/test_torch_video.py)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_frames.main(["--dump", "--location", str(tmp_path)])

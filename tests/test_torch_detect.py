"""The port's detection pass and eval fusion against the JAX package's on
the CPU: the stub detector bit for bit, the class arrays, the detection
pass and its CLI writing JAX's .npy layout (both fed the same decoded
frames: the port's JPEG decoder and PIL differ within a mean of 3.0) into
process_episodes, the fusion under both detector contracts, and fused
episodes on the fake env."""

import numpy as np
import pandas as pd
import pytest

from video_dqn_tpu.data import episodes as jax_episodes
from video_dqn_tpu.data import qlearning as jax_qlearning
from video_dqn_tpu.data.detect import StubDetector as JaxStub
from video_dqn_tpu.data.detect import detections_to_class_array as jax_class_array
from video_dqn_tpu.data.detect import run_detection_pass as jax_detection_pass
from video_dqn_tpu.eval import get_eval_defaults as jax_eval_defaults
from video_dqn_tpu.eval.evaluate import fuse_detector_scores as jax_fuse
from video_dqn_tpu.eval.evaluate import ours_evaluate as jax_ours_evaluate
from video_dqn_tpu.eval.fixtures import make_episode_set as jax_episode_set
from video_dqn_tpu.sim.gibson import relevant_locations as jax_relevant
from video_dqn_tpu_torch import detect_real_videos
from video_dqn_tpu_torch import process_episodes as process_cli
from video_dqn_tpu_torch.data import jpeg
from video_dqn_tpu_torch.data.detect import StubDetector, detections_to_class_array
from video_dqn_tpu_torch.eval.evaluate import fuse_detector_scores, ours_evaluate
from video_dqn_tpu_torch.eval.fixtures import make_episode_set
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults
from video_dqn_tpu_torch.sim.gibson import relevant_locations
from tests import torch_port_util, torch_qdata
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

SIZE = 64


def frames(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def assert_same_dets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def assert_same_class_arrays(got, want):
    assert got.shape == want.shape == (5, 2) and got.dtype == want.dtype == object
    for g, w in zip(got.ravel(), want.ravel()):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hit_rate,seed", [(0.15, 0), (0.6, 3)])
def test_stub_detector_is_bit_equal_to_jax(hit_rate, seed):
    ims = frames(16, 48, seed)
    port, jax = StubDetector(hit_rate, seed), JaxStub(hit_rate, seed)
    assert_same_dets(port(ims), jax(ims))
    for cls in ("bed", "chair", "couch", "dining table", "toilet"):
        for g, w in zip(port(ims[3], cls), jax(ims[3], cls)):
            np.testing.assert_array_equal(g, w)
    assert port.calls == jax.calls == 6


def test_detections_to_class_array_equal():
    dets = JaxStub(hit_rate=0.6)(frames(12, 32, 1))
    dets.append({"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
                 "classes": np.zeros(0, np.int64)})
    # two detections of one class, out of score order, and a class outside the targets
    dets.append({"boxes": np.arange(12, dtype=np.float32).reshape(3, 4),
                 "scores": np.array([0.2, 0.9, 0.5], np.float32),
                 "classes": np.array([62, 62, 1])})
    assert any(d is not None for det in dets for d in jax_class_array(det)[:, 0])
    for det in dets:
        assert_same_class_arrays(detections_to_class_array(det), jax_class_array(det))


def test_detection_cli_writes_what_process_episodes_reads(tmp_path, monkeypatch):
    """The detection CLI (stub, batches of 3) writes JAX's layout and
    values for the same frames; process_episodes assembles from it the
    frame the JAX package assembles from its own pass's file."""
    location = torch_qdata.make_episodes(tmp_path / "ds", videos=2, frames=30)
    monkeypatch.setattr(jax_qlearning, "load_images", jpeg.load_images)
    want = jax_detection_pass(f"{location}/frames", JaxStub(), str(tmp_path / "jax.npy"),
                              batch_size=3, image_size=SIZE)
    out = detect_real_videos.main(["--stub", "--location", location, "--batch", "3",
                                   "--image-size", str(SIZE)], device="cpu")
    got = np.load(out, allow_pickle=True)[()]
    assert sorted(got) == sorted(want) and len(got) == 2
    hits = 0
    for vid in want:
        assert sorted(got[vid]) == sorted(want[vid])
        for fid in want[vid]:
            assert_same_class_arrays(got[vid][fid], want[vid][fid])
            hits += sum(s is not None for s in want[vid][fid][:, 1])
    assert hits > 5

    feather = process_cli.main(["--location", location], device="cpu")
    mine = pd.read_feather(feather)
    theirs = pd.read_feather(jax_episodes.process_episodes(
        location, detections_path=str(tmp_path / "jax.npy")))
    assert len(mine) > 10
    pd.testing.assert_frame_equal(mine, theirs)


def test_detection_cli_needs_weights_or_stub(tmp_path):
    """The JAX CLI falls back to the stub with a warning; the port raises."""
    with pytest.raises(ValueError, match="--weights"):
        detect_real_videos.main(["--location", str(tmp_path)], device="cpu")


def per_image(stub):
    """The eval contract alone: detector(im, class_label) -> (boxes, scores)."""
    def detect(im, class_label):
        return stub(im, class_label)
    return detect


@pytest.mark.parametrize("contract", ["batch", "per_image"])
def test_fuse_detector_scores_equal_jax(contract):
    views = frames(12, 48, 5)
    scores = np.linspace(-1, 1, 12)
    bumped = 0
    for cls, thr in (("chair", 0.9), ("bed", 0.3), ("toilet", 0.99)):
        if contract == "batch":
            port, jax = StubDetector(0.5), JaxStub(0.5)
        else:
            port, jax = per_image(StubDetector(0.5)), per_image(JaxStub(0.5))
        got = fuse_detector_scores(scores, list(views), port, cls, thr)
        want = jax_fuse(scores, list(views), jax, cls, thr)
        np.testing.assert_array_equal(got, want)
        bumped += int((got != scores).sum())
    assert bumped > 3


def zero_scorer(images):
    """A scorer without score_dest: waypoints rank by the fused view
    scores alone."""
    return np.zeros(len(images))


def placed(env, ep, house, relevant_locations):
    """The env at the episode's start with its goals, as run_policy sets it."""
    _, floor, class_label, _, pos, rot = ep
    loc = env.sample_start_state(int(floor))[0]
    env.goals = relevant_locations(loc, house.object_locations_for_habitat_dest[class_label])
    env.set_agent_state(pos, rot)
    return env


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "reference_order"])
def test_fused_episodes_equal_jax(batched):
    """COMBINE_DETECTOR with the stub on the fake env: the step logs (STOP
    mode) and SPL equal the JAX package's, and the fusion moved scores."""
    torch_port_util.jax_native_libs()
    for stop in (True, False):
        want_cfg, got_cfg = jax_eval_defaults(), get_eval_defaults()
        for cfg in (want_cfg, got_cfg):
            for k, v in dict(SLAM=True, SEED=1, STOP=stop, COMBINE_DETECTOR=True,
                             CONFIDENCE_THRESHOLD=0.9, BATCHED_REASONING=batched).items():
                cfg[k] = v
        want_eps, want_env, want_house = jax_episode_set(1, size=32, seed=4)
        got_eps, got_env, got_house = make_episode_set(1, size=32, seed=4)
        jax_det, port_det = JaxStub(0.5), StubDetector(0.5)
        ep, house = want_eps[0], want_house(want_eps[0][0])
        want = jax_ours_evaluate(want_cfg, placed(want_env(house, None, want_cfg), ep, house,
                                            jax_relevant),
                                 ep, house, 0, zero_scorer, detector=jax_det)
        ep, house = got_eps[0], got_house(got_eps[0][0])
        got = ours_evaluate(got_cfg, placed(got_env(house, None, got_cfg), ep, house, relevant_locations),
                            ep, house, 0, zero_scorer, detector=port_det, device="cpu")
        assert port_det.calls == jax_det.calls > 0
        if stop:
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0], w[0])
                assert list(g[1:]) == list(w[1:])
        else:
            assert got == want

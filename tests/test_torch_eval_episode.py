"""End-to-end parity of model-scored evaluation: the same two fake-env
episodes run once through the JAX package's batched harness with its own
multiclass scorer (the reference run), once through that harness with the
port's scorer, and through the port's own batched harness with the port's
scorer at pipeline depths 1 and 2 and with 0 or 2 host threads. Every run
must make the same uint8 requests, see scores within 1e-4 and end with SPL
within 1e-5."""

import numpy as np
import pytest

from video_dqn_tpu.eval.batched_runner import make_multiclass_scorer as jax_multiclass
from video_dqn_tpu.eval.batched_runner import run_policy_batched as jax_run_batched
from video_dqn_tpu_torch.core.disk_logger import DiskReader
from video_dqn_tpu_torch.eval.batched_runner import run_policy_batched
from video_dqn_tpu_torch.eval.fixtures import make_env_and_episode
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults, name_from_config
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from tests.test_batched_eval import SIZE, build_fixtures, fresh_env
from tests.test_eval import eval_cfg
from tests import torch_port_util
from tests.torch_port_util import qnet_pair
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

SCORE_ATOL = 1e-4
SPL_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()


class Recorder:
    """Wraps a dispatch/gather scorer; keeps every call and every stop's
    12-view request with its scores."""

    def __init__(self, scorer):
        self.scorer, self.calls, self.stops = scorer, [], []

    def dispatch(self, images, cls):
        return np.array(images), np.array(cls), self.scorer.dispatch(images, cls)

    def gather(self, handle):
        images, cls, inner = handle
        scores = np.asarray(self.scorer.gather(inner))
        self.calls.append((images, cls, scores))
        for i in range(0, len(images), 12):
            self.stops.append((images[i:i + 12], cls[i:i + 12], scores[i:i + 12]))
        return scores

    def __call__(self, images, cls):
        return self.gather(self.dispatch(images, cls))

    def sorted_stops(self):
        """The stops in an order that does not depend on the batching."""
        return sorted(self.stops, key=lambda s: (s[0].tobytes(), s[1].tobytes()))


def assert_same(got_calls, want_calls):
    assert len(got_calls) == len(want_calls) > 2
    for (gx, gc, gs), (wx, wc, ws) in zip(got_calls, want_calls):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL)


def assert_same_spl(got, want):
    assert set(got) == set(want) == {0, 1}
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=SPL_ATOL)


def run_jax_harness(scorer, tmp_path, tag):
    episodes, houses = build_fixtures()
    cfg = eval_cfg(SLAM=True, SEED=1, RESULT_LOCATION=str(tmp_path / tag))
    recorder = Recorder(scorer)
    results = jax_run_batched(
        cfg, episodes, env_factory=fresh_env,
        house_factory=lambda name: houses[name],
        scorer=recorder, class_index_of=True, max_concurrent=2, debug=True,
    )
    return results, recorder


@pytest.fixture(scope="module")
def models():
    return qnet_pair(False, False, SIZE, seed=3)


@pytest.fixture(scope="module")
def reference(models, tmp_path_factory):
    """The JAX harness with the JAX scorer."""
    jm, params, stats, _ = models
    return run_jax_harness(jax_multiclass(jm, params, stats, image_size=SIZE),
                           tmp_path_factory.mktemp("jax"), "jax")


def test_port_scorer_drives_the_harness_like_jax(models, reference, tmp_path):
    want, want_rec = reference
    got, got_rec = run_jax_harness(
        make_multiclass_scorer(models[3], image_size=SIZE, device="cpu"), tmp_path, "port")
    assert_same(got_rec.calls, want_rec.calls)
    assert_same_spl(got, want)


def port_fresh_env(house, config=None):
    env, _, _ = make_env_and_episode(size=SIZE)
    env.goals = []
    return env


@pytest.mark.parametrize("depth,workers", [(1, 0), (2, 2)])
def test_port_harness_matches_jax(models, reference, tmp_path, depth, workers):
    want, want_rec = reference
    episodes, houses = build_fixtures()
    cfg = get_eval_defaults()
    cfg.SLAM, cfg.SEED, cfg.RESULT_LOCATION = True, 1, str(tmp_path)
    recorder = Recorder(make_multiclass_scorer(models[3], image_size=SIZE, device="cpu"))
    got = run_policy_batched(
        cfg, episodes, env_factory=port_fresh_env,
        house_factory=lambda name: houses[name], scorer=recorder,
        class_index_of=True, max_concurrent=2, pipeline_depth=depth,
        host_workers=workers, device="cpu")
    if depth == 1:  # the same calls in the same order
        assert_same(recorder.calls, want_rec.calls)
    assert_same(recorder.sorted_stops(), want_rec.sorted_stops())
    assert_same_spl(got, want)
    on_disk = DiskReader(str(tmp_path / name_from_config(cfg))).data()
    assert on_disk.keys() == {0, 1}
    assert_same_spl(on_disk, want)

"""End-to-end parity through the JAX package's batched eval harness: the
same two fake-env episodes, scored once by the JAX multiclass scorer and
once by the port's, must see the same per-request scores and end with the
same SPL. Only this test composes the two packages."""

import numpy as np

from video_dqn_tpu.eval.batched_runner import make_multiclass_scorer as jax_multiclass
from video_dqn_tpu.eval.batched_runner import run_policy_batched
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from tests.test_batched_eval import SIZE, build_fixtures, fresh_env
from tests.test_eval import eval_cfg
from tests.torch_port_util import qnet_pair


class Recorder:
    """Plain-callable wrapper that keeps every request and its scores."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.calls = []

    def __call__(self, images, cls):
        scores = np.asarray(self.scorer(images, cls))
        self.calls.append((np.array(images), np.array(cls), scores))
        return scores


def run(scorer, tmp_path, tag):
    episodes, houses = build_fixtures()
    cfg = eval_cfg(SLAM=True, SEED=1, RESULT_LOCATION=str(tmp_path / tag))
    recorder = Recorder(scorer)
    results = run_policy_batched(
        cfg, episodes, env_factory=fresh_env,
        house_factory=lambda name: houses[name],
        scorer=recorder, class_index_of=True, max_concurrent=2, debug=True,
    )
    return results, recorder.calls


def test_port_scorer_drives_the_harness_like_jax(tmp_path):
    jm, params, stats, pm = qnet_pair(False, False, SIZE, seed=3)
    want, want_calls = run(jax_multiclass(jm, params, stats, image_size=SIZE),
                           tmp_path, "jax")
    got, got_calls = run(make_multiclass_scorer(pm, image_size=SIZE, device="cpu"),
                         tmp_path, "port")
    assert len(got_calls) == len(want_calls) > 0
    for (gx, gc, gs), (wx, wc, ws) in zip(got_calls, want_calls):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, atol=1e-4)
    assert set(got) == set(want) == {0, 1}
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=1e-5)

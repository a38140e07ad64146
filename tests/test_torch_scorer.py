"""The port's panorama scorers against the JAX ones on the same uint8 views
and the same weights, in float32 on both sides."""

import numpy as np
import pytest

from video_dqn_tpu.eval.batched_runner import make_multiclass_scorer as jax_multiclass
from video_dqn_tpu.eval.evaluate import make_model_scorer as jax_model_scorer
from video_dqn_tpu_torch.eval.scorer import (
    bucket_size,
    make_model_scorer,
    make_multiclass_scorer,
)
from tests.torch_port_util import qnet_pair

SIZE = 32  # basic head: the smallest image the trunk takes to a 1x1 map
ATOL = 1e-4
RENDERS = [(SIZE, SIZE), (40, 48)]  # at model size, and resized


@pytest.fixture(scope="module")
def nets():
    return qnet_pair(extra_capacity=False, panorama=False, image_size=SIZE, seed=5)


@pytest.mark.parametrize("hw", RENDERS)
def test_model_scorer_matches_jax(nets, rng, hw):
    jm, params, stats, pm = nets
    views = rng.integers(0, 256, (5, 1, *hw, 3), np.uint8)
    want = jax_model_scorer(jm, params, stats, 2, image_size=SIZE)(views)
    got = make_model_scorer(pm, 2, image_size=SIZE, device="cpu")(views)
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    # (V, H, W, 3) single-frame views score the same
    got4 = make_model_scorer(pm, 2, image_size=SIZE, device="cpu")(views[:, 0])
    np.testing.assert_allclose(got4, got, atol=1e-6)


@pytest.mark.parametrize("b,hw", [(5, RENDERS[0]), (12, RENDERS[1]),
                                  (13, RENDERS[0]), (30, RENDERS[1])])
def test_multiclass_scorer_matches_jax(nets, rng, b, hw):
    jm, params, stats, pm = nets
    views = rng.integers(0, 256, (b, 1, *hw, 3), np.uint8)
    cls = rng.integers(0, 5, b)
    want = jax_multiclass(jm, params, stats, image_size=SIZE)(views, cls)
    scorer = make_multiclass_scorer(pm, image_size=SIZE, device="cpu")
    got = scorer(views, cls)
    assert got.shape == (b,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    # per-row classes: each row is scored for its own class
    for c in range(5):
        rows = cls == c
        if rows.any():
            one = make_model_scorer(pm, c, image_size=SIZE, device="cpu")(views[rows])
            np.testing.assert_allclose(got[rows], one, atol=1e-5)


def test_dispatch_gather_equals_direct_call(nets, rng):
    _, _, _, pm = nets
    scorer = make_multiclass_scorer(pm, image_size=SIZE, device="cpu")
    a = rng.integers(0, 256, (13, 1, SIZE, SIZE, 3), np.uint8)
    b = rng.integers(0, 256, (7, 1, 40, 48, 3), np.uint8)
    ca, cb = rng.integers(0, 5, 13), rng.integers(0, 5, 7)
    ha, hb = scorer.dispatch(a, ca), scorer.dispatch(b, cb)  # two in flight
    np.testing.assert_array_equal(scorer.gather(hb), scorer(b, cb))
    np.testing.assert_array_equal(scorer.gather(ha), scorer(a, ca))
    unbucketed = make_multiclass_scorer(pm, image_size=SIZE, bucket=False,
                                        device="cpu")
    np.testing.assert_allclose(unbucketed(a, ca), scorer(a, ca), atol=1e-5)


@pytest.mark.parametrize("b,target", [(1, 12), (12, 12), (13, 24), (30, 48),
                                      (96, 96), (97, 192)])
def test_bucket_size(b, target):
    assert bucket_size(b) == target


def test_multiclass_scorer_rejects_bad_requests(nets):
    _, _, _, pm = nets
    scorer = make_multiclass_scorer(pm, image_size=SIZE, device="cpu")
    views = np.zeros((2, 1, SIZE, SIZE, 3), np.uint8)
    for cls in ([0, 5], [-1, 0], [0]):
        with pytest.raises(ValueError):
            scorer.dispatch(views, cls)
    with pytest.raises(ValueError):
        scorer.dispatch(views.astype(np.float32), [0, 0])

"""The port's visualisation on the card, held to the same code on the CPU:
value maps in bf16 (one bf16 identity launch a batch of cells) against
the CPU's float32 maps, the all-class scorer through each kernel path,
and an episode's strip written on the card equal to the CPU's.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_viz.py
"""

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch.data.png import read_png
from video_dqn_tpu_torch.eval.evaluate import make_geodesic_scorer
from video_dqn_tpu_torch.eval.fixtures import make_episode_set
from video_dqn_tpu_torch.eval.policy_config import get_eval_defaults
from video_dqn_tpu_torch.eval.runner import run_policy
from video_dqn_tpu_torch.models.qnet import HabitatDQN, init_qnet
from video_dqn_tpu_torch.ops import resize_normalize as rn
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from video_dqn_tpu_torch.viz.panorama import make_allclass_scorer
from video_dqn_tpu_torch.viz.render_grid import render_grid
from video_dqn_tpu_torch.viz.value_map import build_value_maps
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)

SIZE = 96
BF16_ATOL = 0.05  # bf16 card maps and scores against float32 CPU ones


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the visualisation's default device is the card")


def seeded_net(panorama: bool) -> HabitatDQN:
    return init_qnet(HabitatDQN(action_dim=3, extra_capacity=False, panorama=panorama,
                                image_size=SIZE), torch.Generator().manual_seed(4))


@pytest.mark.cuda
@pytest.mark.parametrize("panorama", [False, True], ids=["single_frame", "panorama"])
def test_value_maps_on_the_card_match_the_cpu(tmp_path, panorama):
    cells = render_grid(FakeNavEnv(image_size=SIZE, seed=3), str(tmp_path), resolution=8)
    cpu = build_value_maps(seeded_net(panorama), str(tmp_path), panorama, resolution=8,
                           image_size=SIZE, batch_size=16, device="cpu")
    rn.LAUNCHES.clear()
    card = build_value_maps(seeded_net(panorama), str(tmp_path), panorama, resolution=8,
                            image_size=SIZE, batch_size=16)
    assert dict(rn.LAUNCHES) == {("identity", "bfloat16"): -(-cells // 16)}
    for got, want in zip(card[0], cpu[0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    np.testing.assert_array_equal(card[2], cpu[2])


@pytest.mark.cuda
@pytest.mark.parametrize("side,path", [(SIZE, "identity"), (128, "banded")])
def test_allclass_scorer_launches_its_kernel(side, path):
    views = np.random.default_rng(side).integers(0, 256, (12, side, side, 3), np.uint8)
    want = make_allclass_scorer(seeded_net(False), image_size=SIZE, device="cpu")(views)
    scorer = make_allclass_scorer(seeded_net(False), image_size=SIZE)
    rn.LAUNCHES.clear()
    got = scorer(views)
    assert dict(rn.LAUNCHES) == {(path, "bfloat16"): 1}
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


@pytest.mark.cuda
def test_episode_strip_on_the_card_equals_the_cpus(tmp_path):
    strips = []
    for device in ("cuda", "cpu"):
        cfg = get_eval_defaults()
        cfg.SLAM, cfg.SEED = True, 1
        cfg.RESULT_LOCATION = str(tmp_path / f"results_{device}")
        cfg.VIDEO_LOCATION = str(tmp_path / f"videos_{device}")
        episodes, env_factory, house_factory = make_episode_set(1, size=64, seed=4)
        run_policy(cfg, episodes, env_factory=env_factory, house_factory=house_factory,
                   scorer_factory=lambda env, ci: make_geodesic_scorer(env),
                   visualize_every=1, device=device)
        strips.append(sorted((tmp_path / f"videos_{device}").rglob("*.png")))
    names = [[p.name for p in s] for s in strips]
    assert names[0] == names[1] and len(names[0]) == 1
    np.testing.assert_array_equal(read_png(str(strips[0][0])), read_png(str(strips[1][0])))

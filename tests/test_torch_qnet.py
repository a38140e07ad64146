"""The port's ResNet18 and HabitatDQN forward against the JAX modules on
the same weights, in float32 on both sides."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_dqn_tpu.models import ResNet18 as JaxResNet18
from video_dqn_tpu.models.torch_convert import convert_resnet18
from video_dqn_tpu_torch.models.qnet import HabitatDQN, build_qnet, head_hw, init_qnet
from video_dqn_tpu_torch.models.resnet import ResNet18
from tests.torch_port_util import qnet_pair
from tests.torch_ref import TorchResNet18
from tests.test_models import randomize

ATOL = 2e-3  # logits-scale tolerance for full-depth nets (test_models.py)


# 128 px gives the extra_capacity head a 2x2 map: at 96 px it is 1x1 and
# the CHW/HWC flatten order of top.0 could not be told apart.
@pytest.mark.parametrize("extra_capacity,panorama,size,batch", [
    (True, False, 128, 2),
    (True, True, 128, 1),
    (False, False, 64, 2),
])
def test_qnet_forward_matches_jax(rng, extra_capacity, panorama, size, batch):
    jm, params, stats, pm = qnet_pair(extra_capacity, panorama, size)
    f = jm.num_frames
    x = rng.standard_normal((batch, f, size, size, 3), dtype=np.float32)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x, False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (batch, 5, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_qnet_channels_last_and_4d_input(rng):
    _, _, _, pm = qnet_pair(False, False, 64)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        want = pm(x[:, None])
        got = pm.to(memory_format=torch.channels_last)(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tap", ["conv", "pool", "logits"])
def test_resnet18_taps_match_jax(rng, tap):
    tm = randomize(TorchResNet18())
    params, stats = convert_resnet18(tm.state_dict(), include_fc=tap == "logits")
    port = ResNet18(features=tap)
    port.load_state_dict(
        {k: v for k, v in tm.state_dict().items()
         if tap == "logits" or not k.startswith("fc.")}, strict=True)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    want = np.asarray(JaxResNet18(features=tap, dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, x, False))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    if tap == "conv":
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_qnet_rejects_bad_frame_count():
    model = HabitatDQN(panorama=True, image_size=64)
    with pytest.raises(ValueError):
        model(torch.zeros((1, 2, 64, 64, 3)))


@pytest.mark.parametrize("size,side", [(224, 5), (128, 2), (96, 1), (64, 0)])
def test_head_hw(size, side):
    assert head_hw(size) == side
    if side < 1:
        with pytest.raises(ValueError):
            HabitatDQN(extra_capacity=True, image_size=size)


def _cfg(**over):
    cfg = dict(VALUE_LEARNING=False, ONE_ACTION=False, ARCHITECTURE="basic",
               PANORAMA=False, PREVIOUS_IMAGES=False)
    cfg.update(over)
    return SimpleNamespace(**cfg)


@pytest.mark.parametrize("over,actions,extra,frames", [
    ({}, 3, False, 1),
    ({"ARCHITECTURE": "extra_capacity"}, 3, True, 1),
    ({"VALUE_LEARNING": True}, 1, False, 1),
    ({"ONE_ACTION": True, "PANORAMA": True}, 1, False, 4),
    ({"PREVIOUS_IMAGES": True, "ARCHITECTURE": "extra_capacity"}, 3, True, 4),
])
def test_build_qnet_reads_config(over, actions, extra, frames):
    model = build_qnet(_cfg(**over), image_size=96, device="cpu")
    assert (model.action_dim, model.extra_capacity, model.num_frames) == (
        actions, extra, frames)
    assert not model.training
    assert model.resnet.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_init_qnet_is_seeded():
    a = init_qnet(HabitatDQN(extra_capacity=True, panorama=False, image_size=96),
                  torch.Generator().manual_seed(4))
    b = init_qnet(HabitatDQN(extra_capacity=True, panorama=False, image_size=96),
                  torch.Generator().manual_seed(4))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.resnet.bn1.weight == 1) and torch.all(a.top[0].bias == 0)
    w = a.top[0].weight
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.05

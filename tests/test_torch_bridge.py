"""The port's weight bridge: JAX init trees load into the port's HabitatDQN
strictly, and reference torch -> JAX converter -> bridge is the identity
on the reference's state dict."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from video_dqn_tpu.models.qnet import HabitatDQN as JaxHabitatDQN
from video_dqn_tpu.models.qnet import init_qnet as jax_init_qnet
from video_dqn_tpu.models.torch_convert import convert_qnet
from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.models.bridge import qnet_state_dict_from_flax
from video_dqn_tpu_torch.models.qnet import HabitatDQN, head_hw
from tests.test_models import randomize
from tests.torch_ref import TorchHabitatDQN
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

# (extra_capacity, panorama, image size): 128 px gives a 2x2 head map
CASES = [(True, False, 128), (True, True, 128), (False, False, 64)]


def reference_sd(extra_capacity, panorama, size, seed=0):
    tm = TorchHabitatDQN(3, extra_capacity=extra_capacity, panorama=panorama)
    # eval before finish(): its probe forward would count a BN batch
    return randomize(tm.eval().finish(size), seed).state_dict()


@pytest.mark.parametrize("extra_capacity,panorama,size", CASES)
def test_jax_init_loads_strictly(extra_capacity, panorama, size):
    jm = JaxHabitatDQN(action_dim=3, extra_capacity=extra_capacity,
                       panorama=panorama)
    params, stats = jax.device_get(jax_init_qnet(jm, jax.random.key(1), size))
    side = head_hw(size)
    sd = qnet_state_dict_from_flax(params, stats, extra_capacity,
                                   jm.num_frames, (side, side))
    pm = HabitatDQN(action_dim=3, extra_capacity=extra_capacity,
                    panorama=panorama, image_size=size)
    pm.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        pm.resnet.conv1.weight.detach().numpy(),
        np.asarray(params["resnet"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    # the trunk appears under features.* as the same modules
    assert pm.features[0] is pm.resnet.conv1


@pytest.mark.parametrize("extra_capacity,panorama,size", CASES)
def test_reference_round_trip_is_identity(extra_capacity, panorama, size):
    ref = reference_sd(extra_capacity, panorama, size)
    frames = 4 if panorama else 1
    side = head_hw(size)
    params, stats = convert_qnet(ref, extra_capacity, frames, (side, side))
    got = qnet_state_dict_from_flax(params, stats, extra_capacity, frames,
                                    (side, side))
    # the reference trunk's unused 1000-way classifier has no Flax twin
    want = {k: v for k, v in ref.items() if not k.startswith("resnet.fc.")}
    assert set(ref) - set(want) == {"resnet.fc.weight", "resnet.fc.bias"}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    pm = HabitatDQN(action_dim=3, extra_capacity=extra_capacity,
                    panorama=panorama, image_size=size)
    assert set(pm.state_dict()) == set(want)


def test_load_eval_model_reads_reference_checkpoint(tmp_path, rng):
    ref_model = TorchHabitatDQN(3, extra_capacity=True, panorama=False)
    ref_model = randomize(ref_model.finish(128), 2)
    path = tmp_path / "vlv_model.torch"
    torch.save({"model_state_dict": ref_model.state_dict()}, path)
    model = load_eval_model(
        SimpleNamespace(PRETRAINED_MODEL_LOCATION=str(path)),
        SimpleNamespace(VALUE_LEARNING=False, ONE_ACTION=False,
                        ARCHITECTURE="extra_capacity", PANORAMA=False,
                        PREVIOUS_IMAGES=False),
        image_size=128, device="cpu")
    x = rng.standard_normal((2, 128, 128, 3), dtype=np.float32)
    with torch.no_grad():
        want = ref_model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        got = model(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_load_eval_model_needs_a_torch_checkpoint():
    with pytest.raises(ValueError):
        load_eval_model(SimpleNamespace(PRETRAINED_MODEL_LOCATION=""),
                        SimpleNamespace(), device="cpu")

"""TPU.REMAT in the port (models/qnet.py: the trunk checkpointed, its
activations recomputed in the backward): in float32 on the CPU a REMAT
step is bit-equal to a plain step for both architectures (the loss, every
gradient, the parameters after Adam, the BatchNorm buffers, which the
recomputation must not move a second time), the trunk really runs again
in the backward, and the port with REMAT steps as the JAX package with
REMAT (nn.remat of its trunk) does, within the train-parity tolerance of
tests/test_torch_train.py."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from video_dqn_tpu.models.qnet import build_qnet as jax_build_qnet
from video_dqn_tpu.train.dqn import TrainState as JaxTrainState
from video_dqn_tpu.train.dqn import make_train_step as jax_make_train_step
from video_dqn_tpu_torch.models import qnet
from video_dqn_tpu_torch.train.dqn import (create_train_state, flax_state_dict,
                                           load_flax_state_dict, make_train_step)
from tests.test_torch_train import (BATCH, LOSS_RTOL, LR, SIZE, assert_state_close, batches,
                                    configs, flax_vars, torch_batch)

ARCHS = ["extra_capacity", "basic"]
STEPS = 2  # with TARGET_UPDATE_INTERVAL 2: a sync before the second step
TPU = {"IMAGE_SIZE": SIZE, "BATCH_SIZE": BATCH, "COMPUTE_DTYPE": "float32"}


def port_config(arch, remat):
    return configs(ARCHITECTURE=arch, TARGET_UPDATE_INTERVAL=2, TPU={**TPU, "REMAT": remat})


def run_port(arch, remat):
    """STEPS steps of the port from the seeded init: each step's loss and
    gradients, the state after, and how often the trunk's first conv ran."""
    _, pcfg = port_config(arch, remat)
    state = create_train_state(pcfg, device="cpu")
    assert state.model.remat == remat
    calls = []
    state.model.resnet.conv1.register_forward_hook(lambda *a: calls.append(1))
    step_fn = make_train_step(state.model, pcfg)
    losses, grads = [], []
    for b in batches(STEPS, seed=20):
        losses.append(step_fn(state, torch_batch(b))["loss"])
        grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()})
    return losses, grads, state, len(calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_steps_are_bit_equal_to_plain_steps(arch):
    plain_losses, plain_grads, plain, plain_calls = run_port(arch, False)
    losses, grads, remat, calls = run_port(arch, True)
    # the graph-building forward runs the trunk once more, in the backward:
    # extra_capacity's before forward (its after forward has no graph),
    # basic's one 2B forward
    assert calls == plain_calls + STEPS
    for k in range(STEPS):
        assert torch.equal(losses[k], plain_losses[k]), k
        assert grads[k].keys() == plain_grads[k].keys()
        for name, g in grads[k].items():
            assert torch.equal(g, plain_grads[k][name]), (k, name)
    for net in ("model", "target"):
        got, want = getattr(remat, net).state_dict(), getattr(plain, net).state_dict()
        assert got.keys() == want.keys()
        for name, value in got.items():  # parameters and every BatchNorm buffer
            assert torch.equal(value, want[name]), (net, name)
    for p, q in zip(remat.optimizer.state.values(), plain.optimizer.state.values()):
        assert all(torch.equal(p[k], q[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    moved = remat.model.resnet.bn1.running_mean.abs().sum() > 0
    assert bool(moved) == (arch == "basic")  # basic's statistics did move, once a step


def test_remat_does_not_checkpoint_forwards_without_a_graph(monkeypatch):
    """The after-state and target forwards run under no_grad: REMAT leaves
    them as they are, and only a forward that builds a graph checkpoints."""
    _, pcfg = port_config("extra_capacity", True)
    state = create_train_state(pcfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, SIZE, SIZE, 3))
                         .astype(np.float32))
    used = []
    monkeypatch.setattr(qnet, "checkpoint", lambda fn, *a, **kw: used.append(1) or fn(*a))
    with torch.no_grad():
        state.model(x)
    assert not used
    state.model(x)
    assert used == [1]


@pytest.fixture(scope="module", params=ARCHS)
def jax_remat_trace(request):
    """Two jitted JAX steps with REMAT: True from the seeded init."""
    arch = request.param
    jcfg, pcfg = port_config(arch, True)
    assert jcfg.TPU.REMAT
    jm = jax_build_qnet(jcfg)
    assert jm.remat
    params, stats = flax_vars(pcfg, seed=0, randomize=False)
    tx = optax.adam(LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          target_params=copy.deepcopy(params),
                          target_batch_stats=copy.deepcopy(stats),
                          opt_state=tx.init(params), ema_loss=jnp.zeros((), jnp.float32))
    step_fn = jax.jit(jax_make_train_step(jm, jcfg, tx))
    data = batches(2, seed=30)
    states, losses = [serialization.to_state_dict(jax.device_get(state))], []
    for b in data:
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        states.append(serialization.to_state_dict(jax.device_get(state)))
    return pcfg, data, losses, states


def test_remat_steps_match_jaxs_remat_steps(jax_remat_trace):
    """Each step from the JAX state before it: the loss within 1e-4 and
    the state after it as tests/test_torch_train.py holds plain steps."""
    pcfg, data, losses, states = jax_remat_trace
    state = create_train_state(pcfg, device="cpu")
    assert state.model.remat
    step_fn = make_train_step(state.model, pcfg)
    for k, b in enumerate(data):
        load_flax_state_dict(state, states[k])
        loss = step_fn(state, torch_batch(b))["loss"]
        np.testing.assert_allclose(float(loss), losses[k], rtol=LOSS_RTOL, err_msg=f"step {k}")
        assert_state_close(flax_state_dict(state), states[k + 1])

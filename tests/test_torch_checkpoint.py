"""`sample<N>.ckpt` between the packages: the port's pure-Python msgpack
against Flax's, the whole train state both ways through the bridge, a
checkpoint of either package restored by the other, and the port's eval
loader reading one."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from video_dqn_tpu.core.checkpoint import restore_checkpoint as jax_restore
from video_dqn_tpu.core.checkpoint import save_checkpoint as jax_save
from video_dqn_tpu.train.dqn import TrainState as JaxTrainState
from video_dqn_tpu_torch.core import msgpack
from video_dqn_tpu_torch.core.checkpoint import (latest_checkpoint_step, restore_checkpoint,
                                                 save_checkpoint)
from video_dqn_tpu_torch.core.experiment import ExperimentConfig
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.eval.load import load_eval_model
from video_dqn_tpu_torch.models.bridge import (adam_from_optax, adam_to_optax,
                                               flax_from_qnet_state_dict, layout,
                                               qnet_state_dict_from_flax)
from video_dqn_tpu_torch.train.dqn import (create_train_state, flax_state_dict,
                                           load_flax_state_dict, make_train_step, run_train)
from tests.test_torch_train import SIZE, configs, randomize_tree, synthetic_batch, torch_batch
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

STEP = 7


def leaves_equal(a, b):
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)


TREE = {"sample_number": 300000, "state": {
    "step": np.asarray(5, np.int32), "kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
    "transposed": np.arange(6.0).reshape(3, 2).T, "big": np.ones(70000, np.float32),
    "empty": {}, "scalar": np.float32(2.5), "ints": [0, 127, 128, -1, -33, -200, -70000,
                                                    2 ** 16, 2 ** 40, -2 ** 40],
    "float": 1.5, "flags": [True, False, None], "name": "x" * 40, "bytes": b"\x00\x01"}}


def test_msgpack_bytes_equal_flax():
    """Every type of the subset, in the bytes Flax writes, and back."""
    ours = msgpack.packb(TREE)
    assert ours == serialization.msgpack_serialize(TREE)
    back = msgpack.unpackb(ours)
    assert back["state"]["ints"] == TREE["state"]["ints"]
    assert back["state"]["scalar"] == np.float32(2.5) and back["state"]["scalar"].dtype == np.float32
    assert back["state"]["step"].shape == () and back["state"]["step"].dtype == np.int32
    np.testing.assert_array_equal(back["state"]["transposed"], TREE["state"]["transposed"])
    assert bytes(back["state"]["bytes"]) == b"\x00\x01" and back["state"]["empty"] == {}
    assert msgpack.packb(msgpack.unpackb(ours)) == ours


def test_msgpack_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        msgpack.packb({"x": {1, 2}})
    with pytest.raises(TypeError):
        msgpack.packb({1: 2})
    with pytest.raises(ValueError):
        msgpack.unpackb(msgpack.packb([1]) + b"\x00")


def port_state(arch="extra_capacity", steps=1):
    """A port train state at 96 px whose Adam moments are live."""
    _, pcfg = configs(ARCHITECTURE=arch, TARGET_UPDATE_INTERVAL=1)
    state = create_train_state(pcfg, device="cpu")
    step_fn = make_train_step(state.model, pcfg)
    for k in range(steps):
        step_fn(state, torch_batch(synthetic_batch(2, 1, SIZE, seed=k)))
    return pcfg, state


def test_train_state_round_trips_through_the_flax_layout():
    """Params, batch statistics, target, Adam and EMA to the Flax state
    dict and back into a fresh state: equal, and equal again out."""
    pcfg, state = port_state("basic")
    tree = flax_state_dict(state)
    assert tree["opt_state"]["1"] == {} and int(tree["opt_state"]["0"]["count"]) == 1
    fresh = create_train_state(pcfg, device="cpu")
    load_flax_state_dict(fresh, tree)
    leaves_equal(flax_state_dict(fresh), tree)
    for name, p in state.model.named_parameters():
        q = dict(fresh.model.named_parameters())[name]
        assert torch.equal(p, q), name
        assert torch.equal(state.optimizer.state[p]["exp_avg_sq"],
                           fresh.optimizer.state[q]["exp_avg_sq"]), name
    assert fresh.step == state.step and torch.equal(fresh.ema_loss, state.ema_loss)


def test_bridge_inverse_is_exact(rng):
    """Flax -> port -> Flax is the identity on params and batch_stats (the
    128 px head reorders a 2x2 map), and so is Adam's mapping."""
    _, pcfg = configs(TPU={"IMAGE_SIZE": 128})
    net = create_train_state(pcfg, device="cpu").model
    params, stats = flax_from_qnet_state_dict(net.state_dict(), *layout(net))
    params, stats = randomize_tree(params, rng), randomize_tree(stats, rng)
    sd = qnet_state_dict_from_flax(params, stats, *layout(net))
    leaves_equal(flax_from_qnet_state_dict(sd, *layout(net)), (params, stats))
    opt = {"count": np.asarray(3, np.int32), "mu": randomize_tree(params, rng),
           "nu": randomize_tree(params, rng)}
    adam = torch.optim.Adam(net.parameters())
    adam_from_optax(adam, net, opt)
    leaves_equal(adam_to_optax(adam, net), opt)


def jax_template(pcfg, tree):
    """The JAX TrainState to restore into: optax.adam's own state layout."""
    tx = optax.adam(pcfg.LEARNING_RATE)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                         batch_stats=tree["batch_stats"], target_params=tree["params"],
                         target_batch_stats=tree["batch_stats"],
                         opt_state=tx.init(tree["params"]),
                         ema_loss=jnp.zeros((), jnp.float32))


def test_port_checkpoint_restores_in_jax(tmp_path):
    pcfg, state = port_state()
    want = flax_state_dict(state)
    path = save_checkpoint(str(tmp_path), STEP, want)
    assert os.listdir(tmp_path) == [f"sample{STEP}.ckpt"] and path.endswith(f"sample{STEP}.ckpt")
    restored = jax_restore(str(tmp_path), STEP, jax.device_get(jax_template(pcfg, want)))
    assert isinstance(restored.opt_state[0], optax.ScaleByAdamState)
    leaves_equal(serialization.to_state_dict(restored), want)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, rng):
    """A JAX-written TrainState loads into the port equal, leaf by leaf,
    and run_train resumes from it."""
    pcfg, state = port_state(steps=0)
    base = flax_state_dict(state)
    params = randomize_tree(base["params"], rng)
    jstate = jax_template(pcfg, base).replace(
        step=jnp.asarray(STEP, jnp.int32), params=params,
        batch_stats=randomize_tree(base["batch_stats"], rng),
        target_params=randomize_tree(base["params"], rng),
        opt_state=(optax.ScaleByAdamState(count=jnp.asarray(STEP, jnp.int32),
                                          mu=randomize_tree(params, rng),
                                          nu=jax.tree_util.tree_map(np.abs,
                                                                    randomize_tree(params, rng))),
                   optax.EmptyState()),
        ema_loss=jnp.asarray(0.25, jnp.float32))
    folder = tmp_path / "exp"
    (folder / "models").mkdir(parents=True)
    jax_save(str(folder / "models"), STEP, jstate)
    want = serialization.to_state_dict(jax.device_get(jstate))
    tree = restore_checkpoint(str(folder / "models"), STEP)
    leaves_equal(tree, want)
    load_flax_state_dict(state, tree)
    leaves_equal(flax_state_dict(state), want)

    (folder / "config.yml").write_text(
        "PANORAMA: False\nARCHITECTURE: 'extra_capacity'\nUSE_INVERSE_ACTIONS: True\n"
        f"LEARNING_RATE: 0.0001\nCHECKPOINT_INTERVAL: {STEP + 1}\nSEED: 4\n"
        f"TPU:\n  BATCH_SIZE: 2\n  IMAGE_SIZE: {SIZE}\n  COMPUTE_DTYPE: float32\n")
    config = ExperimentConfig(str(folder), resume=True)
    tables = synthetic_video_tables(8, 8, SIZE, seed=0)
    resumed, _ = run_train(config, resume_from=STEP, batcher=TableSource(tables),
                           max_steps=STEP + 1, device="cpu")
    assert resumed.step == STEP + 1 and latest_checkpoint_step(config.models_dir) == STEP + 1
    assert int(restore_checkpoint(config.models_dir, STEP + 1)["opt_state"]["0"]["count"]) \
        == STEP + 1


def test_latest_checkpoint_step_is_the_largest(tmp_path):
    assert latest_checkpoint_step(str(tmp_path / "missing")) is None
    for name in ("sample2.ckpt", "sample10.ckpt", "sample3.ckpt.tmp", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint_step(str(tmp_path)) == 10


def test_restore_checks_the_sample_number(tmp_path):
    (tmp_path / "sample3.ckpt").write_bytes(msgpack.packb({"sample_number": 4, "state": {}}))
    with pytest.raises(ValueError, match="sample_number"):
        restore_checkpoint(str(tmp_path), 3)


def test_eval_loader_reads_a_sample_checkpoint(tmp_path, rng):
    pcfg, state = port_state()
    save_checkpoint(str(tmp_path / "models"), STEP, flax_state_dict(state))
    model_config = SimpleNamespace(folder=str(tmp_path), **{
        k: pcfg[k] for k in ("VALUE_LEARNING", "ONE_ACTION", "ARCHITECTURE", "PANORAMA",
                             "PREVIOUS_IMAGES")})
    model = load_eval_model(SimpleNamespace(PRETRAINED_MODEL_LOCATION="", MODEL_NUMBER=STEP),
                            model_config, image_size=SIZE, device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, SIZE, SIZE, 3), dtype=np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model(x), state.model.eval()(x), rtol=0, atol=0)

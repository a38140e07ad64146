"""The port's inverse-action model, its train step, checkpoints, pair
batcher and training CLI against the JAX package's, in float32 on the CPU,
on the same seeded weights (filled by randomize_tree, carried by the
bridge) and inputs. The JAX functions run jitted; the JAX package has no
Pallas call on this path."""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

import train_inverse_model as jax_cli
from video_dqn_tpu.core.checkpoint import save_checkpoint as jax_save
from video_dqn_tpu.data import gibson_pairs as jax_pairs
from video_dqn_tpu.data.episodes import make_inverse_labeler as jax_labeler
from video_dqn_tpu.models.inverse import InverseActionModel as JaxInverse
from video_dqn_tpu.models.torch_convert import convert_inverse
from video_dqn_tpu.ops.image import normalize_imagenet
from video_dqn_tpu.parallel import make_mesh
from video_dqn_tpu.train import inverse as jax_inverse
from video_dqn_tpu_torch import train_inverse_model
from video_dqn_tpu_torch.core.checkpoint import latest_checkpoint_step, save_checkpoint
from video_dqn_tpu_torch.core.metrics import read_metrics
from video_dqn_tpu_torch.data import jpeg
from video_dqn_tpu_torch.data.episodes import make_inverse_labeler
from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher, split_columns
from video_dqn_tpu_torch.models.bridge import (flax_from_inverse_state_dict,
                                               inverse_state_dict_from_flax, model_to_flax)
from video_dqn_tpu_torch.models.inverse import InverseActionModel, head_side, predict_actions
from video_dqn_tpu_torch.train.inverse import (create_inverse_state, exponential_decay,
                                               flax_state_dict, load_flax_state_dict,
                                               load_inverse_checkpoint, make_inverse_step)
from tests import torch_qdata
from tests.torch_port_util import randomize_tree
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)
from tests.torch_ref import TorchInverseModel

LR, DECAY, EVERY, WD = 1e-3, 0.9, 2, 1e-2
ATOL, RTOL = 1e-5, 1e-4          # forward outputs
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4
# the L1 distance of the port's update of the params in one step from
# JAX's, over the L1 norm of JAX's (as tests/test_torch_train.py holds the
# Q-net's step)
UPDATE_RTOL = 0.02


@functools.lru_cache(maxsize=8)
def flax_vars(size, seed=0):
    """Flax (params, batch_stats) of the inverse model at `size` px: the
    port's tree through the bridge, filled with seeded values that exercise
    every BatchNorm and bias mapping. Cached: callers only read."""
    params, stats = flax_from_inverse_state_dict(InverseActionModel(size).state_dict(), size)
    rng = np.random.default_rng(seed)
    return randomize_tree(params, rng), randomize_tree(stats, rng)


def port_model(size, params, stats):
    net = InverseActionModel(size)
    net.load_state_dict(inverse_state_dict_from_flax(params, stats, size), strict=True)
    return net.eval()


def frames(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), np.uint8)


def jax_prep(x):
    return normalize_imagenet(jnp.asarray(x, jnp.float32) / 255.0)


@pytest.mark.parametrize("size,batch", [(128, 4), (192, 2)])
def test_forward_matches_jax(size, batch):
    """SAME padding at 128 px (trunk map 4x4), VALID at 192 (6x6 -> 2x2x64)."""
    params, stats = flax_vars(size)
    x = np.random.default_rng(1).standard_normal((2, batch, size, size, 3)).astype(np.float32)
    jm = JaxInverse(dtype=jnp.float32)
    enc, cal = jax.jit(lambda b, a: jm.apply({"params": params, "batch_stats": stats},
                                             b, a, False))(x[0], x[1])
    with torch.no_grad():
        got = port_model(size, params, stats)(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    assert head_side(size) == {128: 4, 192: 2}[size]
    for g, w in zip(got, (enc, cal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    actions = predict_actions(port_model(size, params, stats), torch.from_numpy(x[0]),
                              torch.from_numpy(x[1]))
    np.testing.assert_array_equal(actions.numpy(), np.asarray(cal).argmax(-1))


def test_reference_torch_checkpoint_loads_strictly(tmp_path):
    """A reference TorchInverseModel state dict (224 px: JAX's
    convert_inverse reads fc1 as a 3x3x64 map) loads into the port with
    strict=True and gives JAX's output on convert_inverse of the same file."""
    torch.manual_seed(3)
    ref = TorchInverseModel().finish(224)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.0)
    path = tmp_path / "inverse_model.torch"
    torch.save({"model_state_dict": ref.state_dict()}, path)
    from video_dqn_tpu_torch.models.bridge import load_torch_state_dict

    net = InverseActionModel(224)
    net.load_state_dict(load_torch_state_dict(str(path)), strict=True)
    params, stats = convert_inverse(ref.state_dict())
    x = np.random.default_rng(2).standard_normal((2, 1, 224, 224, 3)).astype(np.float32)
    _, want = jax.jit(lambda b, a: JaxInverse(dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, b, a, False))(x[0], x[1])
    with torch.no_grad():
        _, got = net.eval()(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
        _, ref_out = ref.eval()(torch.from_numpy(x[0]).permute(0, 3, 1, 2),
                                torch.from_numpy(x[1]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), ref_out.numpy(), atol=ATOL, rtol=RTOL)


def test_bridge_round_trips_the_optimizer_chains(rng):
    """Flax -> port -> Flax is the identity on params and statistics, and
    on both chains: adam(schedule) and adamw(schedule, wd)."""
    params, stats = flax_vars(128)
    net = port_model(128, params, stats)
    leaves_equal(flax_from_inverse_state_dict(net.state_dict(), 128), (params, stats))
    for wd, tx in ((0.0, optax.adam(0.1)), (WD, optax.adamw(0.1, weight_decay=WD))):
        state = create_inverse_state(weight_decay=wd, image_size=128, device="cpu")
        opt = serialization.to_state_dict(tx.init(params))
        assert len(opt) == (3 if wd else 2)
        opt["0"] = {"count": np.asarray(5, np.int32), "mu": randomize_tree(params, rng),
                    "nu": randomize_tree(params, rng)}
        opt[str(len(opt) - 1)] = {"count": np.asarray(5, np.int32)}
        tree = {"step": np.asarray(5, np.int32), "params": params, "batch_stats": stats,
                "opt_state": opt, "dropout_rng": np.array([3, 9], np.uint32)}
        load_flax_state_dict(state, tree)
        leaves_equal(flax_state_dict(state), tree)


def leaves_equal(a, b):
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)


def test_schedule_is_optax_staircase():
    sched = optax.exponential_decay(LR, EVERY, DECAY, staircase=True)
    port = exponential_decay(LR, DECAY, EVERY)
    for count in range(7):
        np.testing.assert_allclose(port(count), float(sched(count)), rtol=1e-7)
    assert exponential_decay(LR, DECAY, 0)(5) == pytest.approx(LR)


STEPS = 4


def jax_tx(wd):
    sched = optax.exponential_decay(init_value=LR, transition_steps=EVERY, decay_rate=DECAY,
                                    staircase=True)
    return optax.adamw(sched, weight_decay=wd) if wd > 0 else optax.adam(sched)


@functools.lru_cache(maxsize=4)
def jax_trace(size, wd):
    """4 jitted JAX steps at B = 2 from the seeded weights with
    decay_every_steps 2 (the rate drops before step 3). Returns the
    batches, and per step the state dict before it, JAX's dropout mask,
    loss, accuracy and head gradients, and the state dict after the last."""
    jm = JaxInverse(dtype=jnp.float32)
    params, stats = flax_vars(size)
    tx = jax_tx(wd)
    state = jax_inverse.InverseTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), dropout_rng=jax.random.key_data(jax.random.key(1)))
    step_fn = jax.jit(jax_inverse.make_inverse_step(jm, tx))

    @jax.jit
    def probe(state, batch):
        rng = jax.random.split(jax.random.wrap_key_data(state.dropout_rng))[0]

        def loss_fn(p):
            (_, logits), inter = jm.apply(
                {"params": p, "batch_stats": state.batch_stats}, jax_prep(batch["before"][:, 0]),
                jax_prep(batch["after"][:, 0]), True, rngs={"dropout": rng},
                capture_intermediates=True, mutable=["intermediates"])
            labels = batch["action"].astype(jnp.int32)
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
            return loss, ((jnp.argmax(logits, -1) == labels).mean(), inter["intermediates"])

        (loss, (acc, inter)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        kept = inter["Dropout_0"]["__call__"][0] != 0
        # where fc1's ReLU is 0 the mask changes nothing: keep it there
        mask = kept | (jax.nn.relu(inter["fc1"]["__call__"][0]) == 0)
        return loss, acc, grads, mask

    rng = np.random.default_rng(7)
    data, steps = [], []
    for k in range(STEPS):
        b = {"before": frames(2, size, 10 + k)[:, None], "after": frames(2, size, 20 + k)[:, None],
             "action": rng.integers(0, 3, 2).astype(np.int32)}
        loss, acc, grads, mask = jax.device_get(probe(state, b))
        steps.append({"state": serialization.to_state_dict(jax.device_get(state)),
                      "loss": float(loss), "accuracy": float(acc), "grads": grads,
                      "mask": np.asarray(mask)})
        state, metrics = step_fn(state, b)
        np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-6)
        data.append(b)
    return data, steps, serialization.to_state_dict(jax.device_get(state))


def update_distance(before, got, want):
    diff = norm = 0.0
    for b, g, w in zip(*(jax.tree_util.tree_leaves(t) for t in (before, got, want))):
        diff += float(np.abs((g - b) - (w - b)).sum())
        norm += float(np.abs(w - b).sum())
    return diff / norm


@pytest.mark.parametrize("size,wd", [(192, 0.0), (128, WD)], ids=["adam-192", "adamw-128"])
def test_train_step_matches_jax_with_its_dropout_mask(size, wd):
    """Each of 4 steps from JAX's state before it, with JAX's own dropout
    mask: loss (1e-5 relative) and accuracy, head gradients (1e-4), the
    update (2% in L1), across the schedule's boundary. The trunk: Adam
    leaves it bit-unchanged; AdamW scales it by 1 - lr * wd a step."""
    data, steps, final = jax_trace(size, wd)
    state = create_inverse_state(LR, DECAY, EVERY, wd, image_size=size, device="cpu")
    step_fn = make_inverse_step(state.model, torch.float32)
    for k, (b, want) in enumerate(zip(data, steps)):
        load_flax_state_dict(state, want["state"])
        trunk = [p.detach().clone() for p in state.model.trunk_parameters()]
        out = step_fn(state, {key: torch.from_numpy(v) for key, v in b.items()},
                      dropout_mask=torch.from_numpy(want["mask"].copy()))
        np.testing.assert_allclose(float(out["loss"]), want["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"step {k}")
        assert float(out["accuracy"]) == want["accuracy"]
        grads = model_to_flax({n: p.grad for n, p in state.model.named_parameters()},
                              "params", state.model)
        for name in ("conv1", "conv2", "conv3", "fc1", "fc2", "fc_accuracy"):
            jax.tree_util.tree_map(
                lambda g, w: np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0),
                grads[name], want["grads"][name])
        after = steps[k + 1]["state"] if k + 1 < STEPS else final
        got = flax_state_dict(state)
        dist = update_distance(want["state"]["params"], got["params"], after["params"])
        assert dist <= UPDATE_RTOL, (k, dist)
        assert got["opt_state"][str(len(got["opt_state"]) - 1)]["count"] == k + 1
        lr = exponential_decay(LR, DECAY, EVERY)(k)
        for before, p in zip(trunk, state.model.trunk_parameters()):
            if wd:
                torch.testing.assert_close(p.detach(), before * (1 - lr * wd), rtol=1e-6, atol=0)
            else:
                assert torch.equal(p.detach(), before)


@pytest.fixture
def jitted_jax_init(monkeypatch):
    """JAX's create_inverse_state initializes the model op by op, which
    costs a process's first call ~14 s more on the CPU than the same init
    jitted."""
    monkeypatch.setattr(jax_inverse, "init_inverse",
                        jax.jit(jax_inverse.init_inverse, static_argnums=(0, 2)))


def test_checkpoints_restore_both_ways_and_label_alike(tmp_path, jitted_jax_init):
    """A port sample<N>.ckpt restores in JAX's load_inverse_checkpoint
    (params, statistics, optimizer chain, step and key equal), a JAX one in
    the port's, and the restored models give the same labels (float32)."""
    size = 64
    state = create_inverse_state(LR, DECAY, EVERY, image_size=size, device="cpu")
    state.model.load_state_dict(inverse_state_dict_from_flax(*flax_vars(size), size))
    step_fn = make_inverse_step(state.model, torch.float32)
    for k in range(2):
        step_fn(state, {"before": torch.from_numpy(frames(2, size, k)),
                        "after": torch.from_numpy(frames(2, size, 5 + k)),
                        "action": torch.tensor([0, 2])})
    want = flax_state_dict(state)
    save_checkpoint(str(tmp_path / "port"), 2, want)
    _, restored = jax_inverse.load_inverse_checkpoint(str(tmp_path / "port"), image_size=size)
    leaves_equal(serialization.to_state_dict(jax.device_get(restored)), want)

    jax_save(str(tmp_path / "jax"), 2, restored)
    back = load_inverse_checkpoint(str(tmp_path / "jax"), image_size=size, device="cpu")
    leaves_equal(flax_state_dict(back), want)

    before, after = frames(8, size, 30), frames(8, size, 31)
    jl = jax_labeler(JaxInverse(dtype=jnp.float32), restored.params, restored.batch_stats,
                     batch_size=8)
    pl = make_inverse_labeler(back.model, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(pl(before, after), jl(before, after))


# -- the pair batcher ---------------------------------------------------------

def test_split_columns_errors():
    with pytest.raises(ValueError):
        split_columns(np.zeros((3, 10)), [4, 4])


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return torch_qdata.make_pairs(tmp_path_factory.mktemp("pairs"), rows=40, states=24, seed=2)


@pytest.mark.parametrize("kwargs", [
    {}, {"class_label": "all"}, {"known": True, "reward_dist": 2.0},
    {"class_label": "chair", "gamma": 0.5, "cache_images": True}],
    ids=["toilet", "all", "known", "chair_cached"])
def test_pair_batcher_matches_jax(pairs, monkeypatch, kwargs):
    """Labels, the known filter, class selection, and both index streams
    (get_batch without indices; batches' epoch permutations across an
    epoch's end) bit-equal to the JAX batcher's, frames too when both
    decode with the port's JPEG stage."""
    npy, root = pairs
    monkeypatch.setattr(jax_pairs, "load_images", jpeg.load_images)
    args = dict(image_root=root, image_size=32, seed=3, **kwargs)
    port, ref = GibsonPairBatcher(npy, **args), jax_pairs.GibsonPairBatcher(npy, **args)
    assert len(port) == len(ref) and (len(port) < 40) == bool(kwargs.get("known"))
    for name in ("before_loc", "after_loc", "action", "reward", "terminal", "gt"):
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    draws = [port.get_batch(batch_size=5) for _ in range(2)] + \
        [b for b, _ in zip(port.batches(8), range(len(port) // 8 + 2))]
    wants = [ref.get_batch(batch_size=5) for _ in range(2)] + \
        [b for b, _ in zip(ref.batches(8), range(len(ref) // 8 + 2))]
    for got, want in zip(draws, wants):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert draws[0]["before"].shape == (5, 1, 32, 32, 3)


# -- run_inverse_train and the CLI ---------------------------------------------

def test_cli_matches_the_jax_cli(pairs, tmp_path, monkeypatch, capsys, jitted_jax_init):
    """Both CLIs on the same npy at 32 px, B = 8, 5 steps, validating every
    2 steps over 1 batch: the same checkpoints (sample2, 4 and the final
    5), metric tags and steps, and final line; the port's checkpoint holds
    5 steps and restores in the port."""
    npy, root = pairs
    flags = ["--train_data", npy, "--val_data", npy, "--image_root", root, "--image_size", "32",
             "--batch_size", "8", "--num_steps", "5", "--lr_decay_every", "0.5"]
    # one device: the JAX CLI compiles for a mesh of all 8 CPU devices
    # otherwise, which costs this test ~10 s and changes none of its checks
    monkeypatch.setattr(jax_inverse, "run_inverse_train", functools.partial(
        jax_inverse.run_inverse_train, validate_every=2, val_batches=1,
        mesh=make_mesh(data=1, devices=jax.devices()[:1])))
    monkeypatch.setattr(sys, "argv", ["train_inverse_model.py", *flags,
                                      "--out_dir", str(tmp_path / "jax")])
    jax_cli.main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    state, accuracy = train_inverse_model.main([*flags, "--out_dir", str(tmp_path / "port")],
                                               device="cpu", validate_every=2, val_batches=1)
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    for line in (jax_line, port_line):
        assert line.startswith("Final val accuracy: ") and len(line.split()[-1]) == 6, line
    assert port_line == f"Final val accuracy: {accuracy:.4f}"
    names = {side: sorted(p.name for p in (tmp_path / side).glob("sample*.ckpt"))
             for side in ("jax", "port")}
    assert names["port"] == names["jax"] == ["sample2.ckpt", "sample4.ckpt", "sample5.ckpt"]
    tags = {side: sorted((r["tag"], r["step"]) for r in read_metrics(str(tmp_path / side)))
            for side in ("jax", "port")}
    assert tags["port"] == tags["jax"] and len(tags["port"]) == 8
    assert all(np.isfinite(r["value"]) for r in read_metrics(str(tmp_path / "port")))
    assert state.step == 5 and latest_checkpoint_step(str(tmp_path / "port")) == 5
    back = load_inverse_checkpoint(str(tmp_path / "port"), image_size=32, device="cpu")
    leaves_equal(flax_state_dict(back), flax_state_dict(state))

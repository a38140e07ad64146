"""The port's double-DQN loss, gradients and train step against the JAX
package's on the same seeded weights and batches, in float32 on the CPU
(the JAX side as tests/test_train.py runs it), and the port's init and
BatchNorm against Flax's. The JAX functions run jitted: on this CPU a
jitted loss compiles in about 1.6 s, where running it op by op costs 20 s
the first time and 2 s after."""

import contextlib
import copy
import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
from flax import serialization

from video_dqn_tpu.core import get_cfg_defaults as jax_cfg_defaults
from video_dqn_tpu.data.synthetic import synthetic_batch
from video_dqn_tpu.models.qnet import build_qnet as jax_build_qnet
from video_dqn_tpu.train.dqn import TrainState as JaxTrainState
from video_dqn_tpu.train.dqn import make_loss_fn as jax_make_loss_fn
from video_dqn_tpu.train.dqn import make_train_step as jax_make_train_step
from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.models.bridge import (flax_from_qnet_state_dict, layout,
                                               qnet_state_dict_from_flax, to_flax)
from video_dqn_tpu_torch.models.qnet import (TRUNCATED_NORMAL_STD, HabitatDQN, build_qnet,
                                             init_qnet)
from video_dqn_tpu_torch.models.resnet import BatchNorm2d
from video_dqn_tpu_torch.train import dqn
from video_dqn_tpu_torch.train.dqn import (PHASES, create_train_state, flax_state_dict,
                                           load_flax_state_dict, make_loss_fn,
                                           make_train_step)
from tests.torch_port_util import randomize_tree
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)

SIZE, BATCH, LR = 96, 4, 1e-4
LOSS_RTOL = 1e-4


def configs(**over):
    """The same config in both packages: the published run's keys at
    96 px, float32."""
    base = {"PANORAMA": False, "ARCHITECTURE": "extra_capacity", "USE_INVERSE_ACTIONS": True,
            "LOSS_CLIP": "rect", "GAMMA": 0.99, "LEARNING_RATE": LR, "SEED": 4,
            "TPU": {"IMAGE_SIZE": SIZE, "BATCH_SIZE": BATCH, "COMPUTE_DTYPE": "float32"}}
    base.update(over)
    jcfg, pcfg = jax_cfg_defaults(), get_cfg_defaults()
    jcfg.merge_from_dict(base)
    pcfg.merge_from_dict(base)
    return jcfg, pcfg


@functools.lru_cache(maxsize=8)
def _flax_vars(arch, one_action, seed, randomize):
    _, pcfg = configs(ARCHITECTURE=arch, ONE_ACTION=one_action)
    net = init_qnet(build_qnet(pcfg, SIZE, device="cpu"), torch.Generator().manual_seed(seed))
    params, stats = flax_from_qnet_state_dict(net.state_dict(), *layout(net))
    if not randomize:
        return params, stats
    rng = np.random.default_rng(seed)
    return randomize_tree(params, rng), randomize_tree(stats, rng)


def flax_vars(pcfg, seed, randomize=True):
    """Flax (params, batch_stats) of the config's Q-net: the port's seeded
    init through the bridge, or, with `randomize`, seeded values that
    exercise every BatchNorm and bias mapping. Cached: callers only read."""
    return _flax_vars(pcfg.ARCHITECTURE, bool(pcfg.ONE_ACTION or pcfg.VALUE_LEARNING),
                      seed, randomize)


def port_net(pcfg, params, stats):
    net = build_qnet(pcfg, SIZE, device="cpu")
    net.load_state_dict(qnet_state_dict_from_flax(params, stats, *layout(net)), strict=True)
    return net


def batches(n, seed=0, **edit):
    out = []
    for i in range(n):
        b = synthetic_batch(BATCH, 1, SIZE, seed=seed + i)
        for k, fn in edit.items():
            b[k] = fn(b[k])
        out.append(b)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def nan_first_row(gt):
    gt = gt.copy()
    gt[0] = np.nan
    return gt


LOSS_VARIANTS = {
    "plain": ({"LOSS_CLIP": "none"}, {}),
    "rect": ({}, {}),
    "linear": ({"LINEAR": True}, {}),
    "remove_before": ({"REMOVE_BEFORE_REWARD": True},
                      {"valid_mask": lambda m: (np.arange(m.size).reshape(m.shape) % 2)
                       .astype(np.float32)}),
    "ground_truth": ({"TRAIN_ON_GROUND_TRUTH": True}, {}),
    "value_learning_nan_gt": ({"TRAIN_ON_GROUND_TRUTH": True, "VALUE_LEARNING": True},
                              {"gt": nan_first_row}),
    # a single-action head fed inverse-action labels 0-2: clip mode
    "one_action_labels_0_2": ({"ONE_ACTION": True},
                              {"action": lambda a: np.array([0, 1, 2, 2], np.int32)}),
    "basic": ({"ARCHITECTURE": "basic"}, {}),
}


@pytest.mark.parametrize("variant", list(LOSS_VARIANTS))
def test_loss_matches_jax(variant):
    over, edit = LOSS_VARIANTS[variant]
    jcfg, pcfg = configs(**over)
    jm = jax_build_qnet(jcfg)
    params, stats = flax_vars(pcfg, seed=0)
    tparams, tstats = flax_vars(pcfg, seed=1)
    (b,) = batches(1, seed=3, **edit)
    want, want_stats = jax.jit(jax_make_loss_fn(jm, jcfg))(params, tparams, stats, tstats, b)

    online, target = port_net(pcfg, params, stats), port_net(pcfg, tparams, tstats)
    online.set_train(True)
    with torch.no_grad():
        got = make_loss_fn(online, pcfg)(online, target.eval(), torch_batch(b))
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    if variant == "basic":  # the 2B train-mode forward moved the running statistics
        got_stats = to_flax(online.state_dict(), "batch_stats", *layout(online))
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5),
            got_stats, jax.device_get(want_stats))


# The dtype both packages compute each architecture's gradient in for the
# comparison. basic's float32 gradient, through the batch statistics of
# its one 2B train-mode forward, moves by up to 3.3% of a leaf's largest
# in the JAX package, and by up to 1.1% in the port, with nothing but the
# order of float32 sums changed (the port's CPU thread count); the two
# packages' float64 gradients agree within 1e-6 (numbers from
# tests/torch_precision_report.py). So basic's is compared in float64:
# the same code, the prologue's float32 output upcast.
GRAD_DTYPE = {"extra_capacity": "float32", "basic": "float64"}


def grad_inputs(arch):
    """The port's config, the online and target variables (params,
    tparams, stats, tstats) and the batch of the gradient checks."""
    _, pcfg = configs(ARCHITECTURE=arch)
    params, stats = flax_vars(pcfg, seed=0)
    tparams, tstats = flax_vars(pcfg, seed=1)
    (b,) = batches(1, seed=5)
    return pcfg, (params, tparams, stats, tstats), b


def jax_grads(arch, dtype):
    """The JAX package's gradient of the loss w.r.t. the online params,
    computed in `dtype` (float32 or float64)."""
    jcfg, _ = configs(ARCHITECTURE=arch, TPU={"IMAGE_SIZE": SIZE, "BATCH_SIZE": BATCH,
                                              "COMPUTE_DTYPE": dtype})
    _, variables, b = grad_inputs(arch)
    jloss = jax_make_loss_fn(jax_build_qnet(jcfg), jcfg)
    with jax.enable_x64(dtype == "float64"):
        params, tparams, stats, tstats = (
            jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), v) for v in variables)
        return jax.device_get(
            jax.jit(jax.grad(lambda p: jloss(p, tparams, stats, tstats, b)[0]))(params))


def port_grads(arch, dtype="float32"):
    """The port's gradient of the same loss, as a Flax tree. In float64
    the nets and the batch are float64, fed the prologue's output upcast."""
    pcfg, (params, tparams, stats, tstats), b = grad_inputs(arch)
    online, target = port_net(pcfg, params, stats), port_net(pcfg, tparams, tstats)
    batch = torch_batch(b)
    with contextlib.ExitStack() as stack:
        if dtype == "float64":
            online, target = online.double(), target.double()
            batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
            stack.enter_context(upcast_prologue())
        make_loss_fn(online.set_train(True), pcfg)(online, target.eval(), batch).backward()
    return to_flax({n: p.grad for n, p in online.named_parameters()}, "params", *layout(online))


@contextlib.contextmanager
def upcast_prologue():
    """The train step's prologue, its float32 output cast to float64."""
    saved = dqn.resize_normalize
    dqn.resize_normalize = lambda x, out, dtype: saved(x, out, torch.float32).double()
    try:
        yield
    finally:
        dqn.resize_normalize = saved


def leaf_pairs(got, want):
    """(path, got leaf, want leaf) for every leaf of `want`."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        yield path, np.asarray(g), np.asarray(w)


@pytest.mark.parametrize("arch", list(GRAD_DTYPE))
def test_gradients_match_jax(arch):
    """Every parameter's gradient of the rect loss, leaf by leaf through
    the bridge: rtol 1e-3 against the leaf's largest gradient. For the
    published extra_capacity, and for basic with its train-mode
    BatchNorm."""
    want = jax_grads(arch, GRAD_DTYPE[arch])
    got = port_grads(arch, GRAD_DTYPE[arch])
    pairs = list(leaf_pairs(got, want))
    assert len(pairs) == len(jax.tree_util.tree_leaves(got))
    for path, g, w in pairs:
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale, err_msg=str(path))


TRACE_STEPS = 4


@pytest.fixture(scope="module", params=["extra_capacity", "basic"])
def jax_trace(request):
    return run_jax_trace(request.param)


def run_jax_trace(arch):
    """One jitted JAX step per architecture: 4 steps from the seeded init
    (lecun_normal kernels, BatchNorm at (0, 1)) with TARGET_UPDATE_INTERVAL
    2, so the target syncs before steps 2 and 4. Returns the port's
    config, the batches, the losses and the state dict before each step
    and after the last."""
    jcfg, pcfg = configs(ARCHITECTURE=arch, TARGET_UPDATE_INTERVAL=2)
    jm = jax_build_qnet(jcfg)
    params, stats = flax_vars(pcfg, seed=0, randomize=False)
    tx = optax.adam(LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          target_params=copy.deepcopy(params),
                          target_batch_stats=copy.deepcopy(stats),
                          opt_state=tx.init(params), ema_loss=jnp.zeros((), jnp.float32))
    step_fn = jax.jit(jax_make_train_step(jm, jcfg, tx))
    data = batches(TRACE_STEPS, seed=10)
    states, losses = [serialization.to_state_dict(jax.device_get(state))], []
    for b in data:
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        states.append(serialization.to_state_dict(jax.device_get(state)))
    return pcfg, data, losses, states


def assert_state_close(got, want):
    """Params within 4 learning rates: Adam moves an element by about lr a
    step whatever its gradient's size, so one whose gradient is below the
    float32 noise of its sum flips sign between the packages and parts by
    ~2 lr. Running statistics at rtol 1e-4."""
    assert int(got["step"]) == int(want["step"])
    np.testing.assert_allclose(got["ema_loss"], want["ema_loss"], rtol=LOSS_RTOL)
    for field in ("params", "target_params", "batch_stats", "target_batch_stats"):
        rtol, atol = (0, 4 * LR) if "params" in field else (1e-4, 1e-5)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got[field]),
                                jax.tree_util.tree_leaves(want[field])):
            err = np.abs(g - w) - (atol + rtol * np.abs(w))
            assert g.shape == w.shape and err.max() <= 0, (field, path, err.max())
    assert int(got["opt_state"]["0"]["count"]) == int(want["opt_state"]["0"]["count"])


# The L1 distance between the port's and JAX's update of the params in one
# step, over the L1 norm of JAX's: up to 0.3% measured (basic, step 4,
# where ~0.1% of the elements take Adam's step the other way); a skipped
# update is 100% off and a negated one 200%.
UPDATE_RTOL = 0.02


def update_distance(before, got, want):
    """sum |(got - before) - (want - before)| / sum |want - before| over
    every params leaf."""
    diff = norm = 0.0
    for b, g, w in zip(*(jax.tree_util.tree_leaves(t) for t in (before, got, want))):
        diff += float(np.abs((g - b) - (w - b)).sum())
        norm += float(np.abs(w - b).sum())
    return diff / norm


def test_train_step_trace_matches_jax(jax_trace):
    """Each of the 4 steps from the JAX state before it: the loss, the
    update it makes to the params, and the state after it (params, target
    after the syncs, running statistics, Adam's count, EMA), through the
    state-dict bridge. After each sync the target is the loaded params,
    bit for bit."""
    pcfg, data, losses, states = jax_trace
    state = create_train_state(pcfg, device="cpu")
    step_fn = make_train_step(state.model, pcfg)
    for k, b in enumerate(data):
        load_flax_state_dict(state, states[k])
        loss = step_fn(state, torch_batch(b))["loss"]
        np.testing.assert_allclose(float(loss), losses[k], rtol=LOSS_RTOL, err_msg=f"step {k}")
        got = flax_state_dict(state)
        assert_state_close(got, states[k + 1])
        dist = update_distance(states[k]["params"], got["params"], states[k + 1]["params"])
        assert dist <= UPDATE_RTOL, (k, dist)
        if (k + 1) % pcfg.TARGET_UPDATE_INTERVAL == 0:
            for target, online in (("target_params", "params"),
                                   ("target_batch_stats", "batch_stats")):
                jax.tree_util.tree_map(np.testing.assert_array_equal,
                                       got[target], states[k][online])
    moved = states[0]["batch_stats"]["resnet"]["bn1"]["mean"] != \
        states[TRACE_STEPS]["batch_stats"]["resnet"]["bn1"]["mean"]
    assert moved.any() == (pcfg.ARCHITECTURE == "basic")


def test_free_running_trace_matches_jax(jax_trace):
    """The published architecture's 4 steps on the port's own state. (Not
    basic's: there the few Adam updates of step 1 that flip with a
    gradient below float32 noise pass through train-mode BatchNorm, and
    the free-running losses can part beyond 1e-4 within 4 steps; each
    step from the same state, and the update it makes, is held by
    test_train_step_trace_matches_jax.)"""
    pcfg, data, losses, states = jax_trace
    if pcfg.ARCHITECTURE != "extra_capacity":
        return
    state = create_train_state(pcfg, device="cpu")
    load_flax_state_dict(state, states[0])
    step_fn = make_train_step(state.model, pcfg)
    got = [float(step_fn(state, torch_batch(b))["loss"]) for b in data]
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    assert_state_close(flax_state_dict(state), states[TRACE_STEPS])


def test_train_step_marks_phases_in_order():
    _, pcfg = configs(TARGET_UPDATE_INTERVAL=1)
    state = create_train_state(pcfg, device="cpu")
    seen = []
    make_train_step(state.model, pcfg)(state, torch_batch(batches(1)[0]), seen.append)
    assert tuple(seen) == PHASES


def test_init_is_truncated_lecun_normal():
    """Flax's lecun_normal: a standard normal truncated to [-2, 2], scaled
    to variance 1/fan_in, so |w| <= 2/0.8796 sqrt(1/fan_in); an
    untruncated draw of the 1.2M-value layer4 kernel passes 4.5."""
    model = init_qnet(HabitatDQN(extra_capacity=True, panorama=False, image_size=SIZE),
                      torch.Generator().manual_seed(0))
    for name, w in model.named_parameters():
        if w.dim() < 2:
            continue
        z = w.detach().double() * np.sqrt(w[0].numel()) * TRUNCATED_NORMAL_STD
        assert float(z.abs().max()) <= 2.0 + 1e-5, name
        if w.numel() > 100_000:
            assert float(z.abs().max()) > 1.99, name
            np.testing.assert_allclose(float(z.std()), TRUNCATED_NORMAL_STD, rtol=0.01)
    jax_w = nn.initializers.lecun_normal()(jax.random.key(0), (3, 3, 512, 512))
    w = model.resnet.layer4[1].conv2.weight.detach()
    np.testing.assert_allclose(float(w.std()), float(jnp.std(jax_w)), rtol=0.01)
    np.testing.assert_allclose(float(w.abs().max()), float(jnp.abs(jax_w).max()), rtol=0.01)


def test_batchnorm_train_update_matches_flax(rng):
    """Normalized output and running statistics after two train-mode
    batches: Flax momentum 0.9 with the biased variance."""
    x = rng.standard_normal((2, 4, 5, 5, 6), dtype=np.float32) * 3 + 1
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = fbn.init(jax.random.key(0), x[0])
    bn = BatchNorm2d(6).train()
    for xi in x:
        want, mut = fbn.apply(variables, xi, mutable=["batch_stats"])
        variables = {**variables, **mut}
        got = bn(torch.from_numpy(xi).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
    stats = jax.device_get(variables["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["extra_capacity", "basic"])
def test_set_train_keeps_the_frozen_trunk(arch):
    net = HabitatDQN(extra_capacity=arch == "extra_capacity", panorama=False,
                     image_size=SIZE).set_train(True)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 20 and net.training and net.top.training
    assert all(m.training == (arch == "basic") for m in bns)


def test_backbone_weights_load_into_the_trunk(tmp_path):
    """BACKBONE_WEIGHTS: a torchvision resnet18 state dict (with its
    classifier) sets the trunk's weights and statistics; the head keeps
    its seeded init."""
    from video_dqn_tpu_torch.models.resnet import ResNet18

    donor = init_qnet(ResNet18(features="logits"), torch.Generator().manual_seed(7))
    with torch.no_grad():
        for m in donor.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.uniform_(-1, 1)
    path = tmp_path / "resnet18.pth"
    torch.save(donor.state_dict(), path)
    _, pcfg = configs(BACKBONE_WEIGHTS=str(path))
    state = create_train_state(pcfg, device="cpu")
    want = donor.state_dict()
    for k, v in state.model.resnet.state_dict().items():
        assert torch.equal(v, want[k]), k
    _, plain = configs()
    fresh = create_train_state(plain, device="cpu").model
    assert torch.equal(state.model.top[0].weight, fresh.top[0].weight)
    assert torch.equal(state.target.resnet.conv1.weight, want["conv1.weight"])

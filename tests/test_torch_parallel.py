"""The port's mesh, sharding and data-parallel paths against the JAX
package's on meshes of the same shape (video_dqn_tpu_torch/parallel).

JAX runs on make_mesh(D, M, devices=jax.devices()[:D*M]) of the conftest's
8 CPU devices; the port's ranks are gloo processes
(tests/torch_parallel_ranks.py) that read the seeded batches (numpy) and
the JAX states from tmp_path and write their results back. Each port step
starts from JAX's state before it (teacher forcing), so every step is
held on its own. Tolerances are tests/test_train.py's for a sharded JAX
step against one device: per-step losses rtol 1e-4, atol 5e-5; the update
a step makes (params, target, Adam's moments), as the relative L2 of its
difference, under 0.25 a leaf and 0.05 over the tree. A wrong slice or a
gradient multiplied by M reads 70-100% there."""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import optax
from flax import serialization

from video_dqn_tpu.core import get_cfg_defaults as jax_cfg_defaults
from video_dqn_tpu.data.synthetic import synthetic_batch
from video_dqn_tpu.models.qnet import build_qnet as jax_build_qnet
from video_dqn_tpu.parallel import make_mesh as jax_make_mesh
from video_dqn_tpu.parallel import shard_batch as jax_shard_batch
from video_dqn_tpu.parallel.sharding import param_specs as jax_param_specs
from video_dqn_tpu.train.dqn import TrainState as JaxTrainState
from video_dqn_tpu.train.dqn import jit_train_step
from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
from video_dqn_tpu_torch.core.defaults import get_cfg_defaults
from video_dqn_tpu_torch.data.device_dataset import DeviceDataset, check_capacity
from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
from video_dqn_tpu_torch.eval.scorer import make_multiclass_scorer
from video_dqn_tpu_torch.models.bridge import entries, flax_from_qnet_state_dict, layout
from video_dqn_tpu_torch.models.qnet import HabitatDQN, build_qnet, init_qnet
from video_dqn_tpu_torch.models.resnet import BatchNorm2d
from video_dqn_tpu_torch.parallel.mesh import Mesh, make_mesh
from video_dqn_tpu_torch.parallel.sharding import ShardedLinear, param_specs, shard_head
from video_dqn_tpu_torch.parallel import multihost
from video_dqn_tpu_torch.train.dqn import _whole_net, create_train_state
from video_dqn_tpu_torch.core.metrics import MetricsWriter, read_metrics
from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher
from video_dqn_tpu_torch.train.inverse import create_inverse_state, run_inverse_train
from video_dqn_tpu_torch.train.inverse import flax_state_dict as inverse_tree
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)
from tests import torch_qdata
from tests.torch_parallel_ranks import launch

SIZE, BATCH, LR, STEPS = 96, 8, 1e-4, 3
LOSS_RTOL, LOSS_ATOL = 1e-4, 5e-5
LEAF_RTOL, TREE_RTOL = 0.25, 0.05
DATA_STEPS = (0, 1, 17)
BAD_MESHES = ((-1, 3), (3, 1))


def configs(arch, data, model):
    base = {"PANORAMA": False, "ARCHITECTURE": arch, "USE_INVERSE_ACTIONS": True,
            "LOSS_CLIP": "rect", "GAMMA": 0.99, "LEARNING_RATE": LR, "SEED": 4,
            "TARGET_UPDATE_INTERVAL": 2,
            "TPU": {"IMAGE_SIZE": SIZE, "BATCH_SIZE": BATCH, "COMPUTE_DTYPE": "float32",
                    "MESH_DATA": data, "MESH_MODEL": model}}
    jcfg, pcfg = jax_cfg_defaults(), get_cfg_defaults()
    jcfg.merge_from_dict(base)
    pcfg.merge_from_dict(base)
    return jcfg, pcfg, base


def jax_steps(tmp, arch, data, model):
    """JAX's STEPS steps on a data x model mesh from the port's seeded
    init; writes the batches and the state before each step (and after
    the last) for the ranks. Returns the losses, the states and the head
    shards JAX placed on each device, by device index."""
    jcfg, pcfg, base = configs(arch, data, model)
    net = init_qnet(build_qnet(pcfg, SIZE, device="cpu"), torch.Generator().manual_seed(0))
    params, stats = flax_from_qnet_state_dict(net.state_dict(), *layout(net))
    tx = optax.adam(LR)
    state = JaxTrainState(step=np.zeros((), np.int32), params=params, batch_stats=stats,
                          target_params=copy.deepcopy(params),
                          target_batch_stats=copy.deepcopy(stats),
                          opt_state=tx.init(params), ema_loss=np.zeros((), np.float32))
    mesh = jax_make_mesh(data, model, devices=jax.devices()[:data * model])
    step_fn, state, _ = jit_train_step(jax_build_qnet(jcfg), jcfg, tx, mesh, state)
    order = list(mesh.devices.flat)
    shards = {name: {order.index(s.device): np.asarray(s.data)
                     for s in state.params[name][leaf].addressable_shards}
              for name in ("top_dense1", "top_dense2") if name in state.params
              for leaf in ("kernel",)}
    shards.update({f"{name}/bias": {order.index(s.device): np.asarray(s.data)
                                    for s in state.params[name]["bias"].addressable_shards}
                   for name in ("top_dense1", "top_dense2") if name in state.params})
    batches = [synthetic_batch(BATCH, 1, SIZE, seed=10 + k) for k in range(STEPS)]
    states_dir = tmp / "states"
    states_dir.mkdir(parents=True)
    states, losses = [], []
    for k, b in enumerate(batches):
        states.append(serialization.to_state_dict(jax.device_get(state)))
        (states_dir / f"sample{k}.ckpt").write_bytes(serialization.msgpack_serialize(
            {"sample_number": k, "state": states[-1]}))
        state, metrics = step_fn(state, jax_shard_batch(mesh, b))
        losses.append(float(metrics["loss"]))
    states.append(serialization.to_state_dict(jax.device_get(state)))
    np.savez(tmp / "batches.npz", **{f"{k}/{key}": np.asarray(v)
                                     for k, b in enumerate(batches) for key, v in b.items()})
    spec = {"config": base, "states": str(states_dir), "batches": str(tmp / "batches.npz"),
            "steps": STEPS, "mesh": [data, model]}
    return {"losses": losses, "states": states, "shards": shards, "spec": spec, "net": net}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """extra_capacity on 2x2 (data and tensor parallel), and, on the same
    ranks, the gather's gradient, the sharded table and make_mesh's errors."""
    tmp = tmp_path_factory.mktemp("tp")
    run = jax_steps(tmp, "extra_capacity", 2, 2)
    launch(tmp, 4, ["train_steps", "gather_grad", "dataset", "mesh_errors"], **run["spec"],
           tables=[37, 64, 16], batch=BATCH, bad_meshes=BAD_MESHES, data_steps=DATA_STEPS)
    return tmp, compare_steps(tmp, run, 4)


INVERSE = {"batch_size": 8, "num_steps": 4, "validate_every": 2, "val_batches": 1,
           "image_size": 32, "dtype": "float32"}


@pytest.fixture(scope="module")
def bn_run(tmp_path_factory):
    """basic on 2x1: BatchNorm over the global batch; on the same two
    ranks, run_train's refusals and the inverse trainer."""
    tmp = tmp_path_factory.mktemp("bn")
    run = jax_steps(tmp, "basic", 2, 1)
    pairs = [str(p) for p in torch_qdata.make_pairs(tmp / "pairs", rows=40, states=24, seed=2)]
    launch(tmp, 2, ["train_steps", "run_train_checks", "inverse_train"], **run["spec"],
           pairs=pairs, inverse=INVERSE)
    return tmp, compare_steps(tmp, run, 2), pairs


def leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def update_distance(before, got, want):
    """Per leaf and over the tree, |(got - before) - (want - before)|_2 over
    |want - before|_2; a leaf neither moved must stay put."""
    per, da_all, db_all = [], [], []
    for b, g, w in zip(leaves(before), leaves(got), leaves(want)):
        da, db = (w - b).ravel(), (g - b).ravel()
        if np.linalg.norm(da) < 1e-10:
            assert np.linalg.norm(db) < 1e-7
            continue
        per.append(np.linalg.norm(db - da) / np.linalg.norm(da))
        da_all.append(da)
        db_all.append(db)
    if not per:  # nothing moved (the target between syncs)
        return 0.0, 0.0
    a, b = np.concatenate(da_all), np.concatenate(db_all)
    return max(per), np.linalg.norm(b - a) / np.linalg.norm(a)


def same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def stats_margin(got, want) -> float:
    """The largest |got - want| beyond 1e-5 + 1e-4 |want| (<= 0 holds)."""
    return max(float((np.abs(g - w) - 1e-5 - 1e-4 * np.abs(w)).max())
               for g, w in zip(leaves(got), leaves(want)))


def compare_steps(tmp, run, world):
    """The ranks' losses and, for each step, how the gathered state after
    it stands to JAX's (the update distances, the target after the sync,
    the running statistics), read from tmp; then the states on disk go
    (~190 MB each) and only the numbers, the head's shards and the last
    gathered state stay."""
    states, steps = run["states"], []
    for k in range(STEPS):
        got, want, before = restore_checkpoint(str(tmp), k + 1), states[k + 1], states[k]
        dist = {field: update_distance(before[field], got[field], want[field])
                for field in ("params", "target_params")}
        dist.update({m: update_distance(before["opt_state"]["0"][m], got["opt_state"]["0"][m],
                                        want["opt_state"]["0"][m]) for m in ("mu", "nu")})
        steps.append({"step": int(got["step"]), "want_step": int(want["step"]),
                      "ema": (float(got["ema_loss"]), float(want["ema_loss"])), "dist": dist,
                      "target_is_online_before": same(got["target_params"], before["params"]),
                      "stats_unchanged": same(got["batch_stats"], states[0]["batch_stats"])
                      and same(got["target_batch_stats"], states[0]["target_batch_stats"]),
                      "stats_margin": stats_margin(got["batch_stats"], want["batch_stats"]),
                      "stats_moved": not same(want["batch_stats"], states[0]["batch_stats"])})
    for f in [*tmp.glob("sample*.ckpt"), *(tmp / "states").glob("*.ckpt")]:
        if f.name != f"sample{STEPS}.ckpt":
            f.unlink()
    last = restore_checkpoint(str(tmp), STEPS)
    (tmp / f"sample{STEPS}.ckpt").unlink()
    return {"losses": [np.load(tmp / f"rank{r}.npz")["losses"] for r in range(world)],
            "jax_losses": run["losses"], "steps": steps, "last": last,
            "shards": run["shards"], "net": run["net"]}


def check_steps(report):
    losses = report["losses"]
    for got in losses[1:]:
        np.testing.assert_array_equal(got, losses[0])
    np.testing.assert_allclose(losses[0], report["jax_losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for k, step in enumerate(report["steps"]):
        assert step["step"] == step["want_step"] == k + 1
        np.testing.assert_allclose(*step["ema"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for field, (leaf, tree) in step["dist"].items():
            assert leaf < LEAF_RTOL and tree < TREE_RTOL, (k, field, leaf, tree)
        if k == 1:  # (step + 1) % 2: the target is the online net before the update
            assert step["target_is_online_before"]


def test_tp_dp_steps_match_jax(tp_run):
    """extra_capacity on 2x2: the losses, the updates of params, target and
    Adam's moments, across a target sync, and the trunk's running
    statistics bit-unchanged (its BatchNorm runs on them)."""
    _, report = tp_run
    check_steps(report)
    assert all(step["stats_unchanged"] for step in report["steps"])


def test_head_shards_are_jax_slices(tp_run):
    """Rank (d, m) holds, bit for bit, what JAX placed on device (d, m):
    top.0 and top.2 their output features' m-th block (through the
    bridge's layout change), top.4 whole."""
    tmp, run = tp_run
    table = {e.name: e for e in entries(run["net"])}
    whole = dict(run["net"].named_parameters())
    for r in range(4):
        got = np.load(tmp / f"rank{r}.npz")
        for name, jax_name in (("top.0", "top_dense1"), ("top.2", "top_dense2")):
            want = table[f"{name}.weight"].to_torch(run["shards"][jax_name][r])
            assert got[f"{name}.weight"].shape[0] == whole[f"{name}.weight"].shape[0] // 2
            np.testing.assert_array_equal(got[f"{name}.weight"], want)
            np.testing.assert_array_equal(got[f"{name}.bias"],
                                          run["shards"][f"{jax_name}/bias"][r])
        np.testing.assert_array_equal(got["top.4.weight"],
                                      whole["top.4.weight"].detach().numpy())


def test_synced_batchnorm_steps_match_jax(bn_run):
    """basic on 2x1: each rank normalizes by the global batch's statistics,
    as JAX does on a data-sharded batch; the losses, the updates and the
    running statistics (rtol 1e-4) match."""
    _, report, _ = bn_run
    check_steps(report)
    assert all(step["stats_margin"] <= 0 and step["stats_moved"] for step in report["steps"])


def test_run_train_checks_on_ranks(bn_run):
    """As in the JAX package: a batch the data ranks do not divide, and
    decode workers with more than one rank, raise."""
    tmp, _, _ = bn_run
    said = json.loads((tmp / "run_train_checks.json").read_text())
    assert "TPU.BATCH_SIZE 7 must divide evenly across 2 data ranks" in said["batch"]
    assert "DECODE_WORKERS" in said["workers"]


def test_inverse_trainer_is_data_parallel(bn_run, tmp_path):
    """run_inverse_train on 2 ranks against one process: each step's loss
    and accuracy and the validation scalars within 1e-4, the head's update
    within the tree's 0.05, and rank 0's checkpoints only."""
    tmp, _, (npy, root) = bn_run
    writer = MetricsWriter(str(tmp_path))
    kwargs = {**INVERSE, "dtype": torch.float32}
    run_inverse_train(*(GibsonPairBatcher(npy, image_root=root, image_size=32, seed=3)
                        for _ in range(2)), str(tmp_path), writer=writer, **kwargs,
                      device="cpu")
    for tag in ("Loss/train", "Loss/val", "Accuracy/train", "Accuracy/val"):
        got = [r["value"] for r in read_metrics(str(tmp / "inverse"), tag)]
        want = [r["value"] for r in read_metrics(str(tmp_path), tag)]
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=tag)
    assert sorted(p.name for p in (tmp / "inverse").glob("*.ckpt")) == \
        ["sample2.ckpt", "sample4.ckpt"]
    before = inverse_tree(create_inverse_state(image_size=32, device="cpu"))["params"]
    leaf, tree = update_distance(before, restore_checkpoint(str(tmp / "inverse"), 4)["params"],
                                 restore_checkpoint(str(tmp_path), 4)["params"])
    for f in [*(tmp / "inverse").glob("*.ckpt"), *tmp_path.glob("*.ckpt")]:
        f.unlink()  # ~130 MB each
    assert leaf < LEAF_RTOL and tree < TREE_RTOL, (leaf, tree)


def test_sharded_table_matches_replicated(tp_run):
    """TPU.SHARD_DATASET on a data group of 2: each rank holds 1/2 of the
    padded table, and its batches are its rows of the replicated layout's,
    bit for bit."""
    tmp, _ = tp_run
    tables = synthetic_video_tables(37, 64, 16, seed=3)
    rep = DeviceDataset(tables, BATCH, seed=3, device="cpu")
    for r in range(4):
        got = np.load(tmp / f"dataset{r}.npz")
        d = r // 2
        assert bool(got["sharded"]) and int(got["frame_rows"]) == 38
        assert int(got["rows_here"]) == 19
        for step in DATA_STEPS:
            want = rep.sample(step)
            for k, v in want.items():
                np.testing.assert_array_equal(got[f"{step}/{k}"], v[d * 4:(d + 1) * 4].numpy(),
                                              err_msg=f"{k}@{step} rank {r}")


def test_host_fed_ranks_decode_their_slice(tp_run):
    """Host-fed on a mesh: every rank draws the batcher's global rows and
    keeps its data slice of them."""
    tmp, _ = tp_run
    stream = TableSource(synthetic_video_tables(37, 64, 16, seed=3), seed=4).batches(BATCH)
    want = [next(stream) for _ in range(3)]
    for r in range(4):
        got = np.load(tmp / f"dataset{r}.npz")
        d = r // 2
        for i, batch in enumerate(want):
            for k, v in batch.items():
                np.testing.assert_array_equal(got[f"host{i}/{k}"], v[d * 4:(d + 1) * 4])


def test_gather_backward_does_not_scale_by_m(tp_run):
    """The sharded layer's gradients (weight, bias, input) are the plain
    layer's: the gather's backward keeps its slice, where a reduce-scatter
    would multiply them by M = 2."""
    tmp, _ = tp_run
    got = np.load(tmp / "gather_grad.npz")
    for i in range(3):
        np.testing.assert_allclose(got[f"sharded{i}"], got[f"plain{i}"], rtol=1e-5, atol=1e-6)


def test_make_mesh_errors_on_ranks_match_jax(tp_run):
    tmp, _ = tp_run
    said = json.loads((tmp / "mesh_errors.json").read_text())
    for shape, msg in zip(BAD_MESHES, said):
        with pytest.raises(ValueError) as e:
            jax_make_mesh(*shape, devices=jax.devices()[:4])
        assert msg == str(e.value)


def test_primary_is_rank_zero(tp_run):
    """is_primary and primary_only: rank 0 of the group, or the one
    process without a group."""
    tmp, _ = tp_run
    got = [json.loads((tmp / f"primary{r}.json").read_text()) for r in range(4)]
    assert got == [[True, 0], [False, None], [False, None], [False, None]]
    assert multihost.is_primary() and multihost.primary_only(lambda: 1)() == 1


def test_whole_net_holds_the_gathered_head(tp_run):
    """On a model axis of 2 the checkpoint hook scores with a one-card net
    built from the gathered tree (a sharded net's forward would wait on
    its model group): its weights are the tree's, in train mode."""
    tree = tp_run[1]["last"]
    _, pcfg, _ = configs("extra_capacity", -1, 1)
    net = _whole_net(pcfg, tree, "cpu")
    params, stats = flax_from_qnet_state_dict(net.state_dict(), *layout(net))
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, tree["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, stats, tree["batch_stats"])
    assert net.training and not net.resnet.training


@pytest.mark.parametrize("shape", [(-1, 2), (2, 1), (1, 2)])
def test_make_mesh_errors_match_jax(shape):
    """Without a process group the port has one device, as JAX's mesh over
    one: the same shapes fail with the same words."""
    with pytest.raises(ValueError) as want:
        jax_make_mesh(*shape, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=str(want.value)):
        make_mesh(*shape)


def test_one_by_one_mesh_is_the_one_card_path():
    """No process group: the 1x1 mesh, no groups, nothing sharded or
    synced, and the state the one-card trainer built before."""
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    _, pcfg, _ = configs("basic", -1, 1)
    state = create_train_state(pcfg, device="cpu", mesh=mesh)
    plain = create_train_state(pcfg, device="cpu")
    assert not any(isinstance(m, ShardedLinear) for m in state.model.modules())
    assert all(m.sync is None for m in state.model.modules() if isinstance(m, BatchNorm2d))
    for a, b in zip(state.model.state_dict().values(), plain.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["extra_capacity", "basic"])
def test_param_specs_match_jax(arch):
    """The partition rule on the port's names is JAX's on its tree, before
    and after the head is sharded."""
    _, pcfg, _ = configs(arch, -1, 2)
    net = init_qnet(build_qnet(pcfg, SIZE, device="cpu"), torch.Generator().manual_seed(0))
    params, _ = flax_from_qnet_state_dict(net.state_dict(), *layout(net))
    jax_specs = jax_param_specs(params)
    table = [e for e in entries(net) if e.collection == "params"]
    mine = param_specs(net)
    for e in table:
        spec = jax_specs
        for key in e.path:
            spec = spec[key]
        assert (mine[e.name] == "model") == ("model" in tuple(spec)), e.name
    want = {"top.0.weight", "top.0.bias", "top.2.weight", "top.2.bias"} \
        if arch == "extra_capacity" else set()
    assert {n for n, s in mine.items() if s} == want
    whole = {n: p.detach().clone() for n, p in net.named_parameters()}
    shard_head(net, Mesh(data=1, model=2, rank=1))
    assert param_specs(net) == mine
    for n, p in net.named_parameters():
        rows = whole[n].shape[0] // 2
        assert torch.equal(p, whole[n][rows:] if mine[n] else whole[n]), n


def test_sharded_capacity_guard_uses_aggregate():
    """A table over one device's budget that fits the data ranks' together:
    refused replicated, naming TPU.SHARD_DATASET, and taken sharded (JAX's
    tests/test_device_dataset.py numbers: 72 frames of 64 px, 884,736
    bytes, against 0.6 x 1,000,000 a device)."""
    tables = synthetic_video_tables(72, 96, 64, seed=1)
    limit = 1_000_000
    mesh = Mesh(data=4, model=1, rank=2)
    with pytest.raises(ValueError, match="SHARD_DATASET"):
        DeviceDataset(tables, BATCH, device="cpu", memory_limit_bytes=limit, mesh=mesh)
    with pytest.raises(ValueError, match="SHARD_DATASET"):
        check_capacity(72, 64, limit, data_shards=4)
    dds = DeviceDataset(tables, BATCH, device="cpu", memory_limit_bytes=limit, mesh=mesh,
                        shard_frames=True)
    assert dds.sharded and dds.tables["frames"].shape[0] == 18
    np.testing.assert_array_equal(dds.tables["frames"].numpy(), tables["frames"][36:54])
    with pytest.raises(ValueError, match="aggregate data-axis"):
        check_capacity(72, 64, limit // 4, data_shards=4, sharded=True)
    with pytest.raises(ValueError, match="host-fed infeed"):
        check_capacity(72, 64, limit, data_shards=1)


@pytest.mark.parametrize("bucket,views", [(True, 13), (False, 7)])
def test_multi_device_scorer_matches_one_device(bucket, views):
    """The data-parallel scorer on two devices (the CPU twice) gives the
    one-device scorer's scores within 1e-5, bucketed and ragged (the batch
    padded to a multiple of the devices)."""
    model = init_qnet(HabitatDQN(panorama=False, image_size=64),
                      torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (views, 64, 64, 3), np.uint8)
    cls = rng.integers(0, 5, views)
    one = make_multiclass_scorer(copy.deepcopy(model), image_size=64, bucket=bucket,
                                 device="cpu")(images, cls)
    two = make_multiclass_scorer(model, image_size=64, bucket=bucket,
                                 devices=["cpu", "cpu"])
    handle = two.dispatch(images, cls)
    np.testing.assert_allclose(two.gather(handle), one, rtol=1e-5, atol=1e-5)
    assert handle[0].shape[0] == (24 if bucket else 8)

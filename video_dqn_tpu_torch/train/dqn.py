"""Double-DQN training on one card (counterpart of
video_dqn_tpu/train/dqn.py).

The step (`make_train_step`) is the JAX package's, in eager PyTorch:
  * prologue: the uint8 before and after frames go through the identity
    path of the resize+normalize kernel (ops/resize_normalize.py), once
    each, straight into the compute dtype (XLA fused this normalize into
    the first convolution; eager torch launches it);
  * extra_capacity: the before-state forward builds the graph; the
    after-state online forward (argmax only) and the target forward run
    under no_grad, and the trunk's BatchNorm stays on running statistics
    (HabitatDQN.set_train);
  * basic: before and after go through ONE 2B train-mode forward, so the
    batch statistics couple the halves and both update the running ones;
  * the double-DQN target (online argmax, target Q), terminal masking,
    LINEAR, the rect clamp, REMOVE_BEFORE_REWARD, and the ground-truth
    regression with its NaN mask for VALUE_LEARNING; action labels are
    clamped to the head (JAX's take_along_axis mode="clip");
  * the target sync (params and BatchNorm statistics) BEFORE the update
    when (step + 1) % TARGET_UPDATE_INTERVAL == 0, Adam (optax.adam's
    update: lr, betas (0.9, 0.999), eps 1e-8, every parameter), and the
    loss's EMA(0.99) on the device, equal to the loss at step 0.
COMPUTE_DTYPE bfloat16 runs the forwards under bf16 autocast with float32
parameters; float32 runs them without autocast. One step is one dispatch
(the JAX package's SCAN_CHUNK has no counterpart yet). The state
converts to and from the JAX package's TrainState state dict
(`flax_state_dict`, `load_flax_state_dict`), which is what
`sample<N>.ckpt` holds.

On a process group (parallel/multihost.py) a run spans the mesh of
TPU.MESH_DATA x TPU.MESH_MODEL ranks (parallel/mesh.py), as the JAX step
spans a device mesh: each rank steps on its data slice of the global
batch; the extra_capacity head's wide Linears hold one shard a model rank
(parallel/sharding.py); basic's train-mode BatchNorm normalizes by the
global batch; after the backward one all-reduce averages the gradients and
the loss over the data group. That plain all-reduce stands where
DistributedDataParallel would: one collective a step over a flat buffer,
never in flight beside the head's own model-group collectives of the
backward, and the same code on gloo and NCCL; every rank starts from the
same seeded state, so nothing is broadcast. Adam holds each rank's shards
(it is elementwise, so they are exact); the target sync is per rank. A
checkpoint gathers the sharded head over the model group on every rank
and holds the whole Flax tree, so `-r` resumes on any mesh.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.checkpoint import latest_checkpoint_step, restore_checkpoint, save_checkpoint
from ..core.prefetch import prefetch_to_device
from ..core.watchdog import StallWatchdog
from ..data.device_dataset import DeviceDataset, device_memory_bytes
from ..data.qlearning import QLearningBatcher
from ..data.workers import parallel_batches
from ..models.bridge import (adam_from_optax, adam_to_optax, flax_from_qnet_state_dict,
                             layout, load_torch_state_dict, qnet_state_dict_from_flax)
from ..models.qnet import HabitatDQN, build_qnet, init_qnet
from ..ops.resize_normalize import resize_normalize
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharding import full_tensor, local_tensor, param_specs

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the step's phases, in order; `mark(name)` is called as each begins
PHASES = ("sync", "prologue", "forward_before", "forward_after_online",
          "forward_after_target", "loss", "backward", "adam", "end")


def _no_mark(name: str) -> None:
    pass


@dataclass
class TrainState:
    """Online and target Q-nets, Adam over the online net's parameters,
    the number of steps taken, the loss's EMA (a 0-d float32 tensor on
    the device, read by the host only at log points), and the mesh the nets
    are laid on (the 1x1 mesh without a process group)."""
    model: HabitatDQN
    target: HabitatDQN
    optimizer: torch.optim.Adam
    step: int
    ema_loss: torch.Tensor
    mesh: Mesh = field(default_factory=Mesh)


def compute_dtype(config) -> torch.dtype:
    name = config.TPU.COMPUTE_DTYPE
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE must be one of {list(COMPUTE_DTYPES)}, "
                         f"got {name!r}")
    return COMPUTE_DTYPES[name]


def load_backbone_weights(config, model: HabitatDQN) -> None:
    """Load the trunk from the torchvision resnet18 state dict at
    BACKBONE_WEIGHTS (its names are the trunk's; its classifier is
    dropped), as the reference starts from resnet18(pretrained=True).
    With extra_capacity the trunk's BatchNorm runs on running statistics,
    so without weights they stay at their init values for good."""
    path = config.BACKBONE_WEIGHTS
    if not path:
        if config.ARCHITECTURE == "extra_capacity":
            print("WARNING: BACKBONE_WEIGHTS is unset: the backbone is random and "
                  "extra_capacity freezes its BatchNorm statistics at their init values.")
        return
    model.resnet.load_state_dict(read_backbone(path), strict=True)
    print(f"Backbone initialized from {path}")


def read_backbone(path: str) -> Dict[str, torch.Tensor]:
    """The torchvision resnet18 state dict at `path` without its classifier
    (`fc.*`): the trunk's weights and statistics under torchvision names."""
    return {k: v for k, v in load_torch_state_dict(path).items() if not k.startswith("fc.")}


def create_train_state(config, device=None, mesh: Optional[Mesh] = None) -> TrainState:
    """The seeded state of a fresh run: the Q-net initialized from
    config.SEED on the CPU (so every device starts from the same weights),
    the backbone weights if any, laid on `mesh` (HabitatDQN.distribute;
    None: the 1x1 mesh), the target a copy, Adam at step 0."""
    device = resolve_device(device)
    mesh = mesh or Mesh()
    model = build_qnet(config, int(config.TPU.IMAGE_SIZE), device="cpu")
    init_qnet(model, torch.Generator().manual_seed(int(config.SEED)))
    load_backbone_weights(config, model)
    model.distribute(mesh)
    model.to(device, memory_format=torch.channels_last).set_train(True)
    target = copy.deepcopy(model).eval().requires_grad_(False)
    optimizer = torch.optim.Adam(model.parameters(), lr=float(config.LEARNING_RATE),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, target, optimizer, 0, torch.zeros((), device=device), mesh)


def sync_target(state: TrainState) -> None:
    """Copy the online net's parameters and BatchNorm statistics into the
    target net."""
    with torch.no_grad():
        for dst, src in zip(itertools.chain(state.target.parameters(), state.target.buffers()),
                            itertools.chain(state.model.parameters(), state.model.buffers())):
            dst.copy_(src)


def flax_state_dict(state: TrainState) -> Dict:
    """The JAX package's TrainState as a Flax state dict of numpy leaves:
    step, params, batch_stats, target_params, target_batch_stats,
    opt_state (optax.adam's ({count, mu, nu}, EmptyState)) and ema_loss.
    On a model axis of M > 1 the head's shards are gathered (a collective:
    every rank of the model group calls it), so the tree is the whole one."""
    full = functools.partial(full_tensor, specs=param_specs(state.model), mesh=state.mesh)
    params, stats = flax_from_qnet_state_dict(
        {k: full(k, v) for k, v in state.model.state_dict().items()}, *layout(state.model))
    tparams, tstats = flax_from_qnet_state_dict(
        {k: full(k, v) for k, v in state.target.state_dict().items()}, *layout(state.target))
    adam = adam_to_optax(state.optimizer, state.model, full)
    return {"step": np.asarray(state.step, np.int32), "params": params,
            "batch_stats": stats, "target_params": tparams, "target_batch_stats": tstats,
            "opt_state": {"0": adam, "1": {}},
            "ema_loss": np.asarray(state.ema_loss.item(), np.float32)}


def load_flax_state_dict(state: TrainState, tree: Dict) -> None:
    """Load a TrainState state dict (`flax_state_dict`'s layout, from
    either package, whole) into `state`, in place, each rank its shards;
    shapes must match."""
    local = functools.partial(local_tensor, specs=param_specs(state.model), mesh=state.mesh)
    for net, p, s in ((state.model, "params", "batch_stats"),
                      (state.target, "target_params", "target_batch_stats")):
        sd = qnet_state_dict_from_flax(tree[p], tree[s], *layout(net))
        net.load_state_dict({k: local(k, v) for k, v in sd.items()}, strict=True)
    adam_from_optax(state.optimizer, state.model, tree["opt_state"]["0"], local)
    state.step = int(tree["step"])
    state.ema_loss = torch.from_numpy(np.array(tree["ema_loss"], np.float32)).to(
        state.ema_loss.device)


def _prep(frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 (B, F, S, S, 3) -> ImageNet-normalized (B, F, S, S, 3) of
    `dtype`: the identity path of the resize+normalize kernel."""
    b, f, s = frames.shape[:3]
    x = resize_normalize(frames.reshape((b * f,) + frames.shape[2:]), s, dtype)
    # (B*F, 3, S, S) channels_last is (B*F, S, S, 3) contiguous: both views
    return x.permute(0, 2, 3, 1).reshape(frames.shape[:2] + x.shape[2:] + (3,))


def make_loss_fn(model: HabitatDQN, config) -> Callable:
    """loss_fn(online, target, batch, mark) -> the mean loss (0-d float32);
    `batch` holds device tensors with QLearningBatcher.get_batch's keys.
    With trainable BatchNorm (basic) its forward updates the online net's
    running statistics."""
    gamma = float(config.GAMMA)
    linear = bool(config.LINEAR)
    rect = config.LOSS_CLIP == "rect"
    on_gt = bool(config.TRAIN_ON_GROUND_TRUTH)
    value_learning = bool(config.VALUE_LEARNING)
    remove_before = bool(config.REMOVE_BEFORE_REWARD)
    mutable_bn = not model.extra_capacity
    dtype = compute_dtype(config)

    def loss_fn(online, target, batch, mark: Callable = _no_mark) -> torch.Tensor:
        autocast = torch.autocast(batch["before"].device.type, dtype=torch.bfloat16,
                                  enabled=dtype == torch.bfloat16)
        mark("prologue")
        before = _prep(batch["before"], dtype)
        after = None if on_gt else _prep(batch["after"], dtype)
        b = before.shape[0]
        mark("forward_before")
        with autocast:
            if on_gt:
                q_before = online(before)
            elif mutable_bn:
                q_both = online(torch.cat([before, after]))
                q_before, q_after_online = q_both[:b], q_both[b:]
            else:
                q_before = online(before)
                mark("forward_after_online")
                with torch.no_grad():
                    q_after_online = online(after)

        # Q of the taken action for each class, (B, C); labels past a
        # single-action head clamp to its one action
        act = batch["action"].long().clamp(0, q_before.shape[2] - 1)
        q_b = q_before.gather(2, act[:, None, None].expand(-1, q_before.shape[1], 1))[..., 0]

        if on_gt:
            mark("loss")
            gt = batch["gt"]
            if value_learning:
                mask = 1.0 - torch.isnan(gt).float()
                losses = 0.5 * (q_b * mask - torch.nan_to_num(gt, nan=0.0)) ** 2
            else:
                losses = 0.5 * (q_b - gt) ** 2
        else:
            mark("forward_after_target")
            with torch.no_grad(), autocast:
                q_after_target = target(after)
            mark("loss")
            best = q_after_online.argmax(-1)  # (B, C), first index on ties
            q_a = q_after_target.gather(2, best[..., None])[..., 0].detach()
            q_a = q_a * (1.0 - batch["terminal"])
            if linear:
                targets = batch["reward"] + (q_a - 0.1)
            else:
                targets = batch["reward"] + gamma * q_a
            if rect:
                targets = targets.clamp(0.0, 1.0)
            losses = 0.5 * (q_b - targets) ** 2
            if remove_before:
                losses = losses * batch["valid_mask"]
        return losses.mean()

    return loss_fn


def make_train_step(model: HabitatDQN, config) -> Callable:
    """step(state, batch, mark=None) -> {"loss", "ema_loss"} (0-d device
    tensors), advancing `state` in place by one step; on a mesh `batch` is
    this rank's data slice and the loss is the global batch's. `mark(name)`,
    if given, is called as each phase of PHASES begins (for timing)."""
    loss_fn = make_loss_fn(model, config)
    sync_every = int(config.TARGET_UPDATE_INTERVAL)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                mark: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        mark = mark or _no_mark
        mark("sync")
        if (state.step + 1) % sync_every == 0:
            sync_target(state)
        state.model.set_train(True)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, state.target, batch, mark)
        mark("backward")
        loss.backward()
        loss = loss.detach()
        if state.mesh.data_group is not None:
            # the global batch's gradients and loss: means over the data group
            loss = loss.reshape(1).clone()
            state.mesh.mean_over_data([p.grad for p in state.model.parameters()
                                       if p.grad is not None] + [loss])
            loss = loss[0]
        mark("adam")
        state.optimizer.step()
        mark("end")
        state.ema_loss = loss.clone() if state.step == 0 else state.ema_loss * 0.99 + loss * 0.01
        state.step += 1
        return {"loss": loss, "ema_loss": state.ema_loss}

    return step_fn


def stall_watchdog(config, device: torch.device) -> Optional[StallWatchdog]:
    """The loop's stall watchdog, as the JAX package arms it: the
    VDQN_TRAIN_WATCHDOG_S environment variable overrides TPU.STALL_TIMEOUT_S
    (0 = off); TPU.STALL_FIRST_TIMEOUT_S sets the first deadline, else it is
    max(timeout, 2700) on the card (the first step's start-up) and the
    timeout on the CPU. None when off."""
    wd_env = os.environ.get("VDQN_TRAIN_WATCHDOG_S", "").strip()
    if wd_env:
        try:
            timeout = float(wd_env)
        except ValueError:
            raise ValueError(
                f"VDQN_TRAIN_WATCHDOG_S={wd_env!r} is not a number — set it "
                "to a timeout in seconds (0 disables the watchdog)"
            ) from None
    else:
        timeout = float(config.TPU.STALL_TIMEOUT_S or 0)
    if timeout <= 0:
        return None
    first = float(config.TPU.STALL_FIRST_TIMEOUT_S or 0)
    if first <= 0:
        first = max(timeout, 2700.0) if device.type != "cpu" else timeout
    return StallWatchdog(timeout, label="train", first_timeout_s=first)


def batcher_from_config(config) -> QLearningBatcher:
    """The JAX package's batcher for a config (video_dqn_tpu/train/dqn.py
    run_train): the DATASET feather, one-action or inverse-action labels,
    the reward and value options, PREVIOUS_IMAGES, SEED, TPU.IMAGE_SIZE
    and TPU.DECODE_CACHE_MB of RAM cache."""
    cache_mb = int(config.TPU.DECODE_CACHE_MB)
    batcher = QLearningBatcher(
        config.DATASET, one_action=True, confidence_reward=config.CONFIDENCE_REWARD,
        value_learning=config.VALUE_LEARNING, inverse_actions=config.USE_INVERSE_ACTIONS,
        previous_images=config.PREVIOUS_IMAGES, seed=config.SEED,
        image_size=int(config.TPU.IMAGE_SIZE),
        cache_bytes=cache_mb * (1 << 20) if cache_mb > 0 else None)
    print(f"Load data from {config.DATASET}")
    print(f"Reward Ratio: {batcher.reward_percentage()}")
    return batcher


def _rank_batches(batcher, batch_size: int, mesh: Mesh):
    """The host-fed stream on a mesh: every rank draws the same global rows
    from the batcher's seeded index stream and decodes only its data slice
    of them (the JAX package's _multihost_batch_stream)."""
    start, size = mesh.global_batch_slice(batch_size)
    for rows in batcher.index_stream(batch_size):
        yield batcher.get_batch(rows[start:start + size])


def _whole_net(config, tree: Dict, device) -> HabitatDQN:
    """A one-card online net holding a checkpoint tree's params."""
    net = build_qnet(config, int(config.TPU.IMAGE_SIZE), device=device)
    net.load_state_dict(qnet_state_dict_from_flax(tree["params"], tree["batch_stats"],
                                                  *layout(net)), strict=True)
    return net.set_train(True)


def run_train(config, resume_from: int = -1, batcher=None, max_steps: Optional[int] = None,
              log_every: int = 100, device=None, visualize_hook: Optional[Callable] = None):
    """The training loop. `config` is an ExperimentConfig (.models_dir,
    .writer and the config keys). Without a `batcher` it reads the config's
    DATASET feather and its JPEG frames (`batcher_from_config`); a batcher
    passed in is any object with `batches(batch_size)`, an endless stream
    of numpy batch dicts with QLearningBatcher.get_batch's contract (on a
    data axis of more ranks than one, `index_stream(batch_size)`, an
    endless stream of row indices, and `get_batch(rows)` in its place),
    and, for TPU.DEVICE_DATASET, `tables(memory_limit_bytes, data_shards,
    sharded)`, the numpy tables of data/device_dataset.py (e.g.
    data/tables.py `TableSource`). Returns (state, last logged EMA loss). The loop beats the stall watchdog (`stall_watchdog`) every step.
    A `visualize_hook(model, state, sample_number)` runs after each
    checkpoint is written (the training CLI passes one when
    VISUALIZATION_DATA_ROOT is set, as in the JAX package). With
    TPU.DECODE_WORKERS > 0, host-fed and without a `batcher`, the batches
    come from that many decode processes (data/workers.py
    parallel_batches, forked here before the model reaches the card); the
    device dataset decodes once and ignores the key, as the JAX package
    does.

    On a process group every rank runs this loop over the mesh of
    TPU.MESH_DATA x TPU.MESH_MODEL (see the module's docstring), host-fed
    ranks decode their data slice of each batch, and TPU.SHARD_DATASET
    splits the device table over the data group. Metrics, checkpoint files
    and the hook are rank 0's; the checkpoint's gather runs on every rank.
    As in the JAX package, a batch the data ranks do not divide, and
    TPU.DECODE_WORKERS with more than one rank, raise."""
    device = resolve_device(device)
    mesh = make_mesh(int(config.TPU.MESH_DATA), int(config.TPU.MESH_MODEL))
    primary = mesh.rank == 0
    batch_size = int(config.TPU.BATCH_SIZE)
    if mesh.size > 1:
        if batch_size % mesh.data:
            raise ValueError(f"TPU.BATCH_SIZE {batch_size} must divide evenly across "
                             f"{mesh.data} data ranks")
        print(f"Mesh {mesh.data}x{mesh.model}: rank {mesh.rank} at (data {mesh.d}, "
              f"model {mesh.m}) on {device}")
    stream = None
    if batcher is None:
        batcher = batcher_from_config(config)
        workers = int(config.TPU.DECODE_WORKERS)
        if workers > 0 and config.TPU.DEVICE_DATASET:
            print(f"TPU.DECODE_WORKERS: {workers} ignored: the device dataset decodes "
                  "its frames once, in this process")
        elif workers > 0:
            if mesh.size > 1:
                raise ValueError(
                    "TPU.DECODE_WORKERS and multi-rank training don't compose: each rank "
                    "already decodes only its slice of the batch; set DECODE_WORKERS: 0")
            stream = parallel_batches(batcher, batch_size, num_workers=workers,
                                      seed=int(config.SEED))
            print(f"Decode workers: {workers}")
    with stream if stream is not None else contextlib.nullcontext():
        state = create_train_state(config, device, mesh)

        start_step = 0
        if resume_from > -1:
            load_flax_state_dict(state, restore_checkpoint(config.models_dir, resume_from))
            start_step = resume_from
            print(f"Resuming from sample{resume_from}")
        elif config.BOOTSTRAP:
            boot = config.BOOTSTRAP_LOCATION
            step = latest_checkpoint_step(boot)
            if step is not None:
                # the reference's BOOTSTRAP: the weights load, the loop
                # counter starts fresh and the target is re-synced
                load_flax_state_dict(state, restore_checkpoint(boot, step))
                state.step = 0
                sync_target(state)
                print(f"BOOTSTRAP from {boot}/sample{step}")

        num_steps = int(max_steps if max_steps is not None else config.NUM_STEPS)
        step_fn = make_train_step(state.model, config)
        if config.TPU.DEVICE_DATASET:
            t0 = time.perf_counter()
            shard = bool(config.TPU.SHARD_DATASET)
            tables = batcher.tables(device_memory_bytes(device), mesh.data,
                                    shard and mesh.data > 1)
            dds = DeviceDataset(tables, batch_size, seed=int(config.SEED),
                                sampling=str(config.TPU.DEVICE_SAMPLING), device=device,
                                mesh=mesh, shard_frames=shard)
            where = f"1/{mesh.data} of them" if dds.sharded else "replicated"
            print(f"Device dataset: {dds.n} rows, {dds.bytes / 1e9:.2f} GB of frames on "
                  f"{device} ({where}), built in {time.perf_counter() - t0:.2f} s; one step "
                  f"per dispatch (TPU.SCAN_CHUNK has no counterpart yet)")
            batches = dds.batches(state.step)
        else:
            if stream is not None:
                source = stream
            elif mesh.data > 1:
                source = _rank_batches(batcher, batch_size, mesh)
            else:
                source = batcher.batches(batch_size)
            batches = prefetch_to_device(source, device, depth=int(config.TPU.PREFETCH_DEPTH))

        sample_number = start_step
        running_loss = None
        watchdog = stall_watchdog(config, device)
        t0 = time.time()
        try:
            for batch in itertools.islice(batches, max(num_steps - start_step, 0)):
                metrics = step_fn(state, batch)
                sample_number += 1
                if watchdog is not None:
                    watchdog.beat()
                # the EMA stays on the device; the host reads it only here
                if sample_number % log_every == 0:
                    running_loss = float(metrics["ema_loss"])
                    if primary:
                        config.writer.add_scalar("avg_q_loss/train", running_loss,
                                                 sample_number)
                        config.writer.add_scalar(
                            "frames_per_sec/train",
                            log_every * batch_size / (time.time() - t0), sample_number)
                    t0 = time.time()
                if sample_number % int(config.CHECKPOINT_INTERVAL) == 0:
                    # every rank of a model group gathers the sharded head
                    tree = flax_state_dict(state) if primary or mesh.model > 1 else None
                    if primary:
                        save_checkpoint(config.models_dir, sample_number, tree)
                        if visualize_hook is not None:
                            # a sharded net's forward would wait on its model group
                            net = state.model if mesh.model == 1 else \
                                _whole_net(config, tree, device)
                            visualize_hook(net, state, sample_number)
                    if watchdog is not None:
                        watchdog.beat()
        finally:
            if watchdog is not None:
                watchdog.stop()
            batches.close()
        return state, running_loss

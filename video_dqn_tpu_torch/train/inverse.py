"""Inverse-action model training on one card (counterpart of
video_dqn_tpu/train/inverse.py:33-238).

The step (`make_inverse_step`) is the JAX package's, in eager PyTorch:
  * prologue: the uint8 before and after frames, stacked into one batch of
    2B, go through the identity path of the resize+normalize kernel
    (ops/resize_normalize.py) once, straight into the compute dtype;
  * the frozen trunk runs under no_grad on its running statistics, the head
    with dropout 0.5 after fc1, and the loss is the cross-entropy of the
    float32 calibrated logits against the action labels, with accuracy;
  * the optimizer is optax's chain: Adam (betas (0.9, 0.999), eps 1e-8)
    over every parameter, or AdamW when weight_decay > 0, at the staircase
    exponential decay lr * lr_decay ** (count // decay_every_steps) of the
    count of updates before this one. optax sees a zero gradient for the
    trunk, not none, so the trunk keeps zero gradients here: Adam leaves it
    bit-unchanged and AdamW decays it by lr * wd * p a step, as the JAX
    package does (ROADMAP.md queue 3: the reference froze the trunk).
Dropout masks come from a torch.Generator seeded from the state's
`dropout_rng` (uint32[2], JAX's key data, kept so that either package
restores the other's checkpoints) and the step: torch cannot draw JAX's
masks. COMPUTE dtype bfloat16 runs the trunk and head under bf16 autocast
with float32 parameters (the calibration in float32); float32 without.

With a process group up (parallel/multihost.py) `run_inverse_train` is data
parallel over its ranks, the state replicated, as the JAX package's is over
its devices: every rank draws the same global batch and dropout mask and
steps on its rows of them; one all-reduce a step averages the head's
gradients, the loss and the accuracy; validation averages the ranks'
slices; rank 0 writes the scalars and checkpoints.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..core.checkpoint import latest_checkpoint_step, restore_checkpoint, save_checkpoint
from ..core.prefetch import prefetch_to_device
from ..models.bridge import (chain_from_optax, chain_to_optax, flax_from_inverse_state_dict,
                             inverse_state_dict_from_flax, sequential_trunk)
from ..models.inverse import KEEP, InverseActionModel, init_inverse
from ..ops.resize_normalize import resize_normalize
from ..parallel.mesh import Mesh, make_mesh, shard_batch
from .dqn import read_backbone

# the step's phases, in order; `mark(name)` is called as each begins
PHASES = ("prologue", "trunk", "head", "loss", "backward", "adam", "end")


def _no_mark(name: str) -> None:
    pass


def exponential_decay(lr: float, decay: float, every: int) -> Callable[[int], float]:
    """optax.exponential_decay(lr, every, decay, staircase=True): the rate
    at `count` updates; constant when every <= 0, as optax makes it."""
    if every <= 0:
        return lambda count: float(np.float32(lr))
    return lambda count: float(np.float32(lr) * np.float32(decay) ** np.float32(count // every))


@dataclass
class InverseTrainState:
    """The model, its optimizer (Adam or AdamW over every parameter), the
    number of steps taken, the dropout key and the rate schedule."""
    model: InverseActionModel
    optimizer: torch.optim.Optimizer
    step: int
    dropout_rng: np.ndarray
    schedule: Callable[[int], float]
    generator: Optional[torch.Generator] = field(default=None, repr=False)

    def dropout_mask(self, batch: int) -> torch.Tensor:
        """This step's (batch, 128) keep mask, from a generator seeded by
        (dropout_rng, step): a resumed run draws the masks it would have."""
        device = self.model.fc1.weight.device
        if self.generator is None:
            self.generator = torch.Generator(device=device)
        k0, k1 = (int(w) for w in self.dropout_rng)
        self.generator.manual_seed(((k0 << 32 | k1) * 0x9E3779B97F4A7C15 + self.step) % 2 ** 63)
        return torch.rand((batch, self.model.fc1.out_features), device=device,
                          generator=self.generator) < KEEP


def load_backbone(model: InverseActionModel, path: str) -> None:
    """The trunk from a torchvision resnet18 state dict (train/dqn.py
    read_backbone), as the reference starts from resnet18(pretrained=True)."""
    model.resnet18.load_state_dict(sequential_trunk(read_backbone(path)), strict=True)


def create_inverse_state(lr: float = 1e-3, lr_decay: float = 0.9, decay_every_steps: int = 1000,
                         weight_decay: float = 0.0, seed: int = 0, image_size: int = 224,
                         backbone_weights: str = "", device=None) -> InverseTrainState:
    """A fresh state: the model initialized from `seed` on the CPU (every
    device starts from the same weights), the backbone weights if any, the
    optimizer at step 0 and JAX's dropout key for seed + 1."""
    device = resolve_device(device)
    model = init_inverse(InverseActionModel(image_size), torch.Generator().manual_seed(seed))
    if backbone_weights:
        load_backbone(model, backbone_weights)
        print(f"Inverse trunk initialized from {backbone_weights}")
    else:
        print("WARNING: inverse trunk is frozen at random init; pass "
              "backbone_weights (torchvision resnet18 state dict) to match "
              "the reference's pretrained trunk.")
    return _state(model, lr, lr_decay, decay_every_steps, weight_decay, seed, device)


def _state(model: InverseActionModel, lr: float, lr_decay: float, decay_every_steps: int,
           weight_decay: float, seed: int, device: torch.device) -> InverseTrainState:
    """The state around `model`, moved to `device`, at step 0."""
    model.to(device, memory_format=torch.channels_last).train()
    for p in model.trunk_parameters():
        p.grad = torch.zeros_like(p)  # optax's zero gradient: AdamW decays the trunk
    kwargs = {"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8}
    if weight_decay > 0:
        optimizer = torch.optim.AdamW(model.parameters(), weight_decay=weight_decay, **kwargs)
    else:
        optimizer = torch.optim.Adam(model.parameters(), **kwargs)
    # jax.random.key_data(jax.random.key(seed + 1))
    rng = np.array([0, seed + 1], np.uint32)
    return InverseTrainState(model, optimizer, 0, rng,
                             exponential_decay(lr, lr_decay, decay_every_steps))


def flax_state_dict(state: InverseTrainState) -> Dict:
    """The JAX package's InverseTrainState as a Flax state dict of numpy
    leaves: step, params, batch_stats, opt_state (optax's chain) and
    dropout_rng."""
    params, stats = flax_from_inverse_state_dict(state.model.state_dict(),
                                                 state.model.image_size)
    return {"step": np.asarray(state.step, np.int32), "params": params, "batch_stats": stats,
            "opt_state": chain_to_optax(state.optimizer, state.model, state.step),
            "dropout_rng": np.asarray(state.dropout_rng, np.uint32)}


def load_flax_state_dict(state: InverseTrainState, tree: Dict) -> None:
    """Load an InverseTrainState state dict (from either package) into
    `state`, in place; shapes and the optimizer's chain must match."""
    state.model.load_state_dict(inverse_state_dict_from_flax(
        tree["params"], tree["batch_stats"], state.model.image_size), strict=True)
    chain_from_optax(state.optimizer, state.model, tree["opt_state"])
    state.step = int(tree["step"])
    state.dropout_rng = np.asarray(tree["dropout_rng"], np.uint32).copy()


def load_inverse_checkpoint(models_dir: str, step: Optional[int] = None,
                            image_size: int = 224, device=None) -> InverseTrainState:
    """The state of `sample<step>.ckpt` (the latest when None) under
    `models_dir`, written by either package's run_inverse_train."""
    if step is None:
        step = latest_checkpoint_step(models_dir)
        if step is None:
            raise FileNotFoundError(f"no sample<N>.ckpt checkpoints under {models_dir}")
    # create_inverse_state's defaults, without its seeded init: the
    # checkpoint overwrites every weight
    state = _state(InverseActionModel(image_size), 1e-3, 0.9, 1000, 0.0, 0,
                   resolve_device(device))
    load_flax_state_dict(state, restore_checkpoint(models_dir, step))
    return state


def prep_pair(before: torch.Tensor, after: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 (B, [1,] S, S, 3) before and after frames -> the normalized
    (2B, 3, S, S) pair (channels_last) of `dtype`: one identity launch of
    the resize+normalize kernel."""
    if before.dim() == 5:  # (B, 1, S, S, 3) single-frame stacks
        before, after = before[:, 0], after[:, 0]
    pair = torch.cat([before, after])
    return resize_normalize(pair, pair.shape[1], dtype)


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)


def make_inverse_step(model: InverseActionModel, dtype: torch.dtype = torch.bfloat16,
                      mesh: Optional[Mesh] = None) -> Callable:
    """step(state, batch, dropout_mask=None, mark=None) -> {"loss",
    "accuracy"} (0-d device tensors), advancing `state` in place. `batch`
    holds device tensors with GibsonPairBatcher.get_batch's keys. Without
    a `dropout_mask` (B, 128) the state draws one. `mark(name)` is called
    as each phase of PHASES begins. On a `mesh` with a data group, `batch`
    is this rank's rows and the head's gradients, the loss and the
    accuracy are averaged over the group after the backward."""
    head = model.head_parameters()
    synced = mesh is not None and mesh.data_group is not None

    def step_fn(state: InverseTrainState, batch: Dict[str, torch.Tensor],
                dropout_mask: Optional[torch.Tensor] = None,
                mark: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        mark = mark or _no_mark
        mark("prologue")
        pair = prep_pair(batch["before"], batch["after"], dtype)
        b = pair.shape[0] // 2
        if dropout_mask is None:
            dropout_mask = state.dropout_mask(b)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        for p in head:
            p.grad = None
        with _autocast(pair.device, dtype):
            mark("trunk")
            feats = state.model.features(pair)
            mark("head")
            _, logits = state.model.head(feats, True, dropout_mask)
        mark("loss")
        labels = batch["action"].long()
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(-1) == labels).float().mean()
        mark("backward")
        loss.backward()
        loss = loss.detach()
        if synced:
            scalars = torch.stack([loss, accuracy])
            mesh.mean_over_data([p.grad for p in head] + [scalars])
            loss, accuracy = scalars[0], scalars[1]
        mark("adam")
        state.optimizer.step()
        mark("end")
        state.step += 1
        return {"loss": loss, "accuracy": accuracy}

    return step_fn


def make_inverse_eval(dtype: torch.dtype = torch.bfloat16) -> Callable:
    """eval(model, batch) -> (loss, accuracy) as 0-d device tensors, the
    head without dropout."""
    @torch.no_grad()
    def eval_fn(model: InverseActionModel, batch: Dict[str, torch.Tensor]):
        pair = prep_pair(batch["before"], batch["after"], dtype)
        with _autocast(pair.device, dtype):
            _, logits = model.forward_pair(pair, False)
        labels = batch["action"].long()
        return F.cross_entropy(logits, labels), (logits.argmax(-1) == labels).float().mean()

    return eval_fn


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def run_inverse_train(train_batcher, val_batcher, out_dir: str, writer=None,
                      batch_size: int = 128, num_steps: int = 2000, validate_every: int = 100,
                      val_batches: int = 25, lr: float = 1e-3, lr_decay: float = 0.9,
                      decay_every_steps: int = 1000, weight_decay: float = 0.0,
                      image_size: int = 224, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                      backbone_weights: str = "", device=None) -> InverseTrainState:
    """The JAX package's loop: `num_steps` steps over train_batcher's
    epochs (`batches(batch_size)`, fed through the pinned prefetch); every
    `validate_every` steps the mean loss and accuracy of `val_batches`
    batches drawn by `val_batcher.get_batch`, the scalars Loss/train,
    Loss/val, Accuracy/train and Accuracy/val, and `sample<N>.ckpt`; a
    final checkpoint when the last step was no validation step. With a
    process group up every rank runs this loop data-parallel (see the
    module's docstring); the batchers must draw the same rows in every
    rank (the same seeds), and only rank 0 writes."""
    device = resolve_device(device)
    mesh = make_mesh()
    primary = mesh.rank == 0
    start, size = mesh.global_batch_slice(batch_size)
    state = create_inverse_state(lr, lr_decay, decay_every_steps, weight_decay, seed,
                                 image_size, backbone_weights, device)
    step_fn = make_inverse_step(state.model, dtype, mesh)
    eval_fn = make_inverse_eval(dtype)
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    if mesh.data > 1:  # each rank decodes its rows of the global batch
        source = (train_batcher.get_batch(rows[start:start + size])
                  for rows in train_batcher.index_stream(batch_size))
    else:
        source = train_batcher.batches(batch_size)
    batches = prefetch_to_device(source, device)
    it = 0
    try:
        for batch in itertools.islice(batches, num_steps):
            # every rank draws the global mask and keeps its rows
            mask = state.dropout_mask(batch_size)[start:start + size] if mesh.data > 1 \
                else None
            metrics = step_fn(state, batch, mask)
            it += 1
            if it % validate_every == 0:
                vloss, vacc = [], []
                for _ in range(val_batches):
                    vb = shard_batch(mesh, val_batcher.get_batch(batch_size=batch_size))
                    scalars = torch.stack(eval_fn(state.model, to_device(vb, device)))
                    mesh.mean_over_data([scalars])
                    vloss.append(float(scalars[0]))
                    vacc.append(float(scalars[1]))
                if writer is not None and primary:
                    writer.add_scalar("Loss/train", float(metrics["loss"]), it)
                    writer.add_scalar("Loss/val", float(np.mean(vloss)), it)
                    writer.add_scalar("Accuracy/train", float(metrics["accuracy"]), it)
                    writer.add_scalar("Accuracy/val", float(np.mean(vacc)), it)
                if primary:
                    save_checkpoint(out_dir, it, flax_state_dict(state))
    finally:
        batches.close()
    if it % validate_every != 0 and primary:
        # always leave a final checkpoint (runs shorter than validate_every
        # otherwise save nothing)
        save_checkpoint(out_dir, it, flax_state_dict(state))
    return state

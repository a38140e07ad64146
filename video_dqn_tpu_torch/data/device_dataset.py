"""The Q-learning dataset in device memory, sampled on the card
(counterpart of video_dqn_tpu/data/device_dataset.py).

Tables, as numpy arrays (`tables()` of a batch source):
  frames     (U, S, S, 3) uint8   every unique frame, one device buffer
  before_idx (N, F) int32         each row's before-state stack -> frames
  after_idx  (N, F) int32         each row's after-state stack -> frames
  action (N,) int32; reward, terminal, gt, valid_mask (N, 5) float32

They are uploaded once; batch k is then gathered on the card from the rows
`rows(k)`, with the QLearningBatcher.get_batch contract. Row draws are a
pure function of (seed, k): 'epoch' sampling takes window k % (N // B) of
the permutation of epoch k // (N // B), drop_last, as the reference's
shuffling DataLoader; 'uniform' draws B rows with replacement. Each draw
uses a CPU torch.Generator seeded from (seed, epoch) or (seed, k), so the
stream is the same on every device and across resume; it is not the JAX
package's stream, whose threefry bits torch does not reproduce. The B row
indices cross to the card through pinned memory without a synchronize.

On a mesh (parallel/mesh.py) every rank draws the same B global rows and
keeps its data slice, rows [d·B/D, (d+1)·B/D). With `shard_frames`
(TPU.SHARD_DATASET) and a data group of D > 1 the frame table, padded to a
multiple of D, is split along the data group: each rank gathers the
requested frames of the whole batch that it owns (clipped local index,
ownership mask, zero elsewhere, in uint8), and one reduce-scatter (sum)
over the data group deals each rank its slice. Exactly one rank owns each
frame, so the uint8 sum is exact and the stream is bit-equal to the
replicated layout's; the wire carries one batch of frames a step, not the
table. A data group of 1 keeps the replicated layout, as JAX does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..parallel.mesh import Mesh

TABLE_KEYS = ("frames", "before_idx", "after_idx", "action", "reward", "terminal",
              "gt", "valid_mask")
LABEL_KEYS = ("action", "reward", "terminal", "gt", "valid_mask")


def _generator(seed: int, k: int) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, k]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(mixed))


# Share of the card's memory the frame table may take: the rest holds the
# params, Adam's moments, the target net and a step's activations.
MEMORY_BUDGET_FRACTION = 0.6


def device_memory_bytes(device) -> Optional[int]:
    """The card's memory, or None on the CPU (no capacity limit)."""
    device = torch.device(device)
    return torch.cuda.mem_get_info(device)[1] if device.type == "cuda" else None


def check_capacity(num_frames: int, image_size: int, memory_limit_bytes: Optional[int],
                   data_shards: int = 1, sharded: bool = False) -> None:
    """Raise unless a table of `num_frames` uint8 frames of image_size^2 x
    3 fits MEMORY_BUDGET_FRACTION of the device's memory, or of the
    `data_shards` devices' together when the table is `sharded` over them;
    callers check before they decode or upload anything."""
    nbytes = num_frames * image_size * image_size * 3
    scale = data_shards if sharded else 1
    if memory_limit_bytes is None or nbytes <= MEMORY_BUDGET_FRACTION * memory_limit_bytes * scale:
        return
    if sharded or data_shards == 1:
        hint = ("Use the host-fed infeed (TPU.DEVICE_DATASET: false) or a smaller "
                "TPU.IMAGE_SIZE.")
    else:
        hint = (f"Shard the table across the data axis (TPU.SHARD_DATASET: true - aggregate "
                f"capacity {MEMORY_BUDGET_FRACTION * memory_limit_bytes * data_shards / 1e9:.2f}"
                f" GB), or use the host-fed infeed (TPU.DEVICE_DATASET: false).")
    raise ValueError(
        f"TPU.DEVICE_DATASET: the frame table ({num_frames} unique "
        f"{image_size}px frames = {nbytes / 1e9:.2f} GB) exceeds "
        f"{MEMORY_BUDGET_FRACTION:.0%} of the "
        f"{'aggregate data-axis' if sharded else 'device'} memory "
        f"({memory_limit_bytes * scale / 1e9:.2f} GB). " + hint)


class DeviceDataset:
    def __init__(self, tables: Dict[str, np.ndarray], batch_size: int, seed: int = 0,
                 sampling: str = "epoch", device=None,
                 memory_limit_bytes: Optional[int] = None, mesh: Optional[Mesh] = None,
                 shard_frames: bool = False):
        self.device = resolve_device(device)
        missing = set(TABLE_KEYS) - set(tables)
        if missing:
            raise ValueError(f"tables lack {sorted(missing)}")
        if sampling not in ("epoch", "uniform"):
            raise ValueError(f"TPU.DEVICE_SAMPLING must be 'epoch' or 'uniform', "
                             f"got {sampling!r}")
        frames = tables["frames"]
        self.n = len(tables["action"])
        self.batch_size = int(batch_size)
        if self.batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} exceeds dataset size {self.n}")
        self.seed, self.sampling = int(seed), sampling
        self.steps_per_epoch = self.n // self.batch_size
        self.mesh = mesh or Mesh()
        n_data = self.mesh.data
        # a data group of 1 keeps the replicated layout
        self.sharded = bool(shard_frames) and n_data > 1
        if self.sharded and self.batch_size % n_data:
            raise ValueError(f"TPU.SHARD_DATASET: batch_size {batch_size} must divide across "
                             f"the {n_data}-way data axis")

        # capacity guard, before anything is uploaded
        if memory_limit_bytes is None:
            memory_limit_bytes = device_memory_bytes(self.device)
        check_capacity(len(frames), frames.shape[1], memory_limit_bytes, n_data, self.sharded)

        if self.sharded:
            # padded to a multiple of the data ranks; pad rows are never indexed
            self.frame_rows = len(frames) + (-len(frames)) % n_data
            self.shard_rows = self.frame_rows // n_data
            lo = self.mesh.d * self.shard_rows
            shard = np.zeros((self.shard_rows,) + frames.shape[1:], np.uint8)
            mine = frames[lo:lo + self.shard_rows]
            shard[:len(mine)] = mine
            frames = shard
        else:
            self.frame_rows = len(frames)
        self.bytes = frames.nbytes
        self.tables = {k: torch.from_numpy(np.ascontiguousarray(
            frames if k == "frames" else tables[k])).to(self.device) for k in TABLE_KEYS}
        self._epoch_perm = (-1, None)

    def rows(self, step: int) -> torch.Tensor:
        """The B row indices of batch `step` (int64, on the CPU)."""
        b = self.batch_size
        if self.sampling == "uniform":
            return torch.randint(0, self.n, (b,), generator=_generator(self.seed, step))
        epoch, j = divmod(int(step), self.steps_per_epoch)
        if self._epoch_perm[0] != epoch:
            self._epoch_perm = (epoch, torch.randperm(self.n,
                                                      generator=_generator(self.seed, epoch)))
        return self._epoch_perm[1][j * b:(j + 1) * b]

    def sample(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch `step` on the device, this rank's rows of it: before/after
        (B, F, S, S, 3) uint8 and the labels of QLearningBatcher.get_batch."""
        rows = self.rows(step)
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        start, size = self.mesh.global_batch_slice(self.batch_size)
        mine = rows[start:start + size]
        t = self.tables
        s = t["frames"].shape[1:]
        batch = {k: t[k].index_select(0, mine) for k in LABEL_KEYS}
        for key, col in (("before", "before_idx"), ("after", "after_idx")):
            if self.sharded:
                batch[key] = self._gather_sharded(t[col].index_select(0, rows), size)
            else:
                idx = t[col].index_select(0, mine)
                batch[key] = t["frames"].index_select(0, idx.reshape(-1)).reshape(idx.shape + s)
        return batch

    def _gather_sharded(self, idx: torch.Tensor, size: int) -> torch.Tensor:
        """The frames of every row's `idx` (B, F) -> this rank's `size`
        rows of them: its own frames of the whole batch, zero elsewhere,
        summed and dealt over the data group by one reduce-scatter."""
        frames = self.tables["frames"]
        local = idx - self.mesh.d * self.shard_rows
        owned = (local >= 0) & (local < self.shard_rows)
        got = frames.index_select(0, local.clamp(0, self.shard_rows - 1).reshape(-1))
        got = got.reshape(idx.shape + frames.shape[1:])
        got = torch.where(owned[..., None, None, None], got, torch.zeros((), dtype=got.dtype,
                                                                            device=got.device))
        out = torch.empty((size,) + got.shape[1:], dtype=got.dtype, device=got.device)
        dist.reduce_scatter_tensor(out, got.contiguous(), group=self.mesh.data_group)
        return out

    def batches(self, start_step: int = 0):
        """Endless stream of device batches; batch k is sample(k), so a
        resumed run draws what the first run would have drawn."""
        step = start_step
        while True:
            yield self.sample(step)
            step += 1

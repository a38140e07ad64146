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
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device

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


def check_capacity(num_frames: int, image_size: int,
                   memory_limit_bytes: Optional[int]) -> None:
    """Raise unless a table of `num_frames` uint8 frames of image_size^2 x
    3 fits MEMORY_BUDGET_FRACTION of the device's memory; callers check
    before they decode or upload anything."""
    nbytes = num_frames * image_size * image_size * 3
    if memory_limit_bytes is not None and nbytes > MEMORY_BUDGET_FRACTION * memory_limit_bytes:
        raise ValueError(
            f"TPU.DEVICE_DATASET: the frame table ({num_frames} unique "
            f"{image_size}px frames = {nbytes / 1e9:.2f} GB) exceeds "
            f"{MEMORY_BUDGET_FRACTION:.0%} of the device's memory "
            f"({memory_limit_bytes / 1e9:.2f} GB). Use the host-fed infeed "
            f"(TPU.DEVICE_DATASET: false) or a smaller TPU.IMAGE_SIZE.")


class DeviceDataset:
    def __init__(self, tables: Dict[str, np.ndarray], batch_size: int, seed: int = 0,
                 sampling: str = "epoch", device=None,
                 memory_limit_bytes: Optional[int] = None):
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

        # capacity guard, before anything is uploaded
        if memory_limit_bytes is None:
            memory_limit_bytes = device_memory_bytes(self.device)
        check_capacity(len(frames), frames.shape[1], memory_limit_bytes)

        self.bytes = frames.nbytes
        self.tables = {k: torch.from_numpy(np.ascontiguousarray(tables[k])).to(self.device)
                       for k in TABLE_KEYS}
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
        """Batch `step` on the device: before/after (B, F, S, S, 3) uint8 and
        the labels of QLearningBatcher.get_batch."""
        rows = self.rows(step)
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        t = self.tables
        s = t["frames"].shape[1:]
        batch = {k: t[k].index_select(0, rows) for k in LABEL_KEYS}
        for key, col in (("before", "before_idx"), ("after", "after_idx")):
            idx = t[col].index_select(0, rows)
            batch[key] = t["frames"].index_select(0, idx.reshape(-1)).reshape(idx.shape + s)
        return batch

    def batches(self, start_step: int = 0):
        """Endless stream of device batches; batch k is sample(k), so a
        resumed run draws what the first run would have drawn."""
        step = start_step
        while True:
            yield self.sample(step)
            step += 1

"""The (data, model) mesh over torch.distributed (counterpart of
video_dqn_tpu/parallel/mesh.py).

JAX lays a 2-D mesh over the devices one process drives; torch runs one
rank a device, so the mesh is laid over the ranks of the process group:
global rank r sits at (d, m) = (r // M, r % M), the order of
`np.array(devices).reshape(data, model)`. The data group of rank r holds
the ranks with its m (they split the batch and average their gradients);
its model group holds the ranks with its d (they see the same rows and
split the wide head's output features, parallel/sharding.py). Rows
[d·B/D, (d+1)·B/D) of a global batch of B are rank r's.

Without a process group `make_mesh()` is the 1x1 mesh, with no groups: no
collective runs and every path is the one-card path. With a process group,
even of one rank, the groups exist and the collectives run on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True, eq=False)
class Mesh:
    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[Any] = None   # None: no process group, nothing to reduce
    model_group: Optional[Any] = None

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

    def __deepcopy__(self, memo) -> "Mesh":
        # modules hold the mesh; a copied module shares its process groups
        return self

    def global_batch_slice(self, batch_size: int) -> Tuple[int, int]:
        """(start, size) of this rank's rows of a global batch; raises
        when the data ranks do not divide it."""
        if batch_size % self.data:
            raise ValueError(f"batch {batch_size} not divisible by {self.data} data ranks")
        size = batch_size // self.data
        return self.d * size, size

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of a tensor split over the model axis."""
        n = t.shape[0] // self.model
        return t[self.m * n:(self.m + 1) * n]

    def gather_model(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from each model rank's block of rows (a
        collective of the model group: every rank of it must call). Nothing
        without a group; on a group of one rank it still runs (NCCL copies
        the block on the card)."""
        if self.model_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.model)]
        dist.all_gather(parts, t.contiguous(), group=self.model_group)
        return torch.cat(parts)

    def mean_over_data(self, tensors: List[torch.Tensor]) -> None:
        """Each tensor replaced, in place, by its mean over the data group:
        one all-reduce of their concatenation. Nothing without a group."""
        if self.data_group is None or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        flat /= self.data
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the process group's ranks; data=-1
    means all the ranks the model axis leaves. Raises JAX's ValueErrors
    where the ranks do not fill the mesh. With a process group every rank
    must call it, in the same order as the others (it makes the groups)."""
    rank, n = world()
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    return Mesh(data, model, rank, data_groups[rank % model], model_groups[rank // model])


def shard_batch(mesh: Mesh, host_batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (arrays or tensors, batch first)."""
    start, size = mesh.global_batch_slice(len(next(iter(host_batch.values()))))
    return {k: v[start:start + size] for k, v in host_batch.items()}

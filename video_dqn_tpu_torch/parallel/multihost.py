"""Fleet start-up and the primary's side effects (counterpart of
video_dqn_tpu/parallel/multihost.py).

`initialize` is a launcher: one rank a process (the torch idiom), where a
JAX process drives all its local devices. It starts `local_ranks` rank
processes (the spawn start method: a rank must not inherit CUDA), or runs
the one rank in the calling process; each joins the process group at
`coordinator` (host:port; process 0 hosts the store there) as global rank
process_id * local_ranks + local, of num_processes * local_ranks, runs
`fn(device, *args)` and leaves the group. Platform 'native' is NCCL with
local rank l on cuda:<card + l> (`card` 0 unless the caller names the
first card); 'cpu' is gloo on the CPU (tests, CI). A failed
join raises: JAX warns and trains on alone, which would train on 1/N of
the fleet without a sign.

JAX's `place_tree`, `make_global_array` and `device_get_local` have no
counterpart: each rank holds its own shard, and the checkpoint gathers the
sharded head over the model group (train/dqn.py flax_state_dict). JAX's
`global_batch_slice` is `Mesh.global_batch_slice` (parallel/mesh.py).
"""

from __future__ import annotations

import functools
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import world

PLATFORMS = ("cpu", "native")


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join(coordinator: str, world_size: int, rank: int, platform: str,
         local_rank: int = 0) -> torch.device:
    """Join the process group as `rank` of `world_size`; returns the
    rank's device. Raises if the group does not form."""
    if platform == "native":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"tcp://{coordinator}",
                                world_size=world_size, rank=rank, device_id=device)
    elif platform == "cpu":
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=world_size, rank=rank)
    else:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    if dist.get_world_size() != world_size:
        raise RuntimeError(f"joined {dist.get_world_size()} ranks, expected {world_size}: "
                           "the process group did not form")
    return device


def _rank(local_rank: int, coordinator: str, world_size: int, first: int, platform: str,
          card: int, fn: Callable, args: Sequence):
    device = join(coordinator, world_size, first + local_rank, platform, card + local_rank)
    try:
        return fn(device, *args)
    finally:
        dist.destroy_process_group()


def initialize(coordinator: str, num_processes: int, process_id: int,
               platform: str = "native", local_ranks: int = 1,
               fn: Optional[Callable] = None, args: Sequence = (), card: int = 0):
    """Run `fn(device, *args)` in each of this process's `local_ranks`
    ranks of the fleet (see the module's docstring). With one local rank it
    runs here and its result is returned; with more, `fn` (a module-level
    function: it is pickled) runs in spawned processes, the call returns
    None once they all end, and raises if one failed."""
    if platform == "native" and not torch.cuda.is_available():
        raise RuntimeError("--multihost-platform native needs a CUDA device and none is "
                           "available; use --multihost-platform cpu to run on the CPU")
    if num_processes < 1 or not 0 <= process_id < num_processes or local_ranks < 1:
        raise ValueError(f"process {process_id} of {num_processes} with {local_ranks} "
                         "local ranks")
    spec = (coordinator, num_processes * local_ranks, process_id * local_ranks, platform,
            card, fn, tuple(args))
    if local_ranks == 1:
        return _rank(0, *spec)
    mp.start_processes(_rank, args=spec, nprocs=local_ranks, join=True, start_method="spawn")
    return None


def is_primary() -> bool:
    return world()[0] == 0


def primary_only(fn: Callable) -> Callable:
    """Run fn only on rank 0 (checkpoints, metrics)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapper


"""Q-network training CLI of the port (counterpart of the root
train_q_network.py:13-116):

    python -m video_dqn_tpu_torch.train_q_network <folder> [-r] [-d] [--log-every N]
        [--coordinator HOST:PORT --num-processes N --process-id I
         [--multihost-platform {cpu,native}] [--local-devices K]]

`<folder>` holds `config.yml`; its DATASET feather and the JPEG frames it
names are read by the port's own reader and decoder, and training runs on
the card. -r resumes from the latest `sample<N>.ckpt` of `<folder>/models`,
-d deletes the folder's run logs first, and -g is accepted and ignored as
in the JAX CLI.

The fleet flags are the JAX CLI's. With --coordinator every process of the
fleet runs this same command line with its own --process-id; process 0
hosts the rendezvous at HOST:PORT (parallel/multihost.py). 'native' runs
one NCCL rank a visible card (--local-devices is ignored, as in JAX), or
one rank on the card that `main(device=...)` names;
'cpu' runs --local-devices gloo ranks a process on the CPU, so JAX's
`--num-processes 2 --local-devices 4` forms the same 8-rank mesh. The mesh
is TPU.MESH_DATA x TPU.MESH_MODEL over the ranks. Without --coordinator,
on more than one card the CLI spawns one rank a card over a localhost
store, as JAX's default mesh takes every local device; on one card, or on
the CPU, it runs with no process group. Only rank 0 writes the config log,
the metrics and the checkpoints.

With VISUALIZATION_DATA_ROOT set to a folder of grid folders (written by
viz/render_grid.py), each checkpoint is followed by one value map a grid
and class, the max over the four orientations, written as
`<run dir>/value_map_<grid>_<class>_<step>.png`. The online net scores
the grids in eval mode at TPU.IMAGE_SIZE (the JAX CLI scores at 224, which
only a net trained at 224 takes) and goes back to train mode after.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Optional

import torch

from ._device import resolve_device
from .core.checkpoint import latest_checkpoint_step
from .core.experiment import ExperimentConfig
from .parallel import multihost
from .sim.gibson import CLASS_LABELS
from .train.dqn import run_train
from .viz.value_map import build_value_maps, render_value_map


def main(argv: Optional[List[str]] = None, device=None):
    """Train from the folder named in `argv` (sys.argv when None) on
    `device` (None: the card, or every card where there are several;
    raises without CUDA). A `device` named runs one rank, also in the
    native fleet. Returns run_train's (state, last logged EMA loss) where
    this process runs one rank, None where it spawned its ranks."""
    parser = argparse.ArgumentParser(description="train q network (PyTorch port)")
    parser.add_argument("-g", "--gpu", dest="gpu", default="0",
                        help="ignored (reference-CLI compatibility)")
    parser.add_argument("-r", "--resume", action="store_true",
                        help="resume from the latest sample<N> checkpoint")
    parser.add_argument("-d", "--delete", action="store_true",
                        help="delete stored run logs")
    parser.add_argument("--log-every", type=int, default=100,
                        help="metrics cadence in steps")
    parser.add_argument("--coordinator", default="",
                        help="host:port of process 0's rendezvous; turns on fleet mode "
                             "(every process runs this same command line)")
    parser.add_argument("--num-processes", type=int, default=0)
    parser.add_argument("--process-id", type=int, default=-1)
    parser.add_argument("--multihost-platform", choices=multihost.PLATFORMS, default="native",
                        help="cpu: gloo ranks on the CPU (tests, CI); native: one NCCL rank "
                             "a visible card")
    parser.add_argument("--local-devices", type=int, default=4,
                        help="gloo ranks a process (cpu platform only)")
    parser.add_argument("config", help="folder containing config.yml")
    args = parser.parse_args(argv)

    if args.coordinator:
        if args.num_processes <= 0 or args.process_id < 0:
            parser.error("--coordinator requires --num-processes and --process-id")
        if args.multihost_platform == "cpu":
            local, card = args.local_devices, 0
        elif device is None:
            local, card = torch.cuda.device_count(), 0
        else:
            local, card = 1, torch.device(device).index or 0
        return multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                    args.multihost_platform, local, _train, (args,), card)
    if device is None and torch.cuda.device_count() > 1:
        return multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, "native",
                                    torch.cuda.device_count(), _train, (args,))
    return _train(resolve_device(device), args)


def _train(device, args):
    """One rank's run: the config (its writer and log on rank 0 only), the
    checkpoint to resume from, the value-map hook, run_train."""
    primary = multihost.is_primary()
    config = ExperimentConfig(args.config, remove=args.delete and primary, resume=args.resume,
                              writer=primary)
    multihost.primary_only(config.write_config_log)()

    resume_from = -1
    if args.resume:
        latest = latest_checkpoint_step(config.models_dir)
        if latest is not None:
            print(f"Resuming from: {latest}")
            resume_from = latest
    hook = value_map_hook(config, device) if config.VISUALIZATION_DATA_ROOT and primary \
        else None
    return run_train(config, resume_from, log_every=args.log_every, device=device,
                     visualize_hook=hook)


def value_map_hook(config, device) -> Callable:
    """The checkpoint hook of VISUALIZATION_DATA_ROOT: for every grid
    folder under it, value maps of the live online net (eval mode, no
    gradient; train mode restored after), and one add_image a class of
    the max-over-orientations map."""
    root = config.VISUALIZATION_DATA_ROOT
    grids = [d for d in sorted(os.listdir(root)) if os.path.isdir(os.path.join(root, d))]
    panorama = bool(config.PANORAMA or config.PREVIOUS_IMAGES)
    image_size = int(config.TPU.IMAGE_SIZE)

    def visualize_hook(model, state, sample_number: int) -> None:
        try:
            for name in grids:
                maps, agg, free = build_value_maps(model, os.path.join(root, name), panorama,
                                                   image_size=image_size, device=device)
                for i, label in enumerate(CLASS_LABELS):
                    config.writer.add_image(f"value_map_{name}/{label}",
                                            render_value_map(agg[:, :, i], free), sample_number)
                del maps, agg, free  # ~0.5 GB at resolution 1500: one grid's maps at a time
        finally:
            model.set_train(True)

    return visualize_hook


if __name__ == "__main__":
    main()

"""Q-network training CLI of the port (counterpart of the root
train_q_network.py:13-116):

    python -m video_dqn_tpu_torch.train_q_network <folder> [-r] [-d] [--log-every N]

`<folder>` holds `config.yml`; its DATASET feather and the JPEG frames it
names are read by the port's own reader and decoder, and training runs on
the card. -r resumes from the latest `sample<N>.ckpt` of `<folder>/models`,
-d deletes the folder's run logs first, and -g is accepted and ignored as
in the JAX CLI. The JAX CLI's multi-host flags are not ported yet
(ROADMAP.md, queue 1 item 10).

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

from ._device import resolve_device
from .core.checkpoint import latest_checkpoint_step
from .core.experiment import ExperimentConfig
from .sim.gibson import CLASS_LABELS
from .train.dqn import run_train
from .viz.value_map import build_value_maps, render_value_map


def main(argv: Optional[List[str]] = None, device=None):
    """Train from the folder named in `argv` (sys.argv when None) on
    `device` (None: the card; raises without CUDA). Returns run_train's
    (state, last logged EMA loss)."""
    parser = argparse.ArgumentParser(description="train q network (PyTorch port)")
    parser.add_argument("-g", "--gpu", dest="gpu", default="0",
                        help="ignored (reference-CLI compatibility)")
    parser.add_argument("-r", "--resume", action="store_true",
                        help="resume from the latest sample<N> checkpoint")
    parser.add_argument("-d", "--delete", action="store_true",
                        help="delete stored run logs")
    parser.add_argument("--log-every", type=int, default=100,
                        help="metrics cadence in steps")
    parser.add_argument("config", help="folder containing config.yml")
    args = parser.parse_args(argv)
    device = resolve_device(device)

    config = ExperimentConfig(args.config, remove=args.delete, resume=args.resume)
    config.write_config_log()

    resume_from = -1
    if args.resume:
        latest = latest_checkpoint_step(config.models_dir)
        if latest is not None:
            print(f"Resuming from: {latest}")
            resume_from = latest
    hook = value_map_hook(config, device) if config.VISUALIZATION_DATA_ROOT else None
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

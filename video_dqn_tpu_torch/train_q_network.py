"""Q-network training CLI of the port (counterpart of the root
train_q_network.py:13-116):

    python -m video_dqn_tpu_torch.train_q_network <folder> [-r] [-d] [--log-every N]

`<folder>` holds `config.yml`; its DATASET feather and the JPEG frames it
names are read by the port's own reader and decoder, and training runs on
the card. -r resumes from the latest `sample<N>.ckpt` of `<folder>/models`,
-d deletes the folder's run logs first, and -g is accepted and ignored as
in the JAX CLI. The JAX CLI's multi-host flags are not ported yet
(ROADMAP.md, queue 1 item 10), nor is the value-map hook that
VISUALIZATION_DATA_ROOT turns on (queue 1 item 8): such a config raises.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ._device import resolve_device
from .core.checkpoint import latest_checkpoint_step
from .core.experiment import ExperimentConfig
from .train.dqn import run_train


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
    if config.VISUALIZATION_DATA_ROOT:
        raise NotImplementedError(
            "VISUALIZATION_DATA_ROOT (value maps at checkpoints) is not ported to "
            "video_dqn_tpu_torch yet (ROADMAP.md, queue 1 item 8); unset it")
    config.write_config_log()

    resume_from = -1
    if args.resume:
        latest = latest_checkpoint_step(config.models_dir)
        if latest is not None:
            print(f"Resuming from: {latest}")
            resume_from = latest
    return run_train(config, resume_from, log_every=args.log_every, device=device)


if __name__ == "__main__":
    main()

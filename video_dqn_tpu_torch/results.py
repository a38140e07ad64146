"""Results CLI of the port (counterpart of the root evaluation/results.py):

    python -m video_dqn_tpu_torch.results <config.yml>
    python -m video_dqn_tpu_torch.results --folder <result-shard folder>

Merges the result shards of a run and prints each episode's SPL and the
mean. It reads files only, so it runs on the CPU; `device` is taken for
the shape of every entry point of the port (None: the card).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ._device import resolve_device
from .core.disk_logger import DiskReader
from .eval.policy_config import load_file
from .eval.results import display_results


def main(argv: Optional[List[str]] = None, device=None):
    """Print the results that `argv` (sys.argv when None) names; returns
    the mean SPL (None when there are none)."""
    parser = argparse.ArgumentParser(description="show eval results")
    parser.add_argument("config", help="eval config yml, or a result-shard "
                                       "folder with --folder")
    parser.add_argument("--folder", action="store_true",
                        help="treat the argument as a DiskLogger shard folder "
                             "instead of a config")
    args = parser.parse_args(argv)
    resolve_device(device)

    if args.folder:
        data = DiskReader(args.config).data()
        if not data:
            print("no result shards found")
            return None
        for k in sorted(data):
            print(f"Episode {k}: SPL {data[k]}")
        mean = np.mean([float(v) for v in data.values()])
        print(f"Mean SPL: {mean} ({len(data)} episodes)")
        return mean
    return display_results(load_file(args.config))


if __name__ == "__main__":
    main()

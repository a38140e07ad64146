"""Results reader (counterpart of video_dqn_tpu/eval/results.py
`display_results`): merge a run's result shards and print each episode's
SPL and the mean."""

from __future__ import annotations

import os

from ..core.disk_logger import DiskReader
from .policy_config import name_from_config


def display_results(config, quiet: bool = False):
    log_folder = os.path.join(config.RESULT_LOCATION, name_from_config(config))
    data = DiskReader(log_folder).data()
    if not data:
        if not quiet:
            print(f"no results in {log_folder}")
        return None
    if not quiet:
        for k in sorted(data.keys()):
            print(f"Episode {k}: SPL {data[k]}")
    mean = sum(data.values()) / len(data)
    if not quiet:
        print(f"Mean SPL: {mean}")
    return mean

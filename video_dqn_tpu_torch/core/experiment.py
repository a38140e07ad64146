"""Folder-as-experiment (counterpart of video_dqn_tpu/core/experiment.py):
an experiment is a folder holding `config.yml`; loading merges it over the
defaults, validates, freezes and exposes every key as an attribute. Run
logs go to an auto-incremented `run<N>` subfolder (resume reuses the
latest; `remove` deletes the old ones first), checkpoints to
`<folder>/models`, and `write_config_log` writes the resolved config to
`<folder>/log` with the JAX package's text. In a fleet only the primary
rank writes: the others pass `writer=False`, which makes no run dir and
leaves `writer` None."""

from __future__ import annotations

import os
import re
import shutil

from .defaults import VALID_VALUES, get_cfg_defaults
from .metrics import MetricsWriter


class ExperimentConfig:
    def __init__(self, folder: str, remove: bool = False, resume: bool = False,
                 writer: bool = True):
        self.folder = folder
        if remove:
            for f in os.listdir(folder):
                if re.match(r"^run\d+$", f):
                    shutil.rmtree(os.path.join(folder, f), ignore_errors=True)
        runs = [int(m.group(1)) for f in os.listdir(folder)
                if (m := re.match(r"^run(\d+)$", f))]
        run = max(runs, default=0) + (0 if resume else 1)
        self.run_dir = os.path.join(folder, f"run{run}")

        cfg = get_cfg_defaults()
        cfg.merge_from_file(os.path.join(folder, "config.yml"))
        cfg.validate(VALID_VALUES)
        self.cfg = cfg.freeze()
        for k in cfg:
            setattr(self, k, cfg[k])
        self.writer = MetricsWriter(self.run_dir) if writer else None

    @property
    def models_dir(self) -> str:
        return os.path.join(self.folder, "models")

    def write_config_log(self) -> None:
        """The resolved config, as `<folder>/log`."""
        with open(os.path.join(self.folder, "log"), "w") as f:
            f.write(f"Running with config ({self.cfg.dump()})")

"""Evaluation configuration tree and run naming (counterpart of
video_dqn_tpu/eval/policy_config.py): the eval config's keys and defaults
(including the baseline-policy flags, so that published eval configs
parse), `name_from_config` giving byte-identical results and video folder
names, and `load_file` with INHERIT chaining and the MODEL_CONFIG merge
from MODEL_CONFIG_LOCATION. Over the port's core/config.py and
core/defaults.py.
"""

from __future__ import annotations

import os

from ..core.config import ConfigNode
from ..core.defaults import get_cfg_defaults


def get_eval_defaults() -> ConfigNode:
    return ConfigNode(
        {
            "INHERIT": "",
            "SCORE": "geodesic",  # 'geodesic' | 'model' | 'detector'
            "DATASET": "val",
            "SLAM": False,
            "STOP": False,
            "MODEL_CONFIG_LOCATION": "",
            "MODEL_NAME": "",
            "ACT_ON_Q": False,
            "Q_STOCHASTIC": False,
            "BEHAVIOR_CLONING": False,
            "BEHAVIOR_PANORAMA": False,
            "BEHAVIOR_REAL": False,
            "BEHAVIOR_FINETUNE": False,
            "BEHAVIOR_LSTM": True,
            "RESULT_LOCATION": "navigation_results",
            "VIDEO_LOCATION": "navigation_videos",
            "CHASE_DETECTOR": False,
            "COMBINE_DETECTOR": False,
            "CONFIDENCE_THRESHOLD": 0.5,
            "SEED": 0,
            "STAIRS": False,
            "MODEL_NUMBER": 300000,
            "FORWARD_SCORE": False,
            "PREVIOUS_IMAGES_REPLICATE": False,
            "PREVIOUS_IMAGES_ROTATE": False,
            "BEHAVIOR_NONEG": False,
            "BEHAVIOR_MASK": False,
            "BEHAVIOR_LOG": False,
            "HABITAT_POLICY": False,
            "HABITAT_CONFIG_PATH": "",
            "HABITAT_MODEL_NAME": "noname",
            "HABITAT_FRAMES": 0.0,
            "HABITAT_CHECKPOINT": 0,
            "HABITAT_LOG": False,
            "HABITAT_BC_RL": False,
            "PRETRAINED_MODEL_LOCATION": "",
            "CONSISTENCY_WEIGHT": 0.0,
            "BACKTRACK_REJECTION": False,
            "TOTAL_RANDOM": False,
            "FORWARD_IMAGES": False,
            "FORWARD_IMAGE_STEPS": 4,
            "HALLUCINATE": False,
            "SINGLE_MODEL_PANORAMA": False,
            # resolved by load_file from MODEL_CONFIG_LOCATION
            "MODEL_CONFIG": get_cfg_defaults(),
            # score a stop's 12 views in one call (False: the reference's
            # per-view order)
            "BATCHED_REASONING": True,
            # the fusion detector's weights; the detector waits for
            # ROADMAP.md queue 1, item 7, so any non-empty value raises
            "DETECTOR_WEIGHTS": "",
        }
    )


_DEFAULT_MODEL_NUMBER = 300000


def name_from_config(config) -> str:
    """Deterministic run-name encoding, byte-identical to the JAX
    package's (and the reference's), so results folders interoperate."""
    if config.TOTAL_RANDOM:
        name = "total_random"
    elif config.HABITAT_POLICY:
        name = f"habitat_{config.HABITAT_MODEL_NAME}"
        if config.HABITAT_CHECKPOINT != 0:
            name += f"_{config.HABITAT_CHECKPOINT}"
        else:
            name += f"_frames{int(config.HABITAT_FRAMES)}"
        if config.HABITAT_LOG:
            name += "_log"
    elif config.ACT_ON_Q:
        name = f"actonq_{config.MODEL_NAME}"
        if config.Q_STOCHASTIC:
            name += "_stochastic"
    elif config.BEHAVIOR_CLONING:
        name = "behavior_stop" if config.STOP else "behavior"
        if config.BEHAVIOR_LOG:
            name += "_log"
        name += "_panorama" if config.BEHAVIOR_PANORAMA else "_nopanorama"
        if config.BEHAVIOR_REAL:
            name += "_real"
        if config.BEHAVIOR_FINETUNE:
            name += "_finetune"
        if config.BEHAVIOR_NONEG:
            name += "_noneg"
        if config.BEHAVIOR_MASK:
            name += "_mask"
    else:
        name = config.MODEL_NAME if config.SCORE == "model" else config.SCORE
        name += "_log" if config.STOP else "_spl"
        if config.SLAM:
            name += "_slam"
        if config.BACKTRACK_REJECTION:
            name += "_rejection"
        if config.CHASE_DETECTOR:
            name += "_chase"
        if config.FORWARD_SCORE:
            name += "_forward"
        if config.PREVIOUS_IMAGES_REPLICATE:
            name += "_replicate"
        if config.PREVIOUS_IMAGES_ROTATE:
            name += "_prev_rotate"
        if config.FORWARD_IMAGES:
            name += "_forward_images"
        if config.FORWARD_IMAGE_STEPS != 4:
            name += f"_fis{config.FORWARD_IMAGE_STEPS}"
        if config.HALLUCINATE:
            name += "_hallucinate"
        if config.SINGLE_MODEL_PANORAMA:
            name += "_single_panorama"
        if config.COMBINE_DETECTOR:
            name += f"_combined{config.CONFIDENCE_THRESHOLD}"
        if config.CONSISTENCY_WEIGHT != 0:
            name += f"_consistency{config.CONSISTENCY_WEIGHT}"
        if config.MODEL_NUMBER != _DEFAULT_MODEL_NUMBER:
            name += f"_model{config.MODEL_NUMBER}"
    if config.SEED != 0:
        name += f"_seed{config.SEED}"
    if config.DATASET != "val":
        name += f"_{config.DATASET}"
    if config.STAIRS:
        name += "_with_stairs"
    return name


def load_file(file_loc: str) -> ConfigNode:
    """Load an eval config with INHERIT chaining (root-first, children
    override) and MODEL_CONFIG resolution from MODEL_CONFIG_LOCATION."""
    cfg = get_eval_defaults()
    chain = []
    cur = file_loc
    seen = set()
    while cur:
        if cur in seen:
            raise ValueError(f"INHERIT cycle at {cur}")
        seen.add(cur)
        chain.append(cur)
        probe = get_eval_defaults()
        probe.merge_from_file(cur)
        cur = probe.INHERIT or None
    for path in reversed(chain):
        cfg.merge_from_file(path)
    cfg.INHERIT = ""

    if cfg.MODEL_CONFIG_LOCATION:
        sub = get_cfg_defaults()
        sub.merge_from_file(os.path.join(cfg.MODEL_CONFIG_LOCATION, "config.yml"))
        cfg.MODEL_CONFIG = sub
    cfg.freeze()
    return cfg

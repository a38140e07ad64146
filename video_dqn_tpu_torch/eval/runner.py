"""Episode-loop runner (counterpart of video_dqn_tpu/eval/runner.py
`run_policy`, `build_detector_from_config`): builds the fusion detector
of the config, walks the episode table,
reuses the env across episodes of the same house and logs each episode's
result to crash-safe shards (core/disk_logger.py) under
RESULT_LOCATION/<name_from_config>.

Its randomness is numpy's, call for call as the JAX package's: the
global np.random.seed(config.SEED), each episode's default_rng(SEED)
(eval/evaluate.py) and each env's default_rng(seed).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .._device import resolve_device
from ..core.disk_logger import DiskLogger, DiskReader
from ..core.experiment import ExperimentConfig
from ..sim.fake_env import FakeNavEnv
from ..sim.gibson import CLASS_LABELS, get_house, relevant_locations
from ..data.detect import StubDetector
from ..models.detector.inference import load_detector
from .evaluate import make_geodesic_scorer, ours_evaluate
from .load import load_eval_model
from .policy_config import name_from_config
from .scorer import make_model_scorer


def build_detector_from_config(config, device=None):
    """The fusion detector of the config, built once and reused across
    episodes: None unless COMBINE_DETECTOR or SCORE: detector is on
    (CHASE_DETECTOR only names the experiment); a ValueError when one is
    on without DETECTOR_WEIGHTS; StubDetector for DETECTOR_WEIGHTS: 'stub';
    else the Mask R-CNN of that torchvision checkpoint on `device` (None:
    the card)."""
    if not (config.COMBINE_DETECTOR or config.SCORE == "detector"):
        return None
    weights = config.DETECTOR_WEIGHTS if "DETECTOR_WEIGHTS" in config else ""
    if not weights:
        raise ValueError(
            "COMBINE_DETECTOR/SCORE=='detector' needs DETECTOR_WEIGHTS in "
            "the eval config: a torchvision maskrcnn_resnet50_fpn checkpoint "
            "path or 'stub' for the deterministic test detector")
    if weights == "stub":
        return StubDetector()
    return load_detector(weights, device=device)


def load_scoring_model(config, device):
    """(model, model config) for SCORE: model: the Q-net of the experiment
    at MODEL_CONFIG_LOCATION, its weights from PRETRAINED_MODEL_LOCATION or
    the experiment's sample<MODEL_NUMBER>.ckpt (eval/load.py), at the
    experiment's TPU.IMAGE_SIZE."""
    mc = ExperimentConfig(config.MODEL_CONFIG_LOCATION, resume=True)
    model = load_eval_model(config, mc, image_size=int(mc.TPU.IMAGE_SIZE), device=device)
    return model, mc


def run_policy(
    config,
    episodes: Optional[np.ndarray] = None,
    env_factory: Optional[Callable] = None,
    house_factory: Optional[Callable] = None,
    scorer_factory: Optional[Callable] = None,
    detector=None,
    visualize_every: int = 100,
    debug: bool = False,
    episodes_path: str = "evaluation/val_episodes.npy",
    resume: bool = False,
    start: int = 0,
    device=None,
):
    """Run the episode loop on `device` (None: the card).

    Injection points (all optional):
      episodes:        (N, 6) object array rows
                       (house, floor, class, goal_dist, pos, rot)
      env_factory:     (house, model_config, config) -> NavEnv
      house_factory:   name -> GibsonHouse-like (objects/object_locations)
      scorer_factory:  (env, class_index) -> view scorer; the default is
                       the model scorer with SCORE: model, else the
                       geodesic oracle (SCORE: detector too)
      detector:        the fusion detector; the default is
                       build_detector_from_config's
    Every `visualize_every`-th episode (from episode 0; 100 as in the JAX
    package, 0 never) is visualised: with SLAM its last rgb | depth | map
    strip is written under VIDEO_LOCATION (eval/evaluate.py).
    """
    device = resolve_device(device)
    np.random.seed(config.SEED)
    if detector is None:
        detector = build_detector_from_config(config, device)

    log_folder = os.path.join(config.RESULT_LOCATION, name_from_config(config))
    logger = DiskLogger(log_folder, checkpoint_time=60 * 30)
    # resume: skip episodes whose results already exist in the shards
    done = set(DiskReader(log_folder).data().keys()) if resume else set()

    if episodes is None:
        episodes = np.load(episodes_path, allow_pickle=True)

    model_config = config.MODEL_CONFIG
    model = None
    if config.SCORE == "model" and scorer_factory is None:
        model, model_config = load_scoring_model(config, device)

    house_factory = house_factory or get_house
    house_name, env, house = "", None, None

    for epind in range(start, len(episodes)):
        if epind in done:
            continue
        ep = episodes[epind]
        print(f"EP_INDEX: {epind}/{len(episodes)}", flush=True)
        hn, floor, class_label, goal_dist, pos, rot = ep
        if house_name != hn:
            if env is not None:
                env.close()
            house_name = hn
            house = house_factory(hn)
            if env_factory is not None:
                env = env_factory(house, model_config, config)
            else:
                env = FakeNavEnv(
                    panorama=bool(
                        config.SCORE == "model" and model_config.PANORAMA
                    )
                )

        loc = env.sample_start_state(int(floor))[0]
        goals = relevant_locations(
            loc, house.object_locations_for_habitat_dest[class_label]
        )
        env.goals = goals
        env.set_agent_state(pos, rot)

        if scorer_factory is not None:
            scorer = scorer_factory(env, CLASS_LABELS.index(class_label))
        elif config.SCORE == "model":
            scorer = make_model_scorer(
                model, CLASS_LABELS.index(class_label),
                image_size=int(model_config.TPU.IMAGE_SIZE), device=device,
            )
        else:
            scorer = make_geodesic_scorer(env)

        vis = visualize_every > 0 and epind % visualize_every == 0
        out = ours_evaluate(
            config, env, ep, house, epind, scorer, vis, model_config,
            detector=detector, device=device,
        )
        if not debug:
            logger.write(epind, out)
    if env is not None:
        env.close()
    calls = getattr(detector, "calls", None)
    if calls is not None:
        # one fused call a reasoning stop: stops per episode, read off the log
        print(f"Detector calls: {calls}", flush=True)
    return logger

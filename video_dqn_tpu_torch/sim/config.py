"""Simulation task configuration (counterpart of video_dqn_tpu/sim/config.py):
RGB+DEPTH 224x224 sensors, 30-degree turns, 0.25 m forward steps, the SPL
success distance and the optional extra sensor nodes, loadable from yaml
with a comma-separated multi-file merge, over the port's ConfigNode."""

from __future__ import annotations

from typing import Optional

from ..core.config import ConfigNode


def get_sim_defaults() -> ConfigNode:
    return ConfigNode(
        {
            "SIMULATOR": ConfigNode(
                {
                    "TURN_ANGLE": 30,
                    "FORWARD_STEP_SIZE": 0.25,
                    "RGB_SENSOR": ConfigNode({"WIDTH": 224, "HEIGHT": 224, "HFOV": 90}),
                    "DEPTH_SENSOR": ConfigNode(
                        {
                            "WIDTH": 224,
                            "HEIGHT": 224,
                            "HFOV": 90,
                            "MIN_DEPTH": 0.0,
                            "MAX_DEPTH": 10.0,
                        }
                    ),
                    "SENSORS": ["RGB_SENSOR", "DEPTH_SENSOR"],
                    "AGENT_HEIGHT": 1.25,   # navmesh regeneration constants
                    "MAX_CLIMB": 0.05,
                    "ALLOW_STAIRS": True,
                }
            ),
            "TASK": ConfigNode(
                {
                    "SUCCESS_DISTANCE": 0.2,
                    "MEASUREMENTS": ["SPL"],
                    "DETECTRON_SENSOR": ConfigNode({"ENABLED": False}),
                    "MULTI_SPL": ConfigNode({"ENABLED": False}),
                }
            ),
            "ENVIRONMENT": ConfigNode({"MAX_EPISODE_STEPS": int(1e6)}),
        }
    )


def get_config(config_paths: Optional[str] = None, opts: Optional[list] = None) -> ConfigNode:
    """The defaults with each of the comma-separated files merged in turn
    (a later file wins), then `opts` ([KEY, value, ...]); frozen."""
    cfg = get_sim_defaults()
    if config_paths:
        for path in config_paths.split(","):
            cfg.merge_from_file(path.strip())
    if opts:
        cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def env_kwargs_from_config(cfg: ConfigNode) -> dict:
    """A sim config as FakeNavEnv / MeshNavEnv constructor arguments."""
    sim = cfg.SIMULATOR
    return {
        "image_size": sim.RGB_SENSOR.WIDTH,
        "fov_deg": float(sim.RGB_SENSOR.HFOV),
        "turn_angle_deg": float(sim.TURN_ANGLE),
        "forward_step": float(sim.FORWARD_STEP_SIZE),
        "max_depth": float(sim.DEPTH_SENSOR.MAX_DEPTH),
    }

"""The eval policy's mapper and planners (counterpart of
video_dqn_tpu/plan)."""

from .mapper import (
    ACT_FORWARD,
    ACT_LEFT,
    ACT_RIGHT,
    ACT_STOP,
    DepthMapperAndPlanner,
)

__all__ = [
    "ACT_FORWARD",
    "ACT_LEFT",
    "ACT_RIGHT",
    "ACT_STOP",
    "DepthMapperAndPlanner",
]

"""Navigation-environment interface (counterpart of
video_dqn_tpu/sim/interface.py `NavEnv`): the methods the evaluation
harness calls, so that any backend can serve it.

Conventions (habitat's):
  * position: [x, height, z] floats (meters)
  * heading angle: radians about +y; forward at angle a is
    (dx, dz) = (-sin a, -cos a); a LEFT turn increases a
  * actions: 0 = forward 0.25 m, 1 = turn left, 2 = turn right
  * observations: dict with 'rgb' (H, W, 3) uint8 and 'depth'
    (H, W, 1) float meters; panorama mode stacks 4 views at relative
    headings [0, 90, 180, 270] degrees (left turns)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np


class NavEnv(Protocol):
    goals: List[np.ndarray]
    floor_heights: List[float]

    def reset(self, fixed_floor: Optional[int] = None, reachable: bool = True) -> Dict: ...

    def step(self, action: int) -> Tuple[Dict, float, bool, Optional[dict]]: ...

    def get_observation(self, force_panorama: bool = False) -> Dict: ...

    def sample_start_state(self, fixed_floor: Optional[int] = None): ...

    def set_agent_state(self, pos, rot) -> None: ...

    def agent_state(self) -> Tuple[np.ndarray, float]: ...

    @property
    def pos(self) -> np.ndarray: ...

    @property
    def angle(self) -> float: ...

    def geodesic_distance(self, a, b) -> float: ...

    def distance_to_goal(self) -> float: ...

    def close(self) -> None: ...

"""FMM planner with the rotate-then-forward action search (counterpart of
video_dqn_tpu/plan/fmm_planner.py `FMMPlanner`).

  * actions: 3 = forward (du cells), 1 = left, 2 = right, 0 = stop
  * distances(goal): masked FMM from an (x, y) goal, an inf field when the
    goal is out of bounds; set_goal fills masked cells with max + 1 and
    returns the valid mask
  * _virtual_steps: simulate an action list from (x, y, theta); forward
    moves du cells along theta with (du + 2)-point collision
    interpolation; reward = -(cost_end - cost_start) + 1[near goal] + the
    collision penalty of the LAST action
  * find_best_action_set: the forward baseline's reward + 0.1, candidates
    discounted 0.1 per action, first best on ties in search_actions'
    enumeration order
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops.fmm import fmm_distance

STOP, LEFT, RIGHT, FORWARD = 0, 1, 2, 3


class FMMPlanner:
    def __init__(self, traversible: np.ndarray, num_rots: int):
        self.traversible = np.asarray(traversible, bool)
        self.num_rots = num_rots
        self.angle_value = [0.0, 2.0 * np.pi / num_rots, -2.0 * np.pi / num_rots, 0.0]
        self.du = 5  # 25 cm at the 5 cm/cell grid
        self.action_list = self.search_actions()
        self.fmm_dist = None

    def search_actions(self) -> List[List[int]]:
        """[[3], [0]] + rotate^i followed by forward, both directions, in
        the reference planner's enumeration order."""
        action_list = [[FORWARD], [STOP]]
        pos, neg = [], []
        for _ in range(self.num_rots):
            pos.append(LEFT)
            neg.append(RIGHT)
            action_list.append(pos[:] + [FORWARD])
            action_list.append(neg[:] + [FORWARD])
        return action_list

    def distances(self, goal) -> np.ndarray:
        """goal = (x, y) cell; masked-grid FMM in grid units."""
        gx, gy = int(goal[0]), int(goal[1])
        h, w = self.traversible.shape
        if gy >= h or gx >= w or gy < 0 or gx < 0:
            return np.full((h, w), np.inf)
        return fmm_distance(self.traversible, [(gy, gx)])

    def set_goal(self, goal) -> np.ndarray:
        dd = self.distances(goal)
        mask = np.isfinite(dd)
        if mask.any():
            fill = dd[mask].max() + 1
        else:
            fill = 1.0
        self.fmm_dist = np.where(mask, dd, fill)
        return mask

    def _virtual_steps(self, u_list: Sequence[int], state, check_collision: bool = True):
        traversible = self.traversible
        goal_dist = self.fmm_dist
        h, w = traversible.shape
        x, y, t = float(state[0]), float(state[1]), float(state[2])
        out_states = []
        cost_start = goal_dist[int(y), int(x)]
        collision_reward = 0.0
        for action in u_list:
            x_new, y_new, t_new = x, y, t
            if action == FORWARD:
                x_new = x + np.cos(t) * self.du
                y_new = y + np.sin(t) * self.du
            elif action in (LEFT, RIGHT):
                t_new = t + self.angle_value[action]

            collision_reward = -1.0
            inside = (
                0 <= int(x_new) < w and 0 <= int(y_new) < h
            )
            new_state = [x, y, t]
            if inside:
                not_collided = True
                if action == FORWARD and check_collision:
                    for s in np.linspace(0, 1, self.du + 2):
                        _x = x * s + (1 - s) * x_new
                        _y = y * s + (1 - s) * y_new
                        if not traversible[int(_y), int(_x)]:
                            not_collided = False
                            break
                if not_collided:
                    collision_reward = 0.0
                    x, y, t = x_new, y_new, t_new
                    new_state = [x, y, t]
            out_states.append(new_state)

        cost_end = goal_dist[int(y), int(x)]
        reward_near_goal = 1.0 if cost_end < self.du else 0.0
        return -(cost_end - cost_start) + reward_near_goal + collision_reward, out_states

    def find_best_action_set(self, state):
        best_list = [FORWARD]
        best_reward, state_list = self._virtual_steps(best_list, state)
        best_reward += 0.1
        for a_list in self.action_list:
            rew, st_lst = self._virtual_steps(a_list, state)
            rew -= len(st_lst) * 0.1  # prefer shorter sequences
            if rew > best_reward:
                best_list, best_reward, state_list = a_list, rew, st_lst
        return best_list, state_list

    def compare_goal(self, state) -> bool:
        x, y, _ = state
        return self.fmm_dist[int(y), int(x)] < self.du

    def get_action(self, state):
        acts, states = self.find_best_action_set(state)
        return acts[0], states[0], acts

"""Goal-conditioned tasks (port of _GoalTask and Reach from
panda_gym_tpu/envs/tasks/classic.py:24-85).  Push, Slide, PickAndPlace,
Stack and Flip wait for the contact physics (ROADMAP item 13)."""
from __future__ import annotations

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import Task
from panda_gym_tpu_torch.sim.state import build_scene
from panda_gym_tpu_torch.utils import distance


class _GoalTask(Task):
    """Shared sparse/dense reward + success logic (reach.py:80-89 et al.)."""

    reward_type: str = "sparse"
    distance_threshold: float = 0.05

    def is_success(self, env, achieved, desired, state):
        return distance(achieved, desired) < self.distance_threshold

    def compute_reward(self, env, achieved, desired, state, fk):
        return self.reward_from_aux(env, achieved, desired, None)

    def reward_from_aux(self, env, achieved, desired, aux):
        d = distance(achieved, desired)
        if self.reward_type == "sparse":
            return -(d > self.distance_threshold).float()
        return -d.float()


class Reach(_GoalTask):
    """reach.py: goal = point in a box around the robot; achieved = EE."""

    def __init__(self, reward_type="sparse", distance_threshold=0.05,
                 goal_range=0.3):
        self.reward_type = reward_type
        self.distance_threshold = distance_threshold
        # reach.py:24-26 goal ranges; scene reach.py:32-33
        self.goal_range_low = np.array([-goal_range / 2, -goal_range / 2, 0], np.float32)
        self.goal_range_high = np.array([goal_range / 2, goal_range / 2, goal_range], np.float32)
        self.scene = build_scene([], 1.1, 0.7, 0.4, -0.3)
        self.fixed_target = None

    def reset(self, env, state, generator):
        B, dev = state.batch_size, env.device
        if self.fixed_target is not None:
            # set_fixed_target shifts x by -0.6 (reach.py:66-68)
            goal = (torch.as_tensor(self.fixed_target, dtype=torch.float32,
                                    device=dev)
                    + torch.tensor([-0.6, 0.0, 0.0], device=dev)).expand(B, 3)
        else:
            lo = torch.as_tensor(self.goal_range_low, device=dev)
            hi = torch.as_tensor(self.goal_range_high, device=dev)
            u = torch.rand(B, 3, generator=generator, device=dev)
            goal = lo + (hi - lo) * u
        return state.replace(goal=goal.contiguous())

    def achieved_goal(self, env, state, fk):
        return env.robot.ee_position(fk)

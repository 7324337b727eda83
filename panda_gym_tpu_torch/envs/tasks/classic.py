"""Goal-conditioned tasks (port of _GoalTask, _ObjectObsMixin, Reach, Push
and Slide from panda_gym_tpu/envs/tasks/classic.py:24-160).  PickAndPlace,
Stack and Flip need the gripper's prismatic fingers (ROADMAP item 13b)."""
from __future__ import annotations

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import Task
from panda_gym_tpu_torch.math.transforms import quat_to_euler
from panda_gym_tpu_torch.sim.state import (SHAPE_BOX, SHAPE_CYLINDER,
                                           build_scene)
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


class _ObjectObsMixin:
    """Object position, rotation (euler), velocity and angular velocity
    observation block of Push, Slide and PickAndPlace (push.py:50-66); the
    achieved goal is the object's position."""

    def task_obs(self, env, state, fk):
        return torch.cat([state.body_pos[:, 0],
                          quat_to_euler(state.body_quat[:, 0]),
                          state.body_vel[:, 0], state.body_ang[:, 0]], -1)

    def achieved_goal(self, env, state, fk):
        return state.body_pos[:, 0]


def _uniform(generator, B, low, high, device):
    """B draws, uniform in the box [low, high] (3 floats each)."""
    lo = torch.as_tensor(low, device=device)
    hi = torch.as_tensor(high, device=device)
    return lo + (hi - lo) * torch.rand(B, 3, generator=generator,
                                       device=device)


class _ObjectTask(_ObjectObsMixin, _GoalTask):
    """An object on the table pushed or slid to an on-table goal: the goal,
    then the object, drawn at the object's rest height, at rest and
    upright (push.py:68-81, slide.py:72-85)."""

    robot_contact = True

    def reset(self, env, state, generator):
        B, dev = state.batch_size, env.device
        z = torch.tensor([0.0, 0.0, self.object_size / 2], device=dev)
        goal = z + _uniform(generator, B, self.goal_range_low,
                            self.goal_range_high, dev)
        obj = z + _uniform(generator, B, self.obj_range_low,
                           self.obj_range_high, dev)
        pos = state.body_pos.clone()
        pos[:, 0] = obj
        quat = state.body_quat.clone()
        quat[:, 0] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        return state.replace(goal=goal, body_pos=pos, body_quat=quat,
                             body_vel=torch.zeros_like(state.body_vel),
                             body_ang=torch.zeros_like(state.body_ang))


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


class Push(_ObjectTask):
    """push.py: push a 4 cm cube to an on-table goal; gripper blocked."""

    def __init__(self, reward_type="sparse", distance_threshold=0.05,
                 goal_xy_range=0.3, obj_xy_range=0.3):
        self.reward_type = reward_type
        self.distance_threshold = distance_threshold
        self.object_size = 0.04
        half = self.object_size / 2
        self.goal_range_low = np.array([-goal_xy_range / 2, -goal_xy_range / 2, 0], np.float32)
        self.goal_range_high = np.array([goal_xy_range / 2, goal_xy_range / 2, 0], np.float32)
        self.obj_range_low = np.array([-obj_xy_range / 2, -obj_xy_range / 2, 0], np.float32)
        self.obj_range_high = np.array([obj_xy_range / 2, obj_xy_range / 2, 0], np.float32)
        self.scene = build_scene(
            [dict(shape=SHAPE_BOX, size=(half, half, half), mass=1.0)],
            1.1, 0.7, 0.4, -0.3)


class Slide(_ObjectTask):
    """slide.py: a low-friction puck slid to an out-of-reach goal."""

    def __init__(self, reward_type="sparse", distance_threshold=0.05,
                 goal_xy_range=0.3, goal_x_offset=0.4, obj_xy_range=0.3):
        self.reward_type = reward_type
        self.distance_threshold = distance_threshold
        self.object_size = 0.06
        self.goal_range_low = np.array(
            [-goal_xy_range / 2 + goal_x_offset, -goal_xy_range / 2, 0], np.float32)
        self.goal_range_high = np.array(
            [goal_xy_range / 2 + goal_x_offset, goal_xy_range / 2, 0], np.float32)
        self.obj_range_low = np.array([-obj_xy_range / 2, -obj_xy_range / 2, 0], np.float32)
        self.obj_range_high = np.array([obj_xy_range / 2, obj_xy_range / 2, 0], np.float32)
        # slide.py:34-42: cylinder r=0.03, height=0.03, lateral_friction 0.04
        self.scene = build_scene(
            [dict(shape=SHAPE_CYLINDER,
                  size=(self.object_size / 2, self.object_size / 4, 0.0),
                  mass=1.0, mu=0.04)],
            1.4, 0.7, 0.4, -0.1)

"""The six goal-conditioned tasks of upstream panda-gym (port of
panda_gym_tpu/envs/tasks/classic.py): Reach, Push, Slide, PickAndPlace,
Stack and Flip, with the reference's scenes, sampling ranges, achieved
goals, rewards and success thresholds.  Each reset draws its uniforms from
the caller's torch.Generator, in the JAX package's order of keys."""
from __future__ import annotations

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import Task
from panda_gym_tpu_torch.math.transforms import quat_to_euler
from panda_gym_tpu_torch.sim.state import (SHAPE_BOX, SHAPE_CYLINDER,
                                           build_scene)
from panda_gym_tpu_torch.utils import angle_distance, distance


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


def _object_reset(state, obj, dev):
    """The objects put at ``obj`` (B, nb, 3), upright and at rest."""
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand_as(
        state.body_quat).clone()
    return state.replace(body_pos=obj.contiguous(), body_quat=quat,
                         body_vel=torch.zeros_like(state.body_vel),
                         body_ang=torch.zeros_like(state.body_ang))


class PickAndPlace(_ObjectObsMixin, _GoalTask):
    """pick_and_place.py: a 4 cm cube to a goal that may be in the air; 30%
    of goals on the ground (pick_and_place.py:75-77)."""

    robot_contact = True

    def __init__(self, reward_type="sparse", distance_threshold=0.05,
                 goal_xy_range=0.3, goal_z_range=0.2, obj_xy_range=0.3):
        self.reward_type = reward_type
        self.distance_threshold = distance_threshold
        self.object_size = 0.04
        half = self.object_size / 2
        self.goal_range_low = np.array([-goal_xy_range / 2, -goal_xy_range / 2, 0], np.float32)
        self.goal_range_high = np.array(
            [goal_xy_range / 2, goal_xy_range / 2, goal_z_range], np.float32)
        self.obj_range_low = np.array([-obj_xy_range / 2, -obj_xy_range / 2, 0], np.float32)
        self.obj_range_high = np.array([obj_xy_range / 2, obj_xy_range / 2, 0], np.float32)
        self.scene = build_scene(
            [dict(shape=SHAPE_BOX, size=(half, half, half), mass=1.0)],
            1.1, 0.7, 0.4, -0.3)

    def reset(self, env, state, generator):
        """The goal's noise, whether it lies on the ground, then the object
        (the JAX reset's keys kg, kz, ko)."""
        B, dev = state.batch_size, env.device
        z = torch.tensor([0.0, 0.0, self.object_size / 2], device=dev)
        noise = _uniform(generator, B, self.goal_range_low,
                         self.goal_range_high, dev)
        ground = torch.rand(B, generator=generator, device=dev) < 0.3
        noise[:, 2] = torch.where(ground, 0.0, noise[:, 2])
        obj = z + _uniform(generator, B, self.obj_range_low,
                           self.obj_range_high, dev)
        return _object_reset(state.replace(goal=z + noise), obj[:, None], dev)


class Stack(_GoalTask):
    """stack.py: stack a 2 kg cube and a 1 kg cube; the 6-D goal is both
    cubes' positions, threshold 0.1 over the stacked vector
    (stack.py:124-131); the cubes push each other (body_pairs)."""

    robot_contact = True
    body_pairs = ((0, 1),)
    goal_dim = 6

    def __init__(self, reward_type="sparse", distance_threshold=0.1,
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
            [dict(shape=SHAPE_BOX, size=(half, half, half), mass=2.0),
             dict(shape=SHAPE_BOX, size=(half, half, half), mass=1.0)],
            1.1, 0.7, 0.4, -0.3)

    def reset(self, env, state, generator):
        """The goal's noise, then the first and the second cube (the JAX
        reset's keys kg, k1, k2); the second cube and goal one cube higher."""
        B, dev = state.batch_size, env.device
        z = self.object_size / 2
        z1 = torch.tensor([0.0, 0.0, z], device=dev)
        z3 = torch.tensor([0.0, 0.0, 3 * z], device=dev)
        noise = _uniform(generator, B, self.goal_range_low,
                         self.goal_range_high, dev)
        o1 = z1 + _uniform(generator, B, self.obj_range_low,
                           self.obj_range_high, dev)
        o2 = z3 + _uniform(generator, B, self.obj_range_low,
                           self.obj_range_high, dev)
        goal = torch.cat([z1 + noise, z3 + noise], -1)
        return _object_reset(state.replace(goal=goal),
                             torch.stack([o1, o2], 1), dev)

    def task_obs(self, env, state, fk):
        parts = []
        for b in range(2):
            parts += [state.body_pos[:, b], quat_to_euler(state.body_quat[:, b]),
                      state.body_vel[:, b], state.body_ang[:, b]]
        return torch.cat(parts, -1)

    def achieved_goal(self, env, state, fk):
        return torch.cat([state.body_pos[:, 0], state.body_pos[:, 1]], -1)


class Flip(_GoalTask):
    """flip.py: turn a cube to a random orientation; the goal is a unit
    quaternion, the metric angle_distance (flip.py:84-91)."""

    robot_contact = True
    goal_dim = 4

    def __init__(self, reward_type="sparse", distance_threshold=0.2,
                 obj_xy_range=0.3):
        self.reward_type = reward_type
        self.distance_threshold = distance_threshold
        self.object_size = 0.04
        half = self.object_size / 2
        self.obj_range_low = np.array([-obj_xy_range / 2, -obj_xy_range / 2, 0], np.float32)
        self.obj_range_high = np.array([obj_xy_range / 2, obj_xy_range / 2, 0], np.float32)
        self.scene = build_scene(
            [dict(shape=SHAPE_BOX, size=(half, half, half), mass=1.0)],
            1.1, 0.7, 0.4, -0.3)

    def reset(self, env, state, generator):
        """A uniform random unit quaternion from three uniforms (the
        equivalent of R.random(), flip.py:71), then the object (the JAX
        reset's keys kg, ko)."""
        B, dev = state.batch_size, env.device
        u = torch.rand(B, 3, generator=generator, device=dev)
        a, b = 2 * np.pi * u[:, 1], 2 * np.pi * u[:, 2]
        r0, r1 = torch.sqrt(1 - u[:, 0]), torch.sqrt(u[:, 0])
        goal = torch.stack([r0 * torch.sin(a), r0 * torch.cos(a),
                            r1 * torch.sin(b), r1 * torch.cos(b)], -1)
        z = torch.tensor([0.0, 0.0, self.object_size / 2], device=dev)
        obj = z + _uniform(generator, B, self.obj_range_low,
                           self.obj_range_high, dev)
        return _object_reset(state.replace(goal=goal), obj[:, None], dev)

    def task_obs(self, env, state, fk):
        return torch.cat([state.body_pos[:, 0], state.body_quat[:, 0],
                          state.body_vel[:, 0], state.body_ang[:, 0]], -1)

    def achieved_goal(self, env, state, fk):
        return state.body_quat[:, 0]

    def is_success(self, env, achieved, desired, state):
        return angle_distance(achieved, desired) < self.distance_threshold

    def reward_from_aux(self, env, achieved, desired, aux):
        d = angle_distance(achieved, desired)
        if self.reward_type == "sparse":
            return -(d > self.distance_threshold).float()
        return -d.float()

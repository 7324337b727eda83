"""Core env abstractions: Task base + batched RobotTaskEnv
(port of panda_gym_tpu/envs/core.py:46-239, without the gym adapter).

The JAX env is a pure functional core batched with vmap.  Here the batch is
the leading dimension of every tensor, so the batched entry points are the
primary ones:

    states, obs = env.batched_reset(B, generator)
    states, obs, reward, terminated, truncated, info = env.batched_step(states, actions)

``reset(generator)`` is a batch of one.  Randomness comes from an explicit
``torch.Generator`` on the env's device.  The env lives on ``cuda`` unless
the caller passes ``device="cpu"``; asking for the card without one raises.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from panda_gym_tpu_torch.envs.robot import PandaRobot
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.ops.linalg import _hi_prec
from panda_gym_tpu_torch.sim import engine
from panda_gym_tpu_torch.sim.state import EnvState, SceneParams


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names a missing card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device


class Task:
    """Base task: scene + goal lifecycle + reward contract (core.py:212-252).
    Every method works on a batch of envs."""

    scene: SceneParams
    goal_dim: int = 3
    n_obstacles: int = 1          # capacity (>=1 keeps arrays non-empty)
    past_obs_dim: int = 1
    robot_contact: bool = False
    body_pairs: Tuple[Tuple[int, int], ...] = ()
    check_collision: bool = False
    moving_obstacles: bool = False
    terminate_on_success: bool = False

    def reset(self, env: "RobotTaskEnv", state: EnvState,
              generator: torch.Generator) -> EnvState:
        raise NotImplementedError

    def reset_robot(self, env: "RobotTaskEnv", state: EnvState,
                    generator: torch.Generator) -> EnvState:
        """Default robot reset: neutral pose (panda.py:290-298)."""
        q, qd = env.robot.reset_q(state.batch_size, env.device)
        return state.replace(q=q, qd=qd, ctrl_target=q.clone())

    def task_obs(self, env, state: EnvState, fk) -> torch.Tensor:
        return state.q.new_zeros(state.batch_size, 0)

    def achieved_goal(self, env, state: EnvState, fk) -> torch.Tensor:
        raise NotImplementedError

    def is_success(self, env, achieved, desired, state: EnvState):
        raise NotImplementedError

    def is_truncated(self, env, state: EnvState):
        return torch.zeros(state.batch_size, dtype=torch.bool,
                           device=state.q.device)

    def pre_obs(self, env, state: EnvState, fk) -> EnvState:
        return state

    def compute_reward(self, env, achieved, desired, state: EnvState, fk):
        raise NotImplementedError

    def reward_aux(self, env, state: EnvState) -> torch.Tensor:
        return state.q.new_zeros(state.batch_size, 0)

    def reward_from_aux(self, env, achieved, desired, aux):
        raise NotImplementedError


class RobotTaskEnv:
    """Batched robot+task env (replaces core.py:255-414 RobotTaskEnv)."""

    def __init__(self, robot: PandaRobot, task: Task,
                 terminate_on_success: Optional[bool] = None,
                 n_substeps: int = 20, device="cuda"):
        self.device = resolve_device(device)
        self.robot = robot
        self.task = task
        self.model = robot.model
        self.n_substeps = n_substeps
        self.terminate_on_success = (
            task.terminate_on_success if terminate_on_success is None
            else terminate_on_success)
        self.physics_step_batched = engine.make_batched_physics_step(
            robot.model, task.scene,
            n_substeps=n_substeps,
            ctrl_mode=robot.ctrl_mode,
            robot_contact=task.robot_contact,
            body_pairs=task.body_pairs,
            check_collision=task.check_collision,
            moving_obstacles=task.moving_obstacles,
            has_bodies=task.scene.nb > 0,
        )

    # ------------------------------------------------------------------
    def init_state(self, batch: int) -> EnvState:
        m = self.model
        nb = self.task.scene.nb
        no = self.task.n_obstacles
        na = self.robot.action_dim
        dev = self.device
        f = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
        q = torch.as_tensor(self.robot.neutral, device=dev).expand(
            batch, m.ndof).clone()
        return EnvState(
            q=q, qd=f(batch, m.ndof), ctrl_target=q.clone(),
            body_pos=f(batch, nb, 3),
            body_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(
                batch, nb, 1),
            body_vel=f(batch, nb, 3), body_ang=f(batch, nb, 3),
            obstacle_pos=torch.full((batch, no, 3), 99.9, device=dev),
            obstacle_vel=f(batch, no, 3),
            obstacle_size=torch.full((batch, no, 3), 1e-3, device=dev),
            obstacle_type=torch.zeros(batch, no, dtype=torch.int32, device=dev),
            obstacle_active=torch.zeros(batch, no, dtype=torch.bool, device=dev),
            goal=f(batch, self.task.goal_dim),
            steps=torch.zeros(batch, dtype=torch.int32, device=dev),
            is_collided=torch.zeros(batch, dtype=torch.bool, device=dev),
            goal_reached=torch.zeros(batch, dtype=torch.bool, device=dev),
            prev_action=f(batch, na), recent_action=f(batch, na),
            action_count=torch.zeros(batch, dtype=torch.int32, device=dev),
            cur_jvel=f(batch, 7), prev_jvel=f(batch, 7),
            cur_jacc=f(batch, 7), prev_jacc=f(batch, 7), cur_jerk=f(batch, 7),
            link_obstacle_dist=torch.full((batch, max(m.ngroup, 1)), 999.0,
                                          device=dev),
            past_obs=f(batch, 3, self.task.past_obs_dim),
        )

    def _generator(self, generator):
        if generator is None:
            return torch.Generator(device=self.device).manual_seed(0)
        return generator

    # ------------------------------------------------------------------
    @_hi_prec
    def batched_reset(self, batch: int, generator: Optional[torch.Generator] = None
                      ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        """Reset ``batch`` envs: robot pose + goal + scene (core.py:298-308)."""
        generator = self._generator(generator)
        state = self.init_state(batch)
        state = self.task.reset_robot(self, state, generator)
        state = self.task.reset(self, state, generator)
        fk = K.fk_world(self.model, state.q, state.qd)
        state = self.task.pre_obs(self, state, fk)
        return state, self._get_obs(state, fk)

    def reset(self, generator: Optional[torch.Generator] = None):
        """A batch of one env."""
        return self.batched_reset(1, generator)

    def _get_obs(self, state: EnvState, fk=None) -> Dict[str, torch.Tensor]:
        """Dict observation assembly (core.py:286-296)."""
        if fk is None:
            fk = K.fk_world(self.model, state.q, state.qd)
        robot_obs = self.robot.robot_obs(state, fk)
        task_obs = self.task.task_obs(self, state, fk)
        achieved = self.task.achieved_goal(self, state, fk)
        return {
            "observation": torch.cat([robot_obs, task_obs], -1).float(),
            "achieved_goal": achieved.float(),
            "desired_goal": state.goal.float(),
        }

    @_hi_prec
    def _step_post(self, state: EnvState):
        """Everything after the physics substeps: obs/reward/termination."""
        state = state.replace(steps=state.steps + 1)
        fk = K.fk_world(self.model, state.q, state.qd)
        state = self.task.pre_obs(self, state, fk)
        obs = self._get_obs(state, fk)
        achieved = obs["achieved_goal"]
        desired = obs["desired_goal"]
        success, state = self._success(achieved, desired, state)
        terminated = (success if self.terminate_on_success
                      else torch.zeros_like(success))
        truncated = self.task.is_truncated(self, state).bool()
        reward = self.task.compute_reward(
            self, achieved, desired, state, fk).float()
        info = {"is_success": success, "is_truncated": truncated}
        return state, obs, reward, terminated, truncated, info

    def _success(self, achieved, desired, state):
        out = self.task.is_success(self, achieved, desired, state)
        if isinstance(out, tuple):
            success, state = out
        else:
            success = out
        return success.bool(), state

    def batched_step(self, states: EnvState, actions):
        """set_action -> physics (kernel K1 on the card) -> obs/reward."""
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        states = _hi_prec(self.robot.set_action)(states, actions)
        states = self.physics_step_batched(states)
        return self._step_post(states)

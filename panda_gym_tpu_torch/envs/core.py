"""Core env abstractions: Task base, batched RobotTaskEnv and the single-env
adapters (port of panda_gym_tpu/envs/core.py).

The JAX env is a pure functional core batched with vmap.  Here the batch is
the leading dimension of every tensor, so the batched entry points are the
primary ones:

    states, obs = env.batched_reset(B, generator)
    states, obs, reward, terminated, truncated, info = env.batched_step(states, actions)

``reset(generator)`` is a batch of one.  Randomness comes from an explicit
``torch.Generator`` on the env's device.  The env lives on ``cuda`` unless
the caller passes ``device="cpu"``; asking for the card without one raises.

``env.step(states, actions)`` is the per-env entry point (the JAX core's
``step``): the same step with the physics of the per-env path, which honours
``ops.dynamics.set_lcp_mode``.  ``EnvAdapter`` drives it as one env with the
gymnasium surface (numpy observations, ``reset(seed)``, save/restore,
``compute_reward``, ``render``, the reference's robot getters through
``BoundRobot``) and imports no gymnasium; ``GymAdapter`` is the
``gymnasium.Env`` over it, built at first use (gymnasium is imported then).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
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
        physics_kw = dict(
            n_substeps=n_substeps,
            ctrl_mode=robot.ctrl_mode,
            robot_contact=task.robot_contact,
            body_pairs=task.body_pairs,
            check_collision=task.check_collision,
            moving_obstacles=task.moving_obstacles,
            has_bodies=task.scene.nb > 0,
        )
        self.physics_step_batched = engine.make_batched_physics_step(
            robot.model, task.scene, **physics_kw)
        # the per-env entry points' step (``step``): the same physics, and
        # the motor-LCP mode of ops.dynamics.set_lcp_mode honoured
        self.physics_step = engine.make_batched_physics_step(
            robot.model, task.scene, per_env=True, **physics_kw)

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
        return self._step(self.physics_step_batched, states, actions)

    def step(self, states: EnvState, actions):
        """The per-env entry point (core.py:174-179): ``batched_step`` with
        ``physics_step``, which honours ops.dynamics.set_lcp_mode."""
        return self._step(self.physics_step, states, actions)

    def _step(self, physics, states, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        states = _hi_prec(self.robot.set_action)(states, actions)
        return self._step_post(physics(states))


# ---------------------------------------------------------------------------
# single-env adapters


def _numpy(obs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The first env of batched observations as numpy arrays."""
    return {k: v[0].cpu().numpy() for k, v in obs.items()}


def _fresh_seed(counter: int) -> int:
    """A seed from OS entropy and a per-adapter counter, in [0, 2^31)."""
    return int((np.random.SeedSequence().entropy + counter) % (2 ** 31))


class EnvAdapter:
    """One env over a RobotTaskEnv with the gymnasium surface, gymnasium not
    imported (core.py:249-400): ``reset(seed)`` -> (obs, info), ``step`` ->
    (obs, reward, terminated, truncated, info), with numpy observations in
    a dict of ``observation``, ``achieved_goal`` and ``desired_goal``.

    The env is a batch of one on the core's device, stepped through
    ``RobotTaskEnv.step`` (on the card: kernel K1).  A seed seeds a
    ``torch.Generator`` on that device, which draws the episode; the same
    seed gives the same episode, not the JAX package's (the two RNGs
    differ).  ``observation_shapes`` and ``action_shape`` are the shapes of
    the gymnasium spaces, whose bounds are [-10, 10] and [-1, 1]
    (core.py:274-280).  A snapshot (``save_state``) is the state itself:
    no step writes into a state's tensors, so a restore is exact."""

    def __init__(self, env: RobotTaskEnv):
        self.env = env
        self._generator = torch.Generator(device=env.device)
        self._seed_counter = 0
        self._saved_states: Dict[int, EnvState] = {}
        self._next_state_id = 0
        state, obs, _ = self._reset(0)
        self._state = state
        self.observation_shapes = {k: tuple(v.shape[1:])
                                   for k, v in obs.items()}
        self.action_shape = (env.robot.action_dim,)

    def _reset(self, seed: int):
        self._generator.manual_seed(int(seed))
        state, obs = self.env.reset(self._generator)
        out = self.env.task.is_success(self.env, obs["achieved_goal"],
                                       obs["desired_goal"], state)
        success = out[0] if isinstance(out, tuple) else out
        return state, obs, success

    # -- gymnasium API ---------------------------------------------------
    def reset(self, seed: Optional[int] = None, options=None):
        if seed is None:
            self._seed_counter += 1
            seed = _fresh_seed(self._seed_counter)
        state, obs, success = self._reset(seed)
        self._state = state
        return _numpy(obs), {"is_success": bool(success[0])}

    def step(self, action):
        action = torch.as_tensor(np.asarray(action, np.float32),
                                 device=self.env.device).reshape(1, -1)
        state, obs, reward, term, trunc, info = self.env.step(self._state,
                                                              action)
        self._state = state
        # the scalars in one read from the device
        flags = torch.stack([reward.float(), term.float(), trunc.float()]
                            + [v.float() for v in info.values()], -1)[0]
        flags = flags.cpu().numpy()
        return (_numpy(obs), float(flags[0]), bool(flags[1]), bool(flags[2]),
                {k: bool(f) for k, f in zip(info, flags[3:])})

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        """HER's relabeling hook (core.py:282): the reward of goals (N, g)
        or (g,), the state-dependent terms (ReachAO's collision, effort and
        jerk penalties) taken from the adapter's current state, as the
        reference's compute_reward reads its live state."""
        dev = self.env.device
        a = torch.as_tensor(np.asarray(achieved_goal, np.float32), device=dev)
        d = torch.as_tensor(np.asarray(desired_goal, np.float32), device=dev)
        single = a.dim() == 1
        a, d = a.reshape(-1, a.shape[-1]), d.reshape(-1, d.shape[-1])
        r = self.env.task.compute_reward(self.env, a, d, self._state, None)
        r = r.float().cpu().numpy()
        return r[0] if single else r

    # -- state snapshots (core.py:310-336) -------------------------------
    def save_state(self) -> int:
        sid = self._next_state_id
        self._next_state_id += 1
        self._saved_states[sid] = self._state
        return sid

    def restore_state(self, state_id: int) -> None:
        self._state = self._saved_states[state_id]

    def remove_state(self, state_id: int) -> None:
        del self._saved_states[state_id]

    def render(self, mode: str = "rgb_array", width: int = 720,
               height: int = 480, target_position=None, distance: float = 1.4,
               yaw: float = 45, pitch: float = -30, roll: float = 0):
        """rgb_array software render (reference core.py:373-414 signature)."""
        from panda_gym_tpu_torch.render import render_env
        return render_env(self, width=width, height=height,
                          target_position=target_position, distance=distance,
                          yaw=yaw, pitch=pitch, roll=roll)

    def close(self):
        pass

    # task/robot passthroughs used by training/eval code
    @property
    def robot(self) -> "BoundRobot":
        """State-bound robot view: the robot's attributes plus the
        reference's getters (panda.py:264-317, core.py:105-209) on this
        adapter's current state."""
        return BoundRobot(self)

    @property
    def task(self):
        return self.env.task

    @property
    def state(self) -> EnvState:
        return self._state


class BoundRobot:
    """Reference-named robot accessors bound to an adapter's live state.

    Delegates every other attribute to the robot, so framework code
    (``action_dim``, ``robot_obs``, ...) keeps working while reference users
    find ``get_ee_position()`` etc. (panda.py:264-317, mycobot.py:209-230,
    core.py:105-209).  Every getter returns numpy or Python numbers."""

    def __init__(self, adapter: EnvAdapter):
        object.__setattr__(self, "_adapter", adapter)
        object.__setattr__(self, "_robot", adapter.env.robot)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_robot"), name)

    def _fk(self):
        s = self._adapter.state
        return K.fk_world(self._adapter.env.model, s.q, s.qd)

    # panda.py:306-312
    def get_ee_position(self):
        return self._robot.ee_position(self._fk())[0].cpu().numpy()

    def get_ee_velocity(self):
        return self._robot.ee_velocity(self._fk())[0].cpu().numpy()

    # panda.py:300-304
    def get_fingers_width(self):
        return float(self._robot.fingers_width(self._adapter.state)[0])

    # panda.py:314-317 Yoshikawa manipulability
    def get_manipulability(self):
        r = self._robot
        return float(K.manipulability(r.model, r.ee_site,
                                      self._adapter.state.q)[0])

    # core.py:150-171 joint getters, in the reference's PyBullet joint
    # numbering (fingers at 9/10, fixed joints at 7/8, panda.py:62); the
    # chain stores prismatic fingers at dof 7/8
    def _joint(self, field: str, joint: int) -> float:
        from panda_gym_tpu_torch.models.chain import pybullet_dof_index
        vec = getattr(self._adapter.state, field)[0]
        i = pybullet_dof_index(vec.shape[0], joint)
        return 0.0 if i < 0 else float(vec[i])

    def get_joint_angle(self, joint: int) -> float:
        return self._joint("q", joint)

    def get_joint_velocity(self, joint: int) -> float:
        return self._joint("qd", joint)

    # core.py:195-209 IK passthrough (DLS IK, replaces
    # calculateInverseKinematics), the batched dls_ik at B = 1
    def inverse_kinematics(self, link: int, position, orientation=None):
        dev = self._adapter.env.device
        t = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev).reshape(1, -1)
        q = K.dls_ik(self._robot.model, link, t(position),
                     None if orientation is None else t(orientation),
                     q0=self._adapter.state.q)
        return q[0].cpu().numpy()

    # panda.py:264-288: the robot part of the observation
    def get_obs(self):
        a = self._adapter
        return self._robot.robot_obs(a.state, self._fk())[0].cpu().numpy()

    # panda.py:290-298: mutate the adapter's live state
    def set_joint_neutral(self) -> None:
        a = self._adapter
        q = torch.as_tensor(self._robot.neutral,
                            device=a.env.device)[None].clone()
        a._state = a.state.replace(q=q, qd=torch.zeros_like(a.state.qd),
                                   ctrl_target=q.clone())

    def reset(self) -> None:
        self.set_joint_neutral()


_GYM: dict = {}


def gym_env_class(cls):
    """The ``gymnasium.Env`` of an ``EnvAdapter`` class ``cls`` (the adapter
    itself, or an env class of envs/panda_tasks.py): ``cls`` with the
    reference's spaces (core.py:274-280), a Dict of Boxes in [-10, 10] for
    the observation and a Box in [-1, 1] for the action, built from the
    adapter's shapes.  Made once per class, at first use, which imports
    gymnasium."""
    if cls not in _GYM:
        import gymnasium
        from gymnasium import spaces

        def __init__(self, *args, **kwargs):
            cls.__init__(self, *args, **kwargs)
            self.observation_space = spaces.Dict({
                k: spaces.Box(-10.0, 10.0, shape=shape, dtype=np.float32)
                for k, shape in self.observation_shapes.items()})
            self.action_space = spaces.Box(
                -1.0, 1.0, shape=self.action_shape, dtype=np.float32)

        # cls first: its reset, step, render and close come before
        # gymnasium.Env's
        _GYM[cls] = type(cls.__name__, (cls, gymnasium.Env), {
            "__init__": __init__, "__doc__": cls.__doc__,
            "__module__": cls.__module__,
            "metadata": {"render_modes": ["rgb_array"]}})
    return _GYM[cls]


def __getattr__(name):
    # GymAdapter, the gymnasium.Env over EnvAdapter, is made at first use
    if name == "GymAdapter":
        return gym_env_class(EnvAdapter)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

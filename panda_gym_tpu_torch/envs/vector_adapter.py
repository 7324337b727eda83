"""A vector of envs over the batched core, with gymnasium's vector API
(port of panda_gym_tpu/envs/vector_adapter.py).

The reference vectorizes with SB3's SubprocVecEnv, one OS process per env
(setup_training.py:44-47).  Here one batched step serves every env:

    import gymnasium as gym, panda_gym_tpu_torch
    panda_gym_tpu_torch.register_envs(50)
    venv = gym.make_vec("panda_gym_tpu_torch/PandaReach-v3", num_envs=4096)
    obs, info = venv.reset(seed=0)
    obs, r, term, trunc, info = venv.step(venv.action_space.sample())

Autoreset follows gymnasium's NEXT_STEP mode: a step that ends an episode
returns its final observation; the env resets on the following step, whose
action it ignores, with reward 0 and no flags.  The episode's step limit is
the adapter's own (``max_episode_steps``).

``VectorAdapter`` does the stepping, the autoreset and the shapes, and
imports no gymnasium; ``TorchVectorEnv``, the gymnasium.vector.VectorEnv over
it, is made at first use, which imports gymnasium.  Internal training uses
rl/train.py's VectorEnv; this is the drop-in for gym-vector tooling, with
one read to the host per step.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import RobotTaskEnv
from panda_gym_tpu_torch.sim.state import EnvState


def _scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """dst with rows idx replaced by src's rows (a new tensor)."""
    return dst.index_copy(0, idx, src)


class VectorAdapter:
    """``num_envs`` envs of one batched core, stepped together.

    ``reset(seed)`` seeds a torch.Generator on the core's device and resets
    every env; ``step(actions)`` runs one ``batched_step`` of the whole
    batch, after resetting the envs whose episode ended on the step before
    (their reset and the selects stay on the device).  Returns numpy arrays
    as gymnasium's vector API does."""

    def __init__(self, core: RobotTaskEnv, num_envs: int,
                 max_episode_steps: int = 50):
        self.core = core
        self.num_envs = int(num_envs)
        self.max_episode_steps = int(max_episode_steps)
        self._generator = torch.Generator(device=core.device).manual_seed(0)
        _, probe = core.reset(torch.Generator(device=core.device))
        self.single_observation_shapes = {k: tuple(v.shape[1:])
                                          for k, v in probe.items()}
        self.single_action_shape = (core.robot.action_dim,)
        self._states: Optional[EnvState] = None
        self._needs_reset = np.zeros(self.num_envs, dtype=bool)
        self._ep_steps = np.zeros(self.num_envs, dtype=np.int64)

    @property
    def states(self) -> Optional[EnvState]:
        """The batched state of the envs."""
        return self._states

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._states, obs = self.core.batched_reset(self.num_envs,
                                                    self._generator)
        self._needs_reset[:] = False
        self._ep_steps[:] = 0
        return {k: v.cpu().numpy() for k, v in obs.items()}, {}

    def _step_with_reset(self, mask: np.ndarray, actions):
        """Reset the masked envs (their action is ignored this step) and
        step the rest, in one batched step."""
        dev = self.core.device
        idx = torch.as_tensor(np.flatnonzero(mask), device=dev)
        r_states, r_obs = self.core.batched_reset(len(idx), self._generator)
        states = self._states.replace(**{
            k: _scatter(getattr(self._states, k), idx, getattr(r_states, k))
            for k in EnvState.__dataclass_fields__})
        nstates, obs, reward, term, trunc, info = self.core.batched_step(
            states, actions)
        m = torch.as_tensor(mask, device=dev)

        def pick(a, b):
            return torch.where(m.view((-1,) + (1,) * (a.dim() - 1)), a, b)

        out = nstates.replace(**{k: pick(getattr(states, k),
                                         getattr(nstates, k))
                                 for k in EnvState.__dataclass_fields__})
        obs = {k: _scatter(v, idx, r_obs[k]) for k, v in obs.items()}
        info = {k: torch.where(m, False, v) for k, v in info.items()}
        return (out, obs, torch.where(m, 0.0, reward),
                torch.where(m, False, term), torch.where(m, False, trunc),
                info)

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("call reset() before step()")
        actions = torch.as_tensor(np.asarray(actions, np.float32),
                                  device=self.core.device)
        mask = self._needs_reset
        if mask.any():
            (self._states, obs, reward, term, trunc,
             info) = self._step_with_reset(mask, actions)
        else:
            self._states, obs, reward, term, trunc, info = (
                self.core.batched_step(self._states, actions))
        obs = {k: v.cpu().numpy() for k, v in obs.items()}
        flags = torch.stack([reward.float(), term.float(), trunc.float()]
                            + [v.float() for v in info.values()], -1)
        flags = flags.cpu().numpy()
        reward = flags[:, 0]
        term, trunc = flags[:, 1] > 0, flags[:, 2] > 0
        info = {k: flags[:, 3 + i] > 0 for i, k in enumerate(info)}
        # the autoreset step returns the episode's first observation; it is
        # not a step of the new episode (gymnasium NEXT_STEP semantics)
        self._ep_steps = np.where(mask, 0, self._ep_steps + 1)
        # the adapter's own TimeLimit (the single-env path gets gymnasium's
        # TimeLimit wrapper from register(max_episode_steps=...))
        trunc = trunc | ((self._ep_steps >= self.max_episode_steps) & ~term)
        self._needs_reset = term | trunc
        return obs, reward, term, trunc, info

    def close_extras(self, **kwargs):
        pass


_GYM: Dict[str, type] = {}


def torch_vector_env_class():
    """``TorchVectorEnv``: the gymnasium.vector.VectorEnv over
    ``VectorAdapter``, with the reference's spaces batched
    (gymnasium.vector.utils.batch_space).  Made at first use."""
    if "TorchVectorEnv" not in _GYM:
        from gymnasium import spaces
        from gymnasium.vector import AutoresetMode, VectorEnv
        from gymnasium.vector.utils import batch_space

        def __init__(self, core, num_envs, max_episode_steps=50):
            VectorAdapter.__init__(self, core, num_envs, max_episode_steps)
            self.single_observation_space = spaces.Dict({
                k: spaces.Box(-10.0, 10.0, shape=s, dtype=np.float32)
                for k, s in self.single_observation_shapes.items()})
            self.single_action_space = spaces.Box(
                -1.0, 1.0, shape=self.single_action_shape, dtype=np.float32)
            self.observation_space = batch_space(
                self.single_observation_space, self.num_envs)
            self.action_space = batch_space(self.single_action_space,
                                            self.num_envs)

        # VectorAdapter first: its reset, step and close_extras come
        # before VectorEnv's
        _GYM["TorchVectorEnv"] = type("TorchVectorEnv", (VectorAdapter,
                                                         VectorEnv), {
            "__init__": __init__, "__module__": __name__,
            "__doc__": "gymnasium.vector.VectorEnv over VectorAdapter.",
            "metadata": {"autoreset_mode": AutoresetMode.NEXT_STEP}})
    return _GYM["TorchVectorEnv"]


def __getattr__(name):
    if name == "TorchVectorEnv":
        return torch_vector_env_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_vector_core(vector_task: str = "reach", scenario: str = "reachao1",
                     device="cuda", **kwargs) -> RobotTaskEnv:
    """The batched core of a registered id's ``vector_task``: a classic
    task's make_core, or ReachAO on ``scenario`` ("reachao")."""
    kwargs.pop("render", None)
    if vector_task == "reachao":
        from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
        from panda_gym_tpu_torch.rl.config import TrainConfig
        cfg = TrainConfig()
        if "control_type" in kwargs:
            cfg.control_type = kwargs["control_type"]
        return make_reach_ao_core(scenario=scenario, config=cfg,
                                  device=device)
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    return make_core(vector_task, device=device, **kwargs)


def make_vector_env(num_envs: int = 1, max_episode_steps: int = 50,
                    vector_task: str = "reach", scenario: str = "reachao1",
                    device="cuda", **kwargs):
    """``vector_entry_point`` of gym.make_vec for every id of
    panda_gym_tpu_torch.register_envs: a TorchVectorEnv of the id's task."""
    core = make_vector_core(vector_task, scenario, device=device, **kwargs)
    return torch_vector_env_class()(core, num_envs,
                                    max_episode_steps=max_episode_steps)

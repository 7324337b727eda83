"""Episodic replay buffer with Hindsight Experience Replay (port of
panda_gym_tpu/rl/her.py).

An episode-major ring of device tensors, (capacity_episodes, ep_len, ...),
written by the vectorized collector and sampled with 'future'-strategy goal
relabelling on the device.  Rewards are recomputed at sample time from
(achieved, relabelled goal, aux) by the task's reward function, the HER
contract of the reference (env.compute_reward, core.py:282).

``sample`` is ``draw`` (the episode index, two uniforms and the HER mask,
from an explicit ``torch.Generator``) followed by ``gather``, so that the
gather can be held against the JAX package on the same draws.  The two
counters, ``write_idx`` and ``n_stored``, are host integers: the host
decides every write, so reading them never waits for the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from panda_gym_tpu_torch.rl.checkpoint import restore_tensors

TENSORS = ("obs", "achieved", "desired", "action", "aux", "ep_len",
           "terminated")


@dataclass
class HerBuffer:
    obs: torch.Tensor          # (E, T+1, obs_dim) flat "observation"
    achieved: torch.Tensor     # (E, T+1, goal_dim)
    desired: torch.Tensor      # (E, goal_dim) one goal per episode
    action: torch.Tensor       # (E, T, act_dim)
    aux: torch.Tensor          # (E, T, aux_dim) task reward terms
    ep_len: torch.Tensor       # (E,) int32 valid transitions per slot
    terminated: torch.Tensor   # (E, T) bool early-termination flag per step
    write_idx: int = 0         # next episode slot
    n_stored: int = 0          # episodes currently stored

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def ep_horizon(self) -> int:
        return self.action.shape[1]

    @property
    def device(self) -> torch.device:
        return self.obs.device

    def replace(self, **kw) -> "HerBuffer":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "HerBuffer":
        return self.replace(**{k: getattr(self, k).to(device)
                               for k in TENSORS})


def save_state(buf: HerBuffer) -> Dict:
    """The buffer as host data: its tensors copied to the CPU, and the
    counters."""
    return {"tensors": {k: getattr(buf, k).to("cpu", copy=True)
                        for k in TENSORS},
            "write_idx": buf.write_idx, "n_stored": buf.n_stored}


def from_state(state: Dict, device="cpu") -> HerBuffer:
    return HerBuffer(**{k: v.to(device) for k, v in state["tensors"].items()},
                     write_idx=int(state["write_idx"]),
                     n_stored=int(state["n_stored"]))


def load_state(buf: HerBuffer, state: Dict) -> HerBuffer:
    """A saved state copied into ``buf``, a template built from the current
    config, after checking every tensor against it."""
    restore_tensors({k: getattr(buf, k) for k in TENSORS}, state["tensors"],
                    "buffer")
    return buf.replace(write_idx=int(state["write_idx"]),
                       n_stored=int(state["n_stored"]))


def create(capacity_episodes: int, ep_horizon: int, obs_dim: int,
           goal_dim: int, act_dim: int, aux_dim: int,
           device="cuda") -> HerBuffer:
    E, T = capacity_episodes, ep_horizon
    z = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype,
                                                    device=device)
    return HerBuffer(
        obs=z(E, T + 1, obs_dim), achieved=z(E, T + 1, goal_dim),
        desired=z(E, goal_dim), action=z(E, T, act_dim),
        aux=z(E, T, aux_dim), ep_len=z(E, dtype=torch.int32),
        terminated=z(E, T, dtype=torch.bool))


def add_episodes(buf: HerBuffer, obs, achieved, desired, action, aux,
                 ep_len, terminated) -> HerBuffer:
    """Write a batch of B completed episodes into the ring, in place."""
    B = obs.shape[0]
    idx = (buf.write_idx + torch.arange(B, device=buf.device)) % buf.capacity
    for k, v in (("obs", obs), ("achieved", achieved), ("desired", desired),
                 ("action", action), ("aux", aux), ("ep_len", ep_len),
                 ("terminated", terminated)):
        getattr(buf, k)[idx] = v.to(getattr(buf, k).dtype)
    return buf.replace(write_idx=(buf.write_idx + B) % buf.capacity,
                       n_stored=min(buf.n_stored + B, buf.capacity))


def draw(buf: HerBuffer, generator: torch.Generator, batch_size: int,
         her_ratio: float = 0.8) -> Dict[str, torch.Tensor]:
    """The random draws of one sample: episode indices, the uniforms that
    pick t and the future step, and the HER mask."""
    dev = buf.device
    u = lambda: torch.rand(batch_size, generator=generator, device=dev)
    ep = torch.randint(0, max(buf.n_stored, 1), (batch_size,),
                       generator=generator, device=dev)
    return dict(ep=ep, u_t=u(), u_f=u(), use_her=u() < her_ratio)


def gather(buf: HerBuffer, draws: Dict[str, torch.Tensor],
           reward_fn: Callable) -> Dict[str, torch.Tensor]:
    """Transitions at the drawn indices with 'future' goal relabelling
    (her.py:82-106).  reward_fn(achieved_next, goal, aux) is the task's
    reward; ``terminated`` is the env's termination signal for
    bootstrapping."""
    ep = draws["ep"]
    L = torch.clamp_min(buf.ep_len[ep], 1)                       # (B,)
    t = (draws["u_t"] * L).to(torch.int32)
    t = torch.minimum(t, L - 1)
    ep_, t_ = ep.long(), t.long()
    achieved_next = buf.achieved[ep_, t_ + 1]
    aux = buf.aux[ep_, t_]
    # future strategy: goal <- achieved at tau ~ U[t+1, L]
    tau = t + 1 + (draws["u_f"] * (L - t - 1).float()).to(torch.int32)
    tau = torch.minimum(torch.maximum(tau, t + 1), L)
    goal = torch.where(draws["use_her"][:, None],
                       buf.achieved[ep_, tau.long()], buf.desired[ep_])
    return dict(obs=buf.obs[ep_, t_], next_obs=buf.obs[ep_, t_ + 1],
                achieved=buf.achieved[ep_, t_], achieved_next=achieved_next,
                goal=goal, action=buf.action[ep_, t_],
                reward=reward_fn(achieved_next, goal, aux),
                terminated=buf.terminated[ep_, t_])


def sample(buf: HerBuffer, generator: torch.Generator, batch_size: int,
           reward_fn: Callable, her_ratio: float = 0.8):
    """Sample transitions with 'future' goal relabelling (SB3 default,
    n_sampled_goal=4 -> her_ratio 0.8)."""
    return gather(buf, draw(buf, generator, batch_size, her_ratio),
                  reward_fn)

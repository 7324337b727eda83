"""PPO: on-policy learner and rollout collection (port of
panda_gym_tpu/rl/ppo.py).

Clipped surrogate, GAE(lambda), n_epochs of shuffled minibatches, no value
clipping, an entropy bonus (SB3 semantics, the reference's preset
hyperparameters.py:55-70), over the same batched env cores as the
off-policy stack, with auto-resetting continuing rollouts.  As in the
learners, the standard-normal draws and the epochs' permutations are
arguments drawn from an explicit ``torch.Generator`` (``act_noise``,
``update_perms``), so that the tests can hand both packages the same ones.
``hp.normalize`` is read by neither package: observations are not
normalised.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from panda_gym_tpu_torch.envs.core import RobotTaskEnv
from panda_gym_tpu_torch.rl.learners import adam
from panda_gym_tpu_torch.rl.networks import MLP, GaussianPolicy, gaussian_logp
from panda_gym_tpu_torch.rl.train import _keep, flat_x, keep_states

_HALF_LOG_2PI_E = 0.5 * math.log(2 * math.pi * math.e)


@dataclass
class PPOState:
    actor: nn.Module
    value: nn.Module
    actor_opt: torch.optim.Adam
    value_opt: torch.optim.Adam
    step: int = 0


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm: g if ||g|| < max_norm else
    g / ||g|| * max_norm, on the device (torch.nn.utils.clip_grad_norm_
    adds 1e-6 to the norm)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class PPOLearner:
    """Clipped-surrogate PPO (SB3 semantics, hyperparameters.py:55-70).
    The actor's and the value net's gradients are clipped and stepped
    each with its own optimizer state, as optax.chain(clip, adam) over two
    parameter trees does."""

    def __init__(self, obs_dim: int, act_dim: int, hp, device="cuda"):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hp = hp
        self.device = torch.device(device)
        self.gamma = getattr(hp, "gamma", 0.99)
        self.gae_lambda = getattr(hp, "gae_lambda", 0.9)
        self.clip_range = getattr(hp, "clip_range", 0.4)
        self.n_epochs = getattr(hp, "n_epochs", 20)
        self.batch_size = getattr(hp, "batch_size", 128)
        self.ent_coef = getattr(hp, "ent_coef", 0.0)
        self.vf_coef = getattr(hp, "vf_coef", 0.5)
        self.n_steps = getattr(hp, "n_steps", 512)
        self.lr = getattr(hp, "learning_rate", 3e-5)
        self.max_grad_norm = getattr(hp, "max_grad_norm", 0.5)
        pk = getattr(hp, "policy_kwargs", {})
        self.net_arch = tuple(pk.get("net_arch", [256, 256]))
        self.log_std_init = float(pk.get("log_std_init", -2.0))

    def init(self, generator: torch.Generator) -> PPOState:
        actor = GaussianPolicy(self.obs_dim, self.act_dim, self.net_arch,
                               self.log_std_init, generator, self.device)
        value = MLP(self.obs_dim, self.net_arch, 1, generator, self.device)
        return PPOState(actor=actor, value=value,
                        actor_opt=adam(actor.parameters(), self.lr),
                        value_opt=adam(value.parameters(), self.lr))

    # ------------------------------------------------------------- acting
    def act_noise(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randn(n, self.act_dim, generator=generator,
                           device=self.device)

    @torch.no_grad()
    def act(self, ts: PPOState, x, noise: Optional[torch.Tensor] = None,
            deterministic: bool = False):
        mean, log_std = ts.actor(x)
        if deterministic:
            return torch.clamp(mean, -1.0, 1.0)
        return torch.clamp(mean + torch.exp(log_std) * noise, -1.0, 1.0)

    @torch.no_grad()
    def act_logp_value(self, ts: PPOState, x, noise):
        """The sampled action, its log-prob and the state value.  The
        UNCLIPPED action is what the log-prob belongs to; SB3 stores it in
        the buffer and clips only what the env receives."""
        mean, log_std = ts.actor(x)
        a = mean + torch.exp(log_std) * noise
        return a, gaussian_logp(mean, log_std, a), ts.value(x)[..., 0]

    @torch.no_grad()
    def value_of(self, ts: PPOState, x):
        return ts.value(x)[..., 0]

    # ------------------------------------------------------------- update
    def update_perms(self, generator: torch.Generator, n: int):
        """Each epoch's permutation of the n rollout rows, (n_epochs, n)."""
        return torch.stack([torch.randperm(n, generator=generator,
                                           device=self.device)
                            for _ in range(self.n_epochs)])

    def loss(self, ts: PPOState, mb: Dict[str, torch.Tensor]):
        mean, log_std = ts.actor(mb["x"])
        logp = gaussian_logp(mean, log_std, mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        s1 = ratio * mb["adv"]
        s2 = torch.clamp(ratio, 1 - self.clip_range,
                         1 + self.clip_range) * mb["adv"]
        pg_loss = -torch.mean(torch.minimum(s1, s2))
        entropy = torch.mean(torch.sum(log_std + _HALF_LOG_2PI_E, -1))
        v_loss = torch.mean((mb["ret"] - ts.value(mb["x"])[..., 0]) ** 2)
        loss = pg_loss - self.ent_coef * entropy + self.vf_coef * v_loss
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=entropy)

    def update(self, ts: PPOState, rollout: Dict[str, torch.Tensor], perms):
        """n_epochs of minibatch clipped-surrogate updates, in place
        (ppo.py:89-142).  rollout: x, action, logp, adv, ret with N =
        n_steps * n_envs rows; perms (n_epochs, N) from update_perms.
        Advantages are normalised with the population std; each epoch
        takes its permutation's first nmb * batch_size rows as nmb
        minibatches.  Metrics: the mean over minibatches, then over
        epochs."""
        N = rollout["x"].shape[0]
        nmb = max(N // self.batch_size, 1)
        adv = rollout["adv"]
        rollout = dict(rollout, adv=(adv - adv.mean())
                       / (adv.std(unbiased=False) + 1e-8))
        groups = [(list(ts.actor.parameters()), ts.actor_opt),
                  (list(ts.value.parameters()), ts.value_opt)]
        params = [p for ps, _ in groups for p in ps]
        epochs = []
        for perm in perms:
            idxs = perm[: nmb * self.batch_size].reshape(nmb, self.batch_size)
            auxs = []
            for idx in idxs:
                loss, aux = self.loss(ts, {k: v[idx]
                                           for k, v in rollout.items()})
                grads = torch.autograd.grad(loss, params)
                i = 0
                for ps, opt in groups:
                    g = clip_by_global_norm(list(grads[i:i + len(ps)]),
                                            self.max_grad_norm)
                    for p, gp in zip(ps, g):
                        p.grad = gp
                    opt.step()
                    i += len(ps)
                auxs.append({k: v.detach() for k, v in aux.items()})
            epochs.append({k: torch.stack([a[k] for a in auxs]).mean()
                           for k in auxs[0]})
        ts.step += 1
        return ts, {k: torch.stack([e[k] for e in epochs]).mean()
                    for k in epochs[0]}


def gae(rewards, values, last_value, dones, gamma: float, lam: float):
    """GAE(lambda) over a (T, N) rollout; dones mask bootstrapping.
    Returns (advantages, returns)."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


@torch.no_grad()
def collect_rollout(core: RobotTaskEnv, learner: PPOLearner, ts: PPOState,
                    states, obs, generator: torch.Generator, n_steps: int,
                    max_episode_steps: int = 50):
    """Auto-resetting continuing rollout of n_steps across the env batch
    (ppo.py:161-209).  Task terminations and truncations (success,
    collision) are terminal for the value targets; a time-limit cutoff
    bootstraps gamma * V(terminal obs) into the reward (SB3
    handle_timeout_termination).  Every step draws one fresh reset of the
    whole batch and keeps it where the env is done.  Returns (states, obs,
    the flattened rollout, stats)."""
    n = states.q.shape[0]
    traj = []
    for _ in range(n_steps):
        x = flat_x(obs)
        a, logp, v = learner.act_logp_value(
            ts, x, learner.act_noise(generator, n))
        nstates, nobs, reward, term, trunc, info = core.batched_step(
            states, torch.clamp(a, -1.0, 1.0))
        terminal = term | trunc
        timeout = (nstates.steps >= max_episode_steps) & ~terminal
        v_term = learner.value_of(ts, flat_x(nobs))
        done = terminal | timeout
        rstates, robs = core.batched_reset(n, generator)
        states = keep_states(done, rstates, nstates)
        obs = {k: _keep(done, robs[k], nobs[k]) for k in nobs}
        traj.append(dict(
            x=x, action=a, logp=logp, value=v,
            reward=reward + learner.gamma * v_term * timeout.float(),
            raw_reward=reward, done=done.float(),
            success=info["is_success"].float()))
    tr = {k: torch.stack([o[k] for o in traj]) for k in traj[0]}
    adv, ret = gae(tr["reward"], tr["value"],
                   learner.value_of(ts, flat_x(obs)), tr["done"],
                   learner.gamma, learner.gae_lambda)
    flat = lambda t: t.reshape((-1,) + t.shape[2:])  # noqa: E731
    rollout = dict(x=flat(tr["x"]), action=flat(tr["action"]),
                   logp=flat(tr["logp"]), adv=flat(adv), ret=flat(ret))
    stats = dict(mean_reward=tr["raw_reward"].mean(),
                 success_rate=tr["success"].mean())
    return states, obs, rollout, stats


def train_ppo(core: RobotTaskEnv, hp=None, total_steps: int = 100_000,
              n_envs: int = 16, seed: int = 0, log_every: int = 1,
              logger=None, max_episode_steps: int = 50):
    """PPO training over a batched env core, on the core's device
    (ppo.py:212-242).  Returns (learner, state, per-iteration metrics)."""
    from panda_gym_tpu_torch.rl.config import Hyperparameters

    hp = hp or Hyperparameters("PPO")
    gen = torch.Generator(device=core.device).manual_seed(seed)
    states, obs = core.batched_reset(n_envs, gen)
    learner = PPOLearner(flat_x(obs).shape[-1], core.robot.action_dim, hp,
                         core.device)
    ts = learner.init(gen)
    steps_per_iter = learner.n_steps * n_envs
    history = []
    for it in range(max(total_steps // steps_per_iter, 1)):
        states, obs, rollout, stats = collect_rollout(
            core, learner, ts, states, obs, gen, learner.n_steps,
            max_episode_steps=max_episode_steps)
        ts, metrics = learner.update(
            ts, rollout, learner.update_perms(gen, rollout["x"].shape[0]))
        m = {k: float(v) for k, v in {**stats, **metrics}.items()}
        history.append(m)
        if logger is not None and it % log_every == 0:
            logger.log({"iter": it, "env_steps": (it + 1) * steps_per_iter,
                        **m})
    return learner, ts, history

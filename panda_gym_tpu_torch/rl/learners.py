"""Off-policy learners: SAC, TQC, TD3 and DDPG in PyTorch (port of
panda_gym_tpu/rl/learners.py).

TQC follows Kuznetsov et al. 2020 (truncated quantile critics): per-critic
quantile heads, pooled-sorted targets with the top-k quantiles per net
dropped.  Interface:

    learner = make_learner(algo, obs_dim, act_dim, hp, device)
    ts      = learner.init(generator)
    action  = learner.act(ts, x, noise, deterministic, expl)
    ts, metrics = learner.update(ts, batch, learner.update_noise(generator, B))

where x = concat([achieved_goal, desired_goal, observation], -1).  The JAX
update splits a key for the target's and the actor's action samples; here
those standard-normal draws are arguments, and ``update_noise`` /
``act_noise`` draw them from an explicit ``torch.Generator``.  Where the
JAX update returns a new state, this one updates ``ts`` in place and
returns it; each parameter's ``.grad`` keeps the gradient of its update.

Every learner's update is one sequence (``_Base.update``) over four hooks:
``target``, ``critic_loss``, ``actor_loss`` and ``actor_steps``; the
population trainer (rl/population.py) runs the same hooks on K stacked
members.  ``make_learner("PPO")`` returns rl/ppo.py's on-policy learner.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from panda_gym_tpu_torch.rl.checkpoint import restore_tensors
from panda_gym_tpu_torch.rl.networks import (
    DeterministicActor, QCritic, SDEGaussianActor, SquashedGaussianActor,
    deterministic_action, sample_sde_squashed, sample_squashed,
    sde_action_from_expl, sde_std)


@dataclass
class TrainState:
    actor: nn.Module
    critic: nn.Module
    target_critic: nn.Module
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    log_alpha: torch.Tensor
    alpha_opt: torch.optim.Adam
    step: int = 0


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): betas (0.9, 0.999), eps 1e-8 added outside the square
    root, no eps inside it, bias-corrected; its moments exist from the
    start, as optax's do, so that a state's tensors are fixed from init."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(0.0),
                       "exp_avg": torch.zeros_like(p),
                       "exp_avg_sq": torch.zeros_like(p)}
                   for i, p in enumerate(params)}
    opt.load_state_dict(sd)
    return opt


def named_state(ts: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of a TrainState by name, in a fixed order: the live
    tensors, so that copying into them restores a state."""
    out = {}
    for k in ("actor", "critic", "target_critic"):
        out.update({f"{k}/{n}": p
                    for n, p in getattr(ts, k).named_parameters()})
    out["log_alpha"] = ts.log_alpha
    for k in ("actor_opt", "critic_opt", "alpha_opt"):
        opt = getattr(ts, k)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            out.update({f"{k}/{i}/{n}": v for n, v in opt.state[p].items()})
    return out


def save_state(ts: TrainState) -> Dict:
    """A TrainState as host data: its tensors copied to the CPU, and the
    update count."""
    return {"tensors": {k: v.detach().to("cpu", copy=True)
                        for k, v in named_state(ts).items()},
            "step": ts.step}


def load_state(ts: TrainState, state: Dict, what: str = "learner"):
    """Copy a saved state into ``ts`` in place; every tensor is checked
    against ``ts``, the template built from the current config."""
    restore_tensors(named_state(ts), state["tensors"], what)
    ts.step = int(state["step"])
    return ts


def _step_grad(opt, params, loss, keep=True):
    """One Adam step on the gradient of ``loss``; with ``keep`` false the
    gradient is replaced by zeros and the step still runs (the moments
    decay, the count advances and the parameters move by momentum), as
    optax.adam does with TD3's masked gradient (learners.py:334-339).
    torch.optim.Adam would skip a parameter whose .grad is None."""
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g if keep else torch.zeros_like(g)
    opt.step()


class _Base:
    """The update every learner shares (learners.py:357-397 for SAC and
    TQC, 315-349 for TD3 and DDPG), in place: the critic steps first; the
    actor loss reads the new critic but sends gradient only into the actor;
    where the learner tunes alpha, the alpha loss uses that loss's logp
    without its gradient and alpha = exp(log_alpha) as it was before the
    update throughout; then the target's soft update from the new critic."""

    uses_alpha = True

    def __init__(self, obs_dim: int, act_dim: int, hp, device="cuda"):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hp = hp
        self.device = torch.device(device)
        self.gamma = getattr(hp, "gamma", 0.98)
        self.tau = getattr(hp, "tau", 0.02)
        self.lr = getattr(hp, "learning_rate", 3e-4)
        self.net_arch = tuple(getattr(hp, "policy_kwargs", {}).get(
            "net_arch", [256, 256]))
        # gSDE (use_sde=True, every reference SAC/TQC preset,
        # hyperparameters.py:19-27): log_std_init=-3 parameterizes the
        # weight-space noise matrix, usable as-is with the SDE actor.
        self.use_sde = bool(getattr(hp, "use_sde", False))
        self.log_std_init = getattr(hp, "policy_kwargs", {}).get(
            "log_std_init", -3.0 if self.use_sde else -1.0)
        self.target_entropy = -float(act_dim)

    @torch.no_grad()
    def soft_update(self, params, target):
        """target <- tau * params + (1 - tau) * target
        (optax.incremental_update), in place."""
        for p, t in zip(params.parameters(), target.parameters()):
            t.copy_(self.tau * p + (1.0 - self.tau) * t)

    def _state(self, actor, generator) -> TrainState:
        """A fresh TrainState around ``actor``: the critic drawn after it,
        its target a copy, log_alpha 0 and an Adam for each."""
        critic = QCritic(self.obs_dim + self.act_dim, self.net_arch,
                         self.out_dim, self.n_critics, generator, self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        return TrainState(
            actor=actor, critic=critic, target_critic=target,
            actor_opt=adam(actor.parameters(), self.lr),
            critic_opt=adam(critic.parameters(), self.lr),
            log_alpha=log_alpha, alpha_opt=adam([log_alpha], self.lr))

    def act_noise(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """The standard-normal draw of one stochastic action of a batch of
        n (act_noise_shape)."""
        return torch.randn(self.act_noise_shape(n), generator=generator,
                           device=self.device)

    def update_noise(self, generator: torch.Generator, n: int):
        """The standard-normal draws of one update on a batch of n, one per
        shape of update_noise_shapes."""
        return tuple(torch.randn(s, generator=generator, device=self.device)
                     for s in self.update_noise_shapes(n))

    def split_noise(self, noise):
        """(the target's draw, the actor loss's draw) of update_noise."""
        return noise

    def actor_steps(self, step: int) -> bool:
        """Whether update number ``step`` uses the actor's gradient."""
        return True

    def update(self, ts: TrainState, batch: Dict, noise):
        noise_t, noise_a = self.split_noise(noise)
        alpha = torch.exp(ts.log_alpha.detach())
        target = self.target(ts, batch, noise_t, alpha)

        closs = self.critic_loss(ts.critic, batch, target)
        _step_grad(ts.critic_opt, list(ts.critic.parameters()), closs)

        aloss, logp = self.actor_loss(ts.actor, ts.critic, batch["x"],
                                      noise_a, alpha)
        _step_grad(ts.actor_opt, list(ts.actor.parameters()), aloss,
                   self.actor_steps(ts.step))
        m = dict(critic_loss=closs.detach(), actor_loss=aloss.detach())
        if self.uses_alpha:
            lloss = -torch.mean(ts.log_alpha * (logp.detach()
                                                + self.target_entropy))
            _step_grad(ts.alpha_opt, [ts.log_alpha], lloss)
            m["alpha"] = alpha

        self.soft_update(ts.critic, ts.target_critic)
        ts.step += 1
        return ts, dict(m, q_target_mean=torch.mean(target))


class SACLearner(_Base):
    """Soft actor-critic with automatic entropy tuning (ent_coef='auto',
    hyperparameters.py:18)."""

    N_QUANTILES = 0  # scalar critics

    def __init__(self, obs_dim, act_dim, hp, device="cuda"):
        super().__init__(obs_dim, act_dim, hp, device)
        self.actor_cls = (SDEGaussianActor if self.use_sde
                          else SquashedGaussianActor)
        self.n_critics = getattr(hp, "n_critics", 2)
        self.out_dim = max(self.N_QUANTILES, 1)

    # one sampling helper both actor types share: (action, logp), reparam.
    def _actor_sample(self, actor, x, noise):
        if self.use_sde:
            mean, latent, log_std = actor(x)
            return sample_sde_squashed(mean, latent, log_std, noise)
        mean, log_std = actor(x)
        return sample_squashed(mean, log_std, noise)

    def act_noise_shape(self, n: int):
        """The shape of one stochastic action's standard-normal draw for a
        batch of n: W (latent, act) for the gSDE actor, eps (n, act)
        otherwise."""
        return ((self.net_arch[-1], self.act_dim) if self.use_sde
                else (n, self.act_dim))

    def update_noise_shapes(self, n: int):
        """The target's and the actor loss's action samples (k_t and k_a of
        learners.py:358)."""
        return self.act_noise_shape(n), self.act_noise_shape(n)

    def init(self, generator: torch.Generator) -> TrainState:
        actor = self.actor_cls(self.obs_dim, self.act_dim, self.net_arch,
                               self.log_std_init, generator, self.device)
        return self._state(actor, generator)

    # ------------------------------------------------------------- acting
    @torch.no_grad()
    def act(self, ts: TrainState, x, noise: Optional[torch.Tensor] = None,
            deterministic: bool = False, expl=None):
        """expl: per-env episode-persistent gSDE exploration matrices
        (B, latent_dim, act_dim) from sample_expl(); without it a
        stochastic action takes ``noise`` from act_noise()."""
        if self.use_sde:
            mean, latent, log_std = ts.actor(x)
            if deterministic:
                return deterministic_action(mean)
            if expl is not None:
                return sde_action_from_expl(mean, latent, log_std, expl)
            return sample_sde_squashed(mean, latent, log_std, noise)[0]
        mean, log_std = ts.actor(x)
        if deterministic:
            return deterministic_action(mean)
        return sample_squashed(mean, log_std, noise)[0]

    def sample_expl(self, ts: TrainState, generator: torch.Generator, n: int):
        """Per-episode gSDE exploration matrices (sde_sample_freq=-1:
        resampled once per rollout, SB3 collect_rollouts reset_noise);
        None for non-SDE actors."""
        if not self.use_sde:
            return None
        return torch.randn(n, self.net_arch[-1], self.act_dim,
                           generator=generator, device=self.device)

    @torch.no_grad()
    def act_with_std(self, ts: TrainState, x):
        if self.use_sde:
            mean, latent, log_std = ts.actor(x)
            return deterministic_action(mean), sde_std(latent, log_std)
        mean, log_std = ts.actor(x)
        return deterministic_action(mean), torch.exp(log_std)

    # ------------------------------------------------------------- losses
    def _target_q(self, ts, x2, noise, alpha):
        a2, logp2 = self._actor_sample(ts.actor, x2, noise)
        q2 = ts.target_critic(x2, a2)[..., 0]                     # (C, B)
        return torch.amin(q2, 0) - alpha * logp2

    def target(self, ts, batch, noise_t, alpha):
        """The Bellman target, without gradient."""
        with torch.no_grad():
            tq = self._target_q(ts, batch["x2"], noise_t, alpha)
            return batch["reward"] + self.gamma * (
                1.0 - batch["terminated"]) * tq

    def critic_loss(self, critic, batch, target):
        q = critic(batch["x"], batch["action"])[..., 0]           # (C, B)
        return torch.mean((q - target[None, :]) ** 2)

    def _q_for_actor(self, z):
        return torch.amin(z[..., 0], 0)

    def actor_loss(self, actor, critic, x, noise_a, alpha):
        """(loss, logp) of the actor's reparametrized sample under
        ``critic``."""
        a, logp = self._actor_sample(actor, x, noise_a)
        q = self._q_for_actor(critic(x, a))
        return torch.mean(alpha * logp - q), logp


class TQCLearner(SACLearner):
    """Truncated Quantile Critics (sb3_contrib TQC equivalent), the
    reference's primary algorithm (train_config.py:13)."""

    def __init__(self, obs_dim, act_dim, hp, device="cuda"):
        self.N_QUANTILES = getattr(hp, "n_quantiles", 25)
        super().__init__(obs_dim, act_dim, hp, device)
        self.top_drop = getattr(hp, "top_quantiles_to_drop_per_net", 2)

    def _target_q(self, ts, x2, noise, alpha):
        a2, logp2 = self._actor_sample(ts.actor, x2, noise)
        z2 = ts.target_critic(x2, a2)                            # (C, B, Q)
        C, B, Q = z2.shape
        pooled = torch.sort(z2.transpose(0, 1).reshape(B, C * Q), -1).values
        keep = C * Q - self.top_drop * C
        return pooled[:, :keep] - alpha * logp2[:, None]          # (B, keep)

    def target(self, ts, batch, noise_t, alpha):
        with torch.no_grad():
            z_next = self._target_q(ts, batch["x2"], noise_t, alpha)
            return batch["reward"][:, None] + self.gamma * (
                1.0 - batch["terminated"][:, None]) * z_next

    def critic_loss(self, critic, batch, target):
        # target: (B, keep) quantile samples; prediction: (C, B, Q)
        z = critic(batch["x"], batch["action"])
        Q = z.shape[-1]
        taus = (torch.arange(Q, dtype=torch.float32, device=z.device)
                + 0.5) / Q                                        # midpoints
        # pairwise TD errors: (C, B, Q, keep)
        delta = target[None, :, None, :] - z[..., None]
        abs_d = torch.abs(delta)
        huber = torch.where(abs_d <= 1.0, 0.5 * delta ** 2, abs_d - 0.5)
        weight = torch.abs(taus[None, None, :, None] - (delta < 0.0).float())
        return torch.mean(weight * huber)

    def _q_for_actor(self, z):
        return torch.mean(z, dim=(0, 2))


class TD3Learner(_Base):
    """Twin-delayed DDPG (learners.py:275-349): target policy smoothing,
    the min over two critics, and the actor's gradient on every
    ``policy_delay``-th update only.  TrainState keeps log_alpha and its
    Adam, unused, as the JAX state does, so that checkpoints and
    named_state stay uniform."""

    uses_alpha = False
    policy_noise = 0.2
    noise_clip = 0.5
    policy_delay = 2
    n_critics = 2

    def __init__(self, obs_dim, act_dim, hp, device="cuda"):
        super().__init__(obs_dim, act_dim, hp, device)
        self.tau = getattr(hp, "tau", 0.005)
        self.noise_std = getattr(hp, "noise_std", 0.1)
        self.out_dim = 1

    def init(self, generator: torch.Generator) -> TrainState:
        actor = DeterministicActor(self.obs_dim, self.act_dim, self.net_arch,
                                   generator, self.device)
        return self._state(actor, generator)

    def act_noise_shape(self, n: int):
        return (n, self.act_dim)


    def update_noise_shapes(self, n: int):
        """The target smoothing draw (learners.py:317)."""
        return (self.act_noise_shape(n),)

    def split_noise(self, noise):
        return noise[0], None

    @torch.no_grad()
    def act(self, ts: TrainState, x, noise: Optional[torch.Tensor] = None,
            deterministic: bool = False, expl=None):
        a = ts.actor(x)
        if not deterministic:
            a = torch.clamp(a + self.noise_std * noise, -1.0, 1.0)
        return a

    def target(self, ts, batch, noise_t, alpha=None):
        with torch.no_grad():
            a2 = ts.actor(batch["x2"])
            noise = torch.clamp(self.policy_noise * noise_t,
                                -self.noise_clip, self.noise_clip)
            a2 = torch.clamp(a2 + noise, -1.0, 1.0)
            q2 = torch.amin(ts.target_critic(batch["x2"], a2)[..., 0], 0)
            return batch["reward"] + self.gamma * (
                1.0 - batch["terminated"]) * q2

    critic_loss = SACLearner.critic_loss

    def actor_loss(self, actor, critic, x, noise_a=None, alpha=None):
        """(-mean Q_0(x, actor(x)), None): the first critic only."""
        return -torch.mean(critic(x, actor(x))[0, :, 0]), None

    def actor_steps(self, step: int) -> bool:
        return step % self.policy_delay == 0


class DDPGLearner(TD3Learner):
    policy_noise = 0.0
    noise_clip = 0.0
    policy_delay = 1
    n_critics = 1


def ckpt_uses_sde(ts) -> bool:
    """Whether a TrainState's actor (or that of a saved state, save_state)
    is the gSDE actor.  Checkpoints from before the true-gSDE
    implementation carry the legacy squashed-Gaussian actor even when their
    config says use_sde=True."""
    if isinstance(ts, dict):
        return "actor/log_std_sde" in ts["tensors"]
    return hasattr(ts.actor, "log_std_sde")


def align_sde_with_ckpt(hp, ts) -> None:
    """Mutate hp.use_sde in place to match the checkpoint's actor type."""
    has = ckpt_uses_sde(ts)
    if bool(getattr(hp, "use_sde", False)) != has:
        hp.use_sde = has


def make_learner(algorithm: str, obs_dim: int, act_dim: int, hp,
                 device="cuda"):
    """Algorithm dispatch (setup_training.py:100-115; + PPO, which the
    reference ships a preset for but never wires into its dispatch).  PPO
    is on-policy: rl/ppo.py's train_ppo drives it, and the off-policy
    Trainer rejects it."""
    if algorithm == "PPO":
        from panda_gym_tpu_torch.rl.ppo import PPOLearner
        return PPOLearner(obs_dim, act_dim, hp, device)
    algos = {"SAC": SACLearner, "TQC": TQCLearner, "TQC_v2": TQCLearner,
             "TD3": TD3Learner, "DDPG": DDPGLearner}
    if algorithm not in algos:
        raise Exception("Algorithm not found!")  # setup_training.py:112-113
    return algos[algorithm](obs_dim, act_dim, hp, device)

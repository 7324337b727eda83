"""Population training: K learners trained at once (port of
panda_gym_tpu/rl/population.py).

K independent members (own parameters, optimizer states, replay rings and
exploration draws; one algorithm, architecture and set of hyperparameters)
advance together:

  * one env batch: a VectorEnv of K * n_envs envs, member-major (member k
    owns envs k * n_envs ... (k + 1) * n_envs - 1), so each env step is
    ONE batched_step of the env core whatever K is (on ReachAO, 20 K1
    launches per env step, not K * 20);
  * stacked members: every parameter and Adam moment carries a leading K
    axis (``PopState``).  The learner's own loss hooks run on all members at
    once through ``torch.func.vmap`` over ``functional_call``; the gradient
    of the sum of the members' losses with respect to the stacked leaves is
    each member's own gradient, and one torch Adam over the stacked leaves
    is K independent Adams, because Adam is elementwise and the members step
    in lockstep.  tests/test_torch_population.py holds the stacked update
    against each member's own update and against JAX's jax.vmap(update);
  * stacked HER: rl/her.py's StackedHerBuffer, (K, E, ...) tensors with one
    write index, sampled for all members in one gather.

The schedule is JAX's: the fused collect+update rollout with
round(utd * n_envs) stacked updates after each env step, the buffer gate on
member 0's counts, per-member deterministic evaluation with a per-member
best checkpoint, and the curriculum advancing on the members' MEDIAN
evaluation success.  The learners, the buffer and the generator live on the
env core's device.  Member checkpoints are the Trainer's format, so
Trainer.load and policy_io read them.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call, vmap

from panda_gym_tpu_torch.envs.core import RobotTaskEnv
from panda_gym_tpu_torch.rl import her
from panda_gym_tpu_torch.rl.checkpoint import load_checkpoint, save_checkpoint
from panda_gym_tpu_torch.rl.config import TrainConfig
from panda_gym_tpu_torch.rl.learners import (TrainState, _step_grad, adam,
                                             align_sde_with_ckpt, load_state,
                                             make_learner, named_state,
                                             save_state)
from panda_gym_tpu_torch.rl.train import (VectorEnv, learner_batch,
                                          reject_on_policy, schedule,
                                          stage_tag)

_NETS = ("actor", "critic", "target_critic")
_OPTS = ("actor_opt", "critic_opt", "alpha_opt")


@dataclass
class PopState:
    """K members' TrainStates stacked: each network as its parameters by
    the port's names, each (K, ...); log_alpha (K,); one Adam per network
    over the stacked leaves; the shared update count."""

    actor: Dict[str, torch.Tensor]
    critic: Dict[str, torch.Tensor]
    target_critic: Dict[str, torch.Tensor]
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    log_alpha: torch.Tensor
    alpha_opt: torch.optim.Adam
    step: int = 0


def pop_named_state(pop: PopState) -> Dict[str, torch.Tensor]:
    """Every tensor of a PopState by learners.named_state's names."""
    out = {}
    for k in _NETS:
        out.update({f"{k}/{n}": p for n, p in getattr(pop, k).items()})
    out["log_alpha"] = pop.log_alpha
    for k in _OPTS:
        opt = getattr(pop, k)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            out.update({f"{k}/{i}/{n}": v for n, v in opt.state[p].items()})
    return out


def _member_of(stacked: torch.Tensor, like: torch.Tensor, i: int):
    """Member i of a stacked tensor; Adam's step count, which the members
    share, is not stacked."""
    return stacked[i] if stacked.dim() == like.dim() + 1 else stacked


class StackedLearner:
    """K members of one off-policy learner (rl/learners.py) as one: the
    learner interface (act, act_noise, sample_expl, update_noise, update)
    over a PopState, so that VectorEnv rollouts drive the population as
    they drive one member, on a member-major batch of K * n envs."""

    def __init__(self, learner, members: int):
        self.learner = learner
        self.K = int(members)
        self.device = learner.device
        # the graphs functional_call runs; their own values are never read
        tmpl = learner.init(torch.Generator(device=learner.device)
                            .manual_seed(0))
        self._actor, self._critic = tmpl.actor, tmpl.critic

    # ------------------------------------------------------------ states
    def stack(self, states: List[TrainState]) -> PopState:
        """K TrainStates as one PopState (copies); the members must share
        their update count."""
        lr = self.learner.lr
        nets = {k: {n: torch.stack([dict(getattr(s, k).named_parameters())[n]
                                    .detach() for s in states])
                    .requires_grad_(k != "target_critic")
                    for n, _ in getattr(states[0], k).named_parameters()}
                for k in _NETS}
        log_alpha = torch.stack([s.log_alpha.detach() for s in states]
                                ).requires_grad_(True)
        pop = PopState(**nets,
                       actor_opt=adam(nets["actor"].values(), lr),
                       critic_opt=adam(nets["critic"].values(), lr),
                       log_alpha=log_alpha, alpha_opt=adam([log_alpha], lr),
                       step=states[0].step)
        named = [named_state(s) for s in states]
        with torch.no_grad():
            for k, t in pop_named_state(pop).items():
                if t.dim() == named[0][k].dim() + 1:
                    t.copy_(torch.stack([n[k] for n in named]))
                else:
                    t.copy_(named[0][k])
        return pop

    def init(self, generator: torch.Generator) -> PopState:
        """K members, each initialised as learner.init, one after another
        from ``generator``."""
        return self.stack([self.learner.init(generator)
                           for _ in range(self.K)])

    # ------------------------------------------------------------ graphs
    def _nets(self, actor=None, critic=None, target_critic=None):
        """Member-slice parameters as callables, in the places a TrainState
        holds its modules."""
        call = lambda mod, p: (None if p is None else  # noqa: E731
                               lambda *a: functional_call(mod, p, a))
        return SimpleNamespace(actor=call(self._actor, actor),
                               critic=call(self._critic, critic),
                               target_critic=call(self._critic,
                                                  target_critic))

    # ------------------------------------------------------------ acting
    def act_noise(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Each member's act_noise for its n // K envs: (K, ...)."""
        shape = self.learner.act_noise_shape(n // self.K)
        return torch.randn((self.K,) + tuple(shape), generator=generator,
                           device=self.device)

    def sample_expl(self, pop: PopState, generator: torch.Generator, n: int):
        """Per-env gSDE exploration matrices of the n envs (member k's at
        rows k * n / K ...), None for non-SDE learners."""
        sample = getattr(self.learner, "sample_expl", None)
        return None if sample is None else sample(None, generator, n)

    @torch.no_grad()
    def act(self, pop: PopState, x, noise=None, deterministic: bool = False,
            expl=None):
        """Each member's action on its own envs' rows of x (K * n, x_dim)."""
        learner = self.learner

        def one(p, x, noise, expl):
            return learner.act(self._nets(actor=p), x, noise, deterministic,
                               expl)

        args = (pop.actor, x.unflatten(0, (self.K, -1)), noise,
                None if expl is None else expl.unflatten(0, (self.K, -1)))
        dims = tuple(None if a is None else 0 for a in args)
        return vmap(one, in_dims=dims)(*args).flatten(0, 1)

    # ------------------------------------------------------------ update
    def update_noise(self, generator: torch.Generator, n: int):
        """Each member's update_noise for a batch of n: (K, ...) each."""
        return tuple(torch.randn((self.K,) + tuple(s), generator=generator,
                                 device=self.device)
                     for s in self.learner.update_noise_shapes(n))

    def update(self, pop: PopState, batch: Dict[str, torch.Tensor], noise):
        """One update of every member, in place: the learner's update
        (learners.py::_Base.update) with a leading K axis on the state, the
        batch (K, B, ...) and the noise.  Metrics are (K,)."""
        L = self.learner
        noise_t, noise_a = L.split_noise(noise)
        dim = lambda a: None if a is None else 0  # noqa: E731
        alpha = torch.exp(pop.log_alpha.detach())

        def target(pa, pt, b, n, al):
            return L.target(self._nets(actor=pa, target_critic=pt), b, n, al)

        target = vmap(target, in_dims=(0, 0, 0, dim(noise_t), 0))(
            pop.actor, pop.target_critic, batch, noise_t, alpha)

        def critic_loss(pc, b, t):
            return L.critic_loss(self._nets(critic=pc).critic, b, t)

        closs = vmap(critic_loss)(pop.critic, batch, target)
        _step_grad(pop.critic_opt, list(pop.critic.values()), closs.sum())

        def actor_loss(pa, pc, x, n, al):
            nets = self._nets(actor=pa, critic=pc)
            loss, logp = L.actor_loss(nets.actor, nets.critic, x, n, al)
            return (loss, logp) if L.uses_alpha else loss

        out = vmap(actor_loss, in_dims=(0, 0, 0, dim(noise_a), 0))(
            pop.actor, pop.critic, batch["x"], noise_a, alpha)
        aloss, logp = out if L.uses_alpha else (out, None)
        _step_grad(pop.actor_opt, list(pop.actor.values()), aloss.sum(),
                   L.actor_steps(pop.step))
        m = dict(critic_loss=closs.detach(), actor_loss=aloss.detach())
        if L.uses_alpha:
            lloss = -torch.mean(pop.log_alpha[:, None] * (
                logp.detach() + L.target_entropy), 1)
            _step_grad(pop.alpha_opt, [pop.log_alpha], lloss.sum())
            m["alpha"] = alpha

        with torch.no_grad():
            for p, t in zip(pop.critic.values(), pop.target_critic.values()):
                t.copy_(L.tau * p + (1.0 - L.tau) * t)
        pop.step += 1
        return pop, dict(m, q_target_mean=target.flatten(1).mean(1))


def member_slice(stacked: StackedLearner, pop: PopState, i: int
                 ) -> TrainState:
    """Member i of a PopState as a TrainState of its own (a copy)."""
    ts = stacked.learner.init(torch.Generator(device=stacked.device)
                              .manual_seed(0))
    named = pop_named_state(pop)
    with torch.no_grad():
        for k, t in named_state(ts).items():
            t.copy_(_member_of(named[k], t, i))
    ts.step = pop.step
    return ts


def member_gate(buf: her.StackedHerBuffer, interleave_min: int) -> bool:
    """The fused-burst gate (population.py:186-196): the members fill in
    lockstep, so member 0's counts are every member's."""
    return (buf.n_stored >= buf.capacity
            or int(buf.ep_len[0].sum()) >= interleave_min)


class PopulationTrainer:
    """K-member trainer sharing the Trainer's building blocks
    (population.py:51-281): the fused interleaved loop, the buffer gate,
    the learning-starts ramp, curriculum stages on the median and
    per-member best-evaluation snapshots."""

    def __init__(self, config: TrainConfig,
                 make_env: Callable[[str, float, float], RobotTaskEnv],
                 n_members: int, logger=None):
        self.config = config
        self.make_env = make_env
        self.K = int(n_members)
        self.logger = logger
        self.stacked: Optional[StackedLearner] = None
        self.pop: Optional[PopState] = None
        self.buffer: Optional[her.StackedHerBuffer] = None
        self.generator = None
        self.timesteps = 0        # aggregate env steps across members
        self._seed = config.seed
        self._best_eval = None    # (K,) per-member best eval success
        self._loaded = None       # pending member states (load_members)

    # ------------------------------------------------------------------
    def learn(self, seed: Optional[int] = None):
        cfg = self.config
        self._seed = cfg.seed if seed is None else seed
        self.generator = None
        n_stages = len(cfg.stages)
        for i, stage in enumerate(cfg.stages):
            sp_thr = (cfg.speed_thresholds[i] if cfg.goal_condition == "halt"
                      else 0.5)
            horizon = cfg.max_ep_steps[min(i, len(cfg.max_ep_steps) - 1)]
            reached = self.train_stage(stage, horizon,
                                       cfg.ee_error_thresholds[i], sp_thr,
                                       cfg.success_thresholds[i],
                                       final=(i == n_stages - 1))
            print(f"[pop stage {stage}] done (threshold reached: {reached});"
                  f" aggregate timesteps: {self.timesteps}")
            run_dir = getattr(self.logger, "dir", None)
            if run_dir:
                self.save_members(os.path.join(
                    run_dir, f"model_{stage_tag(stage)}_{i}"))
        return self.pop

    def _ensure_learner(self, venv: VectorEnv, capacity: int):
        cfg = self.config
        dev = venv.core.device
        reject_on_policy(cfg.algorithm)
        if self.stacked is None:
            self.stacked = StackedLearner(
                make_learner(cfg.algorithm, venv.x_dim, venv.act_dim,
                             cfg.hyperparams, dev), self.K)
            if self._loaded is not None:
                # templates from a generator of their own, so that the
                # run's stream does not depend on the loaded members
                self.pop = self.stacked.stack([load_state(
                    self.stacked.learner.init(
                        torch.Generator(device=dev).manual_seed(0)), state)
                    for state in self._loaded])
                self._loaded = None
            elif self.pop is None:
                self.pop = self.stacked.init(self.generator)
        if self.buffer is None or self.buffer.ep_horizon < venv.horizon:
            self.buffer = her.create_stacked(
                self.K, capacity, venv.horizon, venv.obs_dim, venv.goal_dim,
                venv.act_dim, venv.aux_dim, dev)

    def update_burst(self, pop, buf, generator, n: int, batch_size: int,
                     reward_fn):
        """n stacked updates, each on a fresh HER batch per member; returns
        (pop, the last update's metrics)."""
        m = {}
        for _ in range(n):
            batch = learner_batch(her.gather_stacked(
                buf, her.draw_stacked(buf, generator, batch_size), reward_fn))
            pop, m = self.stacked.update(
                pop, batch, self.stacked.update_noise(generator, batch_size))
        return pop, m

    def train_stage(self, scenario: str, horizon: int, ee_thr: float,
                    sp_thr: float, success_threshold: float,
                    final: bool = False) -> bool:
        cfg = self.config
        core = self.make_env(scenario, ee_thr, sp_thr)
        if self.generator is None:
            self.generator = torch.Generator(
                device=core.device).manual_seed(self._seed)
        gen = self.generator
        venv = VectorEnv(core, self.K * cfg.n_envs, horizon)
        sched = schedule(cfg, horizon)
        self._ensure_learner(venv, sched.capacity)
        self._best_eval = np.full(self.K, -1.0)

        def reward_fn(achieved_next, goal, aux):
            return core.task.reward_from_aux(core, achieved_next, goal, aux)

        def step_update(pop, buf, generator):
            return self.update_burst(pop, buf, generator,
                                     sched.n_upd_per_step, sched.batch_size,
                                     reward_fn)

        gate_open = False

        def buffer_filled():
            nonlocal gate_open
            gate_open = gate_open or member_gate(self.buffer,
                                                 sched.interleave_min)
            return gate_open

        stage_steps = 0           # per-member env steps this stage
        learning_started = False
        t_start = time.time()
        while stage_steps < cfg.max_timesteps:
            m: Dict = {}
            if (learning_started and cfg.interleave_updates
                    and buffer_filled()):
                episodes, stats, self.pop, ms = venv._rollout_episode(
                    self.stacked, self.pop, gen, buf=self.buffer,
                    update_fn=step_update)
                m = {k: float(v.mean()) for k, v in ms.items()}
            else:
                episodes, stats, _, _ = venv._rollout_episode(
                    self.stacked, self.pop, gen)
            self.buffer = her.add_stacked(self.buffer, **episodes)
            rollout_steps = int(stats["ep_len"].sum()) // self.K
            stage_steps += rollout_steps
            self.timesteps += rollout_steps * self.K
            if not learning_started and stage_steps >= sched.learning_starts:
                learning_started = True

            row = dict(
                scenario=scenario, timesteps=self.timesteps,
                stage_steps=stage_steps, members=self.K,
                rollout_success=[round(float(s), 4) for s in
                                 stats["success"].view(self.K, -1).mean(1)],
                agg_sps=self.timesteps / max(time.time() - t_start, 1e-9),
                **m)
            if self.logger is not None:
                self.logger.log(row)

            if (learning_started
                    and stage_steps % max(cfg.eval_freq, 1) < rollout_steps):
                per_member = self.evaluate(venv, gen)
                if self.logger is not None:
                    self.logger.log(dict(
                        eval_success=[round(float(s), 4)
                                      for s in per_member],
                        timesteps=self.timesteps))
                run_dir = getattr(self.logger, "dir", None)
                for i in range(self.K):
                    if per_member[i] > self._best_eval[i] and run_dir:
                        self._best_eval[i] = per_member[i]
                        self.save_member(os.path.join(
                            run_dir, f"best_model_m{i}.ckpt"), i)
                # the curriculum advances on the population MEDIAN: one
                # lucky seed must not advance it for everyone
                if float(np.median(per_member)) >= success_threshold \
                        and not final:
                    return True
        return False

    def evaluate(self, venv: VectorEnv, generator) -> np.ndarray:
        """Each member's deterministic success rate over one episode batch
        of its n_envs envs: (K,)."""
        _, stats, _, _ = venv._rollout_episode(self.stacked, self.pop,
                                               generator, deterministic=True)
        return stats["success"].view(self.K, -1).mean(1).cpu().numpy()

    # ------------------------------------------------------------- ckpt
    def save_member(self, path: str, i: int):
        """Member i as the Trainer's checkpoint (Trainer.load and
        policy_io read it), with the per-member step count."""
        save_checkpoint(path, {
            "ts": save_state(member_slice(self.stacked, self.pop, i)),
            "timesteps": self.timesteps // self.K,
            "algorithm": self.config.algorithm})

    def save_members(self, prefix: str):
        for i in range(self.K):
            self.save_member(f"{prefix}_m{i}.ckpt", i)

    def load_members(self, paths: List[str]):
        """Seed the K members from checkpoints in the Trainer's format
        (save_members writes them), optimizer state included; learn() then
        continues from them with a fresh buffer."""
        states = [load_checkpoint(p)["ts"] for p in paths]
        if len(states) != self.K:
            raise ValueError(f"{len(states)} member checkpoints for "
                             f"{self.K} members")
        if self.config.algorithm in ("SAC", "TQC", "TQC_v2"):
            align_sde_with_ckpt(self.config.hyperparams, states[0])
        self._loaded = states

"""Curriculum training pipeline: vectorized collector + staged curriculum (port
of panda_gym_tpu/rl/train.py).

  * N envs stepped in lockstep through the env core's ``batched_step``;
  * synchronous episode collection: each rollout runs one episode batch of
    max_ep_steps steps per env (post-termination steps frozen), writes the
    episodes into the HER buffer, then runs gradient updates, or, once the
    buffer holds enough, one update burst after every env step;
  * curriculum stages advance when the deterministic-eval success rate
    reaches the stage threshold (setup_training.py:233-307).

Each jitted scan of the JAX package is a Python loop over env steps here.
The learner and the buffer live on the env core's device, so training runs
on the card unless the caller builds its envs on the CPU.  One
``torch.Generator`` on that device takes the place of the key chain; the
full-state checkpoint stores its state, so that a kill and resume
reproduces the uninterrupted run.  With ``prior_steps`` the buffer is
filled with NEO prior rollouts (rl/imitation.py) before the first collect.
Not ported yet: the device mesh (ROADMAP item 17).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from panda_gym_tpu_torch.envs.core import RobotTaskEnv, _hi_prec
from panda_gym_tpu_torch.rl import her
from panda_gym_tpu_torch.rl.checkpoint import (CheckpointManager,
                                               load_checkpoint,
                                               save_checkpoint)
from panda_gym_tpu_torch.rl.config import TrainConfig
from panda_gym_tpu_torch.rl.imitation import fill_buffer_with_prior
from panda_gym_tpu_torch.rl.learners import (align_sde_with_ckpt,
                                             load_state, make_learner,
                                             save_state)

# ---------------------------------------------------------------------------


def flat_x(obs):
    return torch.cat([obs["achieved_goal"], obs["desired_goal"],
                      obs["observation"]], -1)


def stage_tag(stage: str, limit: int = 120) -> str:
    """Filesystem-safe tag for a stage name. Long mixture names
    ('a+b+...' can exceed the 255-byte filename limit) are truncated with
    a digest suffix so the per-stage snapshot stays unique and the save
    cannot fail."""
    if len(stage) <= limit:
        return stage
    import hashlib
    digest = hashlib.sha1(stage.encode()).hexdigest()[:8]
    return f"{stage[:100]}...{digest}"


def _keep(done, old, new):
    """old where the env is done, else new."""
    return torch.where(done.view((-1,) + (1,) * (new.dim() - 1)), old, new)


def keep_states(done, old, new):
    """_keep on every field of two batched EnvStates."""
    return new.replace(**{k: _keep(done, getattr(old, k), getattr(new, k))
                          for k in new.__dataclass_fields__})


class VectorEnv:
    """Batched env with episode rollouts (train.py:55-238, without the
    device mesh)."""

    def __init__(self, core: RobotTaskEnv, n_envs: int, horizon: int):
        self.core = core
        self.n_envs = n_envs
        self.horizon = horizon
        # one env's reset, from a generator of its own, gives the sizes
        probe, obs = core.batched_reset(
            1, torch.Generator(device=core.device).manual_seed(0))
        self.obs_dim = obs["observation"].shape[-1]
        self.goal_dim = obs["achieved_goal"].shape[-1]
        self.act_dim = core.robot.action_dim
        self.x_dim = self.obs_dim + 2 * self.goal_dim
        self.aux_dim = core.task.reward_aux(core, probe).shape[-1]

    def batch_reset(self, generator):
        return self.core.batched_reset(self.n_envs, generator)

    def rollout_episode(self, learner, ts, generator, deterministic=False,
                        policy_fn=None):
        """One episode batch: (episodes, stats).  ``policy_fn(x, states,
        generator) -> actions`` overrides the learner (the prior bootstrap,
        rl/imitation.py)."""
        episodes, stats, _, _ = self._rollout_episode(
            learner, ts, generator, deterministic, policy_fn=policy_fn)
        return episodes, stats

    def rollout_train(self, learner, ts, buf, generator, update_fn):
        """Collect with an update burst after EVERY env step, so the policy
        improves ``horizon`` times per episode batch (train.py:107-127).
        update_fn(ts, buf, generator) -> (ts, metrics) runs against the
        buffer as it was when the rollout began; the episodes are appended
        after they complete (HER needs whole episodes).  Returns (ts, buf,
        stats, the last burst's metrics)."""
        episodes, stats, ts, m = self._rollout_episode(
            learner, ts, generator, False, buf=buf, update_fn=update_fn)
        return ts, her.add_episodes(buf, **episodes), stats, m

    def _sample_expl(self, learner, ts, generator):
        """Per-episode gSDE exploration matrices; None for non-SDE
        learners."""
        if not hasattr(learner, "sample_expl"):
            return None
        return learner.sample_expl(ts, generator, self.n_envs)

    def env_step(self, learner, ts, states, obs, done, ep_len, generator,
                 deterministic=False, expl=None, policy_fn=None):
        """One env step of the rollout (the body of train.py:162-204's
        scan): act (``policy_fn`` in place of the learner when given),
        step, freeze the finished envs in state and obs with reward 0 after
        ``done``, aux from the kept state, and ``terminated`` true only on
        the step that ends the episode (a collision too: it is terminal for
        the Bellman target, train.py:190-197)."""
        core = self.core
        if policy_fn is not None:
            action = policy_fn(flat_x(obs), states, generator)
        else:
            noise = None
            if not deterministic and expl is None:
                noise = learner.act_noise(generator, self.n_envs)
            action = learner.act(ts, flat_x(obs), noise,
                                 deterministic=deterministic, expl=expl)
        nstates, nobs, reward, term, trunc, info = core.batched_step(
            states, action)
        step_done = term | trunc
        states = keep_states(done, states, nstates)
        obs = {k: _keep(done, obs[k], nobs[k]) for k in nobs}
        reward = torch.where(done, 0.0, reward)
        aux = _hi_prec(core.task.reward_aux)(core, states)
        ep_len = ep_len + (~done).to(torch.int32)
        out = dict(obs=obs["observation"], achieved=obs["achieved_goal"],
                   action=action, aux=aux, reward=reward,
                   terminated=torch.where(done, False, step_done),
                   success=info["is_success"], collided=info["is_truncated"])
        return states, obs, done | step_done, ep_len, out

    def _rollout_episode(self, learner, ts, generator, deterministic=False,
                         buf=None, update_fn=None, policy_fn=None):
        """One synchronous episode batch of ``horizon`` steps
        (train.py:139-238).  Returns the episode tensors shaped for
        HerBuffer, (N, T+1, ...) observations with the initial one, the
        episode stats, the TrainState and the last burst's metrics (with
        ``update_fn``, a burst after each env step, its TrainState carried
        into the next step's action).  No exploration matrices are drawn
        when ``policy_fn`` acts."""
        expl = (None if deterministic or policy_fn is not None
                else self._sample_expl(learner, ts, generator))
        states, obs0 = self.batch_reset(generator)
        obs = obs0
        dev = states.q.device
        done = torch.zeros(self.n_envs, dtype=torch.bool, device=dev)
        ep_len = torch.zeros(self.n_envs, dtype=torch.int32, device=dev)
        traj, metrics = [], {}
        for _ in range(self.horizon):
            states, obs, done, ep_len, out = self.env_step(
                learner, ts, states, obs, done, ep_len, generator,
                deterministic, expl, policy_fn)
            traj.append(out)
            if update_fn is not None:
                ts, metrics = update_fn(ts, buf, generator)
        tr = {k: torch.stack([o[k] for o in traj], 1) for k in traj[0]}
        episodes = dict(
            obs=torch.cat([obs0["observation"][:, None], tr["obs"]], 1),
            achieved=torch.cat([obs0["achieved_goal"][:, None],
                                tr["achieved"]], 1),
            desired=obs0["desired_goal"], action=tr["action"], aux=tr["aux"],
            ep_len=ep_len, terminated=tr["terminated"])
        stats = dict(success=tr["success"].any(1).float(),
                     collided=tr["collided"].any(1).float(),
                     ep_reward=tr["reward"].sum(1),
                     ep_len=ep_len.float())
        return episodes, stats, ts, metrics


# ---------------------------------------------------------------------------


def learner_batch(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A HER sample as the learner's batch: x and x2 flattened as flat_x
    flattens an observation."""
    return dict(x=torch.cat([b["achieved"], b["goal"], b["obs"]], -1),
                x2=torch.cat([b["achieved_next"], b["goal"], b["next_obs"]],
                             -1),
                action=b["action"], reward=b["reward"],
                terminated=b["terminated"].float())


def reject_on_policy(algorithm: str):
    """PPO is on-policy: rl/ppo.py's train_ppo drives it.  The off-policy
    trainers would feed it HER replay batches it cannot consume, and the
    reference never wires PPO into its dispatch (train.py:303-308)."""
    if algorithm == "PPO":
        raise ValueError(
            "PPO is on-policy: use rl/ppo.py::train_ppo (the off-policy "
            "trainers would feed it HER replay batches it cannot consume; "
            "the reference never wires PPO into its dispatch either, "
            "setup_training.py:100-115)")


@dataclass(frozen=True)
class Schedule:
    """The update schedule of one stage (train.py:317-366, 480-490)."""

    capacity: int             # replay capacity in episodes
    batch_size: int
    updates_per_rollout: int  # one burst after a collect rollout
    n_upd_per_step: int       # the burst after each env step when fused
    interleave_min: int       # transitions stored before fused bursts
    learning_starts: int      # stage steps before the first update


def schedule(cfg: TrainConfig, horizon: int) -> Schedule:
    hp = cfg.hyperparams
    # replay capacity does not scale with n_envs (a reference behaviour,
    # ROADMAP §3)
    capacity = max(getattr(hp, "buffer_size", 300_000) // max(horizon, 1),
                   cfg.n_envs)
    batch_size = cfg.update_batch_size or getattr(hp, "batch_size", 256)
    # update-to-data ratio: SB3's TQC preset (train_freq=8 vec-steps of 8
    # envs, gradient_steps=8) performs 8 updates per 64 transitions =
    # 0.125 updates/transition, independent of n_envs; cfg.utd overrides
    utd = cfg.utd
    if utd is None:
        utd = getattr(hp, "gradient_steps", 8) / (
            max(getattr(hp, "train_freq", 8), 1) * 8.0)
    n_upd_per_step = max(int(round(utd * cfg.n_envs)), 1)
    interleave_min = cfg.interleave_min_buffer
    if interleave_min is None:
        # gate until the buffer holds >= 8 fused bursts' worth of samples
        # (ADVICE r4: the n_envs=512 resume collapse)
        interleave_min = max(2 * cfg.learning_starts, 20_000,
                             8 * n_upd_per_step * batch_size)
    return Schedule(
        capacity=capacity, batch_size=batch_size,
        updates_per_rollout=max(int(utd * cfg.n_envs * horizon), 1),
        n_upd_per_step=n_upd_per_step, interleave_min=interleave_min,
        learning_starts=min(cfg.learning_starts, cfg.max_timesteps // 4))


@dataclass
class TrainerMetrics:
    history: List[Dict] = field(default_factory=list)

    def log(self, row: Dict):
        self.history.append(row)


class Trainer:
    """learn()/train_model() equivalent (setup_training.py:182-307)."""

    def __init__(self, config: TrainConfig,
                 make_env: Callable[[str, float, float], RobotTaskEnv],
                 logger=None):
        self.config = config
        self.make_env = make_env
        self.logger = logger
        self.metrics = TrainerMetrics()
        self.learner = None
        self.ts = None
        self.buffer = None
        self.generator = None
        self.timesteps = 0
        self._seed = config.seed
        self._best_eval_success = -1.0
        self._stage_index = 0
        self._resume = None       # pending full-state payload (load_full)
        self._loaded = None       # pending learner state (load)

    # -------------------------------------------------------------- stages
    def learn(self, seed: Optional[int] = None):
        cfg = self.config
        self._seed = cfg.seed if seed is None else seed
        self.generator = None
        n_stages = len(cfg.stages)
        # full-state resume: skip completed stages; the generator's saved
        # state continues the uninterrupted run's stream
        start_stage = self._resume["stage_index"] if self._resume else 0
        for i, stage in enumerate(cfg.stages):
            if i < start_stage:
                continue
            ee_thr = cfg.ee_error_thresholds[i]
            sp_thr = (cfg.speed_thresholds[i] if cfg.goal_condition == "halt"
                      else 0.5)
            horizon = cfg.max_ep_steps[min(i, len(cfg.max_ep_steps) - 1)]
            self._stage_index = i
            reached = self.train_stage(stage, horizon, ee_thr, sp_thr,
                                       cfg.success_thresholds[i],
                                       final=(i == n_stages - 1))
            print(f"[stage {stage}] done (threshold reached: {reached}); "
                  f"timesteps so far: {self.timesteps}")
            # per-stage learner snapshot (setup_training.py:299 model.save)
            run_dir = getattr(self.logger, "dir", None)
            if run_dir:
                self.save(os.path.join(run_dir,
                                       f"model_{stage_tag(stage)}_{i}.ckpt"))
        return self.ts

    def _ensure_learner(self, venv: VectorEnv, capacity: int):
        cfg = self.config
        dev = venv.core.device
        reject_on_policy(cfg.algorithm)
        if self.learner is None:
            self.learner = make_learner(cfg.algorithm, venv.x_dim,
                                        venv.act_dim, cfg.hyperparams, dev)
            if self._loaded is None:
                self.ts = self.learner.init(self.generator)
            else:
                # a template from a generator of its own, so that the run's
                # stream does not depend on whether the learner was loaded
                self.ts = self.learner.init(
                    torch.Generator(device=dev).manual_seed(0))
                load_state(self.ts, self._loaded, "learner")
                self._loaded = None
        if self.buffer is not None and self.buffer.device != dev:
            self.buffer = self.buffer.to(dev)
        if self.buffer is None or self.buffer.ep_horizon < venv.horizon:
            self.buffer = her.create(capacity, venv.horizon, venv.obs_dim,
                                     venv.goal_dim, venv.act_dim,
                                     venv.aux_dim, dev)

    def update_burst(self, ts, buf, generator, n: int, batch_size: int,
                     reward_fn):
        """n updates, each on a fresh HER batch; returns (ts, the last
        update's metrics)."""
        learner = self.learner
        m = {}
        for _ in range(n):
            batch = learner_batch(her.sample(buf, generator, batch_size,
                                             reward_fn))
            ts, m = learner.update(ts, batch,
                                   learner.update_noise(generator, batch_size))
        return ts, m

    def train_stage(self, scenario: str, horizon: int, ee_thr: float,
                    sp_thr: float, success_threshold: float,
                    final: bool = False) -> bool:
        cfg = self.config
        core = self.make_env(scenario, ee_thr, sp_thr)
        if self.generator is None:
            self.generator = torch.Generator(
                device=core.device).manual_seed(self._seed)
        gen = self.generator
        venv = VectorEnv(core, cfg.n_envs, horizon)
        self._best_eval_success = -1.0  # per-stage, like the per-stage EvalCallback
        sched = schedule(cfg, horizon)
        self._ensure_learner(venv, sched.capacity)
        learner = self.learner
        reward_fn = self._reward_fn(core)

        stage_steps = 0
        learning_started = False
        if self._resume is not None:
            # restore the mid-stage position: counters, the generator, and
            # the learner and buffer tensors checked against the templates
            # built from the current config
            r, self._resume = self._resume, None
            stage_steps = int(r["stage_steps"])
            learning_started = bool(r["learning_started"])
            self._best_eval_success = float(r["best_eval_success"])
            gen.set_state(r["generator"])
            load_state(self.ts, r["ts"], "learner")
            if r.get("buffer") is not None:
                self.buffer = her.load_state(self.buffer, r["buffer"])

        # Final stage: per-scene benchmark eval envs with best-model
        # snapshots (setup_training.py:255-290)
        bench_venvs = {}
        bench_best: Dict[str, float] = {}
        if final and cfg.benchmark_eval_scenes:
            for scene in cfg.benchmark_eval_scenes:
                bench_venvs[scene] = VectorEnv(
                    self.make_env(scene, ee_thr, sp_thr), cfg.n_envs, horizon)
                bench_best[scene] = -1.0

        # the NEO prior bootstrap before any learning (setup_training.py:
        # 219-222 -> imitation_learning.py:6-56): whenever the buffer holds
        # nothing yet, fresh runs and resumes without a buffer alike
        if cfg.prior_steps > 0 and self.buffer.n_stored == 0:
            n_roll = max(1, -(-cfg.prior_steps // (cfg.n_envs * horizon)))
            self.buffer, _ = fill_buffer_with_prior(venv, self.buffer, gen,
                                                    n_rollouts=n_roll)

        def step_update(ts, buf, generator):
            return self.update_burst(ts, buf, generator, sched.n_upd_per_step,
                                     sched.batch_size, reward_fn)

        interleave = cfg.interleave_updates
        full_freq = cfg.full_ckpt_freq
        t_start = time.time()
        # buffer-fill gate for interleaved bursts (train.py:476-503): until
        # the buffer holds enough transitions, collect + one end-of-rollout
        # burst; it latches once open
        gate_open = False

        def buffer_filled():
            nonlocal gate_open
            if not gate_open:
                # a full episode ring opens it too
                gate_open = (
                    self.buffer.n_stored >= self.buffer.capacity
                    or int(self.buffer.ep_len.sum()) >= sched.interleave_min)
            return gate_open

        while stage_steps < cfg.max_timesteps:
            t_c = time.time()
            m = {}
            t_u = 0.0
            did_interleave = False
            if learning_started and interleave and buffer_filled():
                self.ts, self.buffer, stats, m = venv.rollout_train(
                    learner, self.ts, self.buffer, gen, step_update)
                m = {k: float(v) for k, v in m.items()}
                did_interleave = True
            else:
                episodes, stats = venv.rollout_episode(learner, self.ts, gen)
                self.buffer = her.add_episodes(self.buffer, **episodes)
            rollout_steps = int(stats["ep_len"].sum())
            t_c = time.time() - t_c
            stage_steps += rollout_steps
            self.timesteps += rollout_steps

            if (not learning_started
                    and stage_steps >= sched.learning_starts):
                learning_started = True
            if learning_started and not did_interleave:
                t_u = time.time()
                self.ts, m = self.update_burst(
                    self.ts, self.buffer, gen, sched.updates_per_rollout,
                    sched.batch_size, reward_fn)
                m = {k: float(v) for k, v in m.items()}
                t_u = time.time() - t_u

            row = dict(
                scenario=scenario, timesteps=self.timesteps,
                stage_steps=stage_steps,
                rollout_success=float(stats["success"].mean()),
                rollout_collided=float(stats["collided"].mean()),
                rollout_reward=float(stats["ep_reward"].mean()),
                sps=self.timesteps / max(time.time() - t_start, 1e-9),
                t_collect=round(t_c, 4), t_update=round(t_u, 4),
                **m)
            self.metrics.log(row)
            if self.logger is not None:
                self.logger.log(row)

            # eval + stop-on-success-threshold (EvalSuccessCallback /
            # StopTrainingOnSuccessThreshold equivalents)
            if (learning_started
                    and stage_steps % max(cfg.eval_freq, 1) < rollout_steps):
                sr = self.evaluate(venv, gen, n_episodes=cfg.n_eval_episodes)
                self.metrics.log(dict(scenario=scenario, eval_success=sr,
                                      timesteps=self.timesteps))
                if self.logger is not None:
                    self.logger.log(dict(eval_success=sr,
                                         timesteps=self.timesteps))
                # best_model.ckpt on the stage's own scenario, the artifact
                # the reference's EvalCallback keeps as best_model.zip
                # (setup_training.py:277-279)
                run_dir = getattr(self.logger, "dir", None)
                if run_dir and sr > self._best_eval_success:
                    self._best_eval_success = sr
                    self.save(os.path.join(run_dir, "best_model.ckpt"))
                for scene, bvenv in bench_venvs.items():
                    bsr = self.evaluate(bvenv, gen,
                                        n_episodes=cfg.n_eval_episodes)
                    row = {f"{scene}_eval_success": bsr,
                           "timesteps": self.timesteps}
                    self.metrics.log(dict(row, scenario=scenario))
                    if self.logger is not None:
                        self.logger.log(row)
                    if bsr > bench_best[scene] and run_dir:
                        bench_best[scene] = bsr
                        self.save(os.path.join(run_dir,
                                               f"best_model_{scene}.ckpt"))
                if sr >= success_threshold and not final:
                    return True

            # periodic full-training-state checkpoint, at the end of a loop
            # iteration, so resume continues with exactly the next rollout
            # the uninterrupted run would have collected
            if full_freq and stage_steps % full_freq < rollout_steps:
                run_dir = getattr(self.logger, "dir", None)
                if run_dir:
                    self._write_full_state(run_dir, stage_steps,
                                           learning_started)
        return False

    def _write_full_state(self, run_dir: str, stage_steps: int,
                          learning_started: bool) -> str:
        """Learner + buffer + generator state + counters, rolling (keep=2):
        everything a kill and resume needs to reproduce the uninterrupted
        run."""
        mgr = CheckpointManager(os.path.join(run_dir, "full_state"), keep=2)
        payload = {
            "algorithm": self.config.algorithm,
            "timesteps": self.timesteps,
            "stage_index": self._stage_index,
            "stage_steps": stage_steps,
            "learning_started": learning_started,
            "best_eval_success": self._best_eval_success,
            "generator": self.generator.get_state(),
            "ts": save_state(self.ts),
            "buffer": None if self.buffer is None else her.save_state(
                self.buffer),
        }
        return mgr.save(self.timesteps, payload)

    def load_full(self, path: str):
        """Resume from a full-state checkpoint written by _write_full_state
        (a ``ckpt_<step>`` file or the ``full_state`` directory, whose
        newest is taken).  learn() then skips to the saved stage and
        continues mid-stage.  Final-stage per-scene high-water marks are not
        kept (best_model_<scene>.ckpt snapshots may re-save)."""
        if os.path.isdir(path):
            latest = CheckpointManager(path).latest()
            if latest is None:
                raise FileNotFoundError(f"no ckpt_<step> under {path}")
            path = latest
        payload = load_checkpoint(path)
        if payload.get("algorithm") != self.config.algorithm:
            raise ValueError(
                f"checkpoint algorithm {payload.get('algorithm')!r} != "
                f"config {self.config.algorithm!r}")
        self.timesteps = int(payload["timesteps"])
        self._resume = payload

    def _reward_fn(self, core):
        def fn(achieved_next, goal, aux):
            return core.task.reward_from_aux(core, achieved_next, goal, aux)
        return fn

    # ------------------------------------------------------------- eval
    def evaluate(self, venv: VectorEnv, generator,
                 n_episodes: int = 100) -> float:
        rounds = max(1, math.ceil(n_episodes / venv.n_envs))
        succ = []
        for _ in range(rounds):
            _, stats = venv.rollout_episode(self.learner, self.ts, generator,
                                            deterministic=True)
            succ.append(stats["success"])
        return float(torch.cat(succ)[:n_episodes].mean())

    # ------------------------------------------------------------- ckpt
    def save(self, path: str, include_buffer: bool = False):
        """Checkpoint for resume (continue_learning, setup_training.py:
        383-422): learner state + step counter, optionally the full replay
        buffer."""
        payload = {"ts": save_state(self.ts), "timesteps": self.timesteps,
                   "algorithm": self.config.algorithm}
        if include_buffer and self.buffer is not None:
            payload["buffer"] = her.save_state(self.buffer)
        save_checkpoint(path, payload)

    def load(self, path: str, restore_buffer: bool = True):
        """restore_buffer=False starts fine-tuning with fresh replay, what
        the reference's continue_learning effectively does (its buffer
        reload is commented out, setup_training.py:80-82)."""
        payload = load_checkpoint(path)
        self.timesteps = int(payload.get("timesteps", 0))
        if self.learner is None:
            # pre-gSDE checkpoints carry the legacy Gaussian actor even
            # under use_sde=True configs: build the matching actor
            if self.config.algorithm in ("SAC", "TQC", "TQC_v2"):
                align_sde_with_ckpt(self.config.hyperparams, payload["ts"])
            self._loaded = payload["ts"]
        else:
            load_state(self.ts, payload["ts"], "learner")
        if restore_buffer and "buffer" in payload:
            self.buffer = her.from_state(payload["buffer"])

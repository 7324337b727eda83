"""Evaluation harness: batched policy benchmarking over scenarios (port of
panda_gym_tpu/eval/benchmark.py).

N-episode evaluation collecting success / collision / timeout rates,
episode lengths, effort, jerk, manipulability and EE-speed statistics, the
reference's results schema (evaluate.py:286-300): all episodes of a
scenario run as one batch, every step through the env core's
``batched_step`` (on the card, K1).  The per-step metrics stay on the
device and are read once per scenario.

Ensembles: a list of train states for one learner; per step the members'
actions are fused with the strategies of eval/ensemble.py
(evaluate.py:174-211).  The NEO prior strategies ("prior", "bcf") wait for
ROADMAP item 12.
"""
from __future__ import annotations

import csv
import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import _hi_prec
from panda_gym_tpu_torch.eval import ensemble as fusion
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.rl.networks import flatten_obs

BENCHMARK_SCENARIOS = [
    # benchmark_model's exact scenario list (setup_training.py:337-350)
    "reachao1", "reachao2", "reachao3", "wangexp-3", "reachao_rand",
    "reachao_rand_start", "library1", "library2", "narrow_tunnel",
    "tunnel", "workshop", "industrial", "wall",
]

# the step loop reads whether every episode has ended (a host sync) once
# every this many steps; past that point every metric is masked to zero,
# so stopping there leaves the results as they are
DONE_CHECK_EVERY = 10

STRATEGIES = (None, "mean", "confidence", "weighted_aggregation",
              "bayesian_fusion", "prior", "bcf")


def make_policy(learner, ts_list: Sequence, strategy: Optional[str] = None):
    """x -> action: the members' deterministic actions (K, B, A) and stds
    (learner.act_with_std) fused by ``strategy`` (evaluate.py:174-211)."""
    if strategy in ("prior", "bcf"):
        raise NotImplementedError(
            f"strategy {strategy!r} needs the NEO prior (ops/neo.py), not "
            "ported yet (ROADMAP item 12)")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy}")
    if not ts_list:
        raise ValueError("no learner checkpoints to evaluate")

    def policy(x):
        pairs = [learner.act_with_std(ts, x) for ts in ts_list]
        means = torch.stack([m for m, _ in pairs])
        var = torch.stack([s for _, s in pairs]) ** 2
        if strategy in (None, "mean"):
            return fusion.mean(means)
        if strategy == "weighted_aggregation":
            return fusion.weighted_aggregation(var, means)
        if strategy == "bayesian_fusion":
            return fusion.bayesian_fusion(means, var)
        return fusion.confidence(means, var)[0]

    return policy


@_hi_prec
def _step_metrics(core, states, reward, info, done):
    """One step's metrics of every episode, zero for those already done
    (benchmark.py:99-126)."""
    model = core.model
    fk = K.fk_world(model, states.q, states.qd)
    active = (~done).float()
    return dict(
        effort=torch.linalg.vector_norm(states.cur_jacc, dim=-1) * active,
        jerk=torch.linalg.vector_norm(states.cur_jerk, dim=-1) * active,
        manip=K.manipulability(model, core.robot.ee_site, states.q) * active,
        ee_speed=torch.linalg.vector_norm(core.robot.ee_velocity(fk),
                                          dim=-1) * active,
        reward=torch.where(done, 0.0, reward),
        success=info["is_success"] & ~done,
        collided=info["is_truncated"] & ~done,
        active=active)


@torch.no_grad()
def run_episodes(core, policy: Callable, states, obs, horizon: int):
    """Step every episode from the given states and observations for up to
    ``horizon`` steps; an episode that terminates or truncates keeps its
    last state.  Returns (done (B,), ep_len (B,), metrics: name -> (T, B)
    per-step tensors on the device), T <= horizon: the loop stops once
    every episode has ended (checked every DONE_CHECK_EVERY steps)."""
    B = states.batch_size
    done = torch.zeros(B, dtype=torch.bool, device=core.device)
    ep_len = torch.zeros(B, dtype=torch.int32, device=core.device)
    rows = []
    for t in range(horizon):
        if t and t % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        nstates, nobs, reward, term, trunc, info = core.batched_step(
            states, policy(flatten_obs(obs)))
        states = states.replace(**{
            k: torch.where(done.reshape((-1,) + (1,) * (v.dim() - 1)),
                           getattr(states, k), v)
            for k, v in ((k, getattr(nstates, k))
                         for k in states.__dataclass_fields__)})
        obs = {k: torch.where(done[:, None], obs[k], v)
               for k, v in nobs.items()}
        ep_len = ep_len + (~done).int()
        rows.append(_step_metrics(core, states, reward, info, done))
        done = done | term | trunc
    return done, ep_len, {k: torch.stack([r[k] for r in rows])
                          for k in rows[0]}


def summarize(ep_len, metrics, n_substeps: int) -> Dict[str, float]:
    """The reference's results schema (evaluate.py:286-300) from
    run_episodes' outputs, read to the host here."""
    m = {k: v.cpu().numpy() for k, v in metrics.items()}
    ep_len = ep_len.cpu().numpy()
    n_episodes = len(ep_len)
    success_ep = m["success"].any(axis=0)
    collided_ep = m["collided"].any(axis=0) & ~success_ep
    timeout_ep = ~success_ep & ~collided_ep
    steps_total = m["active"].sum()

    def per_step_mean(x):
        return float(np.sum(x) / max(steps_total, 1))

    return {
        "scenario_episodes": int(n_episodes),
        "success_rate": float(success_ep.mean()),
        "collision_rate": float(collided_ep.mean()),
        "timeout_rate": float(timeout_ep.mean()),
        "mean_ep_length": float(ep_len.mean()),
        "mean_num_sim_steps": float(ep_len.mean() * n_substeps),
        "mean_effort": per_step_mean(m["effort"]),
        "mean_jerk": per_step_mean(m["jerk"]),
        "mean_manipulability": per_step_mean(m["manip"]),
        "mean_ee_speed": per_step_mean(m["ee_speed"]),
        "mean_reward": float(m["reward"].sum() / n_episodes),
    }


def perform_benchmark(learner, ts_list: Sequence, core,
                      n_episodes: int = 100, horizon: int = 300,
                      strategy: Optional[str] = None,
                      seed: int = 0) -> Dict[str, float]:
    """Batched evaluation of ``n_episodes`` episodes reset from ``seed``;
    returns the reference's results schema."""
    policy = make_policy(learner, ts_list, strategy)
    gen = torch.Generator(device=core.device).manual_seed(seed)
    states, obs = core.batched_reset(n_episodes, gen)
    _, ep_len, m = run_episodes(core, policy, states, obs, horizon)
    return summarize(ep_len, m, core.n_substeps)


def evaluate_scenarios(learner, ts_list, make_core: Callable[[str], object],
                       scenarios: Sequence[str], n_episodes: int = 100,
                       horizon: int = 300, strategy: Optional[str] = None,
                       seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Benchmark over the reference's scenario table
    (setup_training.py:334-381 benchmark_model / evaluate.py:361-379)."""
    return {sc: perform_benchmark(learner, ts_list, make_core(sc),
                                  n_episodes=n_episodes, horizon=horizon,
                                  strategy=strategy, seed=seed)
            for sc in scenarios}


def display_and_save_benchmark_results(results: Dict[str, Dict], path: str):
    """Print the table and write <path>.csv and <path>.json
    (evaluate.py:386-403).  The CSV is the JAX package's: a row per
    scenario, a column per metric, every value a float."""
    cols = list(next(iter(results.values())))
    rows = [[sc] + [float(r[c]) for c in cols] for sc, r in results.items()]
    width = max(len(sc) for sc in results)
    print(" " * width + "".join(f" {c:>20s}" for c in cols))
    for row in rows:
        print(f"{row[0]:>{width}s}" + "".join(f" {v:20.6g}" for v in row[1:]))
    with open(path + ".csv", "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        w.writerows(rows)
    with open(path + ".json", "w") as f:
        json.dump(results, f, indent=1)
    return rows

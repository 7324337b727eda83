"""Hyperparameter sweeps (port of panda_gym_tpu/rl/sweep.py, whose search
space and samplers are pure numpy; copied so that the port reads nothing of
the JAX package).

The reference runs W&B Bayesian HPO over TQC hyperparameters + env params
(tau, gamma, batch_size, n_substeps, collision_reward, net_arch, ...).
This is the local, dependency-free counterpart: declarative search-space
specs, random / grid / quasi-random (Halton) samplers, and a sweep runner
that trains each configuration and scores it (default: env steps to reach
the success threshold — the reference's `global_step: minimize` metric).
Results stream to JSONL.  ``tqc_reach_ao_objective`` trains with the
port's Trainer, on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import itertools
import json
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


# --------------------------------------------------------------------------
# search-space spec (mirrors the wandb sweep yaml `parameters:` block)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float
    log: bool = False

    def sample(self, u: float):
        if self.log:
            return float(math.exp(math.log(self.lo) +
                                  u * (math.log(self.hi) - math.log(self.lo))))
        return float(self.lo + u * (self.hi - self.lo))


@dataclass(frozen=True)
class IntUniform:
    lo: int
    hi: int

    def sample(self, u: float):
        return int(self.lo + u * (self.hi - self.lo + 0.999999))


@dataclass(frozen=True)
class Categorical:
    values: Sequence[Any]

    def sample(self, u: float):
        return self.values[min(int(u * len(self.values)), len(self.values) - 1)]


# the reference's TQC sweep space (wandb_sweep_config.yaml:7-76), minus the
# constant categoricals that only exist to satisfy W&B
DEFAULT_TQC_SPACE: Dict[str, Any] = {
    "tau": Uniform(0.005, 0.04),
    "gamma": Uniform(0.49, 0.99),
    "batch_size": IntUniform(64, 512),
    "n_substeps": IntUniform(2, 50),
    "train_freq": IntUniform(4, 8),
    "buffer_size": IntUniform(150_000, 1_000_000),
    "learning_rate": Uniform(3.5e-4, 3e-3, log=True),
    "use_sde": Categorical((True, False)),
    "net_arch": Categorical(((256, 256), (400, 300), (256, 256, 256))),
    "collision_reward": IntUniform(-500, -25),
}


def _halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def sample_configs(space: Dict[str, Any], n: int, method: str = "halton",
                   seed: int = 0) -> List[Dict[str, Any]]:
    """Draw n configurations: 'random', 'halton' (quasi-random, good
    low-budget coverage), or 'grid' (cartesian over categoricals + 3-point
    quantiles of continuous dims)."""
    names = list(space)
    if method == "grid":
        axes = []
        for k in names:
            d = space[k]
            if isinstance(d, Categorical):
                axes.append(list(d.values))
            else:
                axes.append([d.sample(u) for u in (0.0, 0.5, 1.0)])
        combos = list(itertools.product(*axes))[:n]
        return [dict(zip(names, c)) for c in combos]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cfg = {}
        for j, k in enumerate(names):
            if method == "halton":
                u = _halton(i + 1, _PRIMES[j % len(_PRIMES)])
            else:
                u = float(rng.uniform())
            cfg[k] = space[k].sample(u)
        out.append(cfg)
    return out


# --------------------------------------------------------------------------
# sweep runner
# --------------------------------------------------------------------------

def run_sweep(
    train_and_score: Callable[[Dict[str, Any], int], Dict[str, float]],
    space: Optional[Dict[str, Any]] = None,
    n_trials: int = 20,
    method: str = "halton",
    seed: int = 0,
    out_path: str = "sweep_results.jsonl",
    minimize: str = "global_step",
) -> List[Dict[str, Any]]:
    """Run a sweep: `train_and_score(config, trial_seed) -> metrics dict`
    must contain the `minimize` key (steps-to-threshold by convention;
    inf/nan = failed trial). Returns trials sorted best-first."""
    space = space or DEFAULT_TQC_SPACE
    configs = sample_configs(space, n_trials, method, seed)
    trials = []
    with open(out_path, "a") as f:
        for i, cfg in enumerate(configs):
            t0 = time.time()
            try:
                metrics = train_and_score(cfg, seed + i)
            except Exception as e:  # a diverged trial must not kill the sweep
                metrics = {minimize: float("inf"), "error": repr(e)}
            row = {"trial": i, "config": cfg, "metrics": metrics,
                   "wall_s": round(time.time() - t0, 1)}
            trials.append(row)
            f.write(json.dumps(row, default=str) + "\n")
            f.flush()
    key = lambda r: r["metrics"].get(minimize, float("inf"))
    return sorted(trials, key=lambda r: (math.isnan(_f(key(r))), _f(key(r))))


def _f(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return float("inf")


def tqc_reach_ao_objective(scenario: str = "wangexp_3", n_envs: int = 256,
                           max_steps: int = 200_000,
                           success_threshold: float = 0.9, device="cuda"):
    """Build a train_and_score closure for the reference's sweep target:
    minimize env steps until eval success-rate >= threshold on ReachAO."""
    def train_and_score(cfg: Dict[str, Any], trial_seed: int):
        from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
        from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
        from panda_gym_tpu_torch.rl.train import Trainer

        hp = Hyperparameters("TQC")
        for k in ("tau", "gamma", "batch_size", "train_freq", "buffer_size",
                  "learning_rate", "use_sde"):
            if k in cfg:
                setattr(hp, k, cfg[k])
        if "net_arch" in cfg:
            hp.policy_kwargs = dict(hp.policy_kwargs,
                                    net_arch=list(cfg["net_arch"]))
        config = TrainConfig(algorithm="TQC", n_envs=n_envs,
                             stages=[scenario], max_timesteps=max_steps,
                             success_thresholds=[success_threshold])
        if "n_substeps" in cfg:
            config.n_substeps = int(cfg["n_substeps"])
        if "collision_reward" in cfg:
            config.collision_reward = float(cfg["collision_reward"])
        config.hyperparams = hp
        trainer = Trainer(config, make_env=lambda sc, thr, spd:
                          make_reach_ao_core(sc, config=config,
                                             ee_error_threshold=thr,
                                             speed_threshold=spd,
                                             device=device))
        trainer.learn(seed=trial_seed)
        h = trainer.metrics.history
        reached = [r for r in h if r.get("eval_success", 0.0)
                   >= success_threshold and "timesteps" in r]
        global_step = (min(r["timesteps"] for r in reached)
                       if reached else float("inf"))
        last = h[-1] if h else {}
        return {"global_step": global_step,
                "final_success": last.get("eval_success", 0.0)}
    return train_and_score

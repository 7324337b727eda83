"""Evaluation entry point of the port, the counterpart of tools/evaluate.py
(evaluate_ensemble, evaluation/evaluate.py:319-403): load trained learners
from run dirs, benchmark them over the reference's scenario table,
optionally fusing an ensemble, and write the results table.

    # one run (its .ckpt, or its actor-only .policy.npz export)
    python -m panda_gym_tpu_torch.eval.cli training/run_data/<group>/<run>

    # an ensemble of runs with Bayesian fusion
    python -m panda_gym_tpu_torch.eval.cli run1 run2 --strategy bayesian_fusion

    # a routed policy, the counterpart of tools/build_router.py
    # --benchmark-only: per-scene part files merged into <out>/benchmark.json
    python -m panda_gym_tpu_torch.eval.cli \\
        --routed panda_gym_tpu_torch/assets/routed_gen/routed_policy.npz \\
        --scenarios reachao1 narrow_tunnel --out routed_benchmark

Evaluation runs on the card unless ``--device cpu`` is given; without a
card it raises.  A routed policy is evaluated under the ``config.json``
beside its file.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from panda_gym_tpu_torch.eval import benchmark as EB


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("runs", nargs="*", help="run dirs (ensemble if several)")
    p.add_argument("--routed", default=None, metavar="PATH",
                   help="a routed policy file (.npz) to evaluate in place "
                        "of run dirs")
    p.add_argument("--scenarios", nargs="+", default=None,
                   help="default: the reference's 13-scenario benchmark list")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--horizon", type=int, default=300)
    p.add_argument("--strategy", default=None, choices=EB.STRATEGIES,
                   help="ensemble fusion strategy (action_selection.py); "
                        "'prior' and 'bcf' wait for ROADMAP item 12")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output path prefix (default <first run>/benchmark); "
                        "with --routed an output directory (default "
                        "routed_benchmark)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs and the policy")
    return p.parse_args(argv)


def make_core_fn(cfg, device):
    """Scenario name -> env core under ``cfg`` at true collision: the
    training margin safety_distance is set to 0, as the reference
    evaluates (evaluate.py:361-379)."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core

    cfg.safety_distance = 0.0
    return lambda sc: make_reach_ao_core(
        scenario=sc, config=cfg,
        ee_error_threshold=cfg.ee_error_thresholds[-1],
        speed_threshold=cfg.speed_thresholds[-1], device=device)


def load_members(run_dirs, device):
    """(config, learner, train states) of the runs: each run's preferred
    checkpoint (a torch.save .ckpt, or an actor-only .policy.npz export),
    all on one learner, which must fit every member."""
    from panda_gym_tpu_torch.rl.checkpoint import load_checkpoint
    from panda_gym_tpu_torch.rl.learners import (ckpt_uses_sde, load_state,
                                                 make_learner)
    from panda_gym_tpu_torch.rl.logging_utils import load_run
    from panda_gym_tpu_torch.rl.policy_io import graft_actor, load_policy

    members, archs = [], []
    cfg = None
    for run_dir in run_dirs:
        cfg, ckpts = load_run(run_dir)
        if not ckpts:
            raise SystemExit(f"no checkpoints in {run_dir}")
        if ckpts[-1].endswith(".ckpt"):
            state = load_checkpoint(ckpts[-1])["ts"]
            members.append(("ckpt", state, ckpt_uses_sde(state)))
        else:
            actor, meta = load_policy(ckpts[-1])
            members.append(("npz", actor, bool(meta.get("use_sde", False))))
        pk = getattr(cfg.hyperparams, "policy_kwargs", None) or {}
        archs.append((run_dir, cfg.algorithm,
                      tuple(pk.get("net_arch", ()) or ()) or None,
                      members[-1][2]))
    # one learner serves every member: algorithm, net_arch and actor type
    # must agree
    if len({a[1:] for a in archs}) > 1:
        detail = "\n".join(f"  {d}: algorithm={a} net_arch={n} use_sde={s}"
                           for d, a, n, s in archs)
        raise SystemExit("ensemble members disagree on algorithm, net_arch "
                         f"or actor type; one learner cannot serve them "
                         f"all:\n{detail}")
    cfg.hyperparams.use_sde = members[0][2]
    probe = make_core_fn(cfg, device)("reachao1")
    _, obs = probe.batched_reset(1)
    x_dim = obs["observation"].shape[-1] + 2 * obs["achieved_goal"].shape[-1]
    learner = make_learner(cfg.algorithm, x_dim, probe.robot.action_dim,
                           cfg.hyperparams, device)
    ts_list = []
    for kind, payload, _ in members:
        ts = learner.init(torch.Generator(device=device).manual_seed(0))
        if kind == "ckpt":
            load_state(ts, payload)
        else:
            graft_actor(ts, payload)
        ts_list.append(ts)
    return cfg, learner, ts_list


def run_routed(args, device, scenarios):
    """tools/build_router.py --benchmark-only: one RoutedLearner over the
    routed policy, a part file per scene, merged into <out>/benchmark.json
    and .csv in the reference's scene order."""
    from panda_gym_tpu_torch.eval.router import (RoutedLearner,
                                                 load_routed_policy)
    from panda_gym_tpu_torch.rl.logging_utils import load_config

    policy, _ = load_routed_policy(args.routed, device)
    cfg = load_config(os.path.join(os.path.dirname(args.routed),
                                   "config.json"))
    make_core = make_core_fn(cfg, device)
    out = args.out or "routed_benchmark"
    parts = os.path.join(out, "benchmark_parts")
    os.makedirs(parts, exist_ok=True)
    learner = RoutedLearner()
    for sc in scenarios:
        t0 = time.perf_counter()
        res = EB.perform_benchmark(learner, [policy], make_core(sc),
                                   n_episodes=args.episodes,
                                   horizon=args.horizon, strategy=args.strategy,
                                   seed=args.seed)
        print(f"  {sc:>20s} success={res['success_rate']:.2f} "
              f"collision={res['collision_rate']:.2f} "
              f"mean_ep_length={res['mean_ep_length']:.2f} "
              f"wall={time.perf_counter() - t0:.1f}s", flush=True)
        # part files: calls over scenario subsets never clobber each other
        with open(os.path.join(parts, f"{sc}.json"), "w") as f:
            json.dump(res, f, indent=1)
    names = EB.BENCHMARK_SCENARIOS + sorted(
        f[:-5] for f in os.listdir(parts) if f.endswith(".json")
        and f[:-5] not in EB.BENCHMARK_SCENARIOS)
    results = {}
    for sc in names:
        pf = os.path.join(parts, f"{sc}.json")
        if os.path.exists(pf):
            with open(pf) as f:
                results[sc] = json.load(f)
    EB.display_and_save_benchmark_results(results,
                                          os.path.join(out, "benchmark"))
    mean = float(np.mean([r["success_rate"] for r in results.values()]))
    print(json.dumps({"routed_generalist_mean": round(mean, 4),
                      "scenes": len(results)}), flush=True)
    return results


def main(argv=None):
    args = parse_args(argv)
    if not args.runs and not args.routed:
        raise SystemExit("need at least one run dir, or --routed")
    from panda_gym_tpu_torch.envs.core import resolve_device

    device = resolve_device(args.device)
    scenarios = args.scenarios or EB.BENCHMARK_SCENARIOS
    if args.routed:
        return run_routed(args, device, scenarios)
    cfg, learner, ts_list = load_members(args.runs, device)
    results = EB.evaluate_scenarios(
        learner, ts_list, make_core=make_core_fn(cfg, device),
        scenarios=scenarios, n_episodes=args.episodes, horizon=args.horizon,
        strategy=args.strategy, seed=args.seed)
    EB.display_and_save_benchmark_results(
        results, args.out or os.path.join(args.runs[0], "benchmark"))
    return results


if __name__ == "__main__":
    main()

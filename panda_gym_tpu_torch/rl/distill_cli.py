"""Distill the routed generalist into ONE scene-blind network, the
counterpart of tools/distill_generalist.py (rl/distill.py).

    python -m panda_gym_tpu_torch.rl.distill_cli \\
        [--router panda_gym_tpu_torch/assets/routed_gen/routed_policy.npz] \\
        [--bc-episodes 128] [--dagger-rounds 3] [--dagger-episodes 64] \\
        [--steps 8000] [--out training/run_data/round5_campaign/distilled_gen]

Consumes a routed-policy file (eval/build_router.py: member pool and
per-scene controller masks), behaviour-clones the per-scene teachers into
one actor of the campaign's algorithm (``--net-arch`` wide), then runs
DAgger rounds on the student's own state distribution, benchmarking after
each round with the reference protocol (13 scenes x 100 episodes, horizon
300, setup_training.py:334-381).  The best round's student is saved as
the Trainer's checkpoint and exported as a .policy.npz: one network, no
router or ensemble at evaluation.  ``<out>`` is then a run directory the
eval CLI reads (its config.json carries the student's net_arch).

Options keep the tool's names and defaults.  The envs run under the
``config.json`` beside the routed file (``--config`` to name another);
``--scenarios`` cuts both the collection (default: every scene of the
router) and the benchmark (default: the 13 scenes) to a list, and
``--bench-horizon`` the benchmark's horizon.  Parts resume: each scene's
labelled data and each round's student and benchmark are written under
``<out>/data`` and read back when present.  Training runs on the card
unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

DEFAULT_ROUTER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "routed_gen", "routed_policy.npz")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--router", default=DEFAULT_ROUTER)
    p.add_argument("--config", default=None,
                   help="the envs' TrainConfig (default: config.json beside "
                        "the routed file)")
    p.add_argument("--out", default="training/run_data/round5_campaign/"
                                    "distilled_gen")
    p.add_argument("--bc-episodes", type=int, default=128)
    p.add_argument("--dagger-rounds", type=int, default=3)
    p.add_argument("--dagger-episodes", type=int, default=64)
    p.add_argument("--horizon", type=int, default=300)
    p.add_argument("--drive-noise", type=float, default=0.3,
                   help="DART-style Gaussian noise on the teacher's DRIVING "
                        "action during BC collection (labels stay "
                        "noiseless); 0 disables")
    p.add_argument("--steps", type=int, default=8000,
                   help="gradient steps per training round")
    p.add_argument("--net-arch", nargs="+", type=int, default=[512, 512],
                   help="student MLP widths")
    p.add_argument("--episodes", type=int, default=100,
                   help="benchmark episodes per scene")
    p.add_argument("--bench-horizon", type=int, default=300)
    p.add_argument("--scenarios", nargs="+", default=None,
                   help="collect and benchmark on these scenes only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, teachers and student")
    return p.parse_args(argv)


def flatten_balanced(rounds, scenes):
    """Concat rounds of per-scene (X, A) with per-sample weights that
    balance scenes (early-terminating scenes yield fewer steps)."""
    Xs, As, scene_ids = [], [], []
    for data in rounds:
        for i, sc in enumerate(scenes):
            if sc in data:
                X, A = data[sc]
                Xs.append(X)
                As.append(A)
                scene_ids.append(np.full(len(X), i))
    X, A = np.concatenate(Xs), np.concatenate(As)
    sid = np.concatenate(scene_ids)
    counts = np.bincount(sid, minlength=len(scenes))
    return X, A, 1.0 / np.maximum(counts, 1)[sid]


def main(argv=None):
    args = parse_args(argv)

    from panda_gym_tpu_torch.envs.core import resolve_device
    from panda_gym_tpu_torch.eval.benchmark import (
        BENCHMARK_SCENARIOS, display_and_save_benchmark_results,
        perform_benchmark)
    from panda_gym_tpu_torch.eval.cli import make_core_fn
    from panda_gym_tpu_torch.eval.router import load_routed_policy
    from panda_gym_tpu_torch.rl.checkpoint import save_checkpoint
    from panda_gym_tpu_torch.rl.config import Hyperparameters
    from panda_gym_tpu_torch.rl.distill import (bc_train, collect_labeled,
                                                init_student,
                                                student_as_trainstate)
    from panda_gym_tpu_torch.rl.learners import make_learner, save_state
    from panda_gym_tpu_torch.rl.logging_utils import load_config, write_config
    from panda_gym_tpu_torch.rl.networks import load_flax, to_flax
    from panda_gym_tpu_torch.rl.policy_io import export_policy

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    policy, meta = load_routed_policy(args.router, device)
    scene_to_ctrl = meta["scene_to_controller"]
    ctrl_names = list(meta["controllers"])
    collect_scenes = args.scenarios or list(scene_to_ctrl)
    bench_scenes = args.scenarios or BENCHMARK_SCENARIOS
    print(f"router file: {len(policy.members)} members, "
          f"{len(ctrl_names)} controllers")

    cfg = load_config(args.config or os.path.join(
        os.path.dirname(args.router), "config.json"))
    # the pool's actor graph (build_router records which)
    cfg.hyperparams.use_sde = bool(meta.get("use_sde", False))
    # the STUDENT gets its own width
    student_hp = Hyperparameters(cfg.algorithm)
    student_hp.use_sde = cfg.hyperparams.use_sde
    student_hp.policy_kwargs = dict(student_hp.policy_kwargs,
                                    net_arch=list(args.net_arch))

    cores = {}
    build = make_core_fn(cfg, device)

    def make_core(sc):
        if sc not in cores:
            cores[sc] = build(sc)
        return cores[sc]

    _, obs = make_core(collect_scenes[0]).batched_reset(1)
    x_dim = obs["observation"].shape[-1] + 2 * obs["achieved_goal"].shape[-1]
    act_dim = make_core(collect_scenes[0]).robot.action_dim
    student_learner = make_learner(cfg.algorithm, x_dim, act_dim, student_hp,
                                   device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data_dir = os.path.join(args.out, "data")
    os.makedirs(data_dir, exist_ok=True)

    def gather(student, n_episodes, drive_noise, tag):
        """One labelled pass over the scenes: per-scene (X, A) of the
        active steps, persisted to <out>/data/<tag>_<scene>.npz and read
        back on resume."""
        data = {}
        for sc in collect_scenes:
            part = os.path.join(data_dir, f"{tag}_{sc}.npz")
            if os.path.exists(part):
                with np.load(part) as z:
                    data[sc] = (z["X"], z["A"])
                print(f"  collect[{tag}] {sc:>20s}: {len(data[sc][0]):7d} "
                      f"labeled (resumed)", flush=True)
                continue
            mask = policy.masks[ctrl_names.index(scene_to_ctrl[sc])]
            t0 = time.time()
            X, A, act = collect_labeled(make_core(sc), policy.members, mask,
                                        n_episodes, args.horizon, gen,
                                        student=student,
                                        drive_noise=drive_noise)
            m = act.reshape(-1)
            X = X.reshape(-1, x_dim)[m].cpu().numpy().astype(np.float32)
            A = A.reshape(-1, A.shape[-1])[m].cpu().numpy().astype(
                np.float32)
            np.savez_compressed(part, X=X, A=A)
            data[sc] = (X, A)
            print(f"  collect[{tag}] {sc:>20s}: {len(X):7d} labeled "
                  f"({time.time() - t0:.1f}s)", flush=True)
        return data

    def benchmark(student, tag):
        ts = student_as_trainstate(student_learner, student)
        cache = os.path.join(data_dir, f"bench_{tag}.json")
        results = {}
        if os.path.exists(cache):
            with open(cache) as f:
                results = json.load(f)
        for sc in bench_scenes:
            if sc in results:
                continue
            res = perform_benchmark(student_learner, [ts], make_core(sc),
                                    n_episodes=args.episodes,
                                    horizon=args.bench_horizon,
                                    seed=args.seed)
            results[sc] = res
            with open(cache, "w") as f:
                json.dump(results, f, indent=1)
            print(f"  bench[{tag}] {sc:>20s} "
                  f"success={res['success_rate']:.2f} "
                  f"collision={res['collision_rate']:.2f}", flush=True)
        mean = float(np.mean([r["success_rate"] for r in results.values()]))
        print(json.dumps({f"distilled_mean_{tag}": round(mean, 4),
                          "scenes": len(results)}), flush=True)
        return results, mean

    def save_student(actor, tag):
        np.savez_compressed(os.path.join(data_dir, f"student_{tag}.npz"),
                            **to_flax(actor))

    def load_student(tag):
        path = os.path.join(data_dir, f"student_{tag}.npz")
        if not os.path.exists(path):
            return None
        actor = init_student(student_learner, torch.Generator(
            device=device).manual_seed(0))
        with np.load(path) as z:
            load_flax(actor, {k: z[k] for k in z.files})
        return actor

    def train(student, rounds, seed):
        X, A, w = flatten_balanced(rounds, collect_scenes)
        print(f"dataset: {len(X)} samples")
        return bc_train(student, torch.as_tensor(X, device=device),
                        torch.as_tensor(A, device=device), steps=args.steps,
                        seed=seed, weights=w)[0]

    # ---- round 0: behavioural cloning from teacher rollouts -------------
    rounds = [gather(None, args.bc_episodes, args.drive_noise, "bc")]
    student = load_student("bc")
    if student is None:
        student = train(init_student(student_learner, gen), rounds, args.seed)
        save_student(student, "bc")
    else:
        print("resumed student_bc", flush=True)
    results, mean = benchmark(student, "bc")
    # a copy: the DAgger rounds train the student in place
    best = (mean, copy.deepcopy(student), results, "bc")

    # ---- DAgger rounds: the student drives, the teachers label ---------
    for r in range(args.dagger_rounds):
        tag = f"dagger{r + 1}"
        rounds.append(gather(student, args.dagger_episodes, 0.0, tag))
        resumed = load_student(tag)
        if resumed is None:
            student = train(student, rounds, args.seed + r + 1)
            save_student(student, tag)
        else:
            student = resumed
            print(f"resumed student_{tag}", flush=True)
        results, mean = benchmark(student, tag)
        if mean > best[0]:
            best = (mean, copy.deepcopy(student), results, tag)

    # ---- persist the best student ---------------------------------------
    mean, student, results, tag = best
    cfg.hyperparams = student_hp
    ckpt = save_checkpoint(os.path.join(args.out, "best_model.ckpt"), {
        "ts": save_state(student_as_trainstate(student_learner, student)),
        "timesteps": 0, "algorithm": cfg.algorithm})
    export_policy(ckpt, os.path.join(args.out, "best_model.policy"),
                  config=cfg)
    with open(os.path.join(args.out, "benchmark.json"), "w") as f:
        json.dump(results, f, indent=1)
    display_and_save_benchmark_results(results,
                                       os.path.join(args.out, "benchmark"))
    # config.json with the student's hyperparameters: the eval CLI builds
    # the student's learner from it
    write_config(args.out, cfg)
    with open(os.path.join(args.out, "distill_meta.json"), "w") as f:
        json.dump({"best_round": tag, "mean_success": mean,
                   "router_artifact": args.router,
                   "bc_episodes": args.bc_episodes,
                   "dagger_rounds": args.dagger_rounds,
                   "dagger_episodes": args.dagger_episodes}, f, indent=1)
    print(json.dumps({"distilled_generalist_mean": round(mean, 4),
                      "best_round": tag}))
    return mean, tag


if __name__ == "__main__":
    main()

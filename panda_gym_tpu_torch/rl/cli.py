"""Training entry point of the port, the counterpart of tools/train.py:
builds a TrainConfig, runs the curriculum Trainer on ReachAO and
checkpoints the learner.

    python -m panda_gym_tpu_torch.rl.cli --stages reachao1 --n-envs 64 \\
        --max-timesteps 3840 --benchmark-eval-scenes library1

Options keep tools/train.py's names.  Training runs on the card unless
``--device cpu`` is given; without a card it raises.  ``--benchmark``
scores the best evaluation snapshot (else the final learner) on the
reference's 13-scene protocol afterwards (eval/benchmark.py, horizon 300),
written to <run dir>/benchmark.json and .csv.  ``--prior-steps N`` fills
the replay buffer with ceil(N / (n_envs * horizon)) episode batches of the
NEO prior before the first collect.  ``--benchmark-eval-scenes`` sets
TrainConfig.benchmark_eval_scenes, the scenes evaluated in the final stage
(default: TrainConfig's five).
"""
from __future__ import annotations

import argparse
import os

from panda_gym_tpu_torch.eval import benchmark as EB
from panda_gym_tpu_torch.rl.config import TrainConfig

# the protocol's episode horizon (tools/train.py:225)
BENCHMARK_HORIZON = 300


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--algorithm", default="TQC",
                   choices=["TQC", "TQC_v2", "SAC", "TD3", "DDPG"])
    p.add_argument("--stages", nargs="+",
                   default=["reachao1", "reachao2", "reachao3"])
    p.add_argument("--success-thresholds", nargs="+", type=float, default=None,
                   help="per-stage eval success to advance (default .9/.9/1)")
    p.add_argument("--max-ep-steps", nargs="+", type=int, default=[50, 75, 100])
    p.add_argument("--max-timesteps", type=int, default=600_000)
    p.add_argument("--n-envs", type=int, default=64)
    p.add_argument("--utd", type=float, default=None,
                   help="updates per transition (default: SB3 TQC-preset "
                        "ratio 0.125)")
    p.add_argument("--update-batch-size", type=int, default=None,
                   help="gradient batch size (default: preset batch_size)")
    p.add_argument("--no-interleave", action="store_true",
                   help="collect-then-update loop instead of interleaved "
                        "bursts")
    p.add_argument("--interleave-min-buffer", type=int, default=None,
                   help="interleaved bursts only fire once the buffer holds "
                        "this many transitions (default max(2*learning_"
                        "starts, 20k))")
    p.add_argument("--moving-obstacles", action="store_true",
                   help="sample random obstacle velocities at reset")
    p.add_argument("--learning-starts", type=int, default=10_000)
    p.add_argument("--reward-type", default="sparse",
                   choices=["sparse", "wang", "kumar_her", "kumar_optim",
                            "kumar", "dense"])
    p.add_argument("--control-type", default="js",
                   choices=["js", "ee", "jsd", "pcc"])
    p.add_argument("--goal-condition", default="reach",
                   choices=["reach", "halt"])
    p.add_argument("--collision-reward", type=float, default=-100.0)
    p.add_argument("--safety-distance", type=float, default=0.0)
    p.add_argument("--prior-steps", type=int, default=0,
                   help="NEO-prior imitation transitions to prefill the "
                        "replay buffer with (0 = off)")
    p.add_argument("--eval-freq", type=int, default=10_000)
    p.add_argument("--n-eval-episodes", type=int, default=100)
    p.add_argument("--benchmark-eval-scenes", nargs="*", default=None,
                   help="scenes evaluated in the final stage (default: "
                        "TrainConfig's five)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group", default="default")
    p.add_argument("--name", default=None)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="W&B is not ported: prints a notice")
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume the learner from")
    p.add_argument("--resume-full", default=None,
                   help="full-state checkpoint (<run>/full_state) to resume "
                        "mid-stage: learner + buffer + generator + counters")
    p.add_argument("--full-ckpt-freq", type=int, default=0,
                   help="write a rolling full-state checkpoint every N env "
                        "steps (0 = off)")
    p.add_argument("--benchmark", action="store_true",
                   help="run the 13-scenario benchmark after training")
    p.add_argument("--benchmark-episodes", type=int, default=100)
    p.add_argument("--obs-max-distance", type=float, default=None)
    p.add_argument("--net-arch", nargs="+", type=int, default=None)
    p.add_argument("--no-resume-buffer", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, learner and buffer")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from panda_gym_tpu_torch.envs.core import resolve_device
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.config import Hyperparameters
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.train import Trainer

    device = resolve_device(args.device)
    n_stages = len(args.stages)
    succ = args.success_thresholds or [0.9] * (n_stages - 1) + [1.0]
    cfg = TrainConfig(
        name=args.name or "cli", group=args.group,
        algorithm=args.algorithm, n_envs=args.n_envs,
        stages=list(args.stages), success_thresholds=list(succ),
        ee_error_thresholds=[0.05] * n_stages,
        speed_thresholds=([0.5, 0.1, 0.01] + [0.01] * n_stages)[:n_stages],
        max_ep_steps=list(args.max_ep_steps),
        max_timesteps=args.max_timesteps,
        learning_starts=args.learning_starts,
        prior_steps=args.prior_steps,
        reward_type=args.reward_type, control_type=args.control_type,
        goal_condition=args.goal_condition,
        collision_reward=args.collision_reward,
        safety_distance=args.safety_distance,
        eval_freq=args.eval_freq, n_eval_episodes=args.n_eval_episodes,
        seed=args.seed,
        utd=args.utd, update_batch_size=args.update_batch_size,
        interleave_updates=not args.no_interleave,
        interleave_min_buffer=args.interleave_min_buffer,
        randomize_obstacle_velocity=args.moving_obstacles,
        full_ckpt_freq=args.full_ckpt_freq,
    )
    if args.benchmark_eval_scenes is not None:
        cfg.benchmark_eval_scenes = list(args.benchmark_eval_scenes)
    if args.obs_max_distance is not None:
        cfg.task_observations = dict(cfg.task_observations,
                                     max_distance=args.obs_max_distance)
    cfg.hyperparams = Hyperparameters(args.algorithm)
    if args.net_arch is not None:
        cfg.hyperparams.policy_kwargs = dict(
            cfg.hyperparams.policy_kwargs, net_arch=list(args.net_arch))

    logger = RunLogger(group=args.group, name=args.name, config=cfg,
                       use_wandb=args.wandb, use_tensorboard=args.tensorboard)
    print(f"run dir: {logger.dir}")

    def make_env(sc, thr, spd):
        return make_reach_ao_core(scenario=sc, config=cfg,
                                  ee_error_threshold=thr,
                                  speed_threshold=spd, device=device)

    trainer = Trainer(cfg, make_env=make_env, logger=logger)
    if args.resume:
        trainer.load(args.resume, restore_buffer=not args.no_resume_buffer)
        print(f"resumed learner from {args.resume}")
    if args.resume_full:
        trainer.load_full(args.resume_full)
        print(f"resumed full training state from {args.resume_full} "
              f"(stage {trainer._resume['stage_index']}, "
              f"{trainer.timesteps} steps)")

    trainer.learn(seed=args.seed)
    final = os.path.join(logger.dir, "final.ckpt")
    trainer.save(final, include_buffer=True)
    trainer.save(os.path.join(logger.dir, "final_model.ckpt"))
    print(f"saved final learner to {final}")

    if args.benchmark:
        # the best evaluation snapshot when there is one, as the reference
        # benchmarks best_model.zip (load_model_utils.py:14-50)
        best = os.path.join(logger.dir, "best_model.ckpt")
        if os.path.exists(best):
            trainer.load(best, restore_buffer=False)
            print(f"benchmarking best eval snapshot {best}")
        results = EB.evaluate_scenarios(
            trainer.learner, [trainer.ts],
            make_core=lambda sc: make_env(sc, 0.05, 0.5),
            scenarios=EB.BENCHMARK_SCENARIOS,
            n_episodes=args.benchmark_episodes, horizon=BENCHMARK_HORIZON,
            seed=args.seed)
        EB.display_and_save_benchmark_results(
            results, os.path.join(logger.dir, "benchmark"))
    logger.close()
    return trainer


if __name__ == "__main__":
    main()

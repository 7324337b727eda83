"""Population training entry point of the port, the counterpart of
tools/train_population.py: K members of one algorithm trained at once on
ReachAO (rl/population.py), each env step one batched step of
members * n_envs envs.

    # 4 members on the rand_start pose-probability curriculum
    python -m panda_gym_tpu_torch.rl.population_cli --members 4 \\
        --stages reachao_rand_start_p25 reachao_rand_start_p50 \\
        reachao_rand_start --success-thresholds 0.85 0.85 2.0 \\
        --max-ep-steps 100 100 100 --max-timesteps 400000

Options keep tools/train_population.py's names and defaults;
``--n-envs`` counts envs PER MEMBER.  '<scene>_p25' is <scene> with a
randomized start pose on a quarter of the episodes.  Training runs on the
card unless ``--device cpu`` is given; without a card it raises.  The run
directory gets each member's best and per-stage checkpoints and
final_m<k>.ckpt, in the Trainer's format.
"""
from __future__ import annotations

import argparse
import os

from panda_gym_tpu_torch.rl.config import TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--members", type=int, default=4)
    p.add_argument("--algorithm", default="TQC",
                   choices=["TQC", "TQC_v2", "SAC", "TD3", "DDPG"])
    p.add_argument("--stages", nargs="+", default=["reachao1"])
    p.add_argument("--success-thresholds", nargs="+", type=float,
                   default=None)
    p.add_argument("--max-ep-steps", nargs="+", type=int, default=[100])
    p.add_argument("--max-timesteps", type=int, default=600_000,
                   help="per-member env-step budget per stage")
    p.add_argument("--n-envs", type=int, default=64,
                   help="envs PER MEMBER (total envs = members * n_envs)")
    p.add_argument("--utd", type=float, default=None)
    p.add_argument("--update-batch-size", type=int, default=None)
    p.add_argument("--interleave-min-buffer", type=int, default=None)
    p.add_argument("--learning-starts", type=int, default=50_000)
    p.add_argument("--reward-type", default="sparse")
    p.add_argument("--control-type", default="js")
    p.add_argument("--goal-condition", default="reach")
    p.add_argument("--collision-reward", type=float, default=-100.0)
    p.add_argument("--safety-distance", type=float, default=0.0)
    p.add_argument("--eval-freq", type=int, default=25_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group", default="default")
    p.add_argument("--name", default=None)
    p.add_argument("--obs-max-distance", type=float, default=2.0)
    p.add_argument("--buffer-size", type=int, default=None,
                   help="per-member replay transitions (default: the "
                        "preset's 300k)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, learners and buffer")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from panda_gym_tpu_torch.envs.core import resolve_device
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.config import Hyperparameters
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.population import PopulationTrainer

    device = resolve_device(args.device)
    n_stages = len(args.stages)
    succ = args.success_thresholds or [0.9] * (n_stages - 1) + [2.0]
    cfg = TrainConfig(
        name=args.name or "pop", group=args.group,
        algorithm=args.algorithm, n_envs=args.n_envs,
        stages=list(args.stages), success_thresholds=list(succ),
        ee_error_thresholds=[0.05] * n_stages,
        speed_thresholds=([0.5, 0.1, 0.01] + [0.01] * n_stages)[:n_stages],
        max_ep_steps=list(args.max_ep_steps),
        max_timesteps=args.max_timesteps,
        learning_starts=args.learning_starts,
        reward_type=args.reward_type, control_type=args.control_type,
        goal_condition=args.goal_condition,
        collision_reward=args.collision_reward,
        safety_distance=args.safety_distance,
        eval_freq=args.eval_freq, seed=args.seed,
        utd=args.utd, update_batch_size=args.update_batch_size,
        interleave_min_buffer=args.interleave_min_buffer,
    )
    cfg.task_observations = dict(cfg.task_observations,
                                 max_distance=args.obs_max_distance)
    cfg.hyperparams = Hyperparameters(args.algorithm)
    if args.buffer_size is not None:
        cfg.hyperparams.buffer_size = args.buffer_size

    logger = RunLogger(group=args.group, name=args.name, config=cfg)
    print(f"run dir: {logger.dir} (members={args.members})")

    def make_env(sc, thr, spd):
        return make_reach_ao_core(scenario=sc, config=cfg,
                                  ee_error_threshold=thr,
                                  speed_threshold=spd, device=device)

    pt = PopulationTrainer(cfg, make_env=make_env, n_members=args.members,
                           logger=logger)
    pt.learn(seed=args.seed)
    pt.save_members(os.path.join(logger.dir, "final"))
    print(f"saved {args.members} member checkpoints under {logger.dir}")
    logger.close()
    return pt


if __name__ == "__main__":
    main()

"""Training entry point of the port for the classic panda-gym tasks, the
counterpart of tools/train_classic.py: TQC/SAC + HER on a sparse-reward
Reach, Push, Slide, PickAndPlace, Stack, Flip or MyCobotReach with the same
Trainer as the ReachAO curriculum.

    python -m panda_gym_tpu_torch.rl.classic_cli --task push \\
        --max-timesteps 1000000 --n-envs 64 --group classic_campaign

Options keep tools/train_classic.py's names, and their defaults: the
reference's control type (js for reach, push and mycobotreach, ee for the
rest) and horizon (50, 100 for stack).  Training runs on the card unless
``--device cpu`` is given; without a card it raises.  The TD3 and DDPG
learners raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import os

from panda_gym_tpu_torch.rl.config import TrainConfig


def task_defaults(task: str):
    """The reference's control type and episode horizon of a task
    (tools/train_classic.py:29-43, panda_gym/__init__.py:19-91)."""
    control = "js" if task in ("reach", "push", "mycobotreach") else "ee"
    return control, 100 if task == "stack" else 50


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="reach",
                   choices=["reach", "push", "slide", "pickandplace",
                            "stack", "flip", "mycobotreach"])
    p.add_argument("--algorithm", default="TQC",
                   choices=["TQC", "TQC_v2", "SAC", "TD3", "DDPG"])
    p.add_argument("--reward-type", default="sparse",
                   choices=["sparse", "dense"])
    p.add_argument("--control-type", default=None,
                   choices=["js", "ee", "jsd", "pcc"],
                   help="default: the task's reference default "
                        "(js for reach/push, ee for the rest)")
    p.add_argument("--max-ep-steps", type=int, default=None,
                   help="default 50 (100 for stack), like the reference "
                        "registry (panda_gym/__init__.py:19-91)")
    p.add_argument("--max-timesteps", type=int, default=600_000)
    p.add_argument("--n-envs", type=int, default=64)
    p.add_argument("--learning-starts", type=int, default=10_000)
    p.add_argument("--eval-freq", type=int, default=10_000)
    p.add_argument("--n-eval-episodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group", default="classic")
    p.add_argument("--name", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--no-resume-buffer", action="store_true")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="W&B is not ported: prints a notice")
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, learner and buffer")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from panda_gym_tpu_torch.envs.core import resolve_device
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    from panda_gym_tpu_torch.rl.config import Hyperparameters
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.train import Trainer

    device = resolve_device(args.device)
    # the task's reference defaults, recorded in config.json as the env
    # factory uses them
    default_ct, default_horizon = task_defaults(args.task)
    horizon = args.max_ep_steps or default_horizon
    control_type = args.control_type or default_ct
    kw = dict(reward_type=args.reward_type, control_type=control_type,
              device=device)
    make_env = lambda task, thr, spd: make_core(task, **kw)  # noqa: E731

    cfg = TrainConfig(
        name=args.name or f"{args.algorithm.lower()}_{args.task}",
        group=args.group, algorithm=args.algorithm, n_envs=args.n_envs,
        stages=[args.task], success_thresholds=[2.0],  # run the full budget
        ee_error_thresholds=[0.05], speed_thresholds=[0.5],
        max_ep_steps=[horizon], max_timesteps=args.max_timesteps,
        learning_starts=args.learning_starts,
        reward_type=args.reward_type, control_type=control_type,
        eval_freq=args.eval_freq, n_eval_episodes=args.n_eval_episodes,
        seed=args.seed,
    )
    cfg.hyperparams = Hyperparameters(args.algorithm)
    cfg.benchmark_eval_scenes = []  # no ReachAO scenes here

    logger = RunLogger(group=args.group, name=args.name or cfg.name,
                       config=cfg, use_wandb=args.wandb,
                       use_tensorboard=args.tensorboard)
    print(f"run dir: {logger.dir}")

    trainer = Trainer(cfg, make_env=make_env, logger=logger)
    if args.resume:
        trainer.load(args.resume, restore_buffer=not args.no_resume_buffer)
        print(f"resumed learner from {args.resume}")

    trainer.learn(seed=args.seed)
    trainer.save(os.path.join(logger.dir, "final.ckpt"), include_buffer=True)
    trainer.save(os.path.join(logger.dir, "final_model.ckpt"))
    print(f"saved final learner to {logger.dir}")
    logger.close()
    return trainer


if __name__ == "__main__":
    main()

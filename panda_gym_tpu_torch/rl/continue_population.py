"""Continue a population run, the counterpart of
tools/continue_population.py: reload the K member checkpoints (with their
optimizer state) and train further on a stage.

    python -m panda_gym_tpu_torch.rl.continue_population \\
        [--src training/run_data/round5_campaign/pop_rs] \\
        [--ckpt best_model] [--stage reachao_rand_start] \\
        [--steps 700000] [--name pop_rs2]

PopulationTrainer trains stages fresh; this seeds its members from a run's
``<ckpt>_m<k>.ckpt`` files (rl/population.py's save_members writes them).
The replay buffer is not persisted: it refills from the current policies
during the learning-starts ramp, on-distribution data, before interleaved
updates resume.  The members are saved as ``<run dir>/final_m<k>.ckpt``.
Options keep the tool's names and defaults; ``--root`` is the run-data
root of the new run.  Training runs on the card unless ``--device cpu`` is
given; without a card it raises.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", default="training/run_data/round5_campaign/pop_rs")
    p.add_argument("--ckpt", default="best_model",
                   help="member ckpt prefix: best_model | final | "
                        "model_<stage>_<i>")
    p.add_argument("--stage", default="reachao_rand_start")
    p.add_argument("--steps", type=int, default=700_000)
    p.add_argument("--learning-starts", type=int, default=25_000,
                   help="buffer refill budget before updates resume")
    p.add_argument("--name", default="pop_rs2")
    p.add_argument("--group", default="round5_campaign")
    p.add_argument("--root", default="training/run_data")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, learners and buffer")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from panda_gym_tpu_torch.envs.core import resolve_device
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger, load_run
    from panda_gym_tpu_torch.rl.population import PopulationTrainer

    device = resolve_device(args.device)
    cfg, _ = load_run(args.src)
    cfg.stages = [args.stage]
    cfg.success_thresholds = [2.0]
    cfg.max_timesteps = args.steps
    cfg.learning_starts = args.learning_starts
    # the gate scales off learning_starts; keep the refill short: the
    # policy is already competent, so early interleave is safe
    cfg.interleave_min_buffer = max(2 * args.learning_starts, 40_000)

    paths = []
    for i in range(64):
        path = os.path.join(args.src, f"{args.ckpt}_m{i}.ckpt")
        if not os.path.exists(path):
            break
        paths.append(path)
    if not paths:
        raise SystemExit(f"no member ckpts under {args.src}")
    K = len(paths)
    print(f"continuing {K} members from {args.src} ({args.ckpt}_m*.ckpt) "
          f"on {args.stage} for {args.steps} steps/member")

    logger = RunLogger(group=args.group, name=args.name, config=cfg,
                       root=args.root)
    print(f"run dir: {logger.dir}")

    def make_env(sc, thr, spd):
        return make_reach_ao_core(scenario=sc, config=cfg,
                                  ee_error_threshold=thr,
                                  speed_threshold=spd, device=device)

    pt = PopulationTrainer(cfg, make_env=make_env, n_members=K,
                           logger=logger)
    pt.load_members(paths)
    pt.learn(seed=args.seed)
    pt.save_members(os.path.join(logger.dir, "final"))
    print(f"saved {K} member checkpoints under {logger.dir}")
    logger.close()
    return pt


if __name__ == "__main__":
    main()

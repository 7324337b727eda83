"""Fixed-goal-set generator (port of panda_gym_tpu/eval/goal_maker.py;
reference evaluation/goal_maker.py:14-29).

Samples N reset goals per scenario, all of a scenario's in one batched reset
on the device, and writes them to JSON, for evaluation protocols that need a
frozen goal set across runs.  The goals come from a torch.Generator seeded
with ``seed``: the same seed gives the same goals, not the JAX package's.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

import torch

DEFAULT_SCENARIOS = ("wangexp_3", "narrow_tunnel", "workshop", "library2",
                     "wall")  # goal_maker.py:15


def make_scenario_goals(scenarios: Sequence[str] = DEFAULT_SCENARIOS,
                        n_goals: int = 1000, seed: int = 0, device="cuda"
                        ) -> Dict[str, List[tuple]]:
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core

    out = {}
    for scenario in scenarios:
        core = make_reach_ao_core(scenario, device=device)
        generator = torch.Generator(device=core.device).manual_seed(int(seed))
        states, _ = core.batched_reset(n_goals, generator)
        out[scenario] = [tuple(float(x) for x in g)
                         for g in states.goal.cpu().tolist()]
    return out


def main(path: str = "scenario_goals.json", n_goals: int = 1000,
         seed: int = 0, device="cuda"):
    goals = make_scenario_goals(n_goals=int(n_goals), seed=int(seed),
                                device=device)
    with open(path, "w") as f:
        f.write(json.dumps(goals))
    return goals


if __name__ == "__main__":
    import sys
    main(*sys.argv[1:2])

"""Env factories binding robot + task (port of the Reach, Push and Slide
part of panda_gym_tpu/envs/panda_tasks.py).  Classic tasks put the base at
(-0.6, 0, 0) (reference panda_tasks.py:71-88); Push and Slide block the
gripper, so the Panda is the welded 7-dof arm that kernel K1 covers."""
from __future__ import annotations

from panda_gym_tpu_torch.envs.core import RobotTaskEnv
from panda_gym_tpu_torch.envs.robot import PandaConfig, PandaRobot
from panda_gym_tpu_torch.envs.tasks.classic import Push, Reach, Slide

_CLASSIC_BASE = (-0.6, 0.0, 0.0)


def _robot(control_type: str) -> PandaRobot:
    return PandaRobot(PandaConfig(block_gripper=True,
                                  control_type=control_type,
                                  base_position=_CLASSIC_BASE))


def make_reach_core(reward_type="sparse", control_type="js", goal_range=0.3,
                    device="cuda", **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(control_type),
                        Reach(reward_type=reward_type, goal_range=goal_range),
                        device=device)


def make_push_core(reward_type="sparse", control_type="js", device="cuda",
                   **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(control_type), Push(reward_type=reward_type),
                        device=device)


def make_slide_core(reward_type="sparse", control_type="ee", device="cuda",
                    **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(control_type), Slide(reward_type=reward_type),
                        device=device)


_CORE_FACTORIES = {
    "reach": make_reach_core,
    "push": make_push_core,
    "slide": make_slide_core,
}
# the JAX package's other tasks: the prismatic-finger Panda (9 dofs) and
# MyCobot (6) need a K1 for their chains first
NEXT_SLICE = ("pickandplace", "stack", "flip", "mycobotreach")


def make_core(task: str, **kw) -> RobotTaskEnv:
    """"reach", "push" and "slide"; the JAX package's other tasks raise
    NotImplementedError.  As in the JAX package, ReachAO is built by
    envs/tasks/reach_ao.py::make_reach_ao_core, not here."""
    name = task.lower()
    if name in NEXT_SLICE:
        raise NotImplementedError(
            f"task {task!r} is not ported yet: it waits for K1 on chains "
            f"other than the welded 7-dof Panda (ROADMAP item 13b)")
    if name not in _CORE_FACTORIES:
        raise ValueError(f"unknown task {task!r}; the port has "
                         f"{sorted(_CORE_FACTORIES)}")
    return _CORE_FACTORIES[name](**kw)

"""Env factories binding robot + task (port of the Reach part of
panda_gym_tpu/envs/panda_tasks.py).  Classic tasks put the base at
(-0.6, 0, 0) (reference panda_tasks.py:71-88)."""
from __future__ import annotations

from panda_gym_tpu_torch.envs.core import RobotTaskEnv
from panda_gym_tpu_torch.envs.robot import PandaConfig, PandaRobot
from panda_gym_tpu_torch.envs.tasks.classic import Reach

_CLASSIC_BASE = (-0.6, 0.0, 0.0)


def make_reach_core(reward_type="sparse", control_type="js", goal_range=0.3,
                    device="cuda", **kw) -> RobotTaskEnv:
    robot = PandaRobot(PandaConfig(block_gripper=True,
                                   control_type=control_type,
                                   base_position=_CLASSIC_BASE))
    return RobotTaskEnv(robot, Reach(reward_type=reward_type,
                                     goal_range=goal_range), device=device)


_CORE_FACTORIES = {
    "reach": make_reach_core,
}


def make_core(task: str, **kw) -> RobotTaskEnv:
    """Only "reach" is ported; the other tasks follow the ROADMAP."""
    name = task.lower()
    if name not in _CORE_FACTORIES:
        raise NotImplementedError(f"task {task!r} is not ported yet")
    return _CORE_FACTORIES[name](**kw)

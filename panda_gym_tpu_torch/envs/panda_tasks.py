"""Env factories binding robot + task (port of the core factories of
panda_gym_tpu/envs/panda_tasks.py).  Classic tasks put the base at
(-0.6, 0, 0) (reference panda_tasks.py:71-88).  Reach, Push and Slide block
the gripper (the welded 7-dof Panda); PickAndPlace, Stack and Flip free it
(the 9-dof Panda with prismatic fingers); MyCobotReach runs the 6-dof
MyCobot.  Kernel K1 covers the three chains."""
from __future__ import annotations

from panda_gym_tpu_torch.envs.core import RobotTaskEnv
from panda_gym_tpu_torch.envs.robot import (MyCobotRobot, PandaConfig,
                                            PandaRobot)
from panda_gym_tpu_torch.envs.tasks.classic import (Flip, PickAndPlace, Push,
                                                    Reach, Slide, Stack)

_CLASSIC_BASE = (-0.6, 0.0, 0.0)


def _robot(block_gripper: bool, control_type: str) -> PandaRobot:
    return PandaRobot(PandaConfig(block_gripper=block_gripper,
                                  control_type=control_type,
                                  base_position=_CLASSIC_BASE))


def make_reach_core(reward_type="sparse", control_type="js", goal_range=0.3,
                    device="cuda", **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(True, control_type),
                        Reach(reward_type=reward_type, goal_range=goal_range),
                        device=device)


def make_push_core(reward_type="sparse", control_type="js", device="cuda",
                   **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(True, control_type),
                        Push(reward_type=reward_type), device=device)


def make_slide_core(reward_type="sparse", control_type="ee", device="cuda",
                    **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(True, control_type),
                        Slide(reward_type=reward_type), device=device)


def make_pick_and_place_core(reward_type="sparse", control_type="ee",
                             device="cuda", **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(False, control_type),
                        PickAndPlace(reward_type=reward_type), device=device)


def make_stack_core(reward_type="sparse", control_type="ee", device="cuda",
                    **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(False, control_type),
                        Stack(reward_type=reward_type), device=device)


def make_flip_core(reward_type="sparse", control_type="ee", device="cuda",
                   **kw) -> RobotTaskEnv:
    return RobotTaskEnv(_robot(False, control_type),
                        Flip(reward_type=reward_type), device=device)


def make_mycobot_reach_core(reward_type="sparse", control_type="js",
                            goal_range=0.3, device="cuda",
                            **kw) -> RobotTaskEnv:
    robot = MyCobotRobot(PandaConfig(block_gripper=True,
                                     control_type=control_type,
                                     base_position=_CLASSIC_BASE))
    return RobotTaskEnv(robot,
                        Reach(reward_type=reward_type, goal_range=goal_range),
                        device=device)


_CORE_FACTORIES = {
    "mycobotreach": make_mycobot_reach_core,
    "reach": make_reach_core,
    "push": make_push_core,
    "slide": make_slide_core,
    "pickandplace": make_pick_and_place_core,
    "stack": make_stack_core,
    "flip": make_flip_core,
}


def make_core(task: str, **kw) -> RobotTaskEnv:
    """The batched env of one of the seven classic tasks.  As in the JAX
    package, ReachAO is built by envs/tasks/reach_ao.py::make_reach_ao_core,
    not here."""
    name = task.lower()
    if name not in _CORE_FACTORIES:
        raise ValueError(f"unknown task {task!r}; the port has "
                         f"{sorted(_CORE_FACTORIES)}")
    return _CORE_FACTORIES[name](**kw)

"""Env factories binding robot + task, and the single-env classes (port of
panda_gym_tpu/envs/panda_tasks.py).  Classic tasks put the base at
(-0.6, 0, 0) (reference panda_tasks.py:71-88).  Reach, Push and Slide block
the gripper (the welded 7-dof Panda); PickAndPlace, Stack and Flip free it
(the 9-dof Panda with prismatic fingers); MyCobotReach runs the 6-dof
MyCobot.  Kernel K1 covers the three chains.

``make_core`` builds the batched env; the classes (``PandaReachEnv`` ...)
are one env each with the gymnasium surface (``EnvAdapter``), gymnasium not
imported; envs/gym_envs.py has their ``gymnasium.Env`` versions, which the
registered ids make."""
from __future__ import annotations

from panda_gym_tpu_torch.envs.core import EnvAdapter, RobotTaskEnv
from panda_gym_tpu_torch.envs.robot import (MyCobotRobot, PandaConfig,
                                            PandaRobot)
from panda_gym_tpu_torch.envs.tasks.classic import (Flip, PickAndPlace, Push,
                                                    Reach, Slide, Stack)

_CLASSIC_BASE = (-0.6, 0.0, 0.0)


def _robot(block_gripper: bool, control_type: str, **kw) -> PandaRobot:
    return PandaRobot(PandaConfig(block_gripper=block_gripper,
                                  control_type=control_type,
                                  base_position=_CLASSIC_BASE, **kw))


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


# single-env classes (panda_tasks.py:91-147); ``render`` and the reference's
# other display arguments are accepted and ignored, ``device`` is the
# card unless the caller passes "cpu"

class PandaReachEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "js", goal_range=0.3,
                 show_goal_space=False, device="cuda", **kw):
        super().__init__(make_reach_core(reward_type, control_type,
                                         goal_range, device=device))


class PandaPushEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "js", device="cuda", **kw):
        super().__init__(make_push_core(reward_type, control_type,
                                        device=device))


class PandaSlideEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "ee", device="cuda", **kw):
        super().__init__(make_slide_core(reward_type, control_type,
                                         device=device))


class PandaPickAndPlaceEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "ee", device="cuda", **kw):
        super().__init__(make_pick_and_place_core(reward_type, control_type,
                                                  device=device))


class PandaStackEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "ee", device="cuda", **kw):
        super().__init__(make_stack_core(reward_type, control_type,
                                         device=device))


class PandaFlipEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "ee", device="cuda", **kw):
        super().__init__(make_flip_core(reward_type, control_type,
                                        device=device))


class PandaReachCheckerEnv(EnvAdapter):
    """The reference's analytical-model-free Reach probe
    (panda_tasks.py:111-129: use_robotics_toolbox=False,
    action_limiter="clip"): Reach with the "clip" limiter made explicit."""

    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "js", goal_range=0.3,
                 show_goal_space=False, device="cuda", **kw):
        robot = _robot(True, control_type, action_limiter="clip")
        super().__init__(RobotTaskEnv(
            robot, Reach(reward_type=reward_type, goal_range=goal_range),
            device=device))


class MyCobotReachEnv(EnvAdapter):
    def __init__(self, render: bool = False, reward_type: str = "sparse",
                 control_type: str = "js", goal_range=0.3, device="cuda",
                 **kw):
        super().__init__(make_mycobot_reach_core(reward_type, control_type,
                                                 goal_range, device=device))

"""The gymnasium.Env classes of the port's envs: each single-env class of
envs/panda_tasks.py and envs/tasks/reach_ao.py with the reference's spaces
(core.gym_env_class).  The ids of panda_gym_tpu_torch.register_envs make
these.  Each is made at first use (``from ... import PandaReachEnv``, or the
registry's entry point), which imports gymnasium; importing this module
does not."""
_CLASSES = {
    name: "panda_gym_tpu_torch.envs.panda_tasks"
    for name in ("PandaReachEnv", "PandaReachCheckerEnv", "PandaPushEnv",
                 "PandaSlideEnv", "PandaPickAndPlaceEnv", "PandaStackEnv",
                 "PandaFlipEnv", "MyCobotReachEnv")}
_CLASSES["PandaReachAOEnv"] = "panda_gym_tpu_torch.envs.tasks.reach_ao"


def __getattr__(name):
    if name not in _CLASSES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    from panda_gym_tpu_torch.envs.core import gym_env_class
    return gym_env_class(getattr(importlib.import_module(_CLASSES[name]),
                                 name))


def __dir__():
    return sorted(_CLASSES)

"""PyTorch port of panda_gym_tpu for one NVIDIA H100.

The batched Reach and ReachAO envs run here end to end:
``envs.panda_tasks.make_core("reach")`` and
``envs.tasks.reach_ao.make_reach_ao_core("reachao1")`` build them,
``batched_reset`` / ``batched_step`` drive them, and their robot physics
goes through a hand-written CUDA kernel (``ops/csrc/motor_steps.cu``);
Reach takes the ``ee``, ``js``, ``jsd`` and ``pcc`` control modes.
``ops.neo.compute_action_neo`` is the NEO motion-planner prior for a batch
of envs (ReachAO's ``prior`` observation, the trainer's ``prior_steps``
bootstrap, the ``prior`` and ``bcf`` evaluation strategies).
``rl.train.Trainer`` (or ``python -m panda_gym_tpu_torch.rl.cli``) trains
TQC + HER on them, the learner and the buffer on the env's device, and
``eval.benchmark.perform_benchmark`` (or ``python -m
panda_gym_tpu_torch.eval.cli``) scores a policy on the reference's
13-scene protocol.

The gym surface: ``register_envs(max_ep_steps)`` registers every env id of
the JAX package under the gymnasium namespace ``panda_gym_tpu_torch/``
(``gym.make("panda_gym_tpu_torch/PandaReach-v3", device="cpu")``,
``gym.make_vec(..., num_envs=N)``), beside the JAX package's own ids.  The
single-env classes (``envs.panda_tasks.PandaReachEnv`` ...,
``envs.tasks.reach_ao.PandaReachAOEnv``) and ``envs.vector_adapter.
VectorAdapter`` have the same surface without gymnasium.
``sim.facade.Simulation`` is the stateful, name-addressed simulation of the
reference's PyBullet wrapper, and ``render`` draws a state without OpenGL.

The package imports torch, numpy and the standard library only (gymnasium
and PIL at first use); it never imports the JAX package.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
_NAMESPACE = "panda_gym_tpu_torch"
_ENVS = "panda_gym_tpu_torch.envs.gym_envs"
_VECTOR = "panda_gym_tpu_torch.envs.vector_adapter:make_vector_env"


def _register(env_id: str, entry: str, max_ep_steps: int, kwargs) -> str:
    from gymnasium.envs.registration import register, registry

    full = f"{_NAMESPACE}/{env_id}"
    if full in registry:
        del registry[full]
    # vector_entry_point: gym.make_vec(id, num_envs=N) serves the batch
    # from one batched step (envs/vector_adapter.py)
    register(id=full, entry_point=f"{_ENVS}:{entry}",
             vector_entry_point=_VECTOR, kwargs=kwargs,
             max_episode_steps=max_ep_steps)
    return full


def register_reach_ao(max_ep_steps: int = 50) -> str:
    """``panda_gym_tpu_torch/PandaReachAO-v3`` (reference
    panda_gym/__init__.py:15-20)."""
    return _register("PandaReachAO-v3", "PandaReachAOEnv", max_ep_steps,
                     {"vector_task": "reachao"})


def register_envs(max_ep_steps: int = 50):
    """Register the 32 classic ids and ReachAO's under the namespace
    ``panda_gym_tpu_torch/`` (reference panda_gym/__init__.py:23-91); call
    again to change the episode budget.  Returns the ids."""
    ids = []
    for reward_type in ["sparse", "dense"]:
        for control_type in ["ee", "joints"]:
            reward_suffix = "Dense" if reward_type == "dense" else ""
            control_suffix = "Joints" if control_type == "joints" else ""
            # the reference maps "joints" -> robot control_type "js"
            kwargs = {"reward_type": reward_type,
                      "control_type": "js" if control_type == "joints"
                      else "ee"}
            for name, entry, vector_task in [
                ("PandaReach", "PandaReachEnv", "reach"),
                ("PandaReachChecker", "PandaReachCheckerEnv", "reach"),
                ("PandaPush", "PandaPushEnv", "push"),
                ("PandaSlide", "PandaSlideEnv", "slide"),
                ("PandaPickAndPlace", "PandaPickAndPlaceEnv", "pickandplace"),
                ("PandaStack", "PandaStackEnv", "stack"),
                ("PandaFlip", "PandaFlipEnv", "flip"),
                ("MyCobotReach", "MyCobotReachEnv", "mycobotreach"),
            ]:
                ver = "v0" if name == "MyCobotReach" else "v3"
                ids.append(_register(
                    f"{name}{control_suffix}{reward_suffix}-{ver}", entry,
                    max_ep_steps, dict(kwargs, vector_task=vector_task)))
    ids.append(register_reach_ao(max_ep_steps))
    return ids

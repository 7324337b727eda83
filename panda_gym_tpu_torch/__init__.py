"""PyTorch port of panda_gym_tpu for one NVIDIA H100.

The batched Reach and ReachAO envs run here end to end:
``envs.panda_tasks.make_core("reach")`` and
``envs.tasks.reach_ao.make_reach_ao_core("reachao1")`` build them,
``batched_reset`` / ``batched_step`` drive them, and their robot physics
goes through a hand-written CUDA kernel (``ops/csrc/motor_steps.cu``).  The package imports torch, numpy and the
standard library only; it never imports the JAX package.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.  Gym
registration is not ported yet.
"""

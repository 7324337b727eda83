"""PyTorch port of panda_gym_tpu for one NVIDIA H100.

The batched Reach env runs here end to end: ``envs.panda_tasks.make_core
("reach")`` builds it, ``batched_reset`` / ``batched_step`` drive it, and its
robot physics goes through a hand-written CUDA kernel
(``ops/csrc/motor_steps.cu``).  The package imports torch, numpy and the
standard library only; it never imports the JAX package.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.  Gym
registration is not ported yet.
"""

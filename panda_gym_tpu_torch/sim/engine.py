"""Batched physics step (port of the robot-only branch of
panda_gym_tpu/sim/engine.py::make_batched_physics_step, :440-523).

For configurations whose per-substep work is robot-only (no free bodies, no
contact, no per-substep collision check: Reach and friends) the motor
dynamics run through kernel K1 (``ops/cuda_dynamics.py``) on the card, or
its plain version for CPU tensors.  Moving obstacles advance by their
velocity over the policy step.  The other branches are not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from panda_gym_tpu_torch.models.chain import ChainModel
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops.cuda_dynamics import make_cuda_motor_steps
from panda_gym_tpu_torch.sim.state import EnvState, SceneParams

TIMESTEP = 1.0 / 500.0  # pybullet.py:50


class RobotOnlyPhysics:
    """``states -> states`` after one policy step of robot-only physics.
    ``motor`` is the K1 wrapper; its ``launches`` count the kernel's runs."""

    def __init__(self, model: ChainModel, *, n_substeps: int, ctrl_mode: int,
                 moving_obstacles: bool):
        self.n_substeps = n_substeps
        self.moving_obstacles = moving_obstacles
        self.motor = make_cuda_motor_steps(
            model, n_substeps=n_substeps, dt=TIMESTEP, ctrl_mode=ctrl_mode)

    def __call__(self, states: EnvState) -> EnvState:
        q, qd = self.motor(states.q.contiguous(), states.qd.contiguous(),
                           states.ctrl_target.contiguous())
        upd = dict(q=q, qd=qd)
        if self.moving_obstacles:
            upd["obstacle_pos"] = (
                states.obstacle_pos
                + (self.n_substeps * TIMESTEP) * states.obstacle_vel)
        return states.replace(**upd)


def make_batched_physics_step(
    model: ChainModel,
    scene: SceneParams,
    *,
    n_substeps: int = 20,
    ctrl_mode: int = D.CTRL_POSITION,
    robot_contact: bool = False,
    body_pairs: Sequence[Tuple[int, int]] = (),
    check_collision: bool = False,
    collision_safety_distance: float = 0.0,
    freeze_on_collision: bool = True,
    has_bodies: bool = True,
    moving_obstacles: bool = False,
) -> RobotOnlyPhysics:
    """Batch-native physics step over a batched EnvState."""
    if has_bodies and scene.nb > 0:
        raise NotImplementedError(
            "free-body contact physics is not ported yet (ROADMAP item 16)")
    if check_collision:
        raise NotImplementedError(
            "per-substep collision physics is not ported yet (ROADMAP item 8)")
    return RobotOnlyPhysics(model, n_substeps=n_substeps, ctrl_mode=ctrl_mode,
                            moving_obstacles=moving_obstacles)

"""Motor-dynamics constants (port of the knobs of panda_gym_tpu/ops/dynamics.py).

Read from the same environment variables, with the same defaults, as the
JAX package (dynamics.py:229-247).  The per-env ``rnea`` / ``crba`` /
``motor_substep`` wait for the per-env path (ROADMAP item 16); the
batched physics lives in ``ops/scalarized.py`` and its kernel.
"""
import os as _os

# PyBullet's default positionGain for POSITION_CONTROL motors.
POSITION_GAIN = 0.1
CTRL_POSITION = 0
CTRL_VELOCITY = 1

# masked active-set refinements of the motor box-LCP: cold solve, and per
# substep when warm-started from the previous substep's active set
MOTOR_LCP_ITERS = max(1, int(_os.environ.get("PANDA_MOTOR_LCP_ITERS", "3")))
MOTOR_LCP_WARM_ITERS = max(
    1, int(_os.environ.get("PANDA_MOTOR_LCP_WARM_ITERS", "1")))

# whether the batched path carries the warm active set across substeps
LCP_WARM_START = _os.environ.get("PANDA_LCP_WARM", "1") != "0"


def lcp_warm_default(path_default: bool) -> bool:
    """Path default unless PANDA_LCP_WARM is set explicitly in the env."""
    if "PANDA_LCP_WARM" in _os.environ:
        return LCP_WARM_START
    return path_default

"""Port parity: the port's single-env adapter against the JAX package's
GymAdapter over 5 steps of the free-body tasks: Push with the cube before
the fingertip, so that the arm pushes it, and PickAndPlace (the 9-dof Panda,
its fingers moving).  tests/test_torch_gym.py has the method and the
tolerances."""
import pytest
from test_torch_gym import hold_steps


@pytest.mark.parametrize("name", ["push", "pickandplace"])
def test_adapter_steps_match_jax(monkeypatch, name):
    hold_steps(name, monkeypatch)

"""Port parity: the port's single-env adapter against the JAX package's
GymAdapter over 5 steps, Reach under ee control (10 DLS IK steps per
action) and ReachAO on reachao1 (the collision step, 20 substeps each with
the collision check).  tests/test_torch_gym.py has the method and the
tolerances."""
import pytest
from test_torch_gym import hold_steps


@pytest.mark.parametrize("name", ["reach_ee", "reachao1"])
def test_adapter_steps_match_jax(monkeypatch, name):
    hold_steps(name, monkeypatch)

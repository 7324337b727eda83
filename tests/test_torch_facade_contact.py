"""The stateful Simulation of panda_gym_tpu_torch against the JAX
package's from the same scenes with bodies and obstacles: a box and a
sphere resting on the table with the arm driven down, and a sphere obstacle
moving into the hand beside a falling body (the obstacles' advance, the
sticky collision flag, no freeze).  tests/test_torch_facade.py has the
method and the tolerances."""
import numpy as np
from test_torch_facade import (ATOL_POS, NEUTRAL, _both, _hold,  # noqa: F401
                               jax_sim)


def test_box_on_the_table_matches_jax(jax_sim):
    """A box at rest on the table (2 mm into it) beside a free sphere 1 mm
    into the table, and the arm driven down toward the box: 3 steps with
    the contact forces, the bodies' motion and the reaction on the arm."""
    def build(s):
        s.load_robot(base_position=(-0.6, 0.0, 0.0))
        s.create_plane(z_offset=-0.4)
        s.create_table(length=1.1, width=0.7, height=0.4)
        s.set_joint_angles("robot", list(range(7)), NEUTRAL)
        s.create_box("box", half_extents=(0.02, 0.02, 0.02), mass=0.5,
                     position=(0.0, 0.0, 0.018))
        s.create_sphere("ball", radius=0.02, mass=0.2,
                        position=(0.1, 0.1, 0.019))
        tgt = list(NEUTRAL)
        tgt[1], tgt[3] = 0.1, -1.9
        s.control_joints("robot", list(range(7)), tgt)

    j, t = _both(jax_sim, build)
    for i in range(3):
        j.step()
        t.step()
        _hold(j, t, f"step {i}", bodies=("box", "ball"))
    assert t.physics.warm_start and t.physics.check is None


def test_moving_obstacle_and_flag_match_jax(jax_sim):
    """A sphere obstacle moving into the hand at 1 m/s beside a falling
    body: the obstacle's advance, the sticky flag raised at the same step,
    no freeze (the robot keeps moving), the group distances."""
    def build(s):
        s.load_robot(base_position=(-0.6, 0.0, 0.0))
        s.create_plane(z_offset=-0.4)
        s.create_table(length=1.1, width=0.7, height=0.4)
        s.set_joint_angles("robot", list(range(7)), NEUTRAL)
        s.create_sphere("ball", radius=0.03, mass=1.0,
                        position=(0.2, -0.2, 0.5))
        ee = s.get_link_position("robot", 11)
        s.create_sphere("mover", radius=0.03, mass=0.0,
                        position=ee + np.array([0.14, 0.0, 0.0]))
        s.set_base_velocity("mover", np.array([-1.0, 0.0, 0.0]))
        tgt = list(NEUTRAL)
        tgt[6] = 1.5
        s.control_joints("robot", list(range(7)), tgt)

    j, t = _both(jax_sim, build)
    flags = []
    for i in range(3):
        j.step()
        t.step()
        _hold(j, t, f"step {i}", bodies=("ball", "mover"))
        np.testing.assert_allclose(
            t._state.link_obstacle_dist[0].numpy(),
            np.asarray(j._state.link_obstacle_dist), atol=ATOL_POS)
        flags.append(t.is_collided)
    assert flags[0] is False and flags[-1] is True
    assert not t.physics.warm_start and t.physics.check is not None

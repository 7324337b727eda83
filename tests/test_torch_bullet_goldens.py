"""The reference's literal PyBullet numbers through the port's stateful
Simulation (tests/test_bullet_goldens.py on panda_gym_tpu_torch, the
reference's own atol 1e-3), in both motor-LCP modes: "exact" (the masked
active-set solve, kernel K1's on the card) and "pgs" (50 sweeps of
sequential impulse, the plain PyTorch solve).  No JAX here.

Stock pybullet_data Panda at the origin, all joints at zero:
  * link 1 CoM position at q=0: [0.000, 0.060, 0.373] (test/pybullet_test.py:124-136)
  * after control_joints([5], [0.3], [5.0]) and one 20-substep step:
      link 5 linear velocity [-0.0068, 0.0000, 0.1186] (:156-170)
      link 5 angular velocity [0.000, -2.969, 0.000] (:172-187)
      joint 5 angle 0.063 (:189-204)
      link 5 orientation (xyzw) [0.707, -0.02, 0.02, 0.707] (:139-153)
  * Bullet's IK golden joint vector (:254-266) through the port's FK, and
    the port's DLS IK on the same query.
"""
import numpy as np
import pytest
import torch

from panda_gym_tpu_torch.math.transforms import mat_to_quat
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.sim.facade import Simulation


@pytest.fixture(scope="module", params=["exact", "pgs"])
def stepped_sim(request):
    """Stock-inertia robot at the origin, joint 5 commanded to 0.3 with a
    5 N m force clamp, stepped once (test/pybullet_test.py:110-121), in the
    LCP mode of the parameter."""
    D.set_lcp_mode(request.param)
    try:
        s = Simulation(n_substeps=20, device="cpu")
        s.load_robot(base_position=(0.0, 0.0, 0.0), inertia="stock")
        s.set_joint_angles("robot", list(range(7)), [0.0] * 7)
        s.control_joints("robot", [5], [0.3], [5.0])
        s.step()
        assert s.physics.route == ("pgs" if request.param == "pgs" else "k1")
    finally:
        D.set_lcp_mode("exact")
    return s


def test_link_com_position_golden():
    s = Simulation(n_substeps=20, device="cpu")
    s.load_robot(base_position=(0.0, 0.0, 0.0), inertia="stock")
    s.set_joint_angles("robot", list(range(7)), [0.0] * 7)
    np.testing.assert_allclose(
        s.get_link_position("robot", 1), [0.000, 0.060, 0.373], atol=1e-3)


def test_link_velocity_golden(stepped_sim):
    v = stepped_sim.get_link_velocity("robot", 5)
    np.testing.assert_allclose(v, [-0.0068, 0.0000, 0.1186], atol=1e-3)


def test_link_angular_velocity_golden(stepped_sim):
    om = stepped_sim.get_link_angular_velocity("robot", 5)
    assert abs(om[0]) < 1e-3 and abs(om[2]) < 1e-3
    assert om[1] == pytest.approx(-2.969, abs=1e-3)


def test_joint_angle_golden(stepped_sim):
    assert stepped_sim.get_joint_angle("robot", 5) == pytest.approx(
        0.063, abs=1e-3)


def test_link_orientation_golden(stepped_sim):
    quat = stepped_sim.get_link_orientation("robot", 5)
    np.testing.assert_allclose(quat, [0.707, -0.02, 0.02, 0.707], atol=1e-3)


IK_GOLDEN = np.array([1.000, 1.223, -1.113, -0.021, -0.917, 0.666, -0.499],
                     np.float32)
TARGET_P = np.array([0.4, 0.5, 0.6], np.float32)
TARGET_Q = np.array([0.707, -0.02, 0.02, 0.707])
TARGET_Q = (TARGET_Q / np.linalg.norm(TARGET_Q)).astype(np.float32)


def _residuals(model, joints):
    fk = K.fk_world(model, torch.as_tensor(joints)[None])
    R, p = K.site_frame(model, fk, 6)
    quat = mat_to_quat(R)[0].numpy()
    if np.dot(quat, TARGET_Q) < 0:
        quat = -quat
    return (np.linalg.norm(p[0].numpy() - TARGET_P),
            np.abs(quat - TARGET_Q).max(), quat, p[0].numpy())


def test_fk_of_bullet_ik_golden():
    """Bullet's IK golden joint vector through the port's FK reaches the
    requested orientation within 5e-3, the position within 7e-2
    (tests/test_bullet_goldens.py:99-131 says why)."""
    model = make_panda_model(base_position=(0.0, 0.0, 0.0), inertia="stock")
    _, _, quat, p = _residuals(model, IK_GOLDEN)
    np.testing.assert_allclose(p, TARGET_P, atol=7e-2)
    np.testing.assert_allclose(quat, TARGET_Q, atol=5e-3)


def test_ik_on_golden_query_matches_bullet_quality():
    """The port's DLS IK (through the facade, the batched dls_ik at B = 1)
    on the golden query: a combined residual no worse than Bullet's own
    golden vector's, and the orientation converged."""
    model = make_panda_model(base_position=(0.0, 0.0, 0.0), inertia="stock")
    s = Simulation(device="cpu")
    s.load_robot(base_position=(0.0, 0.0, 0.0), inertia="stock")
    q = s.inverse_kinematics("robot", 6, TARGET_P, TARGET_Q)
    ours_p, ours_q, _, _ = _residuals(model, q.astype(np.float32))
    bullet_p, bullet_q, _, _ = _residuals(model, IK_GOLDEN)
    assert ours_p + ours_q <= bullet_p + bullet_q + 0.02, (
        (ours_p, ours_q, bullet_p, bullet_q))
    assert ours_q < 1e-2

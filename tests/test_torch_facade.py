"""The stateful Simulation facade of panda_gym_tpu_torch
(panda_gym_tpu_torch/sim/facade.py): the cases of tests/test_facade.py on
the port, every one on the CPU, and parity with the JAX package's
Simulation from the same robot-only scene (stock inertia, force clamps);
tests/test_torch_facade_contact.py holds the scenes with bodies and
obstacles.

The JAX facade runs eagerly (``jax.jit`` the identity, ``lax.scan`` a
Python loop; tests/test_torch_collision.py says why).  Tolerances follow
tests/test_dynamics.py: q 2e-5, qd 2e-3 (:295-296), positions and link
quantities 2e-4 (:240-245).
"""
import json

import jax
import numpy as np
import pytest

from panda_gym_tpu_torch.native import boxes_from_urdf, compile_urdf_boxes
from panda_gym_tpu_torch.sim.facade import Simulation

ATOL_POS, ATOL_Q, ATOL_QD = 2e-4, 2e-5, 2e-3


@pytest.fixture()
def sim():
    s = Simulation(n_substeps=20, device="cpu")
    s.load_robot(base_position=(-0.6, 0.0, 0.0))
    s.create_plane(z_offset=-0.4)
    s.create_table(length=1.1, width=0.7, height=0.4)
    return s


URDF = """<robot name="shelf">
  <link name="base">
    <collision><origin xyz="0.1 0 0.2"/><geometry><box size="0.2 0.4 0.02"/></geometry></collision>
  </link>
  <link name="post">
    <collision><origin xyz="0 0 0.1" rpy="0 0 0.3"/><geometry><cylinder radius="0.02" length="0.2"/></geometry></collision>
  </link>
  <link name="panel">
    <collision><geometry><mesh filename="../meshes/panel.obj" scale="1 2 1"/></geometry></collision>
  </link>
  <joint name="j1" type="fixed"><parent link="base"/><child link="post"/><origin xyz="0 0.15 0"/></joint>
  <joint name="j2" type="fixed"><parent link="post"/><child link="panel"/><origin xyz="0 0 0.3" rpy="0.2 0 0"/></joint>
</robot>
"""
OBJ = "".join(f"v {x} {y} {z}\n" for x in (-0.05, 0.05) for y in (-0.1, 0.1)
              for z in (0.0, 0.01)) + "f 1 2 3\n"


def _write_scenario(root):
    scen = root / "shelf"
    (scen / "urdf").mkdir(parents=True)
    (scen / "meshes").mkdir()
    (scen / "urdf" / "shelf.urdf").write_text(URDF)
    (scen / "meshes" / "panel.obj").write_text(OBJ)
    (scen / "shelf.json").write_text(json.dumps({"shelf": {
        "fileName": "shelf.urdf", "basePosition": [0.5, 0.0, 0.0],
        "useFixedBase": True, "globalScaling": 1.4}}))
    return scen


def test_native_and_python_compilers_match_jax(tmp_path):
    """The port's URDF box compiler (native assetc read by path, and its
    Python version) against the JAX package's on the same scenario."""
    from panda_gym_tpu.native import compile_urdf_boxes as jax_compile
    urdf = str(_write_scenario(tmp_path) / "urdf" / "shelf.urdf")
    for scale in (1.0, 1.4):
        ref = jax_compile(urdf, (0.5, 0.0, 0.0), global_scaling=scale)
        ours = compile_urdf_boxes(urdf, (0.5, 0.0, 0.0),
                                  global_scaling=scale)
        py = np.asarray(boxes_from_urdf(urdf, (0.5, 0.0, 0.0), scale))
        assert ref.shape == (3, 6)
        np.testing.assert_allclose(ours, ref, atol=1e-5)
        np.testing.assert_allclose(py, ref, atol=1e-5)


NEUTRAL = [0.0, -0.3, 0.0, -2.2, 0.0, 2.0, 0.785]


@pytest.fixture()
def sim():
    s = Simulation(n_substeps=20, device="cpu")
    s.load_robot(base_position=(-0.6, 0.0, 0.0))
    s.create_plane(z_offset=-0.4)
    s.create_table(length=1.1, width=0.7, height=0.4)
    return s


def test_dt(sim):
    """pybullet_test.py:30-35: dt == timestep * n_substeps == 0.04."""
    assert sim.dt == pytest.approx(0.04)
    assert Simulation(n_substeps=10, device="cpu").dt == pytest.approx(0.02)


def test_gravity_free_fall_golden(sim):
    """pybullet_test.py:56-64: after one step a free body falls with
    v_z = -g * dt = -0.3924."""
    sim.create_sphere("ball", radius=0.03, mass=1.0, position=(0.0, 0.0, 1.0))
    sim.step()
    v = sim.get_base_velocity("ball")
    assert v[2] == pytest.approx(-9.81 * 0.04, rel=1e-4)
    p = sim.get_base_position("ball")
    assert 0.98 < p[2] < 1.0


def test_joint_angle_roundtrip(sim):
    sim.set_joint_angles("robot", list(range(7)), NEUTRAL)
    q = sim.get_joint_angles("robot", list(range(7)))
    np.testing.assert_allclose(q, NEUTRAL, atol=1e-7)
    assert sim.get_joint_angle("robot", 3) == pytest.approx(-2.2)
    # velocities zeroed by resetJointState semantics (pybullet.py:400-414)
    assert np.allclose(sim.get_joint_velocities("robot", list(range(7))), 0)


def test_control_joints_position_servo(sim):
    """pybullet.py:437-463: POSITION control drives toward the target."""
    sim.set_joint_angles("robot", list(range(7)), NEUTRAL)
    tgt = list(NEUTRAL)
    tgt[0] = 0.4
    sim.control_joints("robot", list(range(7)), tgt)
    for _ in range(30):
        sim.step()
    assert sim.get_joint_angle("robot", 0) == pytest.approx(0.4, abs=0.02)


def test_link_kinematics(sim):
    """pybullet_test.py:124-136: link positions from FK; ee above the
    table, base-offset applied."""
    sim.set_joint_angles("robot", list(range(7)), NEUTRAL)
    ee = sim.get_link_position("robot", 11)
    assert ee.shape == (3,)
    assert np.isfinite(ee).all()
    assert ee[2] > 0.2  # neutral pose holds the ee above the table
    quat = sim.get_link_orientation("robot", 11)
    assert np.linalg.norm(quat) == pytest.approx(1.0, abs=1e-5)
    # static robot: zero link velocity
    assert np.allclose(sim.get_link_velocity("robot", 11), 0, atol=1e-6)
    assert np.allclose(sim.get_link_angular_velocity("robot", 11), 0,
                       atol=1e-6)


def test_inverse_kinematics(sim):
    """pybullet_test.py:254-266: IK joint vector actually reaches the
    target under FK."""
    target = np.array([0.0, 0.2, 0.4])
    q = sim.inverse_kinematics("robot", 11, target)
    sim.set_joint_angles("robot", list(range(7)), q[:7])
    err = np.linalg.norm(sim.get_link_position("robot", 11) - target)
    assert err < 1e-4


def test_geometry_factory_and_remove(sim):
    """pybullet_test.py:276-323 creators + remove_body :104-115."""
    sim.create_box("b", half_extents=(0.02, 0.02, 0.02), mass=0.5,
                   position=(0.1, 0.0, 0.1))
    sim.create_cylinder("c", radius=0.03, height=0.1, mass=0.2,
                        position=(0.2, 0.0, 0.1))
    sim.create_sphere("s", radius=0.02, mass=0.0, position=(0.3, 0.0, 0.1))
    assert np.allclose(sim.get_base_position("b"), [0.1, 0.0, 0.1])
    assert np.allclose(sim.get_base_position("s"), [0.3, 0.0, 0.1])
    sim.step()  # compiles with 2 dynamic bodies + 1 obstacle
    sim.remove_body("s")
    sim.remove_body("c")
    sim.step()  # recompiles after scene edit
    with pytest.raises(KeyError):
        sim.get_base_position("s")


def test_set_base_pose(sim):
    """pybullet.py:350-366."""
    sim.create_box("b", half_extents=(0.02,) * 3, mass=0.5,
                   position=(0.1, 0.0, 0.1))
    sim.set_base_pose("b", (0.2, 0.1, 0.3), (0.0, 0.0, 0.0, 1.0))
    assert np.allclose(sim.get_base_position("b"), [0.2, 0.1, 0.3])
    rot = sim.get_base_rotation("b", type="euler")
    assert np.allclose(rot, 0.0, atol=1e-6)


def test_save_restore_state_exact(sim):
    """pybullet_test.py save/restore + removed-state error (pybullet.py:
    79-102)."""
    sim.set_joint_angles("robot", list(range(7)), NEUTRAL)
    sid = sim.save_state()
    tgt = list(NEUTRAL)
    tgt[1] = 0.5
    sim.control_joints("robot", list(range(7)), tgt)
    sim.step()
    moved = sim.get_joint_angles("robot", list(range(7)))
    assert not np.allclose(moved, NEUTRAL, atol=1e-5)
    sim.restore_state(sid)
    np.testing.assert_array_equal(
        sim.get_joint_angles("robot", list(range(7))),
        np.asarray(NEUTRAL, np.float32))
    sim.remove_state(sid)
    with pytest.raises(KeyError):
        sim.restore_state(sid)


def test_friction_setters(sim):
    """pybullet.py:880-906."""
    sim.create_box("b", half_extents=(0.02,) * 3, mass=0.5,
                   position=(0.1, 0.0, 0.1))
    sim.set_lateral_friction("b", link=-1, lateral_friction=0.04)
    assert sim._bodies_idx["b"]["mu"] == pytest.approx(0.04)
    sim.set_spinning_friction("b", link=-1, spinning_friction=0.01)
    assert sim._bodies_idx["b"]["spinning_mu"] == pytest.approx(0.01)


def test_obstacle_collision_flag():
    """Static (mass 0) bodies participate in the collision check."""
    sim = Simulation(device="cpu")
    sim.load_robot()
    # box enclosing the ee region at the zero pose -> shallow contact flags
    sim.create_box("blocker", half_extents=(0.03, 0.03, 0.03), mass=0.0,
                   position=(0.088, 0.0, 0.926))  # at zero-pose ee
    for _ in range(3):
        sim.step()
    assert sim.is_collided


def test_render_and_debug_lines(sim):
    """pybullet.py:117-180 render + :858-878 debug lines."""
    img_plain = sim.render(width=160, height=120)
    sim.create_debug_line((0.0, 0.0, 0.2), (0.3, 0.3, 0.5), color=(1, 0, 0))
    img = sim.render(width=160, height=120)
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    assert (img != img_plain).any()


def test_load_scenario_assets(sim, tmp_path):
    """pybullet.py:518-532 loadURDF/load_scenario through assetc (or its
    Python version), globalScaling honoured: a scenario folder in the
    reference's layout (manifest + urdf/ + meshes/)."""
    scen = _write_scenario(tmp_path)
    sim.load_scenario(str(scen))
    # globalScaling 1.4 scales the joint and collision origins, not the base
    pos = sim.get_base_position("shelf_box0")
    np.testing.assert_allclose(pos, [0.5 + 1.4 * 0.1, 0.0, 1.4 * 0.2],
                               atol=1e-6)
    assert "shelf_box2" in sim._bodies_idx and "shelf_box3" not in \
        sim._bodies_idx
    sim.step()
    assert sim._state.obstacle_pos.shape == (1, 3, 3)


def test_no_rendering_ctx_and_close(sim):
    with sim.no_rendering():
        sim.create_sphere("tmp", radius=0.01, mass=0.0, position=(1, 1, 1))
    sim.place_visualizer(target_position=np.zeros(3), distance=0.9, yaw=45,
                         pitch=-30)
    sim.close()


def test_ghost_bodies_addressable(sim):
    """Ghost bodies (reference target markers) are name-addressable but
    excluded from collision (pybullet.py ghost semantics)."""
    sim.create_sphere("target", radius=0.02, mass=0.0, ghost=True,
                      position=(0.2, 0.1, 0.3))
    assert np.allclose(sim.get_base_position("target"), [0.2, 0.1, 0.3])
    sim.set_base_pose("target", (0.3, 0.0, 0.2), (0, 0, 0, 1))
    assert np.allclose(sim.get_base_position("target"), [0.3, 0.0, 0.2])
    sim.step()  # compiles without the ghost in the obstacle arrays
    assert not sim.is_collided


def test_scene_edit_preserves_stepped_state(sim):
    """Scene mutations must not rewind dynamic bodies to spawn poses."""
    sim.create_sphere("ball", radius=0.03, mass=1.0, position=(0.0, 0.0, 1.0))
    for _ in range(5):
        sim.step()
    z_fallen = sim.get_base_position("ball")[2]
    assert z_fallen < 0.95
    sim.create_sphere("late", radius=0.02, mass=0.0, position=(1, 1, 1))
    sim.step()  # rebuild with the stepped pose, not the spawn pose
    assert sim.get_base_position("ball")[2] < z_fallen


def test_timestep_and_gravity_honored():
    """Non-default constructor args must reach the engine."""
    moon = Simulation(n_substeps=10, timestep=1.0 / 240.0,
                      gravity=(0.0, 0.0, -1.62), device="cpu")
    moon.load_robot()
    moon.create_plane(z_offset=-10.0)
    moon.create_sphere("ball", radius=0.03, mass=1.0, position=(0.5, 0, 1.0))
    moon.step()
    v = moon.get_base_velocity("ball")
    assert v[2] == pytest.approx(-1.62 * moon.dt, rel=1e-4)


def test_collision_does_not_freeze_stepping(sim):
    """The reference facade never halts on contact; is_collided is a sticky
    query flag cleared by reset_collision_flag()."""
    sim.create_box("blocker", half_extents=(0.03, 0.03, 0.03), mass=0.0,
                   position=(0.088 - 0.6, 0.0, 0.926))  # at zero-pose ee
    for _ in range(3):
        sim.step()
    assert sim.is_collided
    # robot still responds to control after contact
    sim.control_joints("robot", [0], [0.5])
    for _ in range(20):
        sim.step()
    assert sim.get_joint_angle("robot", 0) == pytest.approx(0.5, abs=0.05)
    sim.reset_collision_flag()
    assert not sim.is_collided


def test_static_cylinder_is_volumetric(sim):
    """A static cylinder must block along its full height (bounding-box
    approximation), not just a sphere of its radius."""
    sim.create_cylinder("pillar", radius=0.05, height=0.6, mass=0.0,
                        position=(0.5, 0.0, 0.3))
    st = sim._ensure_state()
    i = [n for n, _ in sim._obstacles()].index("pillar")
    assert np.allclose(st.obstacle_size[0, i].numpy(), [0.05, 0.05, 0.3])


def test_restore_state_restores_ctrl_targets(sim):
    """After restore, a partial control_joints must not resurrect stale
    pre-restore targets for the untouched joints."""
    sim.set_joint_angles("robot", list(range(7)), NEUTRAL)
    sim.control_joints("robot", list(range(7)), NEUTRAL)
    sid = sim.save_state()
    pose_a = list(NEUTRAL)
    pose_a[1] = 0.6
    sim.control_joints("robot", list(range(7)), pose_a)
    sim.step()
    sim.restore_state(sid)
    sim.control_joints("robot", [0], [0.3])  # partial update
    tgt = sim._state.ctrl_target[0].numpy()
    assert tgt[1] == pytest.approx(NEUTRAL[1])  # not pose_a's 0.6


def test_dummy_pose_velocity_and_debug_surface(sim):
    """pybullet.py:383-414,867-878: raw-id pose/velocity setters (Euler
    orientations converted) and debug bookkeeping survive round trips."""
    sim.create_sphere("probe", radius=0.03, mass=1.0, position=(0.2, 0.0, 0.5))
    sim.set_base_pose_dummy("probe", np.array([0.3, 0.1, 0.6]),
                            np.array([0.0, 0.0, 0.0]))  # 3-vec => Euler
    assert np.allclose(sim.get_base_position("probe"), [0.3, 0.1, 0.6])
    sim.set_base_velocity_dummy("probe", np.array([0.5, 0.0, 0.0]))
    assert np.allclose(sim.get_base_velocity("probe"), [0.5, 0.0, 0.0])
    sim.set_debug_object_color("probe", (1.0, 0.0, 0.0))
    assert np.allclose(sim._bodies_idx["probe"]["debug_color"], [1, 0, 0])
    sim.create_debug_text("hud", "x")
    sim.create_debug_text("hud2", "y")
    sim.remove_all_debug_text()
    assert sim._debug_texts == {}


def test_obstacle_base_velocity_moves_it(sim):
    """resetBaseVelocity on a kinematic obstacle makes it drift by v*dt per
    policy step (reach_ao.py:1091-1099 moving obstacles); the getter reads
    back the set velocity."""
    sim.create_sphere("mover", radius=0.05, mass=0.0,
                      position=(0.4, 0.0, 0.4))
    sim.set_base_velocity("mover", np.array([0.1, 0.0, 0.0]))
    assert np.allclose(sim.get_base_velocity("mover"), [0.1, 0.0, 0.0])
    p0 = np.asarray(sim.get_base_position("mover"))
    sim.step()
    dx = np.asarray(sim.get_base_position("mover")) - p0
    assert dx[0] == pytest.approx(sim.dt * 0.1, rel=1e-4)
    assert np.allclose(dx[1:], 0.0, atol=1e-7)


def test_set_base_pose_euler_orientation(sim):
    """set_base_pose accepts 3-element euler like the reference
    (pybullet.py:362-363 getQuaternionFromEuler)."""
    sim.create_sphere("ball", radius=0.03, mass=0.0,
                      position=(0.3, 0.0, 0.3))
    sim.set_base_pose("ball", np.array([0.3, 0.0, 0.3]),
                      np.array([0.0, 0.0, np.pi / 2]))
    q = sim.get_base_orientation("ball")
    assert np.allclose(q, [0.0, 0.0, np.sqrt(0.5), np.sqrt(0.5)], atol=1e-6)


def test_pybullet_joint_numbering_mapping():
    """Joint getters/setters accept the reference's PyBullet joint numbering
    (panda.py:62 joint_indices=[0..6, 9, 10]; 7/8 are fixed joints): fingers
    map to the chain's prismatic dofs 7/8, fixed joints read 0.0 and ignore
    writes."""
    s = Simulation(n_substeps=20, device="cpu")
    s.load_robot(gripper="prismatic")
    s.set_joint_angles("robot", [0, 1, 2, 3, 4, 5, 6, 9, 10],
                       NEUTRAL + [0.03, 0.02])
    assert s.get_joint_angle("robot", 9) == pytest.approx(0.03)
    assert s.get_joint_angle("robot", 10) == pytest.approx(0.02)
    assert s.get_joint_angle("robot", 7) == 0.0   # fixed joint
    assert s.get_joint_angle("robot", 8) == 0.0
    qs = s.get_joint_angles("robot", [3, 7, 9, 10])
    np.testing.assert_allclose(qs, [-2.2, 0.0, 0.03, 0.02], atol=1e-7)
    assert s.get_joint_velocities("robot", [7, 9]).tolist() == [0.0, 0.0]
    s.set_joint_angle("robot", 7, 9.9)            # ignored, no dof
    assert s.get_joint_angle("robot", 7) == 0.0
    s.control_joints("robot", [0, 9], [0.5, 0.04])

    # welded-finger variant: finger joints have no dof; everything reads 0.0
    w = Simulation(n_substeps=20, device="cpu")
    w.load_robot(gripper="welded")
    w.set_joint_angles("robot", [0, 9, 10], [0.3, 0.03, 0.02])
    assert w.get_joint_angle("robot", 0) == pytest.approx(0.3)
    assert w.get_joint_angle("robot", 9) == 0.0
    assert w.get_joint_angle("robot", 10) == 0.0


# ---------------------------------------------------------------------------
# parity with the JAX package's Simulation


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.fixture
def jax_sim(monkeypatch):
    """The JAX package's Simulation class, its step eager."""
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    from panda_gym_tpu.sim.facade import Simulation as JaxSimulation
    return JaxSimulation


def _both(jax_cls, build):
    out = []
    for s in (jax_cls(n_substeps=20), Simulation(n_substeps=20,
                                                 device="cpu")):
        build(s)
        out.append(s)
    return out


def _hold(j, t, msg, bodies=(), links=(11,)):
    np.testing.assert_allclose(t._state.q[0].numpy(), np.asarray(j._state.q),
                               atol=ATOL_Q, err_msg=msg)
    np.testing.assert_allclose(t._state.qd[0].numpy(),
                               np.asarray(j._state.qd), atol=ATOL_QD,
                               err_msg=msg)
    for link in links:
        np.testing.assert_allclose(t.get_link_position("robot", link),
                                   j.get_link_position("robot", link),
                                   atol=ATOL_POS, err_msg=msg)
    for b in bodies:
        for get in ("get_base_position", "get_base_velocity"):
            np.testing.assert_allclose(getattr(t, get)(b),
                                       getattr(j, get)(b), atol=ATOL_POS,
                                       err_msg=f"{get} {b}, {msg}")
    assert t.is_collided == bool(j._state.is_collided), msg


def test_robot_only_stock_inertia_with_clamps_matches_jax(jax_sim):
    """Stock inertia, joints 1, 3 and 5 clamped to 20, 10 and 5 N m and
    driven away from their pose: 3 steps, then a changed clamp (the step
    rebuilt, the poses kept) and 2 more."""
    def build(s):
        s.load_robot(base_position=(-0.6, 0.0, 0.0), inertia="stock")
        s.set_joint_angles("robot", list(range(7)), NEUTRAL)
        tgt = list(NEUTRAL)
        tgt[1], tgt[3], tgt[5] = 0.4, -1.6, 2.6
        s.control_joints("robot", list(range(7)), tgt,
                         [87.0, 20.0, 87.0, 10.0, 12.0, 5.0, 12.0])

    j, t = _both(jax_sim, build)
    for i in range(5):
        if i == 3:
            for s in (j, t):
                s.control_joints("robot", [5], [2.6], [2.0])
        j.step()
        t.step()
        _hold(j, t, f"step {i}", links=(5, 11))
        np.testing.assert_allclose(t.get_link_orientation("robot", 5),
                                   j.get_link_orientation("robot", 5),
                                   atol=ATOL_POS)
    assert t.physics.route == "k1"
    assert t.physics.motor.effort[5] == 2.0

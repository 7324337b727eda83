"""Port parity: the free-body contact physics of panda_gym_tpu_torch (the
penalty law, the quaternion helpers, the ground and robot-body contact
forces with the reaction tau_ext, and the ContactPhysics step) against
panda_gym_tpu, both on the CPU.

Both sides get the same seeded numpy inputs.  The forces are held against
the JAX package's per-env engine functions, vmapped; the step against both
of its physics steps, the per-env engine.make_physics_step (vmapped) and
its batched twin ops/scalarized_contact.py::make_batched_contact_physics,
which the JAX Push and Slide envs run.  The JAX steps run op by op with
``lax.scan`` as a Python loop (test_torch_collision.py says why).

The step is stiff (kn = 8000 at dt = 1/500 s) and its explicit friction
law amplifies a rounding difference about 1.45-fold per substep, so the
step is held at 1 and 4 substeps here; test_torch_classic.py holds whole
policy steps.  Tolerances are stated beside each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.math import transforms as JT
from panda_gym_tpu.models.panda import make_panda_model as jax_panda
from panda_gym_tpu.ops import contact as JC
from panda_gym_tpu.ops import kinematics as JK
from panda_gym_tpu.ops import scalarized_contact as JSC
from panda_gym_tpu.sim import engine as JE
from panda_gym_tpu.sim.state import EnvState as JaxEnvState
from panda_gym_tpu.sim.state import build_scene as jax_scene

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.math import transforms as TT
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import contact as TC
from panda_gym_tpu_torch.ops import dynamics as TD
from panda_gym_tpu_torch.ops import kinematics as TK
from panda_gym_tpu_torch.sim import engine as TE
from panda_gym_tpu_torch.sim.state import (SHAPE_BOX, SHAPE_CYLINDER,
                                           SHAPE_SPHERE, build_scene)

B = 8
DT = 1.0 / 500.0
BASE = (-0.6, 0.0, 0.0)
# the free bodies of Push (a 4 cm cube), Slide (a puck, mu 0.04) and a ball
BODIES = {
    "box": dict(shape=SHAPE_BOX, size=(0.02, 0.02, 0.02), mass=1.0),
    "cylinder": dict(shape=SHAPE_CYLINDER, size=(0.03, 0.015, 0.0),
                     mass=1.0, mu=0.04),
    "sphere": dict(shape=SHAPE_SPHERE, size=(0.03, 0.0, 0.0), mass=1.0),
}
TABLE = (1.1, 0.7, 0.4, -0.3)


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.fixture
def eager_scan(monkeypatch):
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)


@pytest.fixture(scope="module")
def models():
    return jax_panda(base_position=BASE), make_panda_model(base_position=BASE)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ------------------------------------------------------------- contact law

def test_penalty_force_matches_jax():
    """Penetrating and separated samples, slip below, near and above the
    friction's v_eps: the per-env law and the batched one of the JAX
    package, atol 1e-4 N on forces up to ~100 N (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    n = 4096
    depth = rng.uniform(-0.005, 0.012, n).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    v_rel = (rng.normal(size=(n, 3)) * rng.choice([1e-4, 2e-3, 0.05], (n, 1))
             ).astype(np.float32)
    got = TC.penalty_force(_t(depth), _t(normal), _t(v_rel), 0.5).numpy()
    ref = np.asarray(JC.penalty_force(jnp.asarray(depth), jnp.asarray(normal),
                                      jnp.asarray(v_rel), 0.5))
    batched = np.stack(JSC.penalty_force(
        jnp.asarray(depth), tuple(jnp.asarray(normal[:, i]) for i in range(3)),
        tuple(jnp.asarray(v_rel[:, i]) for i in range(3)), 0.5), -1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, batched, rtol=1e-6, atol=1e-4)
    assert (depth < 0).any() and not got[depth < 0].any()
    assert np.abs(got).max() > 50.0


def test_quaternion_helpers_match_jax():
    """quat_mul, quat_normalize, quat_to_euler and quat_integrate against
    math/transforms.py, atol 1e-6 (quat_to_euler 2e-6 rad)."""
    rng = np.random.default_rng(1)
    q1, q2 = _quats(rng, 256), _quats(rng, 256)
    om = (rng.normal(size=(256, 3)) * rng.choice([0.0, 1e-3, 5.0], (256, 1))
          ).astype(np.float32)
    np.testing.assert_allclose(TT.quat_mul(_t(q1), _t(q2)).numpy(),
                               np.asarray(JT.quat_mul(q1, q2)), atol=1e-6)
    np.testing.assert_allclose(TT.quat_normalize(_t(3.0 * q1)).numpy(),
                               np.asarray(JT.quat_normalize(3.0 * q1)),
                               atol=1e-6)
    np.testing.assert_allclose(TT.quat_to_euler(_t(q1)).numpy(),
                               np.asarray(JT.quat_to_euler(q1)), atol=2e-6)
    np.testing.assert_allclose(
        TT.quat_integrate(_t(q1), _t(om), DT).numpy(),
        np.asarray(JT.quat_integrate(q1, om, DT)), atol=1e-6)


# ------------------------------------------------------------ ground forces

def _body_states(rng, n, z0):
    """Body poses over the table and past its edge (the plane), a few mm
    into the ground or above it, with velocities."""
    pos = np.stack([rng.uniform(-0.9, 0.5, n), rng.uniform(-0.45, 0.45, n),
                    z0 + rng.uniform(-0.004, 0.003, n)], -1).astype(np.float32)
    tilt = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    quat = np.concatenate([np.sin(tilt / 2), np.ones((n, 1), np.float32)], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    ang = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return pos, quat.astype(np.float32), vel, ang


@pytest.mark.parametrize("body", ["box", "cylinder", "sphere"])
def test_body_ground_forces_match_jax(body):
    """The 12 samples per body against the table top and the plane: force
    atol 1e-3 N and torque 2e-5 N m (forces up to ~100 N)."""
    spec = BODIES[body]
    scene = build_scene([spec], *TABLE)
    jscene = jax_scene([spec], *TABLE)
    rng = np.random.default_rng(2)
    z0 = {"box": 0.02, "cylinder": 0.015, "sphere": 0.03}[body]
    pos, quat, vel, ang = _body_states(rng, 256, z0)
    pos[:8, 2] += np.float32(-0.3 - z0)      # over the plane, past the edge
    pos[:8, 0] = np.float32(0.3)
    R = TT.quat_to_mat(_t(quat))
    f, t = TE.body_ground_forces(scene, 0, _t(pos), R, _t(vel), _t(ang))
    jf, jt = jax.vmap(lambda p, r, v, w: JE._body_ground_forces(
        jscene, 0, p, r, v, w))(pos, jnp.asarray(R.numpy()), vel, ang)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-5)
    assert (f[:, 2] > 1.0).sum() > 32 and (f[:, 2] == 0).sum() > 32


# ---------------------------------------------------- robot-body contact

def _contact_inputs(tm, body, seed):
    """Random arm states near the neutral pose, and a body put a few mm into
    one of the robot's capsules (env b on capsule b), or clear of the arm in
    the last two envs."""
    rng = np.random.default_rng(seed)
    neutral = np.array([0.0, 0.41, 0.0, -1.85, 0.0, 2.26, 0.79], np.float32)
    q = (neutral + rng.normal(0, 0.2, (B, 7))).astype(np.float32)
    qd = rng.normal(0, 0.5, (B, 7)).astype(np.float32)
    fk = TK.fk_world(tm, _t(q), _t(qd))
    p0, p1 = TK.capsule_endpoints_world(tm, fk)
    rc = np.asarray(tm.cap_radius)
    caps = [i for i, b in enumerate(tm.cap_body_tuple) if b >= 2]
    reach = BODIES[body]["size"][0]
    pos = np.zeros((B, 3), np.float32)
    for b in range(B):
        i = caps[(3 * b) % len(caps)]
        mid = 0.5 * (p0[b, i] + p1[b, i]).numpy()
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        pos[b] = mid + d * (rc[i] + reach - 0.004)
    pos[-2:] += np.float32(0.5)
    quat = _quats(rng, B)
    vel = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    ang = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
    return q, qd, pos, quat, vel, ang


@pytest.mark.parametrize("body", ["box", "cylinder", "sphere"])
def test_robot_body_contact_matches_jax(models, body):
    """Force and torque on the body, and the reaction tau_ext = sum_i
    J_i^T (-f_i) on the arm, against engine._robot_body_contact: force atol
    2e-3 N, torque 1e-4 N m, tau_ext 2e-3 N m (forces of tens of N)."""
    jm, tm = models
    spec = BODIES[body]
    scene = build_scene([spec], *TABLE)
    jscene = jax_scene([spec], *TABLE)
    q, qd, pos, quat, vel, ang = _contact_inputs(tm, body, 3)
    R = TT.quat_to_mat(_t(quat))
    fk = TK.fk_world(tm, _t(q), _t(qd))
    f, t, tau = TE.robot_body_contact(tm, fk, *TK.capsule_endpoints_world(
        tm, fk), scene, 0, _t(pos), R, _t(vel), _t(ang))

    def one(q_, qd_, p, r, v, w):
        jfk = JK.fk_world(jm, q_, qd_)
        c0, c1 = JK.capsule_endpoints_world(jm, jfk)
        return JE._robot_body_contact(jm, jfk, c0, c1, jscene, 0, p, r, v, w)

    jf, jt, jtau = jax.vmap(one)(q, qd, pos, jnp.asarray(R.numpy()), vel, ang)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=2e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=2e-3)
    touching = np.linalg.norm(np.asarray(jf), axis=-1) > 1.0
    assert touching[:-2].sum() >= 4 and not touching[-2:].any()
    assert (tau.abs().amax(-1)[:-2] > 0.01).sum() >= 4
    assert not tau[-2:].any()


def test_sphere_in_a_capsule_is_pushed_out(models):
    """A sphere whose centre lies 1 cm from a capsule's axis, well inside
    it: the force points from the axis to the centre (repulsion), the
    sphere-normal rule of engine.py:84-89."""
    _, tm = models
    scene = build_scene([BODIES["sphere"]], *TABLE)
    q = torch.as_tensor([[0.0, 0.41, 0.0, -1.85, 0.0, 2.26, 0.79]])
    fk = TK.fk_world(tm, q, torch.zeros_like(q))
    p0, p1 = TK.capsule_endpoints_world(tm, fk)
    i = tm.cap_body_tuple.index(3)
    mid = 0.5 * (p0[0, i] + p1[0, i])
    axis = (p1[0, i] - p0[0, i]) / torch.linalg.vector_norm(p1[0, i] - p0[0, i])
    side = torch.linalg.cross(axis, torch.tensor([0.0, 0.0, 1.0]))
    side = side / torch.linalg.vector_norm(side)
    pos = (mid + 0.01 * side)[None]
    f, _, _ = TE.robot_body_contact(tm, fk, p0, p1, scene, 0, pos,
                                    torch.eye(3)[None], torch.zeros(1, 3),
                                    torch.zeros(1, 3))
    assert torch.dot(f[0], side).item() > 10.0


# ------------------------------------------------------------ the step

def _step_states(tm, body, seed):
    """A batch of states: bodies resting on the table in every env, and in
    envs 0-3 put 3 mm into a capsule of the hand from the side."""
    rng = np.random.default_rng(seed)
    neutral = np.array([0.0, 0.41, 0.0, -1.85, 0.0, 2.26, 0.79], np.float32)
    q = (neutral + rng.normal(0, 0.1, (B, 7))).astype(np.float32)
    qd = rng.normal(0, 0.3, (B, 7)).astype(np.float32)
    tgt = (q + rng.normal(0, 0.05, (B, 7))).astype(np.float32)
    z0 = {"box": 0.02, "cylinder": 0.015, "sphere": 0.03}[body]
    pos = np.stack([rng.uniform(-0.15, 0.15, B), rng.uniform(-0.15, 0.15, B),
                    np.full(B, z0)], -1).astype(np.float32)
    fk = TK.fk_world(tm, _t(q))
    p0, p1 = TK.capsule_endpoints_world(tm, fk)
    rc = np.asarray(tm.cap_radius)
    hand = [i for i, b in enumerate(tm.cap_body_tuple) if b == 6]
    half_x = BODIES[body]["size"][0]
    for b in range(4):
        i = hand[b % len(hand)]
        side = np.array([(-1.0) ** b, 0.0, 0.0], np.float32)
        mid = 0.5 * (p0[b, i] + p1[b, i]).numpy()
        pos[b] = mid + side * (rc[i] + half_x - 0.003)
    quat = np.tile(np.array([0, 0, 0, 1], np.float32), (B, 1))
    return dict(q=q, qd=qd, ctrl_target=tgt, body_pos=pos[:, None],
                body_quat=quat[:, None],
                body_vel=np.zeros((B, 1, 3), np.float32),
                body_ang=np.zeros((B, 1, 3), np.float32))


def _jax_states(fields):
    """A JAX EnvState batch of the given fields, the rest as init_state."""
    n = fields["q"].shape[0]
    base = dict(
        obstacle_pos=np.full((n, 1, 3), 99.9, np.float32),
        obstacle_vel=np.zeros((n, 1, 3), np.float32),
        obstacle_size=np.full((n, 1, 3), 1e-3, np.float32),
        obstacle_type=np.zeros((n, 1), np.int32),
        obstacle_active=np.zeros((n, 1), bool),
        goal=np.zeros((n, 3), np.float32),
        key=np.zeros((n, 2), np.uint32), steps=np.zeros(n, np.int32),
        is_collided=np.zeros(n, bool), goal_reached=np.zeros(n, bool),
        prev_action=np.zeros((n, 7), np.float32),
        recent_action=np.zeros((n, 7), np.float32),
        action_count=np.zeros(n, np.int32),
        cur_jvel=np.zeros((n, 7), np.float32),
        prev_jvel=np.zeros((n, 7), np.float32),
        cur_jacc=np.zeros((n, 7), np.float32),
        prev_jacc=np.zeros((n, 7), np.float32),
        cur_jerk=np.zeros((n, 7), np.float32),
        link_obstacle_dist=np.full((n, 9), 999.0, np.float32),
        past_obs=np.zeros((n, 3, 1), np.float32))
    return JaxEnvState(**{k: jnp.asarray(v)
                          for k, v in {**base, **fields}.items()})


# the step's tolerances after n substeps: q 2e-5 and qd 2e-3
# (tests/test_dynamics.py:295-296); the bodies' position, orientation
# (quaternion), velocity and angular velocity
ATOL_STEP = dict(q=2e-5, qd=2e-3, body_pos=1e-6, body_quat=2e-5,
                 body_vel=2e-4, body_ang=2e-3)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("n_substeps", [1, 4])
@pytest.mark.parametrize("body", ["box", "cylinder"])
def test_contact_physics_matches_jax(eager_scan, models, body, n_substeps,
                                     warm):
    """ContactPhysics against the per-env engine step (vmapped) and the
    batched contact step of the JAX package, from the same states, bodies
    pushed by the arm in envs 0-3."""
    jm, tm = models
    spec = BODIES[body]
    scene = build_scene([spec], *TABLE)
    jscene = jax_scene([spec], *TABLE)
    fields = _step_states(tm, body, 4)
    js = _jax_states(fields)
    kw = dict(n_substeps=n_substeps, ctrl_mode=0, robot_contact=True,
              warm_start=warm)
    j_env = jax.vmap(JE.make_physics_step(jm, jscene, **kw))(js)
    j_bat = JSC.make_batched_contact_physics(jm, jscene, dt=DT, **kw)(js)
    ts = convert.env_state({k: np.asarray(getattr(js, k))
                            for k in convert.FIELDS}, "cpu")
    phys = TE.ContactPhysics(tm, scene, **kw)
    out = phys(ts)
    assert phys.motor.launches == 0          # CPU tensors: the plain route
    for ref in (j_bat, j_env):
        for k, atol in ATOL_STEP.items():
            np.testing.assert_allclose(getattr(out, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       atol=atol, err_msg=k)
    moved = np.abs(out.body_vel.numpy()[:4]).max((1, 2))
    assert (moved > 0.01).all()


def test_contact_physics_resolves_warm_and_routes_by_device(models,
                                                           monkeypatch):
    """Warm unless PANDA_LCP_WARM=0, as the JAX batched contact step; K1 at
    one substep, its set carried by the wrapper; the engine builds
    ContactPhysics for a scene with bodies."""
    _, tm = models
    scene = build_scene([BODIES["box"]], *TABLE)
    monkeypatch.delenv("PANDA_LCP_WARM", raising=False)
    phys = TE.make_batched_physics_step(tm, scene, robot_contact=True)
    assert isinstance(phys, TE.ContactPhysics)
    assert phys.warm_start and phys.motor.n_substeps == 1
    monkeypatch.setenv("PANDA_LCP_WARM", "0")
    monkeypatch.setattr(TD, "LCP_WARM_START", False)
    assert not TE.make_batched_physics_step(tm, scene,
                                            robot_contact=True).warm_start
    # with a collision check (the stateful Simulation's bodies beside
    # obstacles): the same step, cold by default as the per-env step
    monkeypatch.delenv("PANDA_LCP_WARM", raising=False)
    phys = TE.make_batched_physics_step(tm, scene, check_collision=True)
    assert isinstance(phys, TE.ContactPhysics) and phys.check is not None
    assert not phys.warm_start


def test_push_core_physics_is_contact_physics():
    env = make_core("push", device="cpu")
    assert isinstance(env.physics_step_batched, TE.ContactPhysics)
    assert env.physics_step_batched.robot_contact

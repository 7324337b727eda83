"""Port parity: forces between free bodies and the Stack task against
panda_gym_tpu, on the CPU.

The pair forces (body a's contact samples against body b's volume, equal
and opposite) are held against the JAX package's per-env
engine._body_body_forces, vmapped; the free-body step with a pair against
its per-env step and its batched twin (ops/scalarized_contact.py, which
the JAX Stack env runs), at 1 and 4 substeps; and Stack 3 steps end to end
from a JAX reset.  The second cube is put 1.5 mm into the top of the first
(the contact step is chaotic at depth), in envs 0-3, and on the table
beside it in envs 4-7.  The JAX steps run op by op with ``lax.scan`` as a
Python loop (test_torch_collision.py says why).  Tolerances are stated
beside each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core
from panda_gym_tpu.models.panda import make_panda_model as jax_panda
from panda_gym_tpu.ops import scalarized_contact as JSC
from panda_gym_tpu.sim import engine as JE
from panda_gym_tpu.sim.state import EnvState as JaxEnvState
from panda_gym_tpu.sim.state import build_scene as jax_scene

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.math import transforms as TT
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.sim import engine as TE
from panda_gym_tpu_torch.sim.state import SHAPE_BOX, SHAPE_SPHERE, build_scene

B = 8
DT = 1.0 / 500.0
BASE = (-0.6, 0.0, 0.0)
TABLE = (1.1, 0.7, 0.4, -0.3)
CUBE2 = dict(shape=SHAPE_BOX, size=(0.02, 0.02, 0.02), mass=2.0)
CUBE1 = dict(shape=SHAPE_BOX, size=(0.02, 0.02, 0.02), mass=1.0)
BALL = dict(shape=SHAPE_SPHERE, size=(0.025, 0.0, 0.0), mass=1.0)
# the top samples of a 4 cm cube (centre 0.018, radius 0.002) reach 0.02
# above its centre: a cube put this far above another sits 1.5 mm in it
STACKED = 0.04 - 0.0015
# a cube's samples are its 8 corners: a ball meets the top one on the
# diagonal, 1.5 mm deep
ON_CORNER = (0.018 + (0.025 + 0.002 - 0.0015) / np.sqrt(3.0),) * 3


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.fixture
def eager_scan(monkeypatch):
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _tilt(rng, n, scale):
    tilt = rng.normal(size=(n, 3)) * scale
    quat = np.concatenate([np.sin(tilt / 2), np.ones((n, 1))], -1)
    return (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(
        np.float32)


def _pair_states(rng, n, offset, jitter=0.005):
    """Body 0 on the table; body 1 resting 1.5 mm into it (a little tilted,
    moved in x and y by up to ``jitter``, moving) in the first half of the
    envs, 10 cm away in the second.  ``offset``: body 1's centre from body
    0's in contact."""
    pos0 = np.stack([rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n),
                     np.full(n, 0.02)], -1).astype(np.float32)
    pos1 = (pos0 + np.asarray(offset, np.float32)
            + rng.uniform(-jitter, jitter, (n, 3)) * [1.0, 1.0, 0.0])
    pos1[n // 2:, 0] += 0.1
    pos = np.stack([pos0, pos1.astype(np.float32)], 1)
    quat = np.stack([_tilt(rng, n, 0.01), _tilt(rng, n, 0.01)], 1)
    vel = rng.normal(0, 0.02, (n, 2, 3)).astype(np.float32)
    ang = rng.normal(0, 0.2, (n, 2, 3)).astype(np.float32)
    return pos, quat, vel, ang


@pytest.mark.parametrize("upper", ["cube", "ball"])
def test_body_body_forces_match_jax(upper):
    """The 2 kg cube's samples against a 1 kg cube or a ball put on it:
    force atol 1e-3 N, torque 2e-5 N m (forces of tens of N), against
    engine._body_body_forces; the pair's forces equal and opposite."""
    specs = [CUBE2, CUBE1 if upper == "cube" else BALL]
    scene, jscene = build_scene(specs, *TABLE), jax_scene(specs, *TABLE)
    offset = (0.0, 0.0, STACKED) if upper == "cube" else ON_CORNER
    n = 256
    pos, quat, vel, ang = _pair_states(np.random.default_rng(3), n, offset,
                                       0.005 if upper == "cube" else 2e-4)
    R = TT.quat_to_mat(_t(quat))
    args = (_t(pos[:, 0]), R[:, 0], _t(vel[:, 0]), _t(ang[:, 0]),
            _t(pos[:, 1]), R[:, 1], _t(vel[:, 1]), _t(ang[:, 1]))
    got = TE.body_body_forces(scene, 0, 1, *args)
    ref = jax.vmap(lambda *a: JE._body_body_forces(jscene, 0, 1, *a))(
        *(jnp.asarray(a.numpy()) for a in args))
    for g, r, atol in zip(got, ref, (1e-3, 2e-5, 1e-3, 2e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)
    fa, _, fb, _ = (g.numpy() for g in got)
    np.testing.assert_array_equal(fa, -fb)
    assert (fb[:n // 2, 2] > 0.5).all() and not fb[n // 2:].any()


def _jax_states(fields, ndof):
    """A JAX EnvState batch of the given fields, the rest as init_state."""
    n = fields["q"].shape[0]
    base = dict(
        obstacle_pos=np.full((n, 1, 3), 99.9, np.float32),
        obstacle_vel=np.zeros((n, 1, 3), np.float32),
        obstacle_size=np.full((n, 1, 3), 1e-3, np.float32),
        obstacle_type=np.zeros((n, 1), np.int32),
        obstacle_active=np.zeros((n, 1), bool),
        goal=np.zeros((n, 6), np.float32),
        key=np.zeros((n, 2), np.uint32), steps=np.zeros(n, np.int32),
        is_collided=np.zeros(n, bool), goal_reached=np.zeros(n, bool),
        prev_action=np.zeros((n, 4), np.float32),
        recent_action=np.zeros((n, 4), np.float32),
        action_count=np.zeros(n, np.int32),
        cur_jvel=np.zeros((n, 7), np.float32),
        prev_jvel=np.zeros((n, 7), np.float32),
        cur_jacc=np.zeros((n, 7), np.float32),
        prev_jacc=np.zeros((n, 7), np.float32),
        cur_jerk=np.zeros((n, 7), np.float32),
        link_obstacle_dist=np.full((n, 9), 999.0, np.float32),
        past_obs=np.zeros((n, 3, 1), np.float32))
    assert fields["q"].shape[1] == ndof
    return JaxEnvState(**{k: jnp.asarray(v)
                          for k, v in {**base, **fields}.items()})


# the step's tolerances after n substeps (test_torch_contact_physics.py's):
# q 2e-5 and qd 2e-3 (tests/test_dynamics.py:295-296); the bodies'
# position, orientation (quaternion), velocity and angular velocity
ATOL_STEP = dict(q=2e-5, qd=2e-3, body_pos=1e-6, body_quat=2e-5,
                 body_vel=2e-4, body_ang=2e-3)


@pytest.mark.parametrize("n_substeps", [1, 4])
def test_pair_physics_matches_jax(eager_scan, n_substeps):
    """ContactPhysics of the Stack scene (the 9-dof Panda, two cubes, the
    pair (0, 1)) against the per-env engine step (vmapped) and the batched
    contact step of the JAX package, the upper cube 1.5 mm into the lower
    one in envs 0-3."""
    jm = jax_panda(base_position=BASE, gripper="prismatic")
    tm = make_panda_model(base_position=BASE, gripper="prismatic")
    specs = [CUBE2, CUBE1]
    scene, jscene = build_scene(specs, *TABLE), jax_scene(specs, *TABLE)
    rng = np.random.default_rng(4)
    pos, quat, vel, ang = _pair_states(rng, B, (0.0, 0.0, STACKED))
    neutral = np.concatenate([tm.q_lo[:0], np.array(
        [0.0, 0.41, 0.0, -1.85, 0.0, 2.26, 0.79, 0.02, 0.02], np.float32)])
    q = (neutral + rng.normal(0, 0.01, (B, 9))).astype(np.float32)
    fields = dict(q=q, qd=np.zeros_like(q), ctrl_target=q.copy(),
                  body_pos=pos, body_quat=quat, body_vel=vel, body_ang=ang)
    js = _jax_states(fields, 9)
    kw = dict(n_substeps=n_substeps, ctrl_mode=0, robot_contact=True,
              body_pairs=((0, 1),))
    j_env = jax.vmap(JE.make_physics_step(jm, jscene, **kw))(js)
    j_bat = JSC.make_batched_contact_physics(jm, jscene, dt=DT, **kw)(js)
    ts = convert.env_state({k: np.asarray(getattr(js, k))
                            for k in convert.FIELDS}, "cpu")
    phys = TE.ContactPhysics(tm, scene, **kw)
    out = phys(ts)
    for ref in (j_bat, j_env):
        for k, atol in ATOL_STEP.items():
            np.testing.assert_allclose(getattr(out, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       atol=atol, err_msg=k)
    # the stacked cubes push each other: the upper one is held up
    f, *_ = phys.forces(ts.q, ts.qd, ts.body_pos, ts.body_quat, ts.body_vel,
                        ts.body_ang)
    assert (f[:4, 1, 2] > 5.0).all()


def _stack(pos, n):
    """The second cube on the first in envs 0..n-1, on the table 6 cm
    beside it (at the first cube's height) elsewhere."""
    pos = pos.copy()
    pos[:n, 1] = pos[:n, 0] + np.array([0.0, 0.0, STACKED], np.float32)
    pos[n:, 1] = pos[n:, 0] + np.array([0.0, 0.06, 0.0], np.float32)
    return pos


def test_stack_steps_match_jax(monkeypatch):
    """Stack, 3 steps of ee control from a JAX reset, the second cube put on
    the first in envs 0-3: q 2e-5, qd 2e-3, observation 2e-4, reward 1e-5,
    flags equal (test_torch_classic.py's).  The stacked cube stays on the
    first one."""
    core = jax_make_core("stack")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates, _ = jax.jit(jax.vmap(core.reset))(keys)
    pos = _stack(np.asarray(jstates.body_pos), 4)
    goal = np.asarray(jstates.goal).copy()
    goal[4:6] = pos[4:6].reshape(2, 6)       # two successes
    jstates = jstates.replace(body_pos=jnp.asarray(pos),
                              goal=jnp.asarray(goal))
    env = make_core("stack", device="cpu")
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    rng = np.random.default_rng(6)
    seen = set()
    for i in range(3):
        a = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
        jstates, jo, jr, jt, jtr, ji = core.batched_step(jstates,
                                                         jnp.asarray(a))
        tstates, to, tr, tt, ttr, ti = env.batched_step(tstates, a)
        msg = f"step {i}"
        np.testing.assert_allclose(tstates.q.numpy(), np.asarray(jstates.q),
                                   atol=2e-5, err_msg=msg)
        np.testing.assert_allclose(tstates.qd.numpy(), np.asarray(jstates.qd),
                                   atol=2e-3, err_msg=msg)
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=2e-4, err_msg=f"{k}, {msg}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                                   err_msg=msg)
        for t_, j_ in ((tt, jt), (ttr, jtr),
                       (ti["is_success"], ji["is_success"])):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_),
                                          err_msg=msg)
        seen.update(np.asarray(ji["is_success"]).tolist())
    assert seen == {True, False}
    p = tstates.body_pos.numpy()
    rise = p[:4, 1, 2] - p[:4, 0, 2]
    assert (np.abs(rise - 0.04) < 1e-3).all(), rise
    assert (np.abs(p[:4, 1, :2] - p[:4, 0, :2]) < 1e-3).all()


def test_stack_reset_matches_jax_from_the_same_draws(monkeypatch):
    """The goal's noise, the first cube, the second (the JAX reset's keys
    kg, k1, k2) from the port's draws: goal and cubes within 1e-6."""
    env = make_core("stack", device="cpu")
    n = 4
    states, obs = env.batched_reset(n, torch.Generator().manual_seed(9))
    again = torch.Generator().manual_seed(9)
    draws = [torch.rand(n, 3, generator=again).numpy() for _ in range(3)]
    core = jax_make_core("stack")
    for b in range(n):
        it = iter([d[b] for d in draws])

        def uniform(key, shape=(), minval=0.0, maxval=1.0):
            lo = np.asarray(minval, np.float32)
            hi = np.asarray(maxval, np.float32)
            return jnp.asarray(lo + (hi - lo) * next(it))

        with monkeypatch.context() as m:
            m.setattr(jax.random, "uniform", uniform)
            js, jo = core.reset(jax.random.PRNGKey(b))
        for k in ("goal", "body_pos", "body_quat"):
            np.testing.assert_allclose(getattr(states, k)[b].numpy(),
                                       np.asarray(getattr(js, k)), atol=1e-6,
                                       err_msg=k)
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(jo[k]),
                                       atol=1e-6, err_msg=k)
    assert env.task.body_pairs == ((0, 1),)
    assert isinstance(env.physics_step_batched, TE.ContactPhysics)
    assert env.physics_step_batched.body_pairs == ((0, 1),)

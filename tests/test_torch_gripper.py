"""Port parity: PickAndPlace and Flip, the tasks of the 9-dof Panda with
prismatic fingers, against panda_gym_tpu on the CPU.

The JAX side resets B = 8 envs; in envs 0-3 the fingers are opened to
3 cm each and the cube put between them, turned with the hand, so that
each finger's capsule sits 2 mm deep in a face (the contact step is
chaotic at depth: a deep penetration makes even the JAX package's two
steps part).  The state is carried across with panda_gym_tpu_torch.convert
and both sides take 3 steps (ee control) with the same numpy actions, whose
finger channel closes the gripper a little.  The JAX step runs op by op
with ``lax.scan`` as a Python loop (test_torch_collision.py says why).
Tolerances follow tests/test_dynamics.py: observations atol 2e-4, rewards
1e-5, flags equal (:240-245); q 2e-5, qd 2e-3 (:295-296); the gripped
cubes' velocities 5e-3 (ATOL_GRIP_VEL says why).  The resets are
held against the JAX resets given the same uniform draws, and the port's
fingers open and close as tests/test_envs.py:151-166 holds the JAX env's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.ops import kinematics as TK

B = 8
N_STEPS = 3
N_GRIPPED = 4
ATOL_OBS, ATOL_R, ATOL_Q, ATOL_QD = 2e-4, 1e-5, 2e-5, 2e-3
# A cube squeezed by two fingers is stiff in rotation: the JAX package's own
# two steps (per env and batched) part by up to 1.4e-2 in its velocity and
# angular velocity over these 3 steps (measured on the CPU), the port and
# the batched step by up to 1.5e-3; those entries of the gripped envs are
# held at 5e-3, everything else at the tolerances above.
ATOL_GRIP_VEL = 5e-3
# finger opening of the gripped envs, each finger; the capsules (radius
# 0.012) then sit 0.02 - (0.03 - 0.012) = 2 mm deep in the 4 cm cube
FINGER_Q = 0.03


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


def grip(model, q, pos, quat, n):
    """Envs 0..n-1 with open fingers (FINGER_Q each) and the cube between
    them: centred between the two finger capsules, turned about z so that
    the line between the fingers is its x axis.  numpy in, numpy out."""
    q = q.copy()
    q[:n, 7:9] = FINGER_Q
    fk = TK.fk_world(model, torch.as_tensor(q))
    p0, p1 = TK.capsule_endpoints_world(model, fk)
    mid = (0.5 * (p0 + p1)).numpy()
    left, right = (model.cap_body_tuple.index(d) for d in (7, 8))
    d = mid[:, right] - mid[:, left]
    yaw = np.arctan2(d[:, 1], d[:, 0])
    pos, quat = pos.copy(), quat.copy()
    pos[:n, 0] = 0.5 * (mid[:n, left] + mid[:n, right])
    quat[:n, 0] = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2),
                            np.cos(yaw / 2)], -1)[:n]
    return q, pos.astype(np.float32), quat.astype(np.float32)


@pytest.mark.parametrize("task", ["pickandplace", "flip"])
def test_batched_step_matches_jax(monkeypatch, task):
    core = jax_make_core(task)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates, _ = jax.jit(jax.vmap(core.reset))(keys)
    env = make_core(task, device="cpu")
    q, pos, quat = grip(env.model, np.asarray(jstates.q),
                        np.asarray(jstates.body_pos),
                        np.asarray(jstates.body_quat), N_GRIPPED)
    jstates = jstates.replace(q=jnp.asarray(q), ctrl_target=jnp.asarray(q),
                              body_pos=jnp.asarray(pos),
                              body_quat=jnp.asarray(quat))
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")

    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    rng = np.random.default_rng(5)
    start = pos[:, 0].copy()
    for i in range(N_STEPS):
        a = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
        a[:, 3] = -0.02  # close a little: 2 mm of width per step
        if i == 0:
            s_in = env.robot.set_action(tstates, torch.as_tensor(a))
            *_, tau_ext, _ = env.physics_step_batched.forces(
                s_in.q, s_in.qd, s_in.body_pos, s_in.body_quat,
                s_in.body_vel, s_in.body_ang)
            # the gripped cubes push the fingers apart; the others nothing
            assert (tau_ext[:N_GRIPPED, 7:].abs() > 1.0).all()
            assert not tau_ext[N_GRIPPED:].any()
        jstates, jo, jr, jt, jtr, ji = core.batched_step(jstates,
                                                         jnp.asarray(a))
        tstates, to, tr, tt, ttr, ti = env.batched_step(tstates, a)
        msg = f"{task} step {i}"
        np.testing.assert_allclose(tstates.q.numpy(), np.asarray(jstates.q),
                                   atol=ATOL_Q, err_msg=msg)
        np.testing.assert_allclose(tstates.qd.numpy(), np.asarray(jstates.qd),
                                   atol=ATOL_QD, err_msg=msg)
        for k in ("achieved_goal", "desired_goal"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=ATOL_OBS, err_msg=f"{k}, {msg}")
        # the gripped cubes' velocity and angular velocity, the last 6
        # entries, at their own tolerance
        obs, jobs = to["observation"].numpy(), np.asarray(jo["observation"])
        np.testing.assert_allclose(obs[:N_GRIPPED, -6:], jobs[:N_GRIPPED, -6:],
                                   atol=ATOL_GRIP_VEL, err_msg=msg)
        obs[:N_GRIPPED, -6:] = jobs[:N_GRIPPED, -6:]
        np.testing.assert_allclose(obs, jobs, atol=ATOL_OBS, err_msg=msg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL_R,
                                   err_msg=msg)
        for t_, j_ in ((tt, jt), (ttr, jtr),
                       (ti["is_success"], ji["is_success"])):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_),
                                          err_msg=msg)
    # the gripped cubes moved with the hand; the others rest on the table
    moved = np.abs(tstates.body_pos.numpy()[:, 0] - start).max(-1)
    assert (moved[:N_GRIPPED] > 1e-3).all()
    assert (np.abs(tstates.body_pos.numpy()[N_GRIPPED:, 0, 2] - 0.02)
            < 1e-3).all()


@pytest.mark.parametrize("task", ["pickandplace", "flip"])
def test_reset_matches_jax_from_the_same_draws(monkeypatch, task):
    """The port's batched_reset and the JAX reset of each env, the JAX
    side's uniform draws replaced by the port's (PickAndPlace: the goal's
    noise, the ground draw, the object; Flip: the quaternion's three
    uniforms, the object): goal and object within 1e-6, the observation
    within 1e-6."""
    env = make_core(task, device="cpu")
    n = 6
    states, obs = env.batched_reset(n, torch.Generator().manual_seed(7))
    again = torch.Generator().manual_seed(7)
    if task == "pickandplace":
        draws = [torch.rand(n, 3, generator=again), torch.rand(
            n, generator=again), torch.rand(n, 3, generator=again)]
    else:
        draws = [torch.rand(n, 3, generator=again),
                 torch.rand(n, 3, generator=again)]
    draws = [d.numpy() for d in draws]
    core = jax_make_core(task)
    for b in range(n):
        it = iter([d[b] for d in draws])

        def uniform(key, shape=(), minval=0.0, maxval=1.0):
            lo = np.asarray(minval, np.float32)
            hi = np.asarray(maxval, np.float32)
            return jnp.asarray(lo + (hi - lo) * next(it))

        with monkeypatch.context() as m:
            m.setattr(jax.random, "uniform", uniform)
            js, jo = core.reset(jax.random.PRNGKey(b))
        for k in ("goal", "body_pos", "body_quat", "body_vel", "body_ang",
                  "q", "qd"):
            np.testing.assert_allclose(getattr(states, k)[b].numpy(),
                                       np.asarray(getattr(js, k)), atol=1e-6,
                                       err_msg=k)
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(jo[k]),
                                       atol=1e-6, err_msg=k)
    if task == "pickandplace":
        on_ground = draws[1] < 0.3
        assert on_ground.any() and not on_ground.all()
        np.testing.assert_array_equal(states.goal[on_ground, 2].numpy(),
                                      np.float32(0.02))
    else:
        np.testing.assert_allclose(states.goal.norm(dim=-1).numpy(), 1.0,
                                   atol=1e-6)


def test_tasks_follow_the_reference():
    """ee control, the gripper free (9 dofs, a finger channel), the
    observation sizes of the reference (robot 7, object 12 or 13)."""
    for task, obs_dim, goal_dim in (("pickandplace", 19, 3), ("flip", 20, 4),
                                    ("stack", 31, 6)):
        env = make_core(task, device="cpu")
        assert env.robot.config.control_type == "ee"
        assert env.model.ndof == 9 and env.robot.action_dim == 4
        states, obs = env.batched_reset(2, torch.Generator().manual_seed(1))
        assert obs["observation"].shape == (2, obs_dim)
        assert obs["desired_goal"].shape == (2, goal_dim)
        assert not states.q[:, 7:].any()


def test_fingers_open_close():
    """The finger channel opens the gripper and closes it again
    (tests/test_envs.py:151-166 on the port)."""
    env = make_core("pickandplace", device="cpu")
    states, obs = env.batched_reset(1, torch.Generator().manual_seed(5))
    w0 = obs["observation"][0, 6].item()
    act = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    for _ in range(5):
        states, obs, *_ = env.batched_step(states, act)
    w_open = obs["observation"][0, 6].item()
    assert w_open > w0 + 0.02, (w0, w_open)
    for _ in range(8):
        states, obs, *_ = env.batched_step(states, -act)
    w_closed = obs["observation"][0, 6].item()
    assert w_closed < w_open - 0.02, (w_open, w_closed)
    # the two fingers take half the width each
    torch.testing.assert_close(states.q[0, 7], states.q[0, 8], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("control", ["ee", "js"])
def test_finger_targets_match_jax(control):
    """set_action of the 9-dof Panda with the gripper free, against the JAX
    robot's (vmapped, and under ee its batched IK route): the action's last
    entry moves the width by finger_change, and each finger takes half of
    it.  Arm targets atol 1e-5 (the IK's, tests/test_torch_control_modes.py),
    finger targets 1e-6."""
    env = make_core("pickandplace", control_type=control, device="cpu")
    robot = env.robot
    jrobot = jax_make_core("pickandplace", control_type=control).robot
    assert not robot.config.block_gripper and robot.model.ndof == 9
    assert jrobot.model.ndof == 9
    states, _ = env.batched_reset(B, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    q = states.q.numpy().copy()
    q[:, :7] += rng.normal(0, 0.1, (B, 7)).astype(np.float32)
    q[:, 7:] = rng.uniform(0.0, 0.04, (B, 2)).astype(np.float32)
    states = states.replace(q=torch.as_tensor(q))
    a = rng.uniform(-1, 1, (B, robot.action_dim)).astype(np.float32)
    out = robot.set_action(states, torch.as_tensor(a))
    jstates = _jax_state(states)
    routes = [jax.vmap(jrobot.set_action)]
    if control == "ee":
        routes.append(jrobot.make_set_action_batched())
    width = q[:, 7] + q[:, 8]
    want = np.clip(a[:, -1], -1, 1) * np.float32(0.2) + width
    np.testing.assert_allclose(out.ctrl_target[:, 7:].numpy(),
                               np.repeat(want[:, None] / 2, 2, 1), atol=1e-6)
    for route in routes:
        ref = route(jstates, jnp.asarray(a))
        np.testing.assert_allclose(out.ctrl_target[:, :7].numpy(),
                                   np.asarray(ref.ctrl_target)[:, :7],
                                   atol=1e-5)
        np.testing.assert_allclose(out.ctrl_target[:, 7:].numpy(),
                                   np.asarray(ref.ctrl_target)[:, 7:],
                                   atol=1e-6)
        np.testing.assert_array_equal(out.recent_action.numpy(),
                                      np.asarray(ref.recent_action))


def _jax_state(states):
    from panda_gym_tpu.sim.state import EnvState as JaxEnvState

    fields = convert.env_state_to_numpy(states)
    fields["key"] = np.zeros((states.q.shape[0], 2), np.uint32)
    return JaxEnvState(**{k: jnp.asarray(v) for k, v in fields.items()})

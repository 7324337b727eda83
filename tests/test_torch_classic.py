"""Port parity: the batched Push and Slide envs of panda_gym_tpu_torch
against panda_gym_tpu's, on the CPU.

The JAX side resets B = 8 envs; the object of envs 0-3 is put beside the
end effector, its face 1 cm from the fingertip, so that the arm pushes it
(a non-zero contact torque on the arm), and the goal of envs 4-5 1 cm from
their object (a success); the state is carried across with
panda_gym_tpu_torch.convert and both sides take 3 steps with the same numpy
actions.  The JAX step runs op by op with ``lax.scan`` as a Python loop
(test_torch_collision.py says why).  Tolerances follow tests/test_dynamics.py:
240-245 (the JAX package's batched contact step against its per-env step):
observations atol 2e-4, rewards 1e-5, the flags equal; q 2e-5 and qd 2e-3
(:295-296).  The resets are held against the JAX resets given the same
uniform draws.
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
N_PUSHED = 4
ATOL_OBS, ATOL_R, ATOL_Q, ATOL_QD = 2e-4, 1e-5, 2e-5, 2e-3
# object half widths along x: the cube's, and the puck's bounding box
HALF_X = {"push": 0.02, "slide": 0.03}


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.mark.parametrize("task", ["push", "slide"])
def test_batched_step_matches_jax(monkeypatch, task):
    core = jax_make_core(task)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates, jobs = jax.jit(jax.vmap(core.reset))(keys)
    ee = np.asarray(jobs["observation"])[:, :3]
    pos = np.asarray(jstates.body_pos).copy()
    for b in range(N_PUSHED):
        side = np.float32((-1) ** b * (HALF_X[task] + 0.01))
        pos[b, 0] = ee[b] + np.array([side, 0.0, 0.0], np.float32)
    goal = np.asarray(jstates.goal).copy()
    goal[4:6] = pos[4:6, 0] + np.float32(0.01)
    jstates = jstates.replace(body_pos=jnp.asarray(pos),
                              goal=jnp.asarray(goal))
    env = make_core(task, device="cpu")
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")

    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    rng = np.random.default_rng(1)
    seen = set()
    for i in range(N_STEPS):
        a = rng.uniform(-1, 1, (B, env.robot.action_dim)).astype(np.float32)
        if i == 0:
            # the pushed envs meet the arm: a non-zero contact torque
            s_in = env.robot.set_action(tstates, torch.as_tensor(a))
            phys = env.physics_step_batched
            *_, tau_ext, _ = phys.forces(s_in.q, s_in.qd, s_in.body_pos,
                                         s_in.body_quat, s_in.body_vel,
                                         s_in.body_ang)
            assert (tau_ext[:N_PUSHED].abs().amax(-1) > 1e-3).all()
            assert not tau_ext[N_PUSHED:].any()
        jstates, jo, jr, jt, jtr, ji = core.batched_step(jstates,
                                                         jnp.asarray(a))
        tstates, to, tr, tt, ttr, ti = env.batched_step(tstates, a)
        msg = f"{task} step {i}"
        np.testing.assert_allclose(tstates.q.numpy(), np.asarray(jstates.q),
                                   atol=ATOL_Q, err_msg=msg)
        np.testing.assert_allclose(tstates.qd.numpy(), np.asarray(jstates.qd),
                                   atol=ATOL_QD, err_msg=msg)
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=ATOL_OBS, err_msg=f"{k}, {msg}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL_R,
                                   err_msg=msg)
        for t_, j_ in ((tt, jt), (ttr, jtr),
                       (ti["is_success"], ji["is_success"])):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_),
                                          err_msg=msg)
        seen.update(np.asarray(ji["is_success"]).tolist())
    # the pushed objects moved
    moved = np.abs(tstates.body_pos.numpy()[:N_PUSHED, 0]
                   - pos[:N_PUSHED, 0]).max(-1)
    assert (moved > 0.02).all()
    assert seen == {True, False}


@pytest.mark.parametrize("task", ["push", "slide"])
def test_reset_matches_jax_from_the_same_draws(monkeypatch, task):
    """The port's batched_reset and the JAX reset of each env, the JAX
    side's two uniform draws (goal, then object) replaced by the port's:
    goal and object equal, the observation within 1e-6."""
    env = make_core(task, device="cpu")
    n = 4
    states, obs = env.batched_reset(n, torch.Generator().manual_seed(7))
    again = torch.Generator().manual_seed(7)
    u_goal = torch.rand(n, 3, generator=again).numpy()
    u_obj = torch.rand(n, 3, generator=again).numpy()
    core = jax_make_core(task)
    for b in range(n):
        draws = iter([u_goal[b], u_obj[b]])

        def uniform(key, shape=(), minval=0.0, maxval=1.0):
            lo = np.asarray(minval, np.float32)
            hi = np.asarray(maxval, np.float32)
            return jnp.asarray(lo + (hi - lo) * next(draws))

        with monkeypatch.context() as m:
            m.setattr(jax.random, "uniform", uniform)
            js, jo = core.reset(jax.random.PRNGKey(b))
        np.testing.assert_array_equal(states.goal[b].numpy(),
                                      np.asarray(js.goal))
        np.testing.assert_array_equal(states.body_pos[b].numpy(),
                                      np.asarray(js.body_pos))
        for k in ("body_quat", "body_vel", "body_ang", "q"):
            np.testing.assert_array_equal(getattr(states, k)[b].numpy(),
                                          np.asarray(getattr(js, k)))
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(jo[k]),
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("task", ["push", "slide"])
def test_batched_reset_draws_in_range(task):
    env = make_core(task, device="cpu")
    states, obs = env.batched_reset(256, torch.Generator().manual_seed(5))
    t = env.task
    half = t.object_size / 2
    goal = states.goal.numpy() - [0.0, 0.0, half]
    obj = states.body_pos[:, 0].numpy() - [0.0, 0.0, half]
    assert ((goal >= t.goal_range_low - 1e-7)
            & (goal <= t.goal_range_high + 1e-7)).all()
    assert ((obj >= t.obj_range_low - 1e-7)
            & (obj <= t.obj_range_high + 1e-7)).all()
    assert goal[:, :2].std(0).min() > 0.05 and obj[:, :2].std(0).min() > 0.05
    assert torch.equal(states.body_quat,
                       torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(256, 1, 4))
    assert not states.body_vel.any() and not states.body_ang.any()
    # robot 6 (ee position and velocity) + object 12
    assert obs["observation"].shape == (256, 18)
    assert torch.equal(obs["achieved_goal"], states.body_pos[:, 0])
    ee = env.robot.ee_position(TK.fk_world(env.model, states.q))
    assert torch.equal(obs["observation"][:, :3], ee)


def test_control_types_follow_the_reference():
    """Push acts in joint space, Slide through the end effector (batched
    dls_ik), as the JAX package's factories default them."""
    push, slide = make_core("push", device="cpu"), make_core("slide",
                                                             device="cpu")
    assert push.robot.config.control_type == "js"
    assert slide.robot.config.control_type == "ee"
    assert push.robot.action_dim == 7 and slide.robot.action_dim == 3
    assert push.task.scene.nb == slide.task.scene.nb == 1

"""Port parity: MyCobot (the port's own copy of its tables) and MyCobotReach
against panda_gym_tpu, on the CPU.

The model tables must equal the JAX package's.  MyCobotReach takes 3 steps
end to end from a JAX reset (B = 8, joint-space actions drawn with numpy,
the state carried across with panda_gym_tpu_torch.convert); the JAX step
runs op by op with ``lax.scan`` as a Python loop.  Tolerances follow
tests/test_torch_reach.py: observation atol 2e-4, q 2e-5, qd 2e-3
(tests/test_dynamics.py:295-296), rewards and flags equal.  The reference
passes zero joint forces (mycobot.py:56), so the arm drifts under gravity
where the motors of a Panda would hold it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core
from panda_gym_tpu.models.mycobot import make_mycobot_model as jax_mycobot

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.models import chain as TCH
from panda_gym_tpu_torch.models.mycobot import EE_SITE, make_mycobot_model
from panda_gym_tpu_torch.ops import scalarized as TS

B = 8
N_STEPS = 3
ATOL_OBS, ATOL_Q, ATOL_QD = 2e-4, 2e-5, 2e-3


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


def _with_effort(model, effort):
    """The model with every motor clamped at ``effort`` N m (the port keeps
    only the reference's zeros)."""
    return dataclasses.replace(
        model, effort=np.full_like(model.effort, effort))


@pytest.mark.parametrize("effort", [0.0, 5.0])
def test_model_tables_match_jax(effort):
    base = (-0.6, 0.0, 0.0)
    tm = make_mycobot_model(base_position=base)
    assert not tm.effort.any()
    if effort:
        tm = _with_effort(tm, effort)
    jm = jax_mycobot(base_position=base, effort=effort)
    for k in TCH.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, k),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k in TCH.STATIC_FIELDS:
        assert getattr(tm, k) == getattr(jm, k), k
    assert tm.ndof == 6 and tm.parent_tuple == (-1, 0, 1, 2, 3, 4)
    assert (tm.effort == effort).all()


def test_robot_follows_the_reference():
    env = make_core("mycobotreach", device="cpu")
    robot = env.robot
    assert robot.config.control_type == "js" and robot.config.block_gripper
    assert (robot.n_arm, robot.action_dim, robot.ee_site) == (6, 6, EE_SITE)
    assert not robot.neutral.any() and robot.ndof == 6
    states, obs = env.batched_reset(4, torch.Generator().manual_seed(3))
    assert not robot.fingers_width(states).any()
    assert obs["observation"].shape == (4, 6)
    assert torch.equal(states.q, torch.zeros(4, 6))


def test_mycobot_reach_steps_match_jax(monkeypatch):
    core = jax_make_core("mycobotreach")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates, jobs = jax.jit(jax.vmap(core.reset))(keys)
    # tilt the arm so that it falls, and put half the goals on the end
    # effector so that the reward takes both values
    q = np.asarray(jstates.q).copy()
    q[:, 1] = np.linspace(-0.4, 0.4, B, dtype=np.float32)
    goal = np.asarray(jstates.goal).copy()
    goal[::2] = np.asarray(jobs["achieved_goal"])[::2] + np.float32(0.01)
    jstates = jstates.replace(q=jnp.asarray(q), ctrl_target=jnp.asarray(q),
                              goal=jnp.asarray(goal))
    env = make_core("mycobotreach", device="cpu")
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    rng = np.random.default_rng(4)
    seen = set()
    for i in range(N_STEPS):
        a = rng.uniform(-1.2, 1.2, (B, 6)).astype(np.float32)
        jstates, jo, jr, jt, jtr, ji = core.batched_step(jstates,
                                                         jnp.asarray(a))
        tstates, to, tr, tt, ttr, ti = env.batched_step(tstates, a)
        msg = f"step {i}"
        np.testing.assert_allclose(tstates.q.numpy(), np.asarray(jstates.q),
                                   atol=ATOL_Q, err_msg=msg)
        np.testing.assert_allclose(tstates.qd.numpy(), np.asarray(jstates.qd),
                                   atol=ATOL_QD, err_msg=msg)
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=ATOL_OBS, err_msg=f"{k}, {msg}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr),
                                      err_msg=msg)
        for t_, j_ in ((tt, jt), (ttr, jtr),
                       (ti["is_success"], ji["is_success"])):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_),
                                          err_msg=msg)
        seen.update(np.asarray(ji["is_success"]).tolist())
        for k in ("cur_jvel", "cur_jacc", "cur_jerk"):
            np.testing.assert_allclose(getattr(tstates, k).numpy(),
                                       np.asarray(getattr(jstates, k)),
                                       atol=ATOL_QD, err_msg=f"{k}, {msg}")
    assert seen == {True, False}


@pytest.mark.parametrize("effort", [0.0, 10.0])
def test_zero_effort_drift(effort):
    """From a tilted pose at rest, holding it as the target: with the
    reference's zero forces every impulse cap is 0, every joint saturates
    and the arm falls; with motors of 10 N m it holds the pose."""
    model = _with_effort(make_mycobot_model(base_position=(-0.6, 0.0, 0.0)),
                         effort)
    step = TS.make_batched_motor_steps(model, n_substeps=20, dt=1.0 / 500.0,
                                       ctrl_mode=0, warm_start=True)
    q0 = torch.tensor([[0.0, 0.3, 0.2, 0.0, 0.0, 0.0]])
    q, qd = q0.clone(), torch.zeros(1, 6)
    mc = TS.consts_from_model(model)
    _, _, (sat, _) = TS.motor_substep(mc, list(q[0:1].T), list(qd[0:1].T),
                                      list(q0[0:1].T), 1.0 / 500.0, 0,
                                      return_warm=True)
    for _ in range(3):
        q, qd = step(q, qd, q0)
    moved = (q - q0).abs().max().item()
    if effort == 0.0:
        assert all(bool(s.all()) for s in sat)
        assert moved > 0.05 and qd.abs().max().item() > 0.5
    else:
        assert not any(bool(s.any()) for s in sat)
        assert moved < 1e-4

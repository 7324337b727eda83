"""Port parity: the "ee" and "pcc" control modes of panda_gym_tpu_torch's
Reach env against panda_gym_tpu's, both on the CPU.

JAX resets a batch of 16 envs; the states are carried across with
panda_gym_tpu_torch.convert and both sides take three steps with the same
numpy-drawn actions.  JAX is run by both of its routes: its batched_step
("ee": make_set_action_batched, the scalarized batched IK) and vmap of its
per-env step ("ee": K.dls_ik).  Tolerances of tests/test_dynamics.py:
248-270: observation atol 2e-4, q atol 1e-5, reward atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.envs.robot import PandaConfig, PandaRobot

B = 16
N_STEPS = 3
ATOL_OBS, ATOL_Q, ATOL_REWARD = 2e-4, 1e-5, 1e-5


@pytest.fixture(scope="module", params=["ee", "pcc"])
def mode(request):
    jcore = jax_make_core("reach", control_type=request.param)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states, obs = jax.jit(jax.vmap(jcore.reset))(keys)
    # half the goals next to the end effector: success takes both values
    goal = np.asarray(states.goal).copy()
    goal[::2] = np.asarray(obs["achieved_goal"])[::2] + np.float32(0.02)
    states = states.replace(goal=goal)
    return request.param, jcore, states


@pytest.mark.parametrize("route", ["batched", "per_env"])
def test_steps_match_jax(mode, route):
    control, jcore, jstates = mode
    step = jax.jit(jcore.batched_step if route == "batched"
                   else jax.vmap(jcore.step))
    tcore = make_core("reach", control_type=control, device="cpu")
    ts = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    rng = np.random.default_rng(1)
    for i in range(N_STEPS):
        a = rng.uniform(-1.2, 1.2, (B, tcore.robot.action_dim)).astype(
            np.float32)
        jstates, jo, jr, jt, _, ji = step(jstates, a)
        ts, to, tr, tt, _, ti = tcore.batched_step(ts, a)
        np.testing.assert_allclose(ts.q.numpy(), np.asarray(jstates.q),
                                   atol=ATOL_Q, err_msg=f"q, step {i}")
        np.testing.assert_allclose(ts.ctrl_target.numpy(),
                                   np.asarray(jstates.ctrl_target),
                                   atol=ATOL_Q, err_msg=f"target, step {i}")
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=ATOL_OBS, err_msg=f"{k}, step {i}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                   atol=ATOL_REWARD, err_msg=f"step {i}")
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti["is_success"].numpy(),
                                      np.asarray(ji["is_success"]))
        np.testing.assert_allclose(ts.recent_action.numpy(),
                                   np.asarray(jstates.recent_action),
                                   atol=1e-6)


def test_ee_moves_along_x():
    """'ee' control moves the EE roughly along the commanded displacement
    (the port's tests/test_envs.py::test_ee_control_mode)."""
    env = make_core("reach", control_type="ee", device="cpu")
    states, obs = env.batched_reset(1, torch.Generator().manual_seed(3))
    start = obs["achieved_goal"][0].clone()
    for _ in range(10):
        states, obs, *_ = env.batched_step(states, [[1.0, 0.0, 0.0]])
    moved = (obs["achieved_goal"][0] - start).numpy()
    assert moved[0] > 0.1, moved
    assert abs(moved[1]) < 0.08 and abs(moved[2]) < 0.15, moved


def test_action_dims_and_targets():
    """3 action channels under "ee" (+1 for an unblocked gripper, as
    robot.py:61-71), n_arm otherwise; the ee target's z is kept at or above
    0 (panda.py:240) and "pcc" teleports: q = clip(target), qd = 0 before
    the physics (panda.py:159-162)."""
    for control, blocked, want in (("ee", True, 3), ("ee", False, 4),
                                   ("pcc", True, 7), ("js", False, 8)):
        robot = PandaRobot(PandaConfig(control_type=control,
                                       block_gripper=blocked))
        assert robot.action_dim == want, (control, blocked)
    env = make_core("reach", control_type="pcc", device="cpu")
    states, _ = env.batched_reset(4, torch.Generator().manual_seed(0))
    states = states.replace(qd=torch.ones_like(states.qd))
    T = env.model.tensors("cpu")
    a = torch.full((4, 7), 1.0)
    a[::2] = -1.0
    s = env.robot.set_action(states, a)
    want = torch.clamp(states.q + 0.05 * a, T["q_lo"], T["q_hi"])
    assert torch.equal(s.q, want) and torch.equal(s.ctrl_target, want)
    assert not s.qd.any()
    # the bookkeeping reads the velocity before the teleport
    assert torch.equal(s.cur_jvel, states.qd[:, :7])

"""Port parity: the batched Reach env of panda_gym_tpu_torch against
panda_gym_tpu's core.batched_step, both on the CPU.

The JAX side resets a batch; the state is carried across with
panda_gym_tpu_torch.convert; both sides then take the same numpy-drawn
actions.  Tolerances follow tests/test_dynamics.py:265-270 (batched vs
per-env step): observation atol 2e-4, q atol 1e-5; reward, success and
termination flags must be equal.
"""
import jax
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs import core as TC
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.envs.robot import PandaConfig, PandaRobot
from panda_gym_tpu_torch.sim import engine as TE
from panda_gym_tpu_torch.sim.state import build_scene

B = 64  # the batch tests/test_motor_lcp.py jits Reach at
N_STEPS = 5
ATOL_OBS, ATOL_Q = 2e-4, 1e-5


@pytest.fixture(scope="module")
def jax_env():
    core = jax_make_core("reach")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states, obs = jax.jit(jax.vmap(core.reset))(keys)
    return core, jax.jit(core.batched_step), states, obs


@pytest.fixture(scope="module")
def torch_env():
    return make_core("reach", device="cpu")


def _to_port(jstates):
    return convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")


def test_reset_state_and_obs_carry_across(jax_env, torch_env):
    _, _, jstates, jobs = jax_env
    ts = _to_port(jstates)
    back = convert.env_state_to_numpy(ts)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jstates, k)),
                                      err_msg=k)
    tobs = torch_env._get_obs(ts)
    for k in ("observation", "achieved_goal", "desired_goal"):
        assert tobs[k].shape == jobs[k].shape
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]),
                                   atol=1e-5, err_msg=k)


def test_batched_step_matches_jax(jax_env, torch_env):
    core, step, jstates, jobs = jax_env
    # put half the goals on the end effector so that success and reward
    # take both values
    goal = np.asarray(jstates.goal).copy()
    ee = np.asarray(jobs["achieved_goal"])
    goal[::2] = ee[::2] + np.float32(0.01)
    jstates = jstates.replace(goal=goal)
    ts = _to_port(jstates)
    rng = np.random.default_rng(1)
    seen_success = set()
    for i in range(N_STEPS):
        actions = rng.uniform(-1.2, 1.2, (B, 7)).astype(np.float32)
        jstates, jo, jr, jt, jtr, ji = step(jstates, actions)
        ts, to, tr, tt, ttr, ti = torch_env.batched_step(ts, actions)
        np.testing.assert_allclose(ts.q.numpy(), np.asarray(jstates.q),
                                   atol=ATOL_Q, err_msg=f"q, step {i}")
        np.testing.assert_allclose(ts.qd.numpy(), np.asarray(jstates.qd),
                                   atol=2e-3, err_msg=f"qd, step {i}")
        for k in ("observation", "achieved_goal", "desired_goal"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=ATOL_OBS, err_msg=f"{k}, step {i}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        np.testing.assert_array_equal(ti["is_success"].numpy(),
                                      np.asarray(ji["is_success"]))
        for k in ("steps", "action_count", "ctrl_target", "recent_action",
                  "prev_action", "cur_jvel", "prev_jvel", "cur_jacc",
                  "prev_jacc", "cur_jerk"):
            np.testing.assert_allclose(getattr(ts, k).numpy(),
                                       np.asarray(getattr(jstates, k)),
                                       atol=2e-3, err_msg=f"{k}, step {i}")
        seen_success.update(np.asarray(ji["is_success"]).tolist())
    assert seen_success == {True, False}


def test_batched_reset_draws_goals_in_range(torch_env):
    gen = torch.Generator().manual_seed(5)
    states, obs = torch_env.batched_reset(256, gen)
    goal = states.goal.numpy()
    task = torch_env.task
    assert (goal >= task.goal_range_low).all()
    assert (goal <= task.goal_range_high).all()
    assert goal.std(0).min() > 0.05
    np.testing.assert_array_equal(
        states.q.numpy(), np.broadcast_to(torch_env.robot.neutral, (256, 7)))
    assert obs["observation"].shape == (256, 6)
    assert (states.steps == 0).all()
    again, _ = torch_env.batched_reset(256, torch.Generator().manual_seed(5))
    assert torch.equal(again.goal, states.goal)


def test_reset_is_a_batch_of_one(torch_env):
    states, obs = torch_env.reset(torch.Generator().manual_seed(0))
    assert states.q.shape == (1, 7) and obs["desired_goal"].shape == (1, 3)


def test_reset_obs_matches_jax_on_the_same_state(jax_env, torch_env):
    """The port's reset, with its goals handed to the JAX side's state."""
    core, _, jstates, _ = jax_env
    ts, tobs = torch_env.batched_reset(B, torch.Generator().manual_seed(3))
    jobs = jax.vmap(core._get_obs)(jstates.replace(goal=ts.goal.numpy()))
    for k in ("observation", "achieved_goal", "desired_goal"):
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]),
                                   atol=1e-5, err_msg=k)


def test_velocity_control_targets(torch_env):
    robot = PandaRobot(PandaConfig(block_gripper=True, control_type="jsd",
                                   base_position=(-0.6, 0.0, 0.0)))
    env = TC.RobotTaskEnv(robot, torch_env.task, device="cpu")
    states, _ = env.batched_reset(4)
    a = torch.full((4, 7), 2.0)
    s2 = robot.set_action(states, a)
    assert torch.equal(s2.ctrl_target, torch.ones(4, 7))   # clipped to 1
    assert env.physics_step_batched.motor.ctrl_mode == 1


def test_scale_limiter():
    robot = PandaRobot(PandaConfig(block_gripper=True,
                                   action_limiter="scale"))
    a = torch.tensor([[2.0, -1.0, 0, 0, 0, 0, 0], [0.5, 0, 0, 0, 0, 0, 0]])
    out = robot._limit_action(a)
    assert torch.allclose(out[0], a[0] / 2.0) and torch.equal(out[1], a[1])


def test_moving_obstacles_advance():
    env = make_core("reach", device="cpu")
    phys = TE.make_batched_physics_step(env.model, env.task.scene,
                                        moving_obstacles=True,
                                        has_bodies=False)
    states, _ = env.batched_reset(3)
    vel = torch.arange(9, dtype=torch.float32).reshape(3, 1, 3)
    out = phys(states.replace(obstacle_vel=vel))
    assert torch.allclose(out.obstacle_pos,
                          states.obstacle_pos + 20 * TE.TIMESTEP * vel)


def test_unported_paths_raise():
    """What no task of the JAX package combines: free bodies with a
    collision check or with moving obstacles.  Forces between free bodies
    are ported (Stack)."""
    env = make_core("reach", device="cpu")
    cube = dict(shape=0, size=(0.02,) * 3, mass=1.0)
    scene = build_scene([cube, cube], 1.1, 0.7, 0.4)
    for kw in (dict(check_collision=True), dict(moving_obstacles=True)):
        with pytest.raises(NotImplementedError, match="free bodies"):
            TE.make_batched_physics_step(env.model, scene,
                                         body_pairs=((1, 0),), **kw)
    phys = TE.make_batched_physics_step(env.model, scene,
                                        body_pairs=((1, 0),))
    assert isinstance(phys, TE.ContactPhysics)
    assert phys.body_pairs == ((1, 0),)


@pytest.mark.parametrize("task,ndof", [
    ("reach", 7), ("push", 7), ("slide", 7), ("pickandplace", 9),
    ("stack", 9), ("flip", 9), ("mycobotreach", 6)])
def test_every_classic_task_builds(task, ndof):
    """The JAX package's seven classic tasks, on the CPU when asked; its
    physics the plain route there (no K1 launch)."""
    env = make_core(task, device="cpu")
    assert env.device.type == "cpu" and env.model.ndof == ndof
    states, obs = env.batched_reset(2)
    states, obs, *_ = env.batched_step(
        states, torch.zeros(2, env.robot.action_dim))
    assert torch.isfinite(obs["observation"]).all()
    assert env.physics_step_batched.motor.launches == 0
    with pytest.raises(ValueError, match="unknown task"):
        make_core("reachao1", device="cpu")


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_core("reach")
    with pytest.raises(RuntimeError):
        make_core("reach", device="cuda")


def test_hi_prec_disables_tf32_and_restores():
    seen = []

    @TC._hi_prec
    def probe():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    probe()
    assert seen == [(False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before

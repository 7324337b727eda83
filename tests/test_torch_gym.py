"""Port parity: the gym surface of panda_gym_tpu_torch (the registered ids,
``EnvAdapter``/``GymAdapter``, the env classes, ``BoundRobot``) against
panda_gym_tpu's on the CPU.

A JAX GymAdapter is reset; its state is carried to the port's adapter with
panda_gym_tpu_torch.convert (a leading batch of one) and both take the same
5 numpy actions.  The JAX adapter steps its core's per-env ``step``
eagerly, ``lax.scan`` a Python loop (tests/test_torch_collision.py says
why).  Tolerances follow tests/test_dynamics.py:165-243, which hold the
JAX package's batched step against its per-env step: q 2e-5, qd 2e-3,
observations 2e-4, rewards 1e-5, the flags equal.  The spaces are held
against those the JAX adapter builds from its core's observation shapes
(jax.eval_shape, so nothing compiles).
"""
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import panda_gym_tpu
from panda_gym_tpu.envs import core as jcore_mod
from panda_gym_tpu.envs import panda_tasks as jtasks
from panda_gym_tpu.envs.tasks import reach_ao as jrao

import panda_gym_tpu_torch
from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs import panda_tasks as ttasks
from panda_gym_tpu_torch.envs.core import EnvAdapter
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao

ATOL_OBS, ATOL_R, ATOL_Q, ATOL_QD = 2e-4, 1e-5, 2e-5, 2e-3
N_STEPS = 5


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.fixture(scope="module")
def ids():
    panda_gym_tpu.register_envs(50)
    return panda_gym_tpu_torch.register_envs(50)


def test_registration_beside_the_jax_ids(ids):
    """32 classic ids and ReachAO's under the port's namespace, the JAX
    package's own ids still in the same registry."""
    assert len(ids) == 33 and len(set(ids)) == 33
    assert all(i.startswith("panda_gym_tpu_torch/") for i in ids)
    assert "panda_gym_tpu_torch/PandaReachAO-v3" in ids
    assert "panda_gym_tpu_torch/MyCobotReachJoints-v0" in ids
    assert "panda_gym_tpu_torch/PandaFlipJointsDense-v3" in ids
    for i in ids:
        assert i in gym.registry
        assert i.split("/", 1)[1] in gym.registry   # the JAX package's id
    spec = gym.spec("panda_gym_tpu_torch/PandaPushDense-v3")
    assert spec.kwargs == {"reward_type": "dense", "control_type": "ee",
                           "vector_task": "push"}
    assert spec.max_episode_steps == 50


def _jax_spaces(core):
    """The spaces JAX's GymAdapter builds (envs/core.py:275-289)."""
    from gymnasium import spaces
    _, obs = jax.eval_shape(core.reset, jax.random.PRNGKey(0))
    return (spaces.Dict({k: spaces.Box(-10.0, 10.0, shape=v.shape,
                                       dtype=np.float32)
                         for k, v in obs.items()}),
            spaces.Box(-1.0, 1.0, shape=(core.robot.action_dim,),
                       dtype=np.float32))


def _jax_core(env_id: str):
    spec = gym.spec(env_id.split("/", 1)[1])
    kw = dict(spec.kwargs)
    task = kw.pop("vector_task")
    if task == "reachao":
        return jrao.make_reach_ao_core("reachao1")
    if env_id.split("/", 1)[1].startswith("PandaReachChecker"):
        robot = jtasks._robot(True, kw["control_type"], action_limiter="clip")
        return jcore_mod.RobotTaskEnv(robot, jtasks.Reach(
            reward_type=kw["reward_type"]))
    return jtasks.make_core(task, **kw)


def test_every_id_makes_and_steps_with_jax_spaces(ids):
    """gym.make(id, device="cpu") for each of the 33 ids: a reset and a
    step with finite observations of the spaces' shapes, and the spaces
    those of the JAX package's env."""
    for env_id in ids:
        env = gym.make(env_id, device="cpu")
        obs, info = env.reset(seed=0)
        obs, r, term, trunc, info = env.step(env.action_space.sample())
        jobs_space, jact_space = _jax_spaces(_jax_core(env_id))
        assert env.observation_space == jobs_space, env_id
        assert env.action_space == jact_space, env_id
        for k, space in env.observation_space.spaces.items():
            assert obs[k].shape == space.shape and obs[k].dtype == np.float32
            assert np.isfinite(obs[k]).all(), (env_id, k)
        assert np.isfinite(r) and isinstance(info["is_success"], bool)
        env.close()


def _adapters(name, monkeypatch):
    """(JAX GymAdapter stepping eagerly, the port's EnvAdapter) on one
    state: the JAX reset of seed 3 carried across."""
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    jax_cls, port = {
        "reach_js": (lambda: jtasks.PandaReachEnv(control_type="js"),
                     lambda: ttasks.PandaReachEnv(control_type="js",
                                                  device="cpu")),
        "reach_ee": (lambda: jtasks.PandaReachEnv(control_type="ee"),
                     lambda: ttasks.PandaReachEnv(control_type="ee",
                                                  device="cpu")),
        "push": (lambda: jtasks.PandaPushEnv(),
                 lambda: ttasks.PandaPushEnv(device="cpu")),
        "pickandplace": (lambda: jtasks.PandaPickAndPlaceEnv(),
                         lambda: ttasks.PandaPickAndPlaceEnv(device="cpu")),
        "mycobotreach": (lambda: jtasks.MyCobotReachEnv(),
                         lambda: ttasks.MyCobotReachEnv(device="cpu")),
        "reachao1": (lambda: jrao.PandaReachAOEnv(scenario="reachao1"),
                     lambda: trao.PandaReachAOEnv(scenario="reachao1",
                                                  device="cpu")),
    }[name]
    jenv = jax_cls()
    jenv._jit_step = jenv.env.step            # eager, scan a loop
    jenv.reset(seed=3)
    tenv = port()
    tenv._state = convert.env_state(
        {k: np.asarray(getattr(jenv.state, k))[None]
         for k in convert.FIELDS}, "cpu")
    return jenv, tenv


def _object_before_the_fingers(jenv):
    """Put Push's cube with its face 1 cm before the fingertip along x, so
    that the arm pushes it within the 5 steps: shallow contact, as ROADMAP
    §3 asks (a gripped cube parts even the JAX package's own two steps,
    tests/test_torch_gripper.py)."""
    from panda_gym_tpu.ops.kinematics import fk_world
    s = jenv.state
    ee = np.asarray(jenv.env.robot.ee_position(
        fk_world(jenv.env.model, s.q, s.qd)))
    pos = np.asarray(s.body_pos).copy()
    pos[0] = ee + np.array([0.03, 0.0, 0.0], np.float32)
    jenv._state = s.replace(body_pos=jnp.asarray(pos))


def hold_steps(name, monkeypatch):
    """The port's adapter against JAX's over N_STEPS steps of the same
    actions from one state (the module docstring's tolerances).  The cases
    are split over this file, test_torch_gym_steps.py and
    test_torch_gym_contact.py, each under about 90 s on one worker."""
    jenv, tenv = _adapters(name, monkeypatch)
    if name == "push":
        _object_before_the_fingers(jenv)
        tenv._state = convert.env_state(
            {k: np.asarray(getattr(jenv.state, k))[None]
             for k in convert.FIELDS}, "cpu")
    rng = np.random.default_rng(11)
    for i in range(N_STEPS):
        a = rng.uniform(-1, 1, tenv.action_shape).astype(np.float32)
        jo, jr, jt, jtr, ji = jenv.step(a)
        to, tr, tt, ttr, ti = tenv.step(a)
        msg = f"{name} step {i}"
        np.testing.assert_allclose(tenv.state.q[0].numpy(),
                                   np.asarray(jenv.state.q), atol=ATOL_Q,
                                   err_msg=msg)
        np.testing.assert_allclose(tenv.state.qd[0].numpy(),
                                   np.asarray(jenv.state.qd), atol=ATOL_QD,
                                   err_msg=msg)
        for k in jo:
            np.testing.assert_allclose(to[k], jo[k], atol=ATOL_OBS,
                                       err_msg=f"{k}, {msg}")
        assert abs(tr - jr) <= ATOL_R, msg
        assert (tt, ttr, ti) == (jt, jtr, ji), msg
        assert isinstance(tr, float) and isinstance(tt, bool)


@pytest.mark.parametrize("name", ["reach_js", "mycobotreach"])
def test_adapter_steps_match_jax(monkeypatch, name):
    hold_steps(name, monkeypatch)


def test_compute_reward_on_the_live_state(monkeypatch):
    """compute_reward of a batch of goals and of one goal, against the JAX
    adapter's, on ReachAO (whose reward reads the live state) and Reach
    dense."""
    rng = np.random.default_rng(2)
    jenv, tenv = _adapters("reachao1", monkeypatch)
    a = rng.uniform(-0.1, 0.6, (6, 3)).astype(np.float32)
    d = rng.uniform(-0.1, 0.6, (6, 3)).astype(np.float32)
    np.testing.assert_allclose(tenv.compute_reward(a, d, {}),
                               jenv.compute_reward(a, d, {}), atol=ATOL_R)
    np.testing.assert_allclose(tenv.compute_reward(a[0], d[0], {}),
                               jenv.compute_reward(a[:1], d[:1], {})[0],
                               atol=ATOL_R)
    dense = ttasks.PandaReachEnv(reward_type="dense", device="cpu")
    np.testing.assert_allclose(dense.compute_reward(a, d, {}),
                               -np.linalg.norm(a - d, axis=-1), atol=1e-6)


def test_save_restore_state_exact():
    """save -> step -> restore -> the same action gives exactly equal
    observations (test/save_and_restore_test.py:9-37); a removed state
    raises."""
    env = ttasks.PandaPushEnv(device="cpu")
    env.reset(seed=7)
    sid = env.save_state()
    a = np.full(env.action_shape, 0.3, np.float32)
    obs1, *_ = env.step(a)
    env.step(a)
    env.restore_state(sid)
    obs2, *_ = env.step(a)
    for k in obs1:
        np.testing.assert_array_equal(obs1[k], obs2[k], err_msg=k)
    env.remove_state(sid)
    with pytest.raises(KeyError):
        env.restore_state(sid)


def test_seed_determinism_and_device():
    """The same seed gives the same episode bit for bit, another seed
    another goal; the adapter lives on the requested device, and asking for
    the card without one raises."""
    e1 = ttasks.PandaReachEnv(device="cpu")
    e2 = ttasks.PandaReachEnv(device="cpu")
    o1, _ = e1.reset(seed=7)
    o2, _ = e2.reset(seed=7)
    for k in o1:
        np.testing.assert_array_equal(o1[k], o2[k])
    a = np.full(e1.action_shape, 0.3, np.float32)
    s1, s2 = e1.step(a), e2.step(a)
    np.testing.assert_array_equal(s1[0]["observation"], s2[0]["observation"])
    assert s1[1] == s2[1]
    o3, _ = e1.reset(seed=8)
    assert not np.array_equal(o1["desired_goal"], o3["desired_goal"])
    assert e1.state.q.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ttasks.PandaReachEnv()


def test_bound_robot_getters_match_jax(monkeypatch):
    """The reference's robot getters on the live state against the JAX
    adapter's (PyBullet joint numbering included), IK through the batched
    dls_ik at B = 1, and set_joint_neutral."""
    jenv, tenv = _adapters("pickandplace", monkeypatch)
    a = np.array([0.5, -0.3, 0.2, 0.8], np.float32)
    jenv.step(a)
    tenv.step(a)
    jr, tr = jenv.robot, tenv.robot
    np.testing.assert_allclose(tr.get_ee_position(), jr.get_ee_position(),
                               atol=ATOL_OBS)
    np.testing.assert_allclose(tr.get_ee_velocity(), jr.get_ee_velocity(),
                               atol=ATOL_OBS)
    assert abs(tr.get_fingers_width() - jr.get_fingers_width()) < ATOL_OBS
    assert abs(tr.get_manipulability() - jr.get_manipulability()) < 1e-4
    for j in (0, 3, 7, 8, 9, 10):
        assert abs(tr.get_joint_angle(j) - jr.get_joint_angle(j)) < ATOL_Q
        assert abs(tr.get_joint_velocity(j)
                   - jr.get_joint_velocity(j)) < ATOL_QD
    assert tr.get_joint_angle(7) == 0.0
    np.testing.assert_allclose(tr.get_obs(), jr.get_obs(), atol=ATOL_OBS)
    assert tr.action_dim == jr.action_dim == 4
    target = np.array([0.1, 0.1, 0.3], np.float32)
    q_t = tr.inverse_kinematics(tr.ee_site, target)
    q_j = jr.inverse_kinematics(jr.ee_site, target)
    np.testing.assert_allclose(q_t, q_j, atol=1e-4)
    tr.set_joint_neutral()
    np.testing.assert_array_equal(tenv.state.q[0].numpy(),
                                  tenv.env.robot.neutral)
    assert not tenv.state.qd.any()


def test_env_classes_and_gym_classes():
    """Every single-env class is an EnvAdapter without gymnasium; its
    gymnasium.Env (envs/gym_envs.py) is a subclass of it; the checker uses
    the "clip" limiter."""
    from panda_gym_tpu_torch.envs import gym_envs
    from panda_gym_tpu_torch.envs.core import GymAdapter
    for name in ("PandaReachEnv", "PandaPushEnv", "PandaSlideEnv",
                 "PandaPickAndPlaceEnv", "PandaStackEnv", "PandaFlipEnv",
                 "PandaReachCheckerEnv", "MyCobotReachEnv"):
        cls = getattr(ttasks, name)
        gcls = getattr(gym_envs, name)
        assert issubclass(cls, EnvAdapter) and issubclass(gcls, cls)
        assert issubclass(gcls, gym.Env) and not issubclass(cls, gym.Env)
    assert issubclass(gym_envs.PandaReachAOEnv, trao.PandaReachAOEnv)
    assert issubclass(GymAdapter, EnvAdapter)
    env = ttasks.PandaReachCheckerEnv(device="cpu")
    assert env.env.robot.config.action_limiter == "clip"
    gen = GymAdapter(ttasks.make_core("reach", device="cpu"))
    assert gen.action_space.shape == (7,)
    assert gen.unwrapped is gen

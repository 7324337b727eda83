"""The gymnasium vector API over the port's batched core
(panda_gym_tpu_torch/envs/vector_adapter.py): the cases of
tests/test_vector_adapter.py on the port, and one masked autoreset step
against the JAX package's JaxVectorEnv from the same injected states.

The JAX adapter runs eagerly (``jax.jit`` the identity, ``lax.scan`` a
Python loop; tests/test_torch_eval.py does the same).  Its resets draw from
JAX's PRNG, the port's from a torch.Generator, so the envs that reset are
held to the semantics (reward 0, no flags, a first observation of their new
state) and the others to JAX's step at the tolerances of
tests/test_dynamics.py:203-243 (observations 2e-4, rewards 1e-5, flags
equal) and :295-296 (q 2e-5, qd 2e-3).
"""
import gymnasium as gym
import jax
import numpy as np
import pytest

import panda_gym_tpu_torch
from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.envs.vector_adapter import (VectorAdapter,
                                                     make_vector_core)

ATOL_OBS, ATOL_R, ATOL_Q, ATOL_QD = 2e-4, 1e-5, 2e-5, 2e-3


@pytest.fixture(scope="module")
def venv():
    panda_gym_tpu_torch.register_envs(5)  # a short TimeLimit: autoresets
    v = gym.make_vec("panda_gym_tpu_torch/PandaReach-v3", num_envs=4,
                     device="cpu")
    yield v
    v.close()


def test_make_vec_uses_vector_entry_point(venv):
    from panda_gym_tpu_torch.envs.vector_adapter import TorchVectorEnv
    assert isinstance(venv.unwrapped, TorchVectorEnv)
    assert isinstance(venv.unwrapped, VectorAdapter)
    assert venv.num_envs == 4
    assert venv.unwrapped.core.device.type == "cpu"


def test_vector_reset_and_step_shapes(venv):
    obs, info = venv.reset(seed=0)
    assert obs["observation"].shape == (4, 6)
    assert obs["achieved_goal"].shape == (4, 3)
    actions = np.zeros((4, 3), np.float32)
    obs, reward, term, trunc, info = venv.step(actions)
    assert obs["observation"].shape == (4, 6)
    assert reward.shape == (4,)
    assert term.dtype == bool and trunc.dtype == bool
    assert "is_success" in info
    assert venv.observation_space["observation"].shape == (4, 6)
    assert venv.action_space.shape == (4, 3)


def test_vector_next_step_autoreset(venv):
    """NEXT_STEP semantics: TimeLimit(5) truncates on step 5; step 6 resets,
    reward 0, no flags, a fresh observation."""
    obs, _ = venv.reset(seed=1)
    actions = np.zeros((4, 3), np.float32)
    for t in range(5):
        obs, reward, term, trunc, info = venv.step(actions)
    ended = term | trunc
    assert ended.all(), (term, trunc)
    obs_final = obs["observation"].copy()
    obs, reward, term, trunc, info = venv.step(actions)
    assert not term.any() and not trunc.any()
    assert (reward == 0.0).all()
    assert not np.allclose(obs["observation"], obs_final)


def test_vector_episode_after_autoreset_runs_full_length(venv):
    venv.reset(seed=2)
    actions = np.zeros((4, 3), np.float32)
    for _ in range(6):  # 5 steps + the reset step
        _, _, term, trunc, _ = venv.step(actions)
    for t in range(5):
        _, _, term, trunc, _ = venv.step(actions)
        ended = term | trunc
        if t < 4:
            assert not ended.any()
    assert ended.all()


def test_vector_seed_determinism():
    panda_gym_tpu_torch.register_envs(10)
    v1 = gym.make_vec("panda_gym_tpu_torch/PandaReachJoints-v3", num_envs=3,
                      device="cpu")
    v2 = gym.make_vec("panda_gym_tpu_torch/PandaReachJoints-v3", num_envs=3,
                      device="cpu")
    o1, _ = v1.reset(seed=7)
    o2, _ = v2.reset(seed=7)
    np.testing.assert_array_equal(o1["observation"], o2["observation"])
    a = np.full((3, 7), 0.3, np.float32)
    s1 = v1.step(a)
    s2 = v2.step(a)
    np.testing.assert_array_equal(s1[0]["observation"], s2[0]["observation"])
    np.testing.assert_array_equal(s1[1], s2[1])
    v1.close()
    v2.close()


def test_gymnasium_free_adapter_and_reachao_core():
    """VectorAdapter needs no gymnasium class: the same stepping over a
    core; the ReachAO id's core is ReachAO on its scenario."""
    core = make_vector_core("reachao", "reachao1", device="cpu")
    assert type(core).__name__ == "RobotTaskEnv"
    assert core.task.check_collision
    v = VectorAdapter(make_core("push", device="cpu"), 2,
                      max_episode_steps=2)
    assert v.single_observation_shapes["observation"] == (18,)
    v.reset(seed=0)
    for t in range(3):
        _, r, term, trunc, _ = v.step(np.zeros((2, 7), np.float32))
    assert (r == 0).all() and not trunc.any()   # the reset step


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


def test_masked_autoreset_step_matches_jax(monkeypatch):
    """Envs 0 and 2 ended on the step before: one step of both adapters
    from the same states resets them (and ignores their action) and steps
    envs 1 and 3 in one batched step."""
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    from panda_gym_tpu.envs.panda_tasks import make_core as jmake_core
    from panda_gym_tpu.envs.vector_adapter import JaxVectorEnv

    n = 4
    jv = JaxVectorEnv(jmake_core("reach", control_type="js"), n,
                      max_episode_steps=5)
    jv.reset(seed=0)
    tv = VectorAdapter(make_core("reach", control_type="js", device="cpu"),
                       n, max_episode_steps=5)
    tv.reset(seed=0)
    tv._states = convert.env_state(
        {k: np.asarray(getattr(jv._states, k)) for k in convert.FIELDS},
        "cpu")
    mask = np.array([True, False, True, False])
    steps = np.array([5, 3, 5, 2])
    for v in (jv, tv):
        v._needs_reset = mask.copy()
        v._ep_steps = steps.copy()
    a = np.random.default_rng(4).uniform(-1, 1, (n, 7)).astype(np.float32)
    jo, jr, jt, jtr, ji = jv.step(a)
    to, tr, tt, ttr, ti = tv.step(a)
    keep = ~mask
    np.testing.assert_allclose(tv.states.q.numpy()[keep],
                               np.asarray(jv._states.q)[keep], atol=ATOL_Q)
    np.testing.assert_allclose(tv.states.qd.numpy()[keep],
                               np.asarray(jv._states.qd)[keep], atol=ATOL_QD)
    for k in jo:
        np.testing.assert_allclose(to[k][keep], jo[k][keep], atol=ATOL_OBS,
                                   err_msg=k)
    np.testing.assert_allclose(tr, jr, atol=ATOL_R)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ttr, jtr)
    for k in ji:
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    # the reset envs: reward 0, no flags, their new state's observation,
    # unstepped; the step counters and the next mask as JAX's
    assert (tr[mask] == 0).all() and not (tt | ttr)[mask].any()
    np.testing.assert_array_equal(tv.states.steps.numpy()[mask], 0)
    np.testing.assert_array_equal(to["desired_goal"][mask],
                                  tv.states.goal.numpy()[mask])
    np.testing.assert_array_equal(tv._ep_steps, jv._ep_steps)
    np.testing.assert_array_equal(tv._needs_reset, jv._needs_reset)

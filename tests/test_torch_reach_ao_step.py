"""Port parity: the batched ReachAO step of panda_gym_tpu_torch against
panda_gym_tpu's core.batched_step, end to end on the CPU.

The JAX side resets B = 8 envs; the state is carried across with
panda_gym_tpu_torch.convert, env 0's first obstacle is put on its end
effector (a collision in the first substep: truncation, the collision
penalty and the freeze) and env 1's goal 1 cm from its end effector (a
success: termination), and both sides take 3 steps with the same numpy
actions.  The JAX step runs op by op with its ``lax.scan`` as a Python loop
(test_torch_collision.py says why).  Tolerances: observations atol 5e-4
(tests/test_reach_ao.py:154-155), rewards 1e-5, q 2e-5 and qd 2e-3
(tests/test_dynamics.py:295-296); the flags equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panda_gym_tpu.envs.tasks import reach_ao as jrao

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core

B = 8
N_STEPS = 3
ATOL_OBS, ATOL_R, ATOL_Q, ATOL_QD = 5e-4, 1e-5, 2e-5, 2e-3


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.mark.parametrize("scenario", ["reachao1", "reachao2"])
def test_batched_step_matches_jax(monkeypatch, scenario):
    core = jrao.make_reach_ao_core(scenario)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates, jobs = jax.jit(jax.vmap(core.reset))(keys)
    ee = np.asarray(jobs["achieved_goal"])
    opos = np.asarray(jstates.obstacle_pos).copy()
    opos[0, 0] = ee[0]
    goal = np.asarray(jstates.goal).copy()
    goal[1] = ee[1] + np.float32(0.01)
    jstates = jstates.replace(obstacle_pos=jnp.asarray(opos),
                              goal=jnp.asarray(goal))
    env = make_reach_ao_core(scenario, device="cpu")
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")

    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    rng = np.random.default_rng(1)
    truncated = []
    for i in range(N_STEPS):
        a = rng.uniform(-1, 1, (B, 7)).astype(np.float32)
        a[1] = 0.0
        jstates, jo, jr, jt, jtr, ji = core.batched_step(jstates,
                                                         jnp.asarray(a))
        tstates, to, tr, tt, ttr, ti = env.batched_step(tstates, a)
        msg = f"{scenario} step {i}"
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
                       (ti["is_success"], ji["is_success"]),
                       (ti["is_truncated"], ji["is_truncated"])):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_),
                                          err_msg=msg)
        for k in convert.FIELDS:
            t_, j_ = getattr(tstates, k).numpy(), np.asarray(getattr(jstates, k))
            if t_.dtype.kind == "f":
                np.testing.assert_allclose(t_, j_, atol=ATOL_QD,
                                           err_msg=f"{k}, {msg}")
            else:
                np.testing.assert_array_equal(t_, j_, err_msg=f"{k}, {msg}")
        truncated.append(ttr.numpy())
    assert truncated[0][0] and tr[0] <= -100.0   # collided: penalty, frozen
    assert tt[1]                                  # reached: terminated
    assert not np.all(truncated[-1])

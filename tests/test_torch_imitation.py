"""Port parity: the prior bootstrap of panda_gym_tpu_torch (rl/imitation.py)
against panda_gym_tpu's, both on the CPU.

neo_policy_fn on the same reachao1 states as JAX's (B = 8, env 0 with an
obstacle ~0.1 m from its end effector) at the NEO tolerance, atol and rtol
1e-4; the buffer fills at n_envs 4, horizon 5, from the port's own resets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.rl import imitation as JI
from panda_gym_tpu.rl.train import flat_x as jflat_x

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.rl import her
from panda_gym_tpu_torch.rl import imitation as TI
from panda_gym_tpu_torch.rl.config import Hyperparameters
from panda_gym_tpu_torch.rl.learners import make_learner
from panda_gym_tpu_torch.rl.train import VectorEnv, flat_x

N_ENVS, HORIZON = 4, 5


@pytest.fixture(scope="module")
def venv():
    return VectorEnv(trao.make_reach_ao_core("reachao1", device="cpu"),
                     N_ENVS, HORIZON)


def _buffer(venv, capacity=16):
    return her.create(capacity, venv.horizon, venv.obs_dim, venv.goal_dim,
                      venv.act_dim, venv.aux_dim, "cpu")


def test_neo_policy_fn_matches_jax():
    jcore = jrao.make_reach_ao_core("reachao1")
    tcore = trao.make_reach_ao_core("reachao1", device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(4), 8)
    jstates, jobs = jax.jit(jax.vmap(jcore.reset))(keys)
    opos = np.asarray(jstates.obstacle_pos).copy()
    opos[0, 0] = np.asarray(jobs["achieved_goal"])[0] + [0.0, 0.1, 0.1]
    jstates = jstates.replace(obstacle_pos=jnp.asarray(opos, jnp.float32))
    want = np.asarray(jax.jit(JI.neo_policy_fn(jcore))(
        jflat_x(jobs), jstates, jax.random.PRNGKey(0)))
    ts = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    tobs = {k: torch.tensor(np.asarray(v)) for k, v in jobs.items()}
    with torch.no_grad():
        got = TI.neo_policy_fn(tcore)(flat_x(tobs), ts, torch.Generator())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert got.abs().max() <= 1.0 and got.abs().max() > 1e-3


def test_fill_buffer_with_prior(venv):
    """n_rollouts episode batches of N_ENVS: the buffer holds 4 n_roll
    episodes, every stored action is the clipped prior, in [-1, 1]."""
    buf, stats = TI.fill_buffer_with_prior(
        venv, _buffer(venv), torch.Generator().manual_seed(0), n_rollouts=2)
    assert buf.n_stored == 2 * N_ENVS
    a = buf.action[:2 * N_ENVS]
    assert a.abs().max() <= 1.0 and a.abs().max() > 1e-3
    assert torch.isfinite(buf.obs[:2 * N_ENVS]).all()
    assert set(stats) == {"success", "collided", "ep_reward", "ep_len"}
    assert (buf.ep_len[:2 * N_ENVS] >= 1).all()


class _NoExploration:
    """A learner whose exploration draws fail: a policy_fn must act alone."""

    def sample_expl(self, *a, **k):
        raise AssertionError("exploration drawn for a policy_fn rollout")

    def act_noise(self, *a, **k):
        raise AssertionError("action noise drawn for a policy_fn rollout")

    def act(self, *a, **k):
        raise AssertionError("the learner acted in a policy_fn rollout")


def test_policy_fn_overrides_the_learner(venv):
    seen = []

    def policy(x, states, generator):
        seen.append((x.shape, states.batch_size))
        return torch.zeros(x.shape[0], venv.act_dim)

    episodes, _ = venv.rollout_episode(_NoExploration(), None,
                                       torch.Generator(), policy_fn=policy)
    assert seen == [((N_ENVS, venv.x_dim), N_ENVS)] * HORIZON
    assert not episodes["action"].any()


def test_fill_buffer_with_model(venv):
    hp = Hyperparameters("TQC")
    hp.policy_kwargs = dict(hp.policy_kwargs, net_arch=[16, 16])
    learner = make_learner("TQC", venv.x_dim, venv.act_dim, hp, "cpu")
    gen = torch.Generator().manual_seed(0)
    ts = learner.init(gen)
    buf, _ = TI.fill_buffer_with_model(venv, _buffer(venv), learner, ts, gen,
                                       n_rollouts=1)
    assert buf.n_stored == N_ENVS
    assert buf.action[:N_ENVS].abs().max() <= 1.0

"""The port's env mesh (panda_gym_tpu_torch/parallel/mesh.py) against the
JAX package's (panda_gym_tpu/parallel/mesh.py), on the CPU.

The JAX side shards over 2 of conftest's 8 virtual CPU devices; the port
runs 2 gloo ranks (spawned, a file-store rendezvous, a 30 s collective
timeout, 90 s in all: tests/test_torch_mesh_trainer.py's workers) on the
same inputs, carried across with panda_gym_tpu_torch.convert.  Held:
  * the Reach batched_step of JAX's shard_env_batch against the port's
    2-rank step with the blocks concatenated: observation atol 1e-5,
    reward 1e-6, q 1e-6 (tests/test_parallel.py:46-49);
  * global_metric_mean of both on the same sharded tree;
  * a TQC update with the batch sharded over 2 devices against the port's
    2-rank update on the halves, the gradients all-reduced (gSDE on and
    off, the same pre-drawn batch and noise): the losses (the ranks' mean,
    as the Trainer logs them) rtol 1e-5, every parameter atol 1e-6, and
    the ranks' parameters bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from panda_gym_tpu.envs.panda_tasks import make_reach_core as jax_reach
from panda_gym_tpu.parallel import mesh as JM
from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl.config import Hyperparameters as JHyper

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.parallel.smoke import launch
from panda_gym_tpu_torch.rl import learners as TL

import test_torch_mesh_trainer as W

B, X, A = 16, 20, 7
ATOL = {"observation": 1e-5, "reward": 1e-6, "q": 1e-6}
RTOL_LOSS, ATOL_PARAM = 1e-5, 1e-6
CASES = [("TQC", False), ("TQC", True)]


def _jax_hp(algo, sde):
    hp = JHyper(algo)
    hp.policy_kwargs = dict(log_std_init=-3, net_arch=[32, 32])
    hp.use_sde = sde
    hp.n_quantiles = 5
    return hp


def _update_case(algo, sde, seed):
    """A JAX learner state (log_alpha away from 0), a numpy batch and the
    update's noise as JAX draws it (learners.py:434, networks.py:61,122)."""
    jl = JL.make_learner(algo, X, A, _jax_hp(algo, sde))
    jts = jl.init(jax.random.PRNGKey(seed)).replace(
        log_alpha=jnp.asarray(-0.3, jnp.float32))
    rng = np.random.default_rng(seed)
    batch = dict(x=rng.normal(0, 1, (B, X)), x2=rng.normal(0, 1, (B, X)),
                 action=np.tanh(rng.normal(0, 1, (B, A))),
                 reward=rng.choice([-1.0, 0.0, -101.0], B),
                 terminated=(rng.uniform(size=B) < 0.3).astype(np.float64))
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(seed + 1)
    shape = (jl.net_arch[-1], A) if sde else (B, A)
    noise = tuple(np.asarray(jax.random.normal(k, shape))
                  for k in jax.random.split(key))
    tl = TL.make_learner(algo, X, A, W.learner_hp(algo, sde), "cpu")
    g = jax.device_get
    opt = lambda o: (g(o[0].mu), g(o[0].nu), int(o[0].count))  # noqa: E731
    tts = convert.learner_state(
        tl, g(jts.actor_params), g(jts.critic_params),
        g(jts.target_critic_params), opt(jts.actor_opt),
        opt(jts.critic_opt), float(jts.log_alpha), opt(jts.alpha_opt),
        int(jts.step))
    return jl, jts, batch, key, dict(
        algo=algo, sde=sde, dims=(X, A, B), state=TL.save_state(tts),
        batch=batch, noise=noise)


@pytest.fixture(scope="module")
def parity():
    mesh = JM.make_env_mesh(2)
    es = NamedSharding(mesh, P(JM.ENV_AXIS))
    core = jax_reach()
    states, _ = jax.jit(jax.vmap(core.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))
    actions = np.random.default_rng(0).uniform(
        -1, 1, (B, core.robot.action_dim)).astype(np.float32)
    s, o, r, *_ = jax.jit(core.batched_step)(
        JM.shard_env_batch(states, mesh), jax.device_put(actions, es))
    metrics = {"a": np.arange(64, dtype=np.float32),
               "b": 2 * np.arange(64, dtype=np.float32)}
    jax_mean = JM.global_metric_mean(JM.shard_env_batch(
        {k: jnp.asarray(v) for k, v in metrics.items()}, mesh), mesh)

    updates, jax_updates = [], []
    for i, (algo, sde) in enumerate(CASES):
        jl, jts, batch, key, case = _update_case(algo, sde, 10 + i)
        rep = NamedSharding(mesh, P())
        new, m = jax.jit(jl.update)(
            jax.device_put(jts, rep),
            {k: jax.device_put(v, es) for k, v in batch.items()},
            jax.device_put(key, rep))
        jax_updates.append((new, m))
        updates.append(case)

    payload = dict(states={k: np.asarray(getattr(states, k))
                           for k in convert.FIELDS},
                   actions=actions, metrics=metrics, updates=updates)
    ranks = launch(W.jax_parity_worker, 2, (payload,), W.TIMEOUT_S)
    return dict(step=(s, o, r), mean=jax_mean, updates=jax_updates,
                ranks=ranks)


def test_sharded_step_matches_jax(parity):
    s, o, r = parity["step"]
    want = {"observation": np.asarray(o["observation"]),
            "reward": np.asarray(r), "q": np.asarray(s.q)}
    assert len(s.q.sharding.device_set) == 2
    for k, v in want.items():
        got = np.concatenate([rk["step"][k] for rk in parity["ranks"]])
        assert got.shape == v.shape
        np.testing.assert_allclose(got, v, atol=ATOL[k], rtol=0, err_msg=k)


def test_global_metric_mean_matches_jax(parity):
    for rk in parity["ranks"]:
        for k, v in parity["mean"].items():
            np.testing.assert_allclose(rk["mean"][k], np.asarray(v),
                                       rtol=1e-7, err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{a.lower()}{'-gsde' if s else ''}"
                              for a, s in CASES])
def test_sharded_update_matches_jax(parity, i):
    new, m = parity["updates"][i]
    r0, r1 = (rk["updates"][i] for rk in parity["ranks"])
    for k in ("critic_loss", "actor_loss", "alpha", "q_target_mean"):
        got = (r0["metrics"][k] + r1["metrics"][k]) / 2
        np.testing.assert_allclose(got, float(m[k]), rtol=RTOL_LOSS,
                                   err_msg=k)
    for name, tree in (("actor", new.actor_params),
                       ("critic", new.critic_params),
                       ("target_critic", new.target_critic_params)):
        want = convert.flatten(jax.device_get(tree))
        for k, v in want.items():
            assert np.array_equal(r0["params"][name][k],
                                  r1["params"][name][k]), (name, k)
            np.testing.assert_allclose(r0["params"][name][k], v,
                                       atol=ATOL_PARAM, rtol=0,
                                       err_msg=f"{name} {k}")
    assert r0["log_alpha"] == r1["log_alpha"]
    np.testing.assert_allclose(r0["log_alpha"], float(new.log_alpha),
                               atol=1e-7, rtol=0)
    assert r0["step"] == r1["step"] == int(new.step) == 1

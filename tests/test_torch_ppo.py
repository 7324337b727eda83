"""Port parity: PPO (panda_gym_tpu_torch/rl/ppo.py) against
panda_gym_tpu/rl/ppo.py, on the CPU.

The JAX PPOState is carried into the port with convert.ppo_state.  Held:
gaussian_logp and gae within atol 1e-6 (and rtol 1e-6: one float32
rounding of values up to ~100); one update (3 epochs of 4
minibatches, the clip on each network's global norm engaged) from JAX's own
permutations within atol 1e-5 on every parameter and Adam moment, the
metrics within rtol 1e-5; collect_rollout on Reach from the same reset
states, with JAX's own action noise and reset states fed to the port, over
a horizon that crosses a time-limit cutoff (the bootstrap into the reward,
the auto-reset): observations and actions atol 5e-4 (the rollout tests'
tolerance, tests/test_torch_train.py), log-probs, values, advantages and
returns atol 2e-3 (they carry that observation error through the networks
and the 0.99 discount), the envs' step counters exact.  Also train_ppo on the CPU and
the clip rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core
from panda_gym_tpu.rl import ppo as JP
from panda_gym_tpu.rl.config import Hyperparameters as JHyper
from panda_gym_tpu.rl.networks import gaussian_logp as jax_logp

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.rl import networks as TN
from panda_gym_tpu_torch.rl import ppo as TP
from panda_gym_tpu_torch.rl.config import Hyperparameters

X, A = 12, 7
ATOL_OBS, ATOL_VALUE = 5e-4, 2e-3


def _scan_loop(f, init, xs=None, length=None, reverse=False):
    """jax.lax.scan as a Python loop, stacking the outputs (gae scans in
    reverse)."""
    n = length if xs is None else len(jax.tree_util.tree_leaves(xs)[0])
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, {}
    for i in order:
        x = (None if xs is None
             else jax.tree_util.tree_map(lambda a: a[i], xs))
        carry, ys[i] = f(carry, x)
    ys = [ys[i] for i in range(n)]
    if ys[0] is None:
        return carry, None
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


def _hp(cls=Hyperparameters, **kw):
    hp = cls("PPO")
    hp.policy_kwargs = dict(log_std_init=-2, net_arch=[32, 32])
    hp.n_epochs, hp.batch_size, hp.n_steps = 3, 16, 5
    # a clip that engages: the minibatch gradients' norms exceed it
    hp.max_grad_norm = 0.05
    for k, v in kw.items():
        setattr(hp, k, v)
    return hp


def _adam(opt):
    st = [s for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    g = jax.device_get
    return g(st.mu), g(st.nu), int(st.count)


def _learners(x_dim=X):
    jl = JP.PPOLearner(x_dim, A, _hp(JHyper))
    jts = jl.init(jax.random.PRNGKey(0))
    tl = TP.PPOLearner(x_dim, A, _hp(), device="cpu")
    g = jax.device_get
    tts = convert.ppo_state(tl, g(jts.actor_params), g(jts.value_params),
                            _adam(jts.actor_opt), _adam(jts.value_opt),
                            int(jts.step))
    return jl, jts, tl, tts


def test_gaussian_logp_and_gae():
    rng = np.random.default_rng(0)
    mean, eps = rng.normal(0, 1, (2, 16, A)).astype(np.float32)
    log_std = rng.normal(-2, 0.5, (16, A)).astype(np.float32)
    a = mean + np.exp(log_std) * eps          # as the sampler draws them
    np.testing.assert_allclose(
        TN.gaussian_logp(*map(torch.tensor, (mean, log_std, a))).numpy(),
        np.asarray(jax_logp(mean, log_std, a)), atol=1e-6, rtol=1e-6)
    T, N = 9, 5
    r, v = rng.normal(0, 1, (2, T, N)).astype(np.float32)
    last = rng.normal(0, 1, N).astype(np.float32)
    d = (rng.uniform(size=(T, N)) < 0.3).astype(np.float32)
    jadv, jret = JP.gae(r, v, last, d, 0.99, 0.9)
    tadv, tret = TP.gae(*map(torch.tensor, (r, v, last, d)), 0.99, 0.9)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-6,
                               rtol=1e-6)


def test_clip_by_global_norm_is_optax_rule():
    import optax
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    for c in (10.0, 5.0, 1.0):
        tx = optax.clip_by_global_norm(c)
        want, _ = tx.update([jnp.asarray(t.numpy()) for t in g],
                            tx.init(None))
        for t, w in zip(TP.clip_by_global_norm(g, c), want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-7)


def test_one_update_matches_jax():
    jl, jts, tl, tts = _learners()
    N = 70      # 4 minibatches of 16, the last 6 rows of each epoch dropped
    rng = np.random.default_rng(1)
    ro = dict(x=rng.normal(0, 1, (N, X)), action=rng.normal(0, 0.3, (N, A)),
              logp=rng.normal(5, 1, N), adv=rng.normal(0, 2, N),
              ret=rng.normal(0, 1, N))
    ro = {k: v.astype(np.float32) for k, v in ro.items()}
    key = jax.random.PRNGKey(3)
    perms = torch.stack([torch.tensor(np.asarray(jax.random.permutation(
        k, N))) for k in jax.random.split(key, jl.n_epochs)])
    jts2, jm = jl.update(jts, {k: jnp.asarray(v) for k, v in ro.items()},
                         key)
    tts2, tm = tl.update(tts, {k: torch.tensor(v) for k, v in ro.items()},
                         perms)
    assert tts2.step == int(jts2.step) == 1
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for module, tree, opt, jopt in (
            (tts2.actor, jts2.actor_params, tts2.actor_opt, jts2.actor_opt),
            (tts2.value, jts2.value_params, tts2.value_opt, jts2.value_opt)):
        t, j = TN.to_flax(module), convert.flatten(jax.device_get(tree))
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        mu, nu, count = _adam(jopt)
        named = dict(module.named_parameters())
        for leaf, jtree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            got = TN.flax_params({n: opt.state[p][leaf]
                                  for n, p in named.items()})
            for k, v in convert.flatten(jtree).items():
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5,
                                           err_msg=f"{leaf} {k}")
        assert count == jl.n_epochs * 4 == int(opt.state[
            next(module.parameters())]["step"])


def test_collect_rollout_matches_jax(monkeypatch):
    """Reach, 4 envs, 5 steps with a 3-step time limit: every env times out
    at step 3, bootstraps and resets."""
    n, T, limit = 4, 5, 3
    jcore = jax_make_core("reach")
    tcore = make_core("reach", device="cpu")
    jl, jts, tl, tts = _learners()
    jstates, jobs = jax.vmap(jcore.reset)(jax.random.split(
        jax.random.PRNGKey(0), n))

    def port(states, obs):
        return (convert.env_state({k: np.asarray(getattr(states, k))
                                   for k in convert.FIELDS}, "cpu"),
                {k: torch.tensor(np.asarray(v)) for k, v in obs.items()})

    # the key chain of ppo.py:172-190: JAX's own noise and reset states,
    # handed to the port in the order it draws them
    noise, resets, key = [], [], jax.random.PRNGKey(7)
    for _ in range(T):
        key, k_act, k_reset = jax.random.split(key, 3)
        noise.append(torch.tensor(np.asarray(jax.random.normal(k_act,
                                                               (n, A)))))
        resets.append(port(*jax.vmap(jcore.reset)(jax.random.split(
            k_reset, n))))
    monkeypatch.setattr(tl, "act_noise", lambda g, m: noise.pop(0))
    monkeypatch.setattr(tcore, "batched_reset", lambda m, g: resets.pop(0))
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    js, jo, _, jro, jst = JP.collect_rollout(
        jcore, jl, jts, jstates, jobs, jax.random.PRNGKey(7), T,
        max_episode_steps=limit)
    ts_, to, tro, tst = TP.collect_rollout(
        tcore, tl, tts, *port(jstates, jobs), torch.Generator(), T,
        max_episode_steps=limit)
    assert not noise and not resets
    for k, atol in (("x", ATOL_OBS), ("action", ATOL_OBS),
                    ("logp", ATOL_VALUE), ("adv", ATOL_VALUE),
                    ("ret", ATOL_VALUE)):
        assert tro[k].shape == jro[k].shape, k
        np.testing.assert_allclose(tro[k].numpy(), np.asarray(jro[k]),
                                   atol=atol, rtol=0, err_msg=k)
    np.testing.assert_allclose(to["observation"].numpy(),
                               np.asarray(jo["observation"]), atol=ATOL_OBS)
    np.testing.assert_array_equal(ts_.steps.numpy(), np.asarray(js.steps))
    assert (ts_.steps == T - limit).all()     # reset at the cutoff
    for k in tst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]),
                                   atol=ATOL_OBS, err_msg=k)


def test_train_ppo_on_cpu():
    hp = _hp(n_steps=4)
    learner, ts, hist = TP.train_ppo(make_core("reach", device="cpu"), hp,
                                     total_steps=32, n_envs=4, seed=0,
                                     max_episode_steps=3)
    assert len(hist) == 2 and ts.step == 2
    assert next(ts.actor.parameters()).device.type == "cpu"
    assert all(np.isfinite(v) for m in hist for v in m.values())
    assert set(hist[0]) == {"mean_reward", "success_rate", "pg_loss",
                            "v_loss", "entropy"}

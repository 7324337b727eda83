"""Port parity: the SAC and TQC learners of panda_gym_tpu_torch/rl/learners.py
against panda_gym_tpu/rl/learners.py, on the CPU, with gSDE on and off.

The JAX learner is initialised by JAX and its TrainState (Flax parameters,
optax Adam states) carried into the port with convert.learner_state.  The
batch comes from numpy seeds; the update's noise is JAX's own (the key is
split as learners.py:434 does, and each half drawn as networks.py:61,122
draws it) and handed to the port.  Held: the Bellman target and the losses
within rtol 1e-5 and their gradients against jax.grad within rtol 1e-4,
atol 1e-6; Adam's step alone against optax.adam within atol 1e-7; three
full updates (metrics within rtol 1e-5, parameters within atol 1e-6 but
for elements whose gradient sits at the rounding level, which Adam's first
steps may move by up to 2 lr the other way); the soft update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl.config import Hyperparameters as JHyper

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.rl import learners as TL
from panda_gym_tpu_torch.rl import networks as TN
from panda_gym_tpu_torch.rl.config import Hyperparameters

B, X, A = 16, 20, 7
RTOL_LOSS, RTOL_GRAD, ATOL_GRAD = 1e-5, 1e-4, 1e-6
ATOL_PARAM = 1e-6
CASES = [("SAC", False), ("SAC", True), ("TQC", False), ("TQC", True)]
IDS = ["sac", "sac-gsde", "tqc", "tqc-gsde"]


def _hp(algo, sde, cls=Hyperparameters):
    hp = cls(algo)
    hp.policy_kwargs = dict(log_std_init=-3, net_arch=[32, 32])
    hp.use_sde = sde
    if algo == "TQC":
        hp.n_quantiles = 5
    return hp


def _learners(algo, sde):
    jl = JL.make_learner(algo, X, A, _hp(algo, sde, JHyper))
    jts = jl.init(jax.random.PRNGKey(0))
    # alpha away from 1, so that every alpha term is exercised
    jts = jts.replace(log_alpha=jnp.asarray(-0.3, jnp.float32))
    tl = TL.make_learner(algo, X, A, _hp(algo, sde), device="cpu")
    return jl, jts, tl, _carry(tl, jts)


def _carry(tl, jts):
    g = jax.device_get
    opt = lambda o: (g(o[0].mu), g(o[0].nu), int(o[0].count))
    return convert.learner_state(
        tl, g(jts.actor_params), g(jts.critic_params),
        g(jts.target_critic_params), opt(jts.actor_opt),
        opt(jts.critic_opt), float(jts.log_alpha), opt(jts.alpha_opt),
        int(jts.step))


def _batch(seed):
    rng = np.random.default_rng(seed)
    b = dict(x=rng.normal(0, 1, (B, X)), x2=rng.normal(0, 1, (B, X)),
             action=np.tanh(rng.normal(0, 1, (B, A))),
             reward=rng.choice([-1.0, 0.0, -101.0], B),
             terminated=(rng.uniform(size=B) < 0.3).astype(np.float64))
    b = {k: v.astype(np.float32) for k, v in b.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _noise(jl, key):
    """The update's draws as learners.py:434 and networks.py:61,122 make
    them."""
    shape = ((jl.net_arch[-1], A) if jl.use_sde else (B, A))
    k_t, k_a = jax.random.split(key)
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, shape)))
                 for k in (k_t, k_a))


def _grads_close(t_named, j_tree, what):
    t = TN.flax_params(t_named)
    j = convert.flatten(jax.device_get(j_tree))
    assert sorted(t) == sorted(j), what
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=RTOL_GRAD,
                                   atol=ATOL_GRAD, err_msg=f"{what} {k}")


def _jax_actor_loss(jl, critic_params, x, k_a, alpha):
    """learners.py:370-374 (SAC) and 446-450 (TQC)."""
    def loss(actor_params):
        a, logp = jl._actor_sample(actor_params, x, k_a)
        z = jl.critic.apply(critic_params, x, a)
        q = (jnp.mean(z, axis=(0, 2)) if isinstance(jl, JL.TQCLearner)
             else jnp.min(z[..., 0], axis=0))
        return jnp.mean(alpha * logp - q)
    return loss


@pytest.mark.parametrize("algo,sde", CASES, ids=IDS)
def test_losses_and_gradients(algo, sde):
    jl, jts, tl, tts = _learners(algo, sde)
    jb, tb = _batch(1)
    key = jax.random.PRNGKey(2)
    k_t, k_a = jax.random.split(key)
    noise_t, noise_a = _noise(jl, key)
    alpha = jnp.exp(jts.log_alpha)
    talpha = torch.exp(tts.log_alpha.detach())

    jq = jl._target_q(jts, jb["x2"], k_t, alpha)
    if algo == "TQC":
        jtarget = jb["reward"][:, None] + jl.gamma * (
            1.0 - jb["terminated"][:, None]) * jq
    else:
        jtarget = jb["reward"] + jl.gamma * (1.0 - jb["terminated"]) * jq
    ttarget = tl.target(tts, tb, noise_t, talpha)
    np.testing.assert_allclose(ttarget.numpy(), np.asarray(jtarget),
                               rtol=RTOL_LOSS, atol=1e-4)

    closs, cgrad = jax.value_and_grad(
        lambda p: jl._critic_loss(p, jts, jb, jtarget)[0])(jts.critic_params)
    tloss = tl.critic_loss(tts.critic, tb, torch.as_tensor(
        np.asarray(jtarget)))
    names, params = zip(*tts.critic.named_parameters())
    tgrad = torch.autograd.grad(tloss, params)
    np.testing.assert_allclose(tloss.item(), float(closs), rtol=RTOL_LOSS)
    _grads_close(dict(zip(names, tgrad)), cgrad, "critic grad")

    aloss, agrad = jax.value_and_grad(_jax_actor_loss(
        jl, jts.critic_params, jb["x"], k_a, alpha))(jts.actor_params)
    tloss, _ = tl.actor_loss(tts.actor, tts.critic, tb["x"], noise_a, talpha)
    names, params = zip(*tts.actor.named_parameters())
    tgrad = torch.autograd.grad(tloss, params)
    np.testing.assert_allclose(tloss.item(), float(aloss), rtol=RTOL_LOSS)
    _grads_close(dict(zip(names, tgrad)), agrad, "actor grad")


def test_adam_matches_optax():
    """The step alone: from parameters at 0, each parameter is the sum of
    the steps so far, so atol 1e-7 is far above its rounding."""
    rng = np.random.default_rng(3)
    shapes = [(32, 20), (32,), ()]
    p0 = [np.zeros(s, np.float32) for s in shapes]
    grads = [[rng.normal(0, 10.0 ** -k, s).astype(np.float32)
              for s in shapes] for k in range(3)]
    tx = optax.adam(7e-4)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.as_tensor(p)) for p in p0]
    opt = TL.adam(tp, 7e-4)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.as_tensor(x)
        opt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=0, atol=1e-7)


def _params_close(tts, jts, grads, lr, n_updates, what):
    """Parameters within ATOL_PARAM, but for elements whose gradient in
    some update sat at the rounding level (|g| <= 1e-5 of the leaf's
    largest), which may differ by up to 2 lr per update."""
    for name, module, tree in (("actor", tts.actor, jts.actor_params),
                               ("critic", tts.critic, jts.critic_params),
                               ("target", tts.target_critic,
                                jts.target_critic_params)):
        t = TN.to_flax(module)
        j = convert.flatten(jax.device_get(tree))
        for k in j:
            d = np.abs(t[k] - j[k])
            tiny = np.zeros(d.shape, bool)
            for g in grads[name if name != "target" else "critic"]:
                tiny |= np.abs(g[k]) <= 1e-5 * np.abs(g[k]).max()
            assert (d[~tiny] <= ATOL_PARAM).all(), (
                f"{what} {name} {k}: max {d[~tiny].max()}")
            assert (d[tiny] <= 2 * lr * n_updates + ATOL_PARAM).all(), (
                f"{what} {name} {k}")


@pytest.mark.parametrize("algo,sde", CASES, ids=IDS)
def test_three_updates_match(algo, sde):
    jl, jts, tl, tts = _learners(algo, sde)
    jupdate = jax.jit(jl.update)
    grads = {"actor": [], "critic": []}
    for i in range(3):
        jb, tb = _batch(10 + i)
        key = jax.random.PRNGKey(20 + i)
        jts, jm = jupdate(jts, jb, key)
        tts, tm = tl.update(tts, tb, _noise(jl, key))
        for k in ("critic_loss", "actor_loss", "alpha", "q_target_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL_LOSS, err_msg=f"{k} {i}")
        for name in grads:
            grads[name].append(TN.flax_params(
                {n: p.grad for n, p in getattr(tts, name).named_parameters()}))
        _params_close(tts, jts, grads, tl.lr, i + 1, f"update {i}")
        np.testing.assert_allclose(tts.log_alpha.item(), float(jts.log_alpha),
                                   rtol=0, atol=1e-7)
        assert tts.step == int(jts.step) == i + 1


def test_soft_update_matches_optax():
    jl, jts, tl, tts = _learners("TQC", True)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in tts.critic.parameters():
            p.add_(torch.as_tensor(rng.normal(0, 1, p.shape).astype(
                np.float32)))
    new = {"params": {"VmapMLP_0": {}}}
    for k, v in TN.to_flax(tts.critic).items():
        _, _, layer, leaf = k.split("/")
        new["params"]["VmapMLP_0"].setdefault(layer, {})[leaf] = jnp.asarray(v)
    j = optax.incremental_update(new, jts.target_critic_params, jl.tau)
    tl.soft_update(tts.critic, tts.target_critic)
    t = TN.to_flax(tts.target_critic)
    for k, v in convert.flatten(jax.device_get(j)).items():
        np.testing.assert_allclose(t[k], v, rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("sde", [False, True], ids=["squashed", "gsde"])
def test_act_matches_jax(sde):
    jl, jts, tl, tts = _learners("TQC", sde)
    x = np.random.default_rng(5).normal(0, 1, (B, X)).astype(np.float32)
    tx = torch.as_tensor(x)
    key = jax.random.PRNGKey(6)
    for det in (True, False):
        ja = jl.act(jts, jnp.asarray(x), key, deterministic=det)
        shape = (32, A) if sde else (B, A)
        ta = tl.act(tts, tx, torch.as_tensor(np.asarray(
            jax.random.normal(key, shape))), deterministic=det)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    mean_j, std_j = jl.act_with_std(jts, jnp.asarray(x))
    mean_t, std_t = tl.act_with_std(tts, tx)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), atol=1e-5)
    if sde:
        expl = jl.sample_expl(jts, key, B)
        ja = jl.act(jts, jnp.asarray(x), key, expl=expl)
        ta = tl.act(tts, tx, expl=torch.as_tensor(np.asarray(expl)))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
        g = torch.Generator().manual_seed(0)
        assert tl.sample_expl(tts, g, B).shape == (B, 32, A)
    else:
        assert tl.sample_expl(tts, torch.Generator(), B) is None


def test_unported_algorithms_raise():
    for algo in ("TD3", "DDPG", "PPO"):
        with pytest.raises(NotImplementedError, match="item 15"):
            TL.make_learner(algo, X, A, Hyperparameters(algo), device="cpu")
    with pytest.raises(Exception, match="Algorithm not found"):
        TL.make_learner("A2C", X, A, Hyperparameters("TQC"), device="cpu")


def test_state_save_and_restore_checks_leaves():
    _, _, tl, tts = _learners("TQC", True)
    saved = TL.save_state(tts)
    assert TL.ckpt_uses_sde(saved) and TL.ckpt_uses_sde(tts)
    other = tl.init(torch.Generator().manual_seed(1))
    TL.load_state(other, saved)
    for (k, a), b in zip(TL.named_state(tts).items(),
                         TL.named_state(other).values()):
        assert torch.equal(a, b), k
    narrow = TL.make_learner("TQC", X, A, _hp("TQC", True), device="cpu")
    narrow.net_arch = (16, 16)
    with pytest.raises(ValueError, match="resume learner: leaf"):
        TL.load_state(narrow.init(torch.Generator()), saved)
    squashed = TL.make_learner("TQC", X, A, _hp("TQC", False), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        TL.load_state(squashed.init(torch.Generator()), saved)

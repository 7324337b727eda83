"""Port parity: the TD3 and DDPG learners of panda_gym_tpu_torch/rl/learners.py
against panda_gym_tpu/rl/learners.py, on the CPU.

The JAX learner is initialised by JAX and its TrainState carried into the
port with convert.learner_state.  The update's noise is JAX's own
(learners.py:317 draws it from the update's key) and handed to the port.
Held, with tests/test_torch_learners.py's tolerances: the Bellman target
and both losses within rtol 1e-5 and their gradients against jax.grad
within rtol 1e-4, atol 1e-6; three full updates (metrics within rtol 1e-5,
parameters within atol 1e-6 but for elements whose gradient sits at the
rounding level); on TD3's second update the actor's gradient is masked and
its Adam still steps, so the actor moves by momentum alone, in both
packages.  Also the exploration action and the dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl.config import Hyperparameters as JHyper

from panda_gym_tpu_torch.rl import learners as TL
from panda_gym_tpu_torch.rl import networks as TN
from panda_gym_tpu_torch.rl.config import Hyperparameters
from panda_gym_tpu_torch.rl.ppo import PPOLearner
from test_torch_learners import (A, B, RTOL_LOSS, X, _batch, _carry,
                                 _grads_close, _params_close)

ALGOS = ["TD3", "DDPG"]


def _hp(algo, cls=Hyperparameters):
    hp = cls(algo)
    hp.policy_kwargs = dict(net_arch=[32, 32])
    return hp


def _learners(algo):
    jl = JL.make_learner(algo, X, A, _hp(algo, JHyper))
    jts = jl.init(jax.random.PRNGKey(0))
    tl = TL.make_learner(algo, X, A, _hp(algo), device="cpu")
    return jl, jts, tl, _carry(tl, jts)


def _noise(key):
    """learners.py:317: the target smoothing draw from the update's key."""
    return (torch.tensor(np.asarray(jax.random.normal(key, (B, A)))),)


def _jax_target(jl, jts, jb, key):
    """learners.py:315-323."""
    a2 = jl.actor.apply(jts.actor_params, jb["x2"])
    noise = jnp.clip(jl.policy_noise * jax.random.normal(key, a2.shape),
                     -jl.noise_clip, jl.noise_clip)
    a2 = jnp.clip(a2 + noise, -1, 1)
    q2 = jnp.min(jl.critic.apply(jts.target_critic_params, jb["x2"],
                                 a2)[..., 0], axis=0)
    return jb["reward"] + jl.gamma * (1 - jb["terminated"]) * q2


@pytest.mark.parametrize("algo", ALGOS)
def test_losses_and_gradients(algo):
    jl, jts, tl, tts = _learners(algo)
    assert isinstance(tts.actor, TN.DeterministicActor)
    assert tts.critic.kernel[0].shape[0] == (2 if algo == "TD3" else 1)
    jb, tb = _batch(1)
    key = jax.random.PRNGKey(2)
    jtarget = _jax_target(jl, jts, jb, key)
    ttarget = tl.target(tts, tb, _noise(key)[0])
    np.testing.assert_allclose(ttarget.numpy(), np.asarray(jtarget),
                               rtol=RTOL_LOSS, atol=1e-4)

    def critic_loss(cp):
        q = jl.critic.apply(cp, jb["x"], jb["action"])[..., 0]
        return jnp.mean((q - jtarget[None]) ** 2)

    closs, cgrad = jax.value_and_grad(critic_loss)(jts.critic_params)
    tloss = tl.critic_loss(tts.critic, tb, torch.as_tensor(
        np.asarray(jtarget)))
    names, params = zip(*tts.critic.named_parameters())
    np.testing.assert_allclose(tloss.item(), float(closs), rtol=RTOL_LOSS)
    _grads_close(dict(zip(names, torch.autograd.grad(tloss, params))),
                 cgrad, "critic grad")

    def actor_loss(ap):
        a = jl.actor.apply(ap, jb["x"])
        return -jnp.mean(jl.critic.apply(jts.critic_params, jb["x"],
                                         a)[0, :, 0])

    aloss, agrad = jax.value_and_grad(actor_loss)(jts.actor_params)
    tloss, logp = tl.actor_loss(tts.actor, tts.critic, tb["x"])
    assert logp is None
    names, params = zip(*tts.actor.named_parameters())
    np.testing.assert_allclose(tloss.item(), float(aloss), rtol=RTOL_LOSS)
    _grads_close(dict(zip(names, torch.autograd.grad(tloss, params))),
                 agrad, "actor grad")


@pytest.mark.parametrize("algo", ALGOS)
def test_three_updates_match(algo):
    jl, jts, tl, tts = _learners(algo)
    jupdate = jax.jit(jl.update)
    grads = {"actor": [], "critic": []}
    for i in range(3):
        jb, tb = _batch(10 + i)
        key = jax.random.PRNGKey(20 + i)
        actor_before = {k: v.copy()
                        for k, v in TN.to_flax(tts.actor).items()}
        jactor_before = jts.actor_params
        jts, jm = jupdate(jts, jb, key)
        tts, tm = tl.update(tts, tb, _noise(key))
        assert set(tm) == set(jm) == {"critic_loss", "actor_loss",
                                      "q_target_mean"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL_LOSS, err_msg=f"{k} {i}")
        for name in grads:
            grads[name].append(TN.flax_params(
                {n: p.grad for n, p in getattr(tts, name).named_parameters()}))
        _params_close(tts, jts, grads, tl.lr, i + 1, f"update {i}")
        assert tts.step == int(jts.step) == i + 1
        if algo == "TD3" and i == 1:
            # the delayed actor: a zero gradient, and still a step
            assert all(not p.grad.any() for p in tts.actor.parameters())
            moved = [np.abs(TN.to_flax(tts.actor)[k] - v).max()
                     for k, v in actor_before.items()]
            assert min(moved) > 0
            jmoved = jax.tree_util.tree_map(
                lambda a, b: float(jnp.abs(a - b).max()), jts.actor_params,
                jactor_before)
            assert min(jax.tree_util.tree_leaves(jmoved)) > 0
            assert int(tts.actor_opt.state[
                next(tts.actor.parameters())]["step"]) == 2
        else:
            assert any(p.grad.any() for p in tts.actor.parameters())


@pytest.mark.parametrize("algo", ALGOS)
def test_act_matches_jax(algo):
    jl, jts, tl, tts = _learners(algo)
    x = np.random.default_rng(5).normal(0, 1, (B, X)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    for det in (True, False):
        ja = jl.act(jts, jnp.asarray(x), key, deterministic=det)
        ta = tl.act(tts, torch.as_tensor(x), torch.as_tensor(np.asarray(
            jax.random.normal(key, (B, A)))), deterministic=det)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    assert tl.act_noise(torch.Generator(), B).shape == (B, A)
    assert [n.shape for n in tl.update_noise(torch.Generator(), B)] == [
        (B, A)]


def test_dispatch_builds_every_algorithm():
    """TD3, DDPG and PPO build; an unknown name still raises."""
    assert isinstance(TL.make_learner("TD3", X, A, _hp("TD3"), "cpu"),
                      TL.TD3Learner)
    ddpg = TL.make_learner("DDPG", X, A, _hp("DDPG"), "cpu")
    assert type(ddpg) is TL.DDPGLearner and ddpg.policy_delay == 1
    assert isinstance(TL.make_learner("PPO", X, A, Hyperparameters("PPO"),
                                      "cpu"), PPOLearner)
    with pytest.raises(Exception, match="Algorithm not found"):
        TL.make_learner("A2C", X, A, Hyperparameters("TQC"), device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
def test_state_save_and_restore(algo):
    """TD3 and DDPG keep log_alpha and its Adam, as the JAX state does, so
    that checkpoints are uniform."""
    _, jts, tl, tts = _learners(algo)
    assert tts.log_alpha.item() == float(jts.log_alpha) == 0.0
    saved = TL.save_state(tts)
    assert "log_alpha" in saved["tensors"] and not TL.ckpt_uses_sde(saved)
    other = tl.init(torch.Generator().manual_seed(1))
    TL.load_state(other, saved)
    for (k, a), b in zip(TL.named_state(tts).items(),
                         TL.named_state(other).values()):
        assert torch.equal(a, b), k

"""Port parity: the networks and samplers of panda_gym_tpu_torch/rl/networks.py
against panda_gym_tpu/rl/networks.py, on the CPU.

Flax parameters are initialised by JAX and carried into the port by name
(networks.load_flax); inputs come from numpy seeds, and the samplers'
standard-normal draws are JAX's own (jax.random.normal on the key the JAX
sampler splits, networks.py:61,122), handed to the port.  Outputs and log
probabilities are held within atol 1e-5.  Narrow widths ([32, 32], 5
quantiles) plus one forward pass at the TQC preset's full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.rl import networks as JN

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.rl import networks as TN

ATOL = 1e-5
B, X, A = 16, 20, 7


def _x(seed, n=B, d=X):
    return np.random.default_rng(seed).normal(0, 1, (n, d)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _pair(jax_mod, port_mod, *inputs, seed=0):
    params = jax_mod.init(jax.random.PRNGKey(seed), *inputs)
    TN.load_flax(port_mod, convert.flatten(jax.device_get(params)))
    return params


def test_flatten_obs_key_order():
    obs = {k: np.full((2, n), i, np.float32) for i, (k, n) in enumerate(
        (("observation", 4), ("achieved_goal", 3), ("desired_goal", 3)))}
    j = JN.flatten_obs({k: jnp.asarray(v) for k, v in obs.items()})
    t = TN.flatten_obs({k: _t(v) for k, v in obs.items()})
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256)],
                         ids=["narrow", "full-width"])
def test_squashed_actor_forward(hidden):
    x = _x(1, d=62)
    jm = JN.SquashedGaussianActor(A, hidden, -3.0)
    tm = TN.SquashedGaussianActor(62, A, hidden, -3.0, device="cpu")
    p = _pair(jm, tm, jnp.asarray(x))
    jmean, jls = jm.apply(p, jnp.asarray(x))
    tmean, tls = tm(_t(x))
    _close(tmean, jmean)
    _close(tls, jls)


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256)],
                         ids=["narrow", "full-width"])
def test_sde_actor_forward(hidden):
    x = _x(2, d=62)
    jm = JN.SDEGaussianActor(A, hidden, -3.0)
    tm = TN.SDEGaussianActor(62, A, hidden, -3.0, device="cpu")
    p = _pair(jm, tm, jnp.asarray(x))
    for t, j in zip(tm(_t(x)), jm.apply(p, jnp.asarray(x))):
        _close(t, j)


@pytest.mark.parametrize("hidden,out,n_critics",
                         [((32, 32), 5, 2), ((32, 32), 1, 3),
                          ((256, 256), 25, 2)],
                         ids=["narrow-tqc", "narrow-sac", "full-width-tqc"])
def test_critic_ensemble_forward(hidden, out, n_critics):
    x, a = _x(3, d=62), np.tanh(_x(4, d=A))
    jm = JN.QCritic(hidden, out, n_critics)
    tm = TN.QCritic(62 + A, hidden, out, n_critics, device="cpu")
    p = _pair(jm, tm, jnp.asarray(x), jnp.asarray(a))
    j = jm.apply(p, jnp.asarray(x), jnp.asarray(a))
    t = tm(_t(x), _t(a))
    assert t.shape == j.shape == (n_critics, B, out)
    _close(t, j)


def test_flax_names_round_trip():
    tm = TN.QCritic(X + A, (32, 32), 5, 2, device="cpu")
    flat = TN.to_flax(tm)
    assert sorted(flat) == sorted(
        f"params/VmapMLP_0/Dense_{i}/{k}" for i in range(3)
        for k in ("kernel", "bias"))
    assert flat["params/VmapMLP_0/Dense_0/kernel"].shape == (2, X + A, 32)
    other = TN.QCritic(X + A, (32, 32), 5, 2, device="cpu")
    TN.load_flax(other, flat)
    for p, q in zip(tm.parameters(), other.parameters()):
        assert torch.equal(p, q)
    flat["params/VmapMLP_0/Dense_1/kernel"] = np.zeros((2, 32, 33))
    with pytest.raises(ValueError, match="Dense_1/kernel"):
        TN.load_flax(other, flat)


@pytest.mark.parametrize("kind", ["actor", "critic"])
def test_init_matches_flax_distribution(kind):
    """Fresh kernels are lecun-normal (truncated at 2 std, variance
    1/fan_in), biases zero, the log-std head's bias log_std_init: the same
    distribution as Flax's; moments within a few sampling errors."""
    g = torch.Generator().manual_seed(0)
    fan_in, n_out = 256, 256
    if kind == "actor":
        tm = TN.SquashedGaussianActor(fan_in, 7, (n_out, n_out), -3.0,
                                      generator=g, device="cpu")
        w = tm.dense[1].weight.detach().numpy().T
        assert torch.all(tm.dense[-1].bias == -3.0)
        assert torch.all(tm.dense[0].bias == 0.0)
        jm = JN.SquashedGaussianActor(7, (n_out, n_out), -3.0)
        jw = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, fan_in)))[
            "params"]["Dense_1"]["kernel"]
    else:
        tm = TN.QCritic(fan_in - 7, (n_out, n_out), 25, 2, generator=g,
                        device="cpu")
        w = tm.kernel[1].detach().numpy()
        assert torch.all(tm.bias[1] == 0.0)
        jm = JN.QCritic((n_out, n_out), 25, 2)
        jw = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, fan_in - 7)),
                     jnp.zeros((1, 7)))["params"]["VmapMLP_0"]["Dense_1"][
            "kernel"]
    jw = np.asarray(jw)
    assert w.shape == jw.shape
    std = 1.0 / np.sqrt(n_out)
    for a in (w, jw):
        assert abs(a.std() - std) < 0.02 * std
        assert abs(a.mean()) < 0.02 * std
        # truncated at 2 stds of the untruncated normal (std / 0.8796)
        assert np.abs(a).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)


def test_sample_squashed():
    mean, log_std = _x(5, d=A), np.clip(_x(6, d=A), -3, 1)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, mean.shape))
    ja, jl = JN.sample_squashed(jnp.asarray(mean), jnp.asarray(log_std), key)
    ta, tl = TN.sample_squashed(_t(mean), _t(log_std), _t(eps))
    _close(ta, ja)
    _close(tl, jl)
    _close(TN.deterministic_action(_t(mean)),
           JN.deterministic_action(jnp.asarray(mean)))


def test_sde_samplers():
    mean = _x(8, d=A)
    latent = np.maximum(_x(9, d=32), 0)
    log_std = np.random.default_rng(10).uniform(-4, 0, (32, A)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    W = np.asarray(jax.random.normal(key, log_std.shape))
    ja, jl = JN.sample_sde_squashed(jnp.asarray(mean), jnp.asarray(latent),
                                    jnp.asarray(log_std), key)
    ta, tl = TN.sample_sde_squashed(_t(mean), _t(latent), _t(log_std), _t(W))
    _close(ta, ja)
    _close(tl, jl)
    _close(TN.sde_std(_t(latent), _t(log_std)),
           JN.sde_std(jnp.asarray(latent), jnp.asarray(log_std)))
    expl = np.random.default_rng(12).normal(0, 1, (B, 32, A)).astype(
        np.float32)
    _close(TN.sde_action_from_expl(_t(mean), _t(latent), _t(log_std),
                                   _t(expl)),
           JN.sde_action_from_expl(jnp.asarray(mean), jnp.asarray(latent),
                                   jnp.asarray(log_std), jnp.asarray(expl)))

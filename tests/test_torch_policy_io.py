"""Port parity: the .policy.npz format of panda_gym_tpu_torch/rl/policy_io.py
and panda_gym_tpu/rl/policy_io.py, on the CPU.

The committed training/run_data/round4_campaign/tqc_r4_gen/
best_model.policy.npz (a legacy squashed-Gaussian actor, use_sde false,
x_dim 62) is loaded into both packages: deterministic actions agree within
1e-5 on seeded observations.  A policy the port exports reads back through
the JAX package's load_policy and acts the same.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl import policy_io as JP
from panda_gym_tpu.rl.config import Hyperparameters as JHyper

from panda_gym_tpu_torch.rl import learners as TL
from panda_gym_tpu_torch.rl import policy_io as TP
from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
from panda_gym_tpu_torch.rl.train import Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
POLICY = os.path.join(ROOT, "training", "run_data", "round4_campaign",
                      "tqc_r4_gen", "best_model.policy.npz")
X_DIM, A = 62, 7


def _obs(seed, n=32):
    return np.random.default_rng(seed).normal(0, 0.5, (n, X_DIM)).astype(
        np.float32)


def _learners(sde, net_arch=(256, 256)):
    hps = []
    for cls in (JHyper, Hyperparameters):
        hp = cls("TQC")
        hp.use_sde = sde
        hp.policy_kwargs = dict(log_std_init=-3, net_arch=list(net_arch))
        hps.append(hp)
    jl = JL.make_learner("TQC", X_DIM, A, hps[0])
    tl = TL.make_learner("TQC", X_DIM, A, hps[1], device="cpu")
    return (jl, jl.init(jax.random.PRNGKey(0)), tl,
            tl.init(torch.Generator().manual_seed(0)))


def test_committed_policy_acts_alike():
    jparams, jmeta = JP.load_policy(POLICY)
    tparams, tmeta = TP.load_policy(POLICY)
    assert tmeta == jmeta and tmeta["use_sde"] is False
    jl, jts, tl, tts = _learners(sde=False)
    jts = JP.graft_actor(jts, jparams)
    tts = TP.graft_actor(tts, tparams)
    x = _obs(1)
    ja = jl.act(jts, jnp.asarray(x), jax.random.PRNGKey(0),
                deterministic=True)
    ta = tl.act(tts, torch.as_tensor(x), deterministic=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)


def test_graft_rejects_a_mismatch():
    tparams, _ = TP.load_policy(POLICY)
    _, _, tl, tts = _learners(sde=False, net_arch=(64, 64))
    with pytest.raises(ValueError, match="net_arch / obs-dim mismatch"):
        TP.graft_actor(tts, tparams)
    _, _, tl, tts = _learners(sde=True)
    with pytest.raises(ValueError, match="param tree mismatch"):
        TP.graft_actor(tts, tparams)


@pytest.mark.parametrize("sde", [False, True], ids=["squashed", "gsde"])
def test_port_export_reads_back_in_jax(tmp_path, sde):
    jl, jts, tl, tts = _learners(sde, net_arch=(32, 32))
    cfg = TrainConfig()
    cfg.hyperparams = tl.hp
    tr = Trainer(cfg, make_env=None)
    tr.ts, tr.timesteps = tts, 1234
    tr.save(str(tmp_path / "m.ckpt"))
    out = TP.export_policy(str(tmp_path / "m.ckpt"),
                           str(tmp_path / "m.policy"), cfg)
    assert out.endswith(".policy.npz")
    jparams, meta = JP.load_policy(out)
    assert meta["use_sde"] is sde and meta["timesteps"] == 1234
    assert meta["net_arch"] == [32, 32] and meta["format"] == TP.FORMAT
    jts = JP.graft_actor(jts, jparams)
    x = _obs(2)
    ja = jl.act(jts, jnp.asarray(x), jax.random.PRNGKey(0),
                deterministic=True)
    ta = tl.act(tts, torch.as_tensor(x), deterministic=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    # and back into the port, bit for bit
    tparams, _ = TP.load_policy(out)
    _, _, _, other = _learners(sde, net_arch=(32, 32))
    TP.graft_actor(other, tparams)
    for p, q in zip(tts.actor.parameters(), other.actor.parameters()):
        assert torch.equal(p, q)

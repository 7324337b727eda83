"""Card-only tests of the PyTorch port: kernel K1 against its plain version
and the batched Reach env on the card.

Run on a machine with an NVIDIA card (tests/conftest.py imports JAX, which
such a machine need not have, so it is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Imports torch, numpy and the port only.  Whether a card is present is
decided inside the ``card`` fixture, so every process collects the same
tests; without a card each test skips.
"""
import numpy as np
import pytest
import torch

from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import cuda_dynamics as CD

pytestmark = pytest.mark.cuda

DT = 1.0 / 500.0
# tests/test_dynamics.py:295-296
ATOL_Q, ATOL_QD = 2e-5, 2e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _inputs(model, B, mode, seed, device):
    rng = np.random.default_rng(seed)
    q = rng.uniform(np.asarray(model.q_lo), np.asarray(model.q_hi), (B, 7))
    qd = rng.normal(0, 0.5, (B, 7))
    tgt = (q + rng.normal(0, 0.05, (B, 7)) if mode == 0
           else rng.normal(0, 1.0, (B, 7)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (q, qd, tgt)]


@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
@pytest.mark.parametrize("B", [24, 1000])
def test_k1_matches_plain(card, mode, B):
    model = make_panda_model()
    k1 = CD.make_cuda_motor_steps(model, n_substeps=20, dt=DT, ctrl_mode=mode)
    args = _inputs(model, B, mode, 11, card)
    qk, qdk = k1(*args)
    qp, qdp = k1.plain(*args)
    torch.cuda.synchronize()
    assert k1.launches == 1
    assert (qk - qp).abs().max().item() <= ATOL_Q
    assert (qdk - qdp).abs().max().item() <= ATOL_QD


def test_k1_checks_its_inputs(card):
    k1 = CD.make_cuda_motor_steps(make_panda_model(), n_substeps=1, dt=DT,
                                  ctrl_mode=0)
    good = torch.zeros(8, 7, device=card)
    for bad in (good.double(), torch.zeros(8, 6, device=card),
                torch.zeros(7, 8, device=card).T):
        with pytest.raises(ValueError):
            k1(bad, good, good)
    assert k1.launches == 0
    k1(torch.zeros(0, 7, device=card), torch.zeros(0, 7, device=card),
       torch.zeros(0, 7, device=card))
    assert k1.launches == 1


def test_reach_on_card_matches_cpu(card):
    env_g = make_core("reach")
    env_c = make_core("reach", device="cpu")
    assert env_g.device.type == "cuda"
    states, _ = env_g.batched_reset(128, torch.Generator(card).manual_seed(0))
    s_c = states.__class__(**{k: getattr(states, k).cpu()
                              for k in states.__dataclass_fields__})
    rng = np.random.default_rng(0)
    for _ in range(2):
        a = rng.uniform(-1, 1, (128, 7)).astype(np.float32)
        states, obs, r, *_ = env_g.batched_step(states, a)
        s_c, obs_c, r_c, *_ = env_c.batched_step(s_c, a)
        np.testing.assert_allclose(states.q.cpu().numpy(), s_c.q.numpy(),
                                   atol=ATOL_Q)
        np.testing.assert_allclose(obs["observation"].cpu().numpy(),
                                   obs_c["observation"].numpy(), atol=2e-4)
    assert env_g.physics_step_batched.motor.launches == 2

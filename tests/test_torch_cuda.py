"""Card-only tests of the PyTorch port: kernel K1 against its plain version,
the batched Reach and ReachAO envs, the trainer (HER sample and TQC
update against the CPU, a short Reach run) and the batched IK of the
evaluation's start poses (against the CPU) on the card.

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

from panda_gym_tpu_torch.envs.core import _hi_prec
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
from panda_gym_tpu_torch.models.panda import EE_SITE, make_panda_model
from panda_gym_tpu_torch.ops import cuda_dynamics as CD
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.rl import her
from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
from panda_gym_tpu_torch.rl.learners import (load_state, make_learner,
                                             named_state, save_state)
from panda_gym_tpu_torch.rl.logging_utils import RunLogger
from panda_gym_tpu_torch.rl.train import Trainer, learner_batch

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


@pytest.mark.parametrize("lanes", [CD.LANES, CD.THREAD],
                         ids=["lanes", "thread"])
@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
# a lone env, and ragged last blocks of 16 envs (24, 1000, 4100) and of 128
@pytest.mark.parametrize("B", [1, 24, 1000, 4100])
def test_k1_matches_plain(card, mode, B, lanes):
    model = make_panda_model()
    k1 = CD.make_cuda_motor_steps(model, n_substeps=20, dt=DT, ctrl_mode=mode,
                                  warm_start=True)
    args = _inputs(model, B, mode, 11, card)
    qk, qdk = k1.launch(*args, lanes)
    qp, qdp = k1.plain(*args)
    torch.cuda.synchronize()
    assert k1.launches == 1
    assert k1.kernel_launches[lanes] == 1
    assert (qk - qp).abs().max().item() <= ATOL_Q
    assert (qdk - qdp).abs().max().item() <= ATOL_QD


def test_k1_picks_kernel_from_batch(card):
    """The lane-group kernel up to one wave of its grid, one env per thread
    past it."""
    wave = CD.lanes_wave(card.index)
    occ = CD.occupancy(card.index, CD.LANES)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert wave == sms * occ["blocks_per_sm"] * 16
    k1 = CD.make_cuda_motor_steps(make_panda_model(), n_substeps=1, dt=DT,
                                  ctrl_mode=0, warm_start=True)
    for B in (1, wave, wave + 1):
        k1(*_inputs(make_panda_model(), B, 0, 3, card))
    torch.cuda.synchronize()
    assert k1.kernel_launches == {CD.LANES: 2, CD.THREAD: 1}


def test_k1_checks_its_inputs(card):
    k1 = CD.make_cuda_motor_steps(make_panda_model(), n_substeps=1, dt=DT,
                                  ctrl_mode=0, warm_start=True)
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


@pytest.mark.parametrize("cold", [True, False], ids=["cold", "warm"])
@pytest.mark.parametrize("lanes", [CD.LANES, CD.THREAD],
                         ids=["lanes", "thread"])
def test_k1_one_substep_matches_plain(card, lanes, cold):
    """n_substeps=1, as the ReachAO collision step launches K1."""
    model = make_panda_model()
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=not cold)
    args = _inputs(model, 1000, 0, 5, card)
    qk, qdk = k1.launch(*args, lanes)
    qp, qdp = k1.plain(*args)
    assert (qk - qp).abs().max().item() <= ATOL_Q
    assert (qdk - qdp).abs().max().item() <= ATOL_QD


def test_reach_ao_step_k1_route_matches_plain(card):
    """One ReachAO policy step of the collision physics on the card: K1 once
    per substep against the plain cold substep, from the same states."""
    env = make_reach_ao_core("reachao2")
    gen = torch.Generator(card).manual_seed(0)
    states, obs = env.batched_reset(256, gen)
    opos = states.obstacle_pos.clone()
    opos[:4, 0] = obs["achieved_goal"][:4]       # collide in substep 1
    states = _hi_prec(env.robot.set_action)(
        states.replace(obstacle_pos=opos),
        torch.rand(256, 7, generator=gen, device=card) * 2 - 1)
    phys = env.physics_step_batched
    out_k = phys(states)
    out_p = phys(states, phys.plain_substep_step)
    assert phys.motor.launches == 20
    assert (out_k.q - out_p.q).abs().max().item() <= ATOL_Q
    assert (out_k.qd - out_p.qd).abs().max().item() <= ATOL_QD
    assert ((out_k.link_obstacle_dist - out_p.link_obstacle_dist).abs().max()
            .item() <= 1e-4)
    assert torch.equal(out_k.is_collided, out_p.is_collided)
    assert out_k.is_collided[:4].all()


def test_dls_ik_card_matches_cpu(card):
    """The batched IK as ReachAO's pose randomizers call it (30 steps from
    the neutral pose), on targets of the three IK'd benchmark scenes'
    ranges: the card's q within 1e-5 of the CPU's."""
    model = make_panda_model()
    rng = np.random.default_rng(3)
    boxes = [((0.0, -0.6, 0.2), (0.5, -0.5, 0.7)),        # narrow_tunnel
             ((-0.5, -0.8, 0.4), (0.2, -0.4, 0.7)),       # industrial
             ((0.3, -0.5, 0.2), (0.6, 0.5, 0.6))]         # in the shell
    targets = np.concatenate([rng.uniform(lo, hi, (256, 3))
                              for lo, hi in boxes]).astype(np.float32)
    q0 = torch.as_tensor(make_core("reach", device="cpu").robot.neutral)
    ik = _hi_prec(K.dls_ik)
    q_cpu = ik(model, EE_SITE, torch.as_tensor(targets), q0=q0, n_iters=30)
    q_card = ik(model, EE_SITE, torch.as_tensor(targets, device=card),
                q0=q0.to(card), n_iters=30)
    assert q_card.device.type == "cuda"
    assert (q_card.cpu() - q_cpu).abs().max().item() <= 1e-5


def test_reach_ao_warm_on_card_raises(card, monkeypatch):
    """K1 cannot carry the warm active set across its one-substep launches,
    so the collision step refuses to run warm on the card."""
    monkeypatch.setenv("PANDA_LCP_WARM", "1")
    monkeypatch.setattr(D, "LCP_WARM_START", True)
    env = make_reach_ao_core("reachao1")
    states, _ = env.batched_reset(8, torch.Generator(card).manual_seed(0))
    with pytest.raises(NotImplementedError):
        env.batched_step(states, torch.zeros(8, 7, device=card))
    assert env.physics_step_batched.motor.launches == 0


# ------------------------------------------------------------------ training

def _tqc_pair(card, net_arch=(256, 256)):
    """A TQC learner (the preset: 25 quantiles, 2 critics, gSDE) on the
    card and its twin on the CPU in the same state."""
    hp = Hyperparameters("TQC")
    hp.policy_kwargs = dict(hp.policy_kwargs, net_arch=list(net_arch))
    on_card = make_learner("TQC", 62, 7, hp, card)
    on_cpu = make_learner("TQC", 62, 7, hp, "cpu")
    ts = on_card.init(torch.Generator(card).manual_seed(0))
    ts_cpu = load_state(on_cpu.init(torch.Generator().manual_seed(0)),
                        save_state(ts))
    return on_card, ts, on_cpu, ts_cpu


def _filled_buffer(card, n=64, T=20):
    rng = np.random.default_rng(3)
    buf = her.create(2 * n, T, 56, 3, 7, 5, card)
    f = lambda *s: torch.as_tensor(rng.normal(0, 0.2, s).astype(np.float32),
                                   device=card)
    aux = f(n, T, 5).abs()
    aux[..., 0] = (aux[..., 0] > 0.3).float()
    return her.add_episodes(
        buf, obs=f(n, T + 1, 56), achieved=f(n, T + 1, 3), desired=f(n, 3),
        action=f(n, T, 7), aux=aux,
        ep_len=torch.as_tensor(rng.integers(1, T + 1, n), device=card),
        terminated=f(n, T) > 0.3)


def test_her_sample_card_matches_cpu(card):
    env = make_reach_ao_core("reachao1")
    rf = lambda a, g, x: env.task.reward_from_aux(env, a, g, x)
    buf = _filled_buffer(card)
    draws = her.draw(buf, torch.Generator(card).manual_seed(1), 256)
    b = her.gather(buf, draws, rf)
    b_cpu = her.gather(buf.to("cpu"), {k: v.cpu() for k, v in draws.items()},
                       rf)
    for k in b:
        assert b[k].device.type == "cuda"
        assert torch.equal(b[k].cpu(), b_cpu[k]), k


def test_tqc_update_card_matches_cpu(card):
    """One update from the same state, batch and noise: losses and alpha
    within rtol 1e-4, every gradient within rtol 1e-4, atol 1e-6 (chip_smoke
    phase 8 says why gradients and not the new parameters)."""
    env = make_reach_ao_core("reachao1")
    rf = lambda a, g, x: env.task.reward_from_aux(env, a, g, x)
    buf = _filled_buffer(card)
    gen = torch.Generator(card).manual_seed(2)
    batch = learner_batch(her.sample(buf, gen, 256, rf))
    on_card, ts, on_cpu, ts_cpu = _tqc_pair(card)
    noise = on_card.update_noise(gen, 256)
    _, m = on_card.update(ts, batch, noise)
    _, m_cpu = on_cpu.update(ts_cpu, {k: v.cpu() for k, v in batch.items()},
                             tuple(n.cpu() for n in noise))
    for k in ("critic_loss", "actor_loss", "alpha"):
        np.testing.assert_allclose(float(m[k]), float(m_cpu[k]), rtol=1e-4)
    for name in ("actor", "critic"):
        for (n, p), q in zip(getattr(ts, name).named_parameters(),
                             getattr(ts_cpu, name).parameters()):
            np.testing.assert_allclose(p.grad.cpu().numpy(),
                                       q.grad.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}.{n}")
    assert ts.step == ts_cpu.step == 1


def test_reach_trainer_runs_on_card(card, tmp_path):
    """Two rollouts of the Reach trainer at n_envs 512 on the card: each
    rollout followed by a burst, every tensor of the learner and the buffer
    on the card, K1 once per env step."""
    cfg = TrainConfig(n_envs=512, stages=["s0"], max_ep_steps=[10],
                      ee_error_thresholds=[0.05], success_thresholds=[2.0],
                      max_timesteps=10240, learning_starts=5120,
                      eval_freq=10 ** 9, benchmark_eval_scenes=[])
    cores = []

    def make_env(scene, thr, spd):
        cores.append(make_core("reach"))
        return cores[-1]

    tr = Trainer(cfg, make_env, logger=RunLogger(root=str(tmp_path)))
    tr.learn(seed=0)
    rows = [r for r in tr.metrics.history if "rollout_reward" in r]
    assert len(rows) == 2 and tr.timesteps == 10240
    # learning starts at min(5120, 10240 // 4) = 2560: a burst of
    # int(0.125 * 5120) = 640 after each rollout (the gate stays shut)
    assert tr.ts.step == 2 * 640
    assert cores[0].physics_step_batched.motor.launches == 2 * 10
    for k, v in named_state(tr.ts).items():
        if not k.endswith("/step"):
            assert v.device.type == "cuda", k
        assert torch.isfinite(v).all(), k
    assert tr.buffer.device.type == "cuda" and tr.buffer.n_stored == 1024

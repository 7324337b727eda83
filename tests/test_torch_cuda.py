"""Card-only tests of the PyTorch port: kernel K1 against its plain version
(with its one-substep launches of the contact step: the seed, the carried
active set, the contact torque) on the welded Panda, MyCobot and the 9-dof
Panda, the batched Reach, ReachAO, Push, Slide, PickAndPlace and
MyCobotReach envs, the trainer (HER sample and TQC
update against the CPU, a short Reach run), the batched IK of the
evaluation's start poses (against the CPU), and the paths of the NEO prior
and the ee/pcc control modes (against the CPU) on the card.

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
from panda_gym_tpu_torch.models.mycobot import make_mycobot_model
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
    n = model.ndof
    q = rng.uniform(np.asarray(model.q_lo), np.asarray(model.q_hi), (B, n))
    qd = rng.normal(0, 0.5, (B, n))
    tgt = (q + rng.normal(0, 0.05, (B, n)) if mode == 0
           else rng.normal(0, 1.0, (B, n)))
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


@pytest.mark.parametrize("lanes", [CD.LANES, CD.THREAD],
                         ids=["lanes", "thread"])
@pytest.mark.parametrize("B", [1, 1000])
def test_k1_chained_warm_substeps_equal_one_launch(card, B, lanes):
    """A seed launch and 20 warm one-substep launches that carry the set,
    with tau_ext = 0, equal one warm 20-substep launch bit for bit."""
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    k20 = CD.make_cuda_motor_steps(model, n_substeps=20, dt=DT, ctrl_mode=0,
                                   warm_start=True)
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    q, qd, tgt = _inputs(model, B, 0, 21, card)
    q20, qd20 = k20.launch(q, qd, tgt, lanes)
    warm = k1.seed(q, qd, tgt, lanes)
    psat, psign = k1.plain_seed(q, qd, tgt)
    assert torch.equal(warm[0], psat) and torch.equal(warm[1], psign)
    zero = torch.zeros_like(q)
    for _ in range(20):
        q, qd, warm = k1.substep(q, qd, tgt, zero, warm, lanes)
    torch.cuda.synchronize()
    assert k1.launches == 21 and k1.kernel_launches[lanes] == 21
    assert torch.equal(q, q20) and torch.equal(qd, qd20)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("lanes", [CD.LANES, CD.THREAD],
                         ids=["lanes", "thread"])
def test_k1_tau_ext_substep_matches_plain(card, lanes, warm):
    """One substep with a random contact torque, from a random set (or
    cold), against the plain substep: 2e-5 / 2e-3, the set equal."""
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    B = 1000
    q, qd, tgt = _inputs(model, B, 0, 31, card)
    gen = torch.Generator(card).manual_seed(41)
    tau = torch.randn(B, 7, generator=gen, device=card) * 20.0
    w = None
    if warm:
        w = (torch.rand(B, 7, generator=gen, device=card) < 0.3,
             torch.where(torch.rand(B, 7, generator=gen, device=card) < 0.5,
                         -1.0, 1.0))
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    qk, qdk, wk = k1.substep(q, qd, tgt, tau, w, lanes)
    qp, qdp, wp = k1.plain_substep(q, qd, tgt, tau, w)
    torch.cuda.synchronize()
    assert (qk - qp).abs().max().item() <= ATOL_Q
    assert (qdk - qdp).abs().max().item() <= ATOL_QD
    if warm:
        assert torch.equal(wk[0], wp[0]) and torch.equal(wk[1], wp[1])
    else:
        assert wk is None and wp is None


@pytest.mark.parametrize("task", ["push", "slide"])
def test_contact_step_k1_route_matches_plain(card, task):
    """One Push or Slide policy step on the card: K1 with tau_ext, one seed
    and 20 warm one-substep launches, against the plain route from the same
    states, objects pushed by the arm in envs 0-7."""
    env = make_core(task)
    gen = torch.Generator(card).manual_seed(0)
    states, obs = env.batched_reset(256, gen)
    pos = states.body_pos.clone()
    ee = env.robot.ee_position(K.fk_world(env.model, states.q))
    pos[:8, 0] = ee[:8] + torch.tensor([0.02, 0.0, -0.01], device=card)
    states = _hi_prec(env.robot.set_action)(
        states.replace(body_pos=pos),
        torch.rand(256, env.robot.action_dim, generator=gen, device=card)
        * 2 - 1)
    phys = env.physics_step_batched
    out_k = phys(states)
    out_p = phys(states, plain=True)
    assert phys.motor.launches == 21
    assert (out_k.q - out_p.q).abs().max().item() <= ATOL_Q
    assert (out_k.qd - out_p.qd).abs().max().item() <= ATOL_QD
    # the pushed objects moved; the others stay where they were on the table
    assert ((out_k.body_pos[:8] - pos[:8]).abs().amax((1, 2)) > 1e-3).all()
    assert ((out_k.body_pos[8:, 0, :2] - pos[8:, 0, :2]).abs() < 1e-4).all()


# the chains besides the welded Panda, which run the one-env-per-thread
# kernel at every batch
CHAINS = {
    "mycobot": lambda: make_mycobot_model(base_position=(-0.6, 0.0, 0.0)),
    "panda9": lambda: make_panda_model(base_position=(-0.6, 0.0, 0.0),
                                       gripper="prismatic"),
}


@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
@pytest.mark.parametrize("B", [1, 1000, 4100])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_k1_chain_matches_plain(card, chain, B, mode):
    """20 warm substeps of MyCobot and of the 9-dof Panda: the wrapper picks
    the one-env-per-thread kernel; q, qd within 2e-5, 2e-3."""
    model = CHAINS[chain]()
    k1 = CD.make_cuda_motor_steps(model, n_substeps=20, dt=DT, ctrl_mode=mode,
                                  warm_start=True)
    args = _inputs(model, B, mode, 12, card)
    qk, qdk = k1(*args)
    qp, qdp = k1.plain(*args)
    torch.cuda.synchronize()
    assert k1.kernel_launches == {CD.LANES: 0, CD.THREAD: 1}
    assert (qk - qp).abs().max().item() <= ATOL_Q
    assert (qdk - qdp).abs().max().item() <= ATOL_QD


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_k1_chain_tau_ext_substeps_match_plain(card, chain):
    """A seed and 20 one-substep launches with a contact torque, each warm
    from the set of the one before, against the plain chain substep by
    substep (q, qd within 2e-5, 2e-3, the active sets equal), and equal bit
    for bit to one 20-substep launch with that torque."""
    model = CHAINS[chain]()
    B = 1000
    q, qd, tgt = _inputs(model, B, 0, 32, card)
    tau = torch.randn(B, model.ndof, generator=torch.Generator(
        card).manual_seed(33), device=card) * 5.0
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    k20 = CD.make_cuda_motor_steps(model, n_substeps=20, dt=DT, ctrl_mode=0,
                                   warm_start=True)
    q20, qd20 = k20._launch(q, qd, tgt, CD.THREAD, 20, True, tau_ext=tau)
    warm = k1.seed(q, qd, tgt)
    wp = k1.plain_seed(q, qd, tgt)
    qp, qdp = q, qd
    for _ in range(20):
        q, qd, warm = k1.substep(q, qd, tgt, tau, warm)
        qp, qdp, wp = k1.plain_substep(qp, qdp, tgt, tau, wp)
        assert (q - qp).abs().max().item() <= ATOL_Q
        assert (qd - qdp).abs().max().item() <= ATOL_QD
        assert torch.equal(warm[0], wp[0])
    torch.cuda.synchronize()
    assert k1.kernel_launches == {CD.LANES: 0, CD.THREAD: 21}
    assert torch.equal(q, q20) and torch.equal(qd, qd20)


def _grip(env, states, n):
    """Open the fingers of envs 0..n-1 to 3 cm each and put their cube
    between them, turned with the hand, 2 mm into each finger's capsule."""
    q = states.q.clone()
    q[:n, 7:9] = 0.03
    p0, p1 = K.capsule_endpoints_world(env.model, K.fk_world(env.model, q))
    mid = 0.5 * (p0 + p1)
    left, right = (env.model.cap_body_tuple.index(d) for d in (7, 8))
    d = mid[:n, right] - mid[:n, left]
    yaw = torch.atan2(d[:, 1], d[:, 0])
    pos, quat = states.body_pos.clone(), states.body_quat.clone()
    pos[:n, 0] = 0.5 * (mid[:n, left] + mid[:n, right])
    zero = torch.zeros_like(yaw)
    quat[:n, 0] = torch.stack([zero, zero, torch.sin(yaw / 2),
                               torch.cos(yaw / 2)], -1)
    return states.replace(q=q, ctrl_target=q.clone(), body_pos=pos,
                          body_quat=quat)


def test_pick_and_place_step_k1_route_matches_plain(card):
    """One PickAndPlace policy step on the card, the cube gripped in envs
    0-7: K1 on the 9-dof chain with tau_ext, a seed and 20 warm one-substep
    launches on the one-env-per-thread kernel, against the plain route from
    the same states."""
    env = make_core("pickandplace")
    gen = torch.Generator(card).manual_seed(0)
    states, _ = env.batched_reset(256, gen)
    states = _grip(env, states, 8)
    act = torch.rand(256, 4, generator=gen, device=card) * 2 - 1
    act[:, 3] = -0.02
    states = _hi_prec(env.robot.set_action)(states, act)
    phys = env.physics_step_batched
    *_, tau, _ = _hi_prec(phys.forces)(states.q, states.qd, states.body_pos,
                                       states.body_quat, states.body_vel,
                                       states.body_ang)
    assert (tau[:8, 7:].abs() > 1.0).all()
    out_k = phys(states)
    out_p = phys(states, plain=True)
    assert phys.motor.kernel_launches == {CD.LANES: 0, CD.THREAD: 21}
    assert (out_k.q - out_p.q).abs().max().item() <= ATOL_Q
    assert (out_k.qd - out_p.qd).abs().max().item() <= ATOL_QD
    assert ((out_k.body_pos[:8, 0] - states.body_pos[:8, 0]).abs().amax(1)
            > 1e-4).all()


def test_mycobot_reach_step_k1_route_matches_plain(card):
    """One MyCobotReach step on the card: K1 once, 20 warm substeps of the
    6-dof chain on the one-env-per-thread kernel, against the plain
    version from the same states."""
    env = make_core("mycobotreach")
    gen = torch.Generator(card).manual_seed(0)
    states, _ = env.batched_reset(1000, gen)
    states = states.replace(q=states.q + 0.3 * torch.rand(
        1000, 6, generator=gen, device=card))
    act = torch.rand(1000, 6, generator=gen, device=card) * 2 - 1
    s_in = _hi_prec(env.robot.set_action)(states, act)
    motor = env.physics_step_batched.motor
    qp, qdp = motor.plain(s_in.q, s_in.qd, s_in.ctrl_target)
    out, obs, *_ = env.batched_step(states, act)
    torch.cuda.synchronize()
    assert motor.kernel_launches == {CD.LANES: 0, CD.THREAD: 1}
    assert (out.q - qp).abs().max().item() <= ATOL_Q
    assert (out.qd - qdp).abs().max().item() <= ATOL_QD
    assert obs["observation"].shape == (1000, 6)


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
    out_p = phys(states, plain=True)
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


def test_reach_ao_warm_on_card_matches_plain(card, monkeypatch):
    """Under PANDA_LCP_WARM=1 the collision step runs warm on the card: a
    seed launch and 20 one-substep launches that carry the active set,
    against the plain warm route from the same states."""
    monkeypatch.setenv("PANDA_LCP_WARM", "1")
    monkeypatch.setattr(D, "LCP_WARM_START", True)
    env = make_reach_ao_core("reachao1")
    gen = torch.Generator(card).manual_seed(0)
    states, _ = env.batched_reset(256, gen)
    states = _hi_prec(env.robot.set_action)(
        states, torch.rand(256, 7, generator=gen, device=card) * 2 - 1)
    phys = env.physics_step_batched
    assert phys.warm_start
    out_k = phys(states)
    out_p = phys(states, plain=True)
    assert phys.motor.launches == 21
    assert (out_k.q - out_p.q).abs().max().item() <= ATOL_Q
    assert (out_k.qd - out_p.qd).abs().max().item() <= ATOL_QD
    assert torch.equal(out_k.is_collided, out_p.is_collided)


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


# ------------------------------------------------- the prior, ee and pcc

def _to_cpu(states):
    return states.replace(**{k: getattr(states, k).cpu()
                             for k in states.__dataclass_fields__})


def test_admm_card_matches_cpu(card):
    """The batched ADMM on 256 random NEO-sized problems (13 variables, 75
    rows): the card's solution within 1e-5 of the CPU's."""
    from panda_gym_tpu_torch.ops.qp import solve_qp_admm

    rng = np.random.default_rng(5)
    B, n, m = 256, 13, 75
    M = rng.normal(size=(B, n, n))
    P = [np.einsum("bij,bkj->bik", M, M) / n + 0.01 * np.eye(n),
         rng.normal(size=(B, n)), rng.normal(size=(B, m, n)),
         rng.uniform(-2, -0.1, (B, m)), rng.uniform(0.1, 2, (B, m))]
    P = [torch.as_tensor(a, dtype=torch.float32) for a in P]
    x_cpu, _ = _hi_prec(solve_qp_admm)(*P)
    x, _ = _hi_prec(solve_qp_admm)(*[a.to(card) for a in P])
    assert (x.cpu() - x_cpu).abs().max().item() <= 1e-5


@pytest.mark.parametrize("scene", ["reachao1", "tunnel", "industrial"])
def test_neo_card_matches_cpu(card, scene):
    """NEO on 256 reset envs, env 0 with an obstacle ~0.1 m from its end
    effector: the card's command within 1e-4 of the CPU's on every env but
    at most 2 (damper-edge ties; chip_smoke phase 10b tells them apart)."""
    from panda_gym_tpu_torch.ops.neo import compute_action_neo

    env = make_reach_ao_core(scene)
    states, obs = env.batched_reset(256, torch.Generator(card).manual_seed(0))
    opos = states.obstacle_pos.clone()
    opos[0, 0] = obs["achieved_goal"][0] + torch.tensor([0.0, 0.1, 0.1],
                                                         device=card)
    states = states.replace(obstacle_pos=opos)

    def neo(s):
        return compute_action_neo(env.model, env.robot.ee_site, s,
                                  K.fk_world(env.model, s.q), s.goal)

    with torch.no_grad():
        qd = neo(states)
    qd_cpu = neo(_to_cpu(states))
    assert qd.device.type == "cuda" and torch.isfinite(qd).all()
    assert int(((qd.cpu() - qd_cpu).abs() > 1e-4).any(1).sum()) <= 2


@pytest.mark.parametrize("control", ["ee", "pcc"])
def test_control_modes_card_match_cpu(card, control):
    """Two Reach steps at B = 512 from the same states and actions: q within
    1e-5 and the observation within 2e-4 of the CPU's, K1 once per step."""
    env, env_cpu = (make_core("reach", control_type=control, device=d)
                    for d in (card, "cpu"))
    gen = torch.Generator(card).manual_seed(1)
    s, _ = env.batched_reset(512, gen)
    s_cpu = _to_cpu(s)
    for _ in range(2):
        a = torch.rand(512, env.robot.action_dim, generator=gen,
                       device=card) * 2 - 1
        s, o, *_ = env.batched_step(s, a)
        s_cpu, o_cpu, *_ = env_cpu.batched_step(s_cpu, a.cpu())
        assert (s.q.cpu() - s_cpu.q).abs().max().item() <= 1e-5
        assert ((o["observation"].cpu() - o_cpu["observation"]).abs().max()
                .item() <= 2e-4)
    assert env.physics_step_batched.motor.launches == 2


def test_prior_paths_run_on_card(card, tmp_path):
    """The prior observation, the trainer's bootstrap and the prior
    strategy, each on the card: the observation grows by 7, the bootstrap
    fills the buffer (20 K1 launches per env step), the evaluation's rates
    sum to 1."""
    from panda_gym_tpu_torch.eval import benchmark as EB

    cfg = TrainConfig(task_observations={
        "obstacles": "vectors+closest_per_link", "prior": "rrmc_neo"})
    env = make_reach_ao_core("reachao1", config=cfg)
    s, obs = env.batched_reset(64, torch.Generator(card).manual_seed(0))
    assert obs["observation"].shape == (64, 63)
    cfg = TrainConfig(n_envs=64, stages=["tunnel"], max_ep_steps=[5],
                      prior_steps=320, max_timesteps=160, learning_starts=1,
                      eval_freq=10 ** 9, benchmark_eval_scenes=[])
    cfg.hyperparams.policy_kwargs = dict(log_std_init=-3, net_arch=[64, 64])
    cores = []

    def make_env(scene, thr, spd):
        cores.append(make_reach_ao_core(scene, config=cfg))
        return cores[-1]

    tr = Trainer(cfg, make_env, logger=RunLogger(root=str(tmp_path)))
    tr.learn(seed=0)
    assert tr.buffer.n_stored >= 128 and tr.buffer.device.type == "cuda"
    core = make_reach_ao_core("reachao_rand_start")
    res = EB.perform_benchmark(None, [], core, n_episodes=16, horizon=5,
                               strategy="prior")
    rates = [res[k] for k in ("success_rate", "collision_rate",
                              "timeout_rate")]
    assert abs(sum(rates) - 1.0) < 1e-9
    assert core.physics_step_batched.motor.launches == 20 * 5

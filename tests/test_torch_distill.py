"""Port parity: distillation (panda_gym_tpu_torch/rl/distill.py) against
panda_gym_tpu/rl/distill.py, on the CPU.

collect_labeled with the committed routed generalist's 17 members as the
teacher (controller 0's mask), a 32-wide student driving (DAgger) with drive noise,
on reachao1, 4 episodes of 3 steps, from JAX's own reset states with the
first obstacle moved onto the end effector of the envs whose reset key has
an even first word (they collide on the first step and stay frozen), the
drive noise JAX's own: X and the active mask within the rollout tests'
atol 5e-4 / exactly, the teacher labels within the routed action's rtol
1e-5 / atol 1e-6 on the step whose states are JAX's, 5e-4 after; the JAX
side eager (tests/test_torch_eval.py says why).  bc_train for 20 steps
against JAX's from the same numpy index stream, with and without sample
weights: parameters within atol 1e-5.  Also the student helpers.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.eval import router as JR
from panda_gym_tpu.rl import distill as JD
from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl.config import Hyperparameters as JHyper
from panda_gym_tpu.rl.logging_utils import load_run as jload_run

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.rl import distill as TD
from panda_gym_tpu_torch.rl import learners as TL
from panda_gym_tpu_torch.rl import networks as TN
from panda_gym_tpu_torch.rl.config import Hyperparameters
from panda_gym_tpu_torch.rl.logging_utils import load_config
from test_torch_ppo import _scan_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "panda_gym_tpu_torch", "assets", "routed_gen")
X_DIM, ACT = 62, 7
ATOL_OBS = 5e-4


def _student_hp(cls):
    hp = cls("TQC")
    hp.use_sde = False
    hp.policy_kwargs = dict(log_std_init=-3, net_arch=[32, 32])
    return hp


def test_collect_labeled_matches_jax(monkeypatch):
    n, horizon, seed = 4, 3, 5
    jpolicy, _ = JR.load_routed_policy(os.path.join(ASSET,
                                                    "routed_policy.npz"))
    members = convert.routed_policy(jpolicy.members, jpolicy.masks,
                                    jpolicy.router_params, "cpu").members
    mask = np.asarray(jpolicy.masks[0])
    assert 0 < mask.sum() < len(mask)
    jcfg, _ = jload_run(ASSET)
    jcfg.hyperparams.use_sde = False
    jactor = JL.make_learner("TQC", X_DIM, ACT, jcfg.hyperparams).actor
    jstudent = JL.make_learner("TQC", X_DIM, ACT, _student_hp(JHyper))
    sparams = jstudent.init(jax.random.PRNGKey(1)).actor_params
    student = TL.make_learner("TQC", X_DIM, ACT, _student_hp(Hyperparameters),
                              "cpu").init(torch.Generator()).actor
    TN.load_flax(student, convert.flatten(jax.device_get(sparams)))

    cfg = load_config(os.path.join(ASSET, "config.json"))
    kw = lambda c: dict(config=c, ee_error_threshold=0.05,  # noqa: E731
                        speed_threshold=0.5)
    jcore = jrao.make_reach_ao_core("reachao1", **kw(jcfg))
    tcore = trao.make_reach_ao_core("reachao1", device="cpu", **kw(cfg))
    reset = jax.jit(jcore.reset)

    def collide_reset(key):
        s, o = reset(key)
        hit = key[0] % 2 == 0
        opos = s.obstacle_pos.at[0].set(
            jnp.where(hit, o["achieved_goal"], s.obstacle_pos[0]))
        return s.replace(obstacle_pos=opos), o

    # the draws of distill.py:94-106: the reset keys and each step's
    # drive noise, JAX's own
    key = jax.random.PRNGKey(seed)
    k_rest, k_loop = jax.random.split(key)
    jstates, jobs = jax.vmap(collide_reset)(jax.random.split(k_rest, n))
    hit = np.asarray(jax.vmap(lambda k: k[0] % 2 == 0)(
        jax.random.split(k_rest, n)))
    assert hit.any() and not hit.all()
    noise, k = [], k_loop
    for _ in range(horizon):
        k, k_n = jax.random.split(k)
        noise.append(torch.tensor(np.asarray(jax.random.normal(
            k_n, (n, ACT)))))
    tstates = convert.env_state({f: np.asarray(getattr(jstates, f))
                                 for f in convert.FIELDS}, "cpu")
    tobs = {f: torch.tensor(np.asarray(v)) for f, v in jobs.items()}

    monkeypatch.setattr(jcore, "reset", collide_reset)
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    jX, jA, jact = JD.collect_labeled(
        jcore, jactor, jpolicy.members, jnp.asarray(mask), n, horizon, key,
        student_params=sparams, drive_noise=0.3,
        student_actor=jstudent.actor)
    monkeypatch.undo()
    monkeypatch.setattr(tcore, "batched_reset",
                        lambda m, g: (tstates, tobs))
    monkeypatch.setattr(TD, "draw_normal", lambda g, s, d: noise.pop(0))
    tX, tA, tact = TD.collect_labeled(
        tcore, members, torch.tensor(mask), n, horizon, torch.Generator(),
        student=student, drive_noise=0.3)
    assert not noise
    assert tX.shape == (horizon, n, X_DIM) and tA.shape == (horizon, n, ACT)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    # the colliding envs: done after their first step, frozen since
    assert not tact[1:, hit].any() and tact[:, ~hit].all()
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=ATOL_OBS,
                               rtol=0)
    np.testing.assert_allclose(tA[0].numpy(), np.asarray(jA[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=ATOL_OBS,
                               rtol=0)


def test_bc_train_matches_jax():
    jl = JL.make_learner("TQC", 12, 4, _student_hp(JHyper))
    params = jl.init(jax.random.PRNGKey(0)).actor_params
    rng = np.random.default_rng(0)
    Xd = rng.normal(0, 1, (50, 12)).astype(np.float32)
    Ad = np.tanh(rng.normal(0, 1, (50, 4))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 50)
    for weights in (None, w):
        jp, jloss = JD.bc_train(jl.actor, params, Xd, Ad, steps=20,
                                batch_size=16, lr=1e-3, seed=3,
                                weights=weights, log=lambda s: None)
        tl = TL.make_learner("TQC", 12, 4, _student_hp(Hyperparameters),
                             "cpu")
        actor = TD.init_student(tl, torch.Generator())
        TN.load_flax(actor, convert.flatten(jax.device_get(params)))
        actor, tloss = TD.bc_train(actor, torch.tensor(Xd), torch.tensor(Ad),
                                   steps=20, batch_size=16, lr=1e-3, seed=3,
                                   weights=weights, log=lambda s: None)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        t = TN.to_flax(actor)
        for k, v in convert.flatten(jax.device_get(jp)).items():
            np.testing.assert_allclose(t[k], v, atol=1e-5, rtol=0,
                                       err_msg=k)
    ts = TD.student_as_trainstate(tl, actor)
    for p, q in zip(ts.actor.parameters(), actor.parameters()):
        assert torch.equal(p, q)
    assert ts.step == 0 and ts.actor is not actor

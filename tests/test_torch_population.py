"""The port's population trainer (panda_gym_tpu_torch/rl/population.py), its
stacked HER buffer and its entry point, on the CPU.

Held: the stacked update (K = 3 members, torch.func.vmap over the learner's
own loss hooks) against each member's own sequential update within atol
1e-5 on every tensor of the state (tests/test_population.py:17-55's rule),
for SAC, TQC, TD3 and DDPG; the stacked update against JAX's
jax.vmap(learner.update) from convert.population_state's carried stacked
state (tests/test_torch_learners.py's tolerances, the metrics also within
atol 1e-6 where they come near 0); the stacked ring against
JAX's vmapped add_episodes, and its one gather against each member's own;
the population rollout (K = 2) equal to two single-member rollouts from
the same reset states and exploration draws; the member-0 buffer gate; the
curriculum advancing on the MEDIAN; a member checkpoint through
Trainer.load (the same actions) and policy_io; learn on Reach and ReachAO;
population_cli at --device cpu.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.rl import her as JH
from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl.config import Hyperparameters as JHyper

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_reach_core
from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
from panda_gym_tpu_torch.rl import her as TH
from panda_gym_tpu_torch.rl import learners as TL
from panda_gym_tpu_torch.rl import networks as TN
from panda_gym_tpu_torch.rl import policy_io, population_cli
from panda_gym_tpu_torch.rl import population as TP
from panda_gym_tpu_torch.rl import train as TT
from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
from test_torch_learners import RTOL_LOSS, _params_close

K, X, A, B = 3, 10, 3, 16
CASES = [("TQC", True), ("TQC", False), ("SAC", True), ("TD3", False),
         ("DDPG", False)]
IDS = ["tqc-gsde", "tqc", "sac-gsde", "td3", "ddpg"]


def _hp(algo, sde, cls=Hyperparameters):
    hp = cls(algo)
    hp.policy_kwargs = dict(hp.policy_kwargs, net_arch=[32, 32])
    hp.use_sde = sde
    if algo == "TQC":
        hp.n_quantiles = 5
    return hp


def _batches(seed, k=K):
    rng = np.random.default_rng(seed)
    b = dict(x=rng.normal(0, 1, (k, B, X)), x2=rng.normal(0, 1, (k, B, X)),
             action=np.tanh(rng.normal(0, 1, (k, B, A))),
             reward=rng.choice([-1.0, 0.0, -101.0], (k, B)),
             terminated=(rng.uniform(size=(k, B)) < 0.3).astype(np.float64))
    return {k_: v.astype(np.float32) for k_, v in b.items()}


@pytest.mark.parametrize("algo,sde", CASES, ids=IDS)
def test_stacked_update_equals_sequential(algo, sde):
    learner = TL.make_learner(algo, X, A, _hp(algo, sde), device="cpu")
    stacked = TP.StackedLearner(learner, K)
    g = torch.Generator().manual_seed(0)
    pop = stacked.init(g)
    singles = [TP.member_slice(stacked, pop, i) for i in range(K)]
    for it in range(3):
        batch = {k: torch.tensor(v) for k, v in _batches(it).items()}
        noise = stacked.update_noise(g, B)
        pop, m = stacked.update(pop, batch, noise)
        for i in range(K):
            singles[i], mi = learner.update(
                singles[i], {k: v[i] for k, v in batch.items()},
                tuple(n[i] for n in noise))
            assert set(mi) == set(m)
            for k in mi:
                np.testing.assert_allclose(float(m[k][i]), float(mi[k]),
                                           atol=1e-5, err_msg=f"{k} {it}")
    assert pop.step == 3
    for i in range(K):
        mine = TL.named_state(TP.member_slice(stacked, pop, i))
        for k, v in TL.named_state(singles[i]).items():
            np.testing.assert_allclose(mine[k].detach().numpy(),
                                       v.detach().numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"member {i} {k}")
    # the members stay distinct
    a = pop.actor["dense.0.weight"]
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("algo,sde", [("TQC", True), ("TD3", False)],
                         ids=["tqc-gsde", "td3"])
def test_stacked_update_matches_jax_vmap(algo, sde):
    jl = JL.make_learner(algo, X, A, _hp(algo, sde, JHyper))
    jts = jax.vmap(jl.init)(jax.random.split(jax.random.PRNGKey(0), K))
    learner = TL.make_learner(algo, X, A, _hp(algo, sde), device="cpu")
    stacked = TP.StackedLearner(learner, K)
    g = jax.device_get
    opt = lambda o: (g(o[0].mu), g(o[0].nu), g(o[0].count))  # noqa: E731
    pop = convert.population_state(
        stacked, g(jts.actor_params), g(jts.critic_params),
        g(jts.target_critic_params), opt(jts.actor_opt),
        opt(jts.critic_opt), g(jts.log_alpha), opt(jts.alpha_opt),
        g(jts.step))
    for i in range(K):      # carried whole
        t = TN.to_flax(TP.member_slice(stacked, pop, i).actor)
        for k, v in convert.flatten(g(jts.actor_params)).items():
            np.testing.assert_array_equal(t[k], v[i], err_msg=k)
    jupdate = jax.jit(jax.vmap(jl.update))
    grads = {i: {"actor": [], "critic": []} for i in range(K)}
    shape = (jl.net_arch[-1], A) if sde else (B, A)
    for it in range(3):
        b = _batches(10 + it)
        keys = jax.random.split(jax.random.PRNGKey(20 + it), K)
        jts, jm = jupdate(jts, {k: jnp.asarray(v) for k, v in b.items()},
                          keys)
        if algo == "TD3":
            noise = (np.stack([jax.random.normal(k, (B, A)) for k in keys]),)
        else:
            noise = tuple(np.stack(d) for d in zip(*[
                [jax.random.normal(kk, shape) for kk in jax.random.split(k)]
                for k in keys]))
        pop, m = stacked.update(pop, {k: torch.tensor(v)
                                      for k, v in b.items()},
                                tuple(torch.tensor(n) for n in noise))
        for k in jm:
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       rtol=RTOL_LOSS, atol=1e-6,
                                       err_msg=f"{k} {it}")
        for i in range(K):
            ts_i = TP.member_slice(stacked, pop, i)
            for name in ("actor", "critic"):
                grads[i][name].append(TN.flax_params(
                    {n: p.grad[i] for n, p in getattr(pop, name).items()}))
            _params_close(ts_i, jax.tree_util.tree_map(lambda x: x[i], jts),
                          grads[i], learner.lr, it + 1,
                          f"member {i} update {it}")


# ---------------------------------------------------------------- HER
CAP, T, OBS, GOAL, ACT, AUX = 4, 3, 6, 3, 7, 2


def _episodes(seed, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    ach = f(n, T + 1, GOAL)
    return dict(obs=f(n, T + 1, OBS), achieved=ach,
                desired=ach[:, -1] + f(n, GOAL) * 0.1, action=f(n, T, ACT),
                aux=np.abs(f(n, T, AUX)),
                ep_len=rng.integers(1, T + 1, n).astype(np.int32),
                terminated=rng.uniform(size=(n, T)) < 0.3)


def test_stacked_her_matches_jax_and_members():
    """Two members' rings filled across the wrap-around: the port's ring
    equals JAX's jax.vmap(add_episodes) (population.py:95-113) carried with
    convert.stacked_her_buffer, and one stacked gather equals each member's
    own gather on its slice of the draws."""
    KM = 2
    template = JH.create(CAP, T, OBS, GOAL, ACT, AUX)
    jb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (KM,) + x.shape).copy(), template)
    tb = TH.create_stacked(KM, CAP, T, OBS, GOAL, ACT, AUX, device="cpu")
    for seed, n in ((0, 3), (1, 3)):
        ep = _episodes(seed, KM * n)
        jb = jax.vmap(JH.add_episodes)(jb, **{
            k: jnp.asarray(v.reshape((KM, n) + v.shape[1:]))
            for k, v in ep.items()})
        tb = TH.add_stacked(tb, **{k: torch.as_tensor(v)
                                   for k, v in ep.items()})
    carried = convert.stacked_her_buffer(
        {k: np.asarray(getattr(jb, k)) for k in convert.BUFFER_FIELDS},
        "cpu")
    assert (tb.write_idx, tb.n_stored) == (carried.write_idx,
                                           carried.n_stored) == (2, CAP)
    for k in TH.TENSORS:
        assert torch.equal(getattr(tb, k), getattr(carried, k)), k
    assert tb.nbytes == sum(np.asarray(getattr(jb, k)).nbytes
                            for k in TH.TENSORS)

    def reward_fn(a, g, aux):
        return -(torch.linalg.norm(a - g, dim=-1) > 0.05).float() - aux[:, 0]

    draws = TH.draw_stacked(tb, torch.Generator().manual_seed(3), 32)
    assert draws["ep"].shape == (KM, 32) and int(draws["ep"].max()) < CAP
    got = TH.gather_stacked(tb, draws, reward_fn)
    for i in range(KM):
        ring = TH.HerBuffer(**{k: getattr(tb, k)[i] for k in TH.TENSORS},
                            write_idx=tb.write_idx, n_stored=tb.n_stored)
        want = TH.gather(ring, {k: v[i] for k, v in draws.items()},
                         reward_fn)
        for k, v in want.items():
            assert torch.equal(got[k][i], v), (i, k)


def test_member_gate_reads_member_zero():
    tb = TH.create_stacked(2, CAP, T, OBS, GOAL, ACT, AUX, device="cpu")
    tb = tb.replace(n_stored=1)
    tb.ep_len[1] = T            # member 1 holds more than member 0
    tb.ep_len[0, 0] = 1
    assert not TP.member_gate(tb, 4)
    tb.ep_len[0, :2] = 2
    assert TP.member_gate(tb, 4)
    assert TP.member_gate(tb.replace(n_stored=CAP), 10 ** 9)


# ---------------------------------------------------------- rollouts
def _pop_cfg(**kw):
    cfg = TrainConfig(n_envs=2, stages=["s0"], success_thresholds=[2.0],
                      max_ep_steps=[3], ee_error_thresholds=[0.05],
                      max_timesteps=24, learning_starts=6, eval_freq=6,
                      interleave_min_buffer=6, benchmark_eval_scenes=[])
    for k, v in kw.items():
        setattr(cfg, k, v)
    hp = cfg.hyperparams
    hp.policy_kwargs = dict(log_std_init=-3, net_arch=[32, 32])
    hp.n_quantiles, hp.batch_size, hp.buffer_size = 5, 16, 300
    return cfg


def _reach(*_):
    return make_reach_core(reward_type="dense", device="cpu")


def test_population_rollout_equals_member_rollouts(monkeypatch):
    """K = 2 members of 2 envs: one rollout of the 4-env batch equals each
    member's own 2-env rollout from its half of the reset states and of the
    gSDE exploration draws."""
    core = _reach()
    pv = TT.VectorEnv(core, 4, 3)
    learner = TL.make_learner("TQC", pv.x_dim, pv.act_dim, _hp("TQC", True),
                              device="cpu")
    stacked = TP.StackedLearner(learner, 2)
    pop = stacked.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    states, obs = core.batched_reset(4, g)
    expl = learner.sample_expl(None, g, 4)
    monkeypatch.setattr(pv, "batch_reset", lambda gen: (states, obs))
    monkeypatch.setattr(pv, "_sample_expl", lambda *a: expl)
    pep, pst, _, _ = pv._rollout_episode(stacked, pop, g)
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        sv = TT.VectorEnv(core, 2, 3)
        part = (states.replace(**{k: getattr(states, k)[rows]
                                  for k in states.__dataclass_fields__}),
                {k: v[rows] for k, v in obs.items()})
        monkeypatch.setattr(sv, "batch_reset", lambda gen, p=part: p)
        monkeypatch.setattr(sv, "_sample_expl",
                            lambda *a, e=expl[rows]: e)
        sep, sst, _, _ = sv._rollout_episode(
            learner, TP.member_slice(stacked, pop, i), g)
        for k, v in sep.items():
            np.testing.assert_allclose(pep[k][rows].double().numpy(),
                                       v.double().numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"member {i} {k}")
        for k, v in sst.items():
            np.testing.assert_allclose(pst[k][rows].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=f"member {i} {k}")
    assert pep["action"].abs().max() > 0


class _Log:
    def __init__(self, d):
        self.dir = str(d)
        self.rows = []

    def log(self, row):
        self.rows.append(row)


def test_learn_on_reach_and_member_checkpoints(tmp_path):
    """K = 2 on Reach: a collect rollout, then fused rollouts; one burst of
    round(utd * n_envs) = 1 stacked update per env step; per-member best
    checkpoints; a member checkpoint through Trainer.load and policy_io
    acts as the member does."""
    cfg = _pop_cfg()
    log = _Log(tmp_path)
    pt = TP.PopulationTrainer(cfg, _reach, n_members=2, logger=log)
    pt.learn(seed=0)
    rows = [r for r in log.rows if "rollout_success" in r]
    assert pt.timesteps == 2 * 24 and len(rows) == 4
    assert "critic_loss" not in rows[0] and "critic_loss" in rows[1]
    assert pt.pop.step == 3 * 3            # 3 fused rollouts of 3 steps
    assert pt.buffer.members == 2 and pt.buffer.n_stored == 4 * 2
    assert pt.buffer.capacity == 300 // 3
    evals = [r for r in log.rows if "eval_success" in r]
    assert len(evals) == 4 and all(len(r["eval_success"]) == 2
                                   for r in evals)
    for f in ("best_model_m0.ckpt", "best_model_m1.ckpt",
              "model_s0_0_m0.ckpt", "model_s0_0_m1.ckpt"):
        assert (tmp_path / f).exists(), f
    a = pt.pop.actor["dense.0.weight"]
    assert not torch.equal(a[0], a[1])

    path = str(tmp_path / "m1.ckpt")
    pt.save_member(path, 1)
    tr = TT.Trainer(cfg, _reach)
    tr.load(path)
    assert tr.timesteps == pt.timesteps // 2
    venv = TT.VectorEnv(_reach(), 2, 3)
    tr._ensure_learner(venv, 10)
    x = torch.randn(2, venv.x_dim, generator=torch.Generator().manual_seed(2))
    want = pt.stacked.act(pt.pop, torch.cat([x, x]), deterministic=True)[2:]
    got = tr.learner.act(tr.ts, x, deterministic=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    out = policy_io.export_policy(path, str(tmp_path / "m1"), cfg)
    params, meta = policy_io.load_policy(out)
    assert meta["use_sde"] and meta["timesteps"] == pt.timesteps // 2
    np.testing.assert_array_equal(
        params["params/Dense_0/kernel"],
        pt.pop.actor["dense.0.weight"][1].detach().numpy().T)


def test_stage_advances_on_the_median(tmp_path, monkeypatch):
    """Three members, two stages: with evaluations [0.9, 0.1, 0.2] the
    median 0.2 holds stage 0 to its budget (2 rollouts) although member 0
    passed; with [0.9, 0.1, 0.95] it advances after the first evaluation,
    which follows the first rollout."""
    for succ, want_rows in (([0.9, 0.1, 0.2], 2), ([0.9, 0.1, 0.95], 1)):
        cfg = _pop_cfg(stages=["s0", "s1"], success_thresholds=[0.85, 2.0],
                       max_ep_steps=[3, 3], ee_error_thresholds=[0.05] * 2,
                       speed_thresholds=[0.5] * 2, max_timesteps=12,
                       learning_starts=3)
        log = _Log(tmp_path)
        pt = TP.PopulationTrainer(cfg, _reach, n_members=3, logger=log)
        monkeypatch.setattr(pt, "evaluate", lambda v, g, s=succ: np.array(s))
        pt.learn(seed=0)
        s0 = [r for r in log.rows
              if "rollout_success" in r and r["scenario"] == "s0"]
        assert len(s0) == want_rows, succ


def test_learn_on_reach_ao():
    """ReachAO, K = 2 members of 2 envs at horizon 2: one batched step of 4
    envs per env step, losses finite, the buffer on the env's device."""
    cfg = _pop_cfg(stages=["reachao1"], max_ep_steps=[2], max_timesteps=8,
                   learning_starts=4, eval_freq=8, interleave_min_buffer=4)
    calls = []

    def make_env(sc, thr, spd):
        env = make_reach_ao_core(sc, config=cfg, ee_error_threshold=thr,
                                 speed_threshold=spd, device="cpu")
        step = env.batched_step

        def counted(states, actions):
            calls.append(actions.shape[0])
            return step(states, actions)
        env.batched_step = counted
        return env

    log = _Log("")
    log.dir = None
    pt = TP.PopulationTrainer(cfg, make_env, n_members=2, logger=log)
    pt.learn(seed=1)
    assert pt.timesteps >= 2 * 8 and set(calls) == {4}
    assert pt.buffer.device.type == "cpu" and pt.pop.step >= 1
    rows = [r for r in log.rows if "critic_loss" in r]
    assert rows and all(np.isfinite(r["critic_loss"]) for r in rows)


def test_population_cli(tmp_path, monkeypatch):
    args = ["--members", "2", "--stages", "reachao1", "--n-envs", "2",
            "--max-ep-steps", "2", "--max-timesteps", "4",
            "--learning-starts", "2", "--eval-freq", "4",
            "--buffer-size", "40", "--name", "p"]
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            population_cli.main(args)
    pt = population_cli.main(args + ["--device", "cpu"])
    run = tmp_path / "training" / "run_data" / "default" / "p"
    for f in ("metrics.jsonl", "config.json", "final_m0.ckpt",
              "final_m1.ckpt", "model_reachao1_0_m1.ckpt"):
        assert (run / f).exists(), f
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["stages"] == ["reachao1"] and cfg["n_envs"] == 2
    assert pt.K == 2 and pt.timesteps == 2 * 4
    assert pt.buffer.capacity == 40 // 2
    assert os.path.getsize(run / "final_m0.ckpt") > 0

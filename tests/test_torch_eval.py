"""Port parity: the evaluation slice of panda_gym_tpu_torch (eval/ensemble.py,
eval/router.py, eval/benchmark.py, eval/cli.py, rl/logging_utils.py's
run loading) against panda_gym_tpu's, both on the CPU.

Inputs are drawn with numpy from a seed, or are the committed routed
generalist (17 legacy squashed-Gaussian members [256, 256], x_dim 62, a
router 62 -> 128 -> 128 -> 10) on observations of reset benchmark scenes.
Tolerances: fusion atol 1e-6; routed actions rtol 1e-5 / atol 1e-6, the
router's choices equal where its top two logits differ by more than 1e-5;
perform_benchmark from JAX's own reset states (reachao1 and narrow_tunnel,
4 episodes, 6 steps, the JAX side eager): episode outcomes equal,
continuous metrics rtol 1e-4.
"""
import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.eval import benchmark as JB
from panda_gym_tpu.eval import ensemble as jfusion
from panda_gym_tpu.eval import router as JR
from panda_gym_tpu.rl import learners as JL
from panda_gym_tpu.rl.config import Hyperparameters as JHyperparameters
from panda_gym_tpu.rl.logging_utils import load_run as jload_run

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.eval import benchmark as TB
from panda_gym_tpu_torch.eval import cli as ecli
from panda_gym_tpu_torch.eval import ensemble as tfusion
from panda_gym_tpu_torch.eval import router as TR
from panda_gym_tpu_torch.rl import cli as tcli
from panda_gym_tpu_torch.rl.config import Hyperparameters
from panda_gym_tpu_torch.rl.learners import make_learner
from panda_gym_tpu_torch.rl.logging_utils import (get_run_dirs, load_config,
                                                  load_run)
from panda_gym_tpu_torch.rl.networks import flatten_obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "panda_gym_tpu_torch", "assets", "routed_gen")
POLICY = os.path.join(ASSET, "routed_policy.npz")
R4_GEN = os.path.join(ROOT, "training", "run_data", "round4_campaign",
                      "tqc_r4_gen")
ATOL_FUSE = 1e-6
RTOL_ACT, ATOL_ACT, TIE = 1e-5, 1e-6, 1e-5
RTOL_METRIC = 1e-4
OUTCOMES = ("scenario_episodes", "success_rate", "collision_rate",
            "timeout_rate", "mean_ep_length", "mean_num_sim_steps")


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------------ fusion

@pytest.fixture(scope="module")
def ensemble():
    rng = np.random.default_rng(0)
    K, B, A = 4, 16, 7
    means = rng.uniform(-1, 1, (K, B, A)).astype(np.float32)
    stds = rng.uniform(0.01, 0.5, (K, B, A)).astype(np.float32)
    return means, stds


def test_fusion_functions_match_jax(ensemble):
    means, stds = ensemble
    var = stds ** 2
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), atol=ATOL_FUSE, rtol=0)
    close(tfusion.bayesian_fusion(_t(means), _t(var)),
          jfusion.bayesian_fusion(means, var))
    key = jax.random.PRNGKey(3)
    normal = np.asarray(jax.random.normal(key, means.shape[1:]))
    close(tfusion.bayesian_fusion(_t(means), _t(var), _t(normal)),
          jfusion.bayesian_fusion(means, var, key))
    g = torch.Generator().manual_seed(0)
    drawn = tfusion.bayesian_fusion(_t(means), _t(var), g)
    close(drawn, tfusion.bayesian_fusion(
        _t(means), _t(var), torch.randn(means.shape[1:],
                                        generator=torch.Generator()
                                        .manual_seed(0))))
    close(tfusion.weighted_aggregation(_t(var), _t(means)),
          jfusion.weighted_aggregation(var, means))
    close(tfusion.mean(_t(means)), jfusion.mean(means))
    ta, ti = tfusion.confidence(_t(means), _t(var))
    ja, ji = jfusion.confidence(means, var)
    close(ta, ja)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert len(set(ti.tolist())) > 1
    prior = means[0]
    for sigma in (0.3, stds[1]):
        tm, ts = tfusion.fuse_controllers(_t(prior), sigma if np.isscalar(
            sigma) else _t(sigma), _t(means[2]), _t(stds[2]))
        jm, js = jfusion.fuse_controllers(prior, sigma, means[2], stds[2])
        close(tm, jm)
        close(ts, js)


def test_masked_bayesian_fusion_matches_jax(ensemble):
    means, stds = ensemble
    K, B, _ = means.shape
    rng = np.random.default_rng(1)
    mask_bk = (rng.uniform(size=(B, K)) < 0.5).astype(np.float32)
    mask_bk[:, 0] = 1.0
    for mask in (mask_bk, np.asarray([1.0, 0.0, 1.0, 0.0], np.float32),
                 np.ones(K, np.float32)):
        np.testing.assert_allclose(
            TR.masked_bayesian_fusion(_t(means), _t(stds), _t(mask)).numpy(),
            np.asarray(JR.masked_bayesian_fusion(means, stds, mask)),
            atol=ATOL_FUSE, rtol=0)
    # an all-ones mask is the full bayesian fusion
    np.testing.assert_allclose(
        TR.masked_bayesian_fusion(_t(means), _t(stds), torch.ones(K)).numpy(),
        tfusion.bayesian_fusion(_t(means), _t(stds) ** 2).numpy(),
        atol=ATOL_FUSE, rtol=0)


# ------------------------------------------------------------ member stack

@pytest.mark.parametrize("use_sde", [False, True], ids=["legacy", "gsde"])
def test_member_mean_std_matches_jax(use_sde):
    """K actors of each arity as one MemberStack (a batched product per
    layer) against JAX's vmapped member_mean_std on the same parameters,
    and against each port actor's act_with_std."""
    x_dim, act, K = 12, 4, 3
    hp = Hyperparameters("TQC")
    hp.use_sde = use_sde
    hp.policy_kwargs = dict(hp.policy_kwargs, net_arch=[32, 32])
    learner = make_learner("TQC", x_dim, act, hp, "cpu")
    states = [learner.init(torch.Generator().manual_seed(s)) for s in range(K)]
    members = TR.stack_members([ts.actor for ts in states])
    assert members.sde is use_sde and len(members) == K
    x = torch.as_tensor(np.random.default_rng(2).normal(
        0, 1, (5, x_dim)).astype(np.float32))
    means, stds = TR.member_mean_std(members, x)
    for k, ts in enumerate(states):
        m, s = learner.act_with_std(ts, x)
        np.testing.assert_allclose(means[k].numpy(), m.numpy(), atol=1e-6)
        np.testing.assert_allclose(stds[k].numpy(), s.numpy(), rtol=1e-5)
    jhp = JHyperparameters("TQC")
    jhp.use_sde = use_sde
    jhp.policy_kwargs = dict(jhp.policy_kwargs, net_arch=[32, 32])
    jl = JL.make_learner("TQC", x_dim, act, jhp)
    flat = members.flax_params()
    jmembers = {"params": {}}
    for k, v in flat.items():
        _, *path = k.split("/")
        node = jmembers["params"]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    jm, js = JR.member_mean_std(jl.actor, jmembers, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(means.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(stds.numpy(), np.asarray(js), rtol=1e-5)


# --------------------------------------------------- the routed generalist

@pytest.fixture(scope="module")
def routed():
    """The committed routed policy on both sides, and observations of a
    reset of five benchmark scenes under its training config."""
    jpolicy, jmeta = JR.load_routed_policy(POLICY)
    tpolicy = convert.routed_policy(jpolicy.members, jpolicy.masks,
                                    jpolicy.router_params, "cpu")
    cfg = load_config(os.path.join(ASSET, "config.json"))
    xs = []
    for i, sc in enumerate(["reachao1", "reachao_rand_start", "library2",
                            "narrow_tunnel", "wall"]):
        core = trao.make_reach_ao_core(sc, cfg, device="cpu")
        _, obs = core.batched_reset(8, torch.Generator().manual_seed(i))
        xs.append(flatten_obs(obs))
    x = torch.cat(xs)
    jcfg, _ = jload_run(ASSET)
    jcfg.hyperparams.use_sde = False
    jl = JL.make_learner("TQC", x.shape[1], 7, jcfg.hyperparams)
    jrl = JR.RoutedLearner(jl, jpolicy.masks.shape[0])
    return jpolicy, jmeta, tpolicy, jrl, x


def test_routed_policy_shape(routed):
    jpolicy, meta, tpolicy, _, x = routed
    assert meta["format"] == TR.FORMAT and meta["use_sde"] is False
    assert x.shape == (40, meta["x_dim"]) == (40, 62)
    assert len(tpolicy.members) == 17 and not tpolicy.members.sde
    assert tpolicy.members.n_hidden == 2
    assert tuple(tpolicy.masks.shape) == (10, 17)
    assert [tuple(layer.weight.shape) for layer in tpolicy.router.dense] == [
        (128, 62), (128, 128), (10, 128)]


def test_routed_action_matches_jax(routed):
    """Routed actions and router choices on one batch of observations."""
    jpolicy, _, tpolicy, jrl, x = routed
    act, choice = TR.routed_action(tpolicy, x, return_choice=True)
    jact, jchoice = JR.routed_action(jrl.actor, jrl.router, jpolicy,
                                     jnp.asarray(x.numpy()),
                                     return_choice=True)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=RTOL_ACT,
                               atol=ATOL_ACT)
    top2 = torch.topk(tpolicy.router(x), 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > TIE
    np.testing.assert_array_equal(choice[clear].numpy(),
                                  np.asarray(jchoice)[clear.numpy()])
    assert clear.float().mean() > 0.9 and len(set(choice.tolist())) > 2
    # the learner interface of the benchmark
    a2, s2 = TR.RoutedLearner().act_with_std(tpolicy, x)
    assert torch.equal(a2, act) and (s2 == 1e-3).all()
    jm, js = jrl.act_with_std(jpolicy, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(a2.numpy(), np.asarray(jm), rtol=RTOL_ACT,
                               atol=ATOL_ACT)


def test_routed_policy_save_load_roundtrip(routed, tmp_path):
    """The port loads the committed file as convert.routed_policy builds
    it; a file the port writes holds the same arrays, and JAX loads it to
    the same routed action."""
    jpolicy, meta, tpolicy, jrl, x = routed
    loaded, meta2 = TR.load_routed_policy(POLICY, "cpu")
    assert meta2 == meta
    act = TR.routed_action(tpolicy, x)
    assert torch.equal(TR.routed_action(loaded, x), act)
    path = TR.save_routed_policy(str(tmp_path / "rt"), loaded, meta)
    assert path.endswith("rt.npz")
    with np.load(POLICY) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again, _ = TR.load_routed_policy(path, "cpu")
    assert torch.equal(TR.routed_action(again, x), act)
    jagain, jmeta = JR.load_routed_policy(path)
    assert jmeta == meta
    np.testing.assert_allclose(
        np.asarray(JR.routed_action(jrl.actor, jrl.router, jagain,
                                    jnp.asarray(x.numpy()))),
        act.numpy(), rtol=RTOL_ACT, atol=ATOL_ACT)


def test_asset_copy_is_byte_equal():
    """The port's copy of the evaluated artifacts is the JAX package's:
    the policy and reference scores of round5_campaign/routed_gen and the
    training config of round4_campaign/tqc_r4_gen."""
    runs = os.path.join(ROOT, "training", "run_data")
    sha = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    for name, src in (("routed_policy.npz", "round5_campaign/routed_gen"),
                      ("benchmark.json", "round5_campaign/routed_gen"),
                      ("config.json", "round4_campaign/tqc_r4_gen")):
        assert sha(os.path.join(ASSET, name)) == sha(
            os.path.join(runs, src, name)), name


# --------------------------------------------------------------- benchmark

def _scan_loop(f, init, xs=None, length=None, **kw):
    """jax.lax.scan as a Python loop, stacking the outputs."""
    assert not kw
    n = length if xs is None else len(xs)
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else xs[i])
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


@pytest.mark.parametrize("scenario", ["reachao1", "narrow_tunnel"])
def test_perform_benchmark_matches_jax(routed, monkeypatch, scenario):
    """JAX's perform_benchmark with the routed generalist (4 episodes, 6
    steps, eager) against the port's run_episodes + summarize started from
    JAX's own reset states (fold_in(PRNGKey(seed), 1), then split, as
    benchmark.py:134-136)."""
    jpolicy, _, tpolicy, jrl, _ = routed
    n, horizon, seed = 4, 6, 0
    cfg = load_config(os.path.join(ASSET, "config.json"))
    cfg.safety_distance = 0.0
    jcfg, _ = jload_run(ASSET)
    jcfg.safety_distance = 0.0
    kw = lambda c: dict(config=c, ee_error_threshold=c.ee_error_thresholds[-1],
                        speed_threshold=c.speed_thresholds[-1])
    jcore = jrao.make_reach_ao_core(scenario, **kw(jcfg))
    tcore = trao.make_reach_ao_core(scenario, device="cpu", **kw(cfg))
    # the JAX side op by op: its jitted run as a plain function and every
    # scan (the horizon's and the collision substeps') as a Python loop, as
    # compiling them takes minutes on the CPU; the reset compiled once, for
    # the states handed to the port and for the run alike
    monkeypatch.setattr(jcore, "reset", jax.jit(jcore.reset))
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    monkeypatch.setattr(jax, "jit", lambda f: f)
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), 1), n)
    jstates, jobs = jax.vmap(jcore.reset)(keys)
    want = JB.perform_benchmark(jrl, [jpolicy], jcore, n_episodes=n,
                                horizon=horizon, seed=seed)
    monkeypatch.undo()
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    tobs = {k: torch.tensor(np.asarray(v)) for k, v in jobs.items()}
    policy = TB.make_policy(TR.RoutedLearner(), [tpolicy])
    done, ep_len, m = TB.run_episodes(tcore, policy, tstates, tobs, horizon)
    got = TB.summarize(ep_len, m, tcore.n_substeps)
    assert list(got) == list(want)
    for k in OUTCOMES:
        assert got[k] == want[k], k
    for k in set(got) - set(OUTCOMES):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_METRIC,
                                   err_msg=k)
    assert set(m) == {"effort", "jerk", "manip", "ee_speed", "reward",
                      "success", "collided", "active"}
    assert all(v.shape == (horizon, n) for v in m.values())


@pytest.mark.slow
def test_episodes_match_jax_over_a_long_horizon(routed):
    """library2 (the scene where the port's protocol passes collided most
    against the JAX scores), 16 episodes, 100 steps: JAX's compiled run
    (fp32 on the CPU) and the port's run_episodes from JAX's reset states
    end every episode the same way at the same step (~2 minutes)."""
    jpolicy, _, tpolicy, jrl, _ = routed
    n, horizon = 16, 100
    cfg = load_config(os.path.join(ASSET, "config.json"))
    cfg.safety_distance = 0.0
    jcfg, _ = jload_run(ASSET)
    jcfg.safety_distance = 0.0
    jcore = jrao.make_reach_ao_core("library2", config=jcfg,
                                    ee_error_threshold=0.05,
                                    speed_threshold=0.5)
    tcore = trao.make_reach_ao_core("library2", config=cfg,
                                    ee_error_threshold=0.05,
                                    speed_threshold=0.5, device="cpu")
    run = JB._build_run(jrl, jcore, n, horizon, None, 0.3, 1)
    _, j_len, jm = run(jax.random.PRNGKey(0), [jpolicy])
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 1), n)
    jstates, jobs = jax.jit(jax.vmap(jcore.reset))(keys)
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    tobs = {k: torch.tensor(np.asarray(v)) for k, v in jobs.items()}
    _, t_len, tm = TB.run_episodes(
        tcore, TB.make_policy(TR.RoutedLearner(), [tpolicy]), tstates, tobs,
        horizon)
    for k in ("success", "collided"):
        np.testing.assert_array_equal(tm[k].numpy().any(0),
                                      np.asarray(jm[k]).any(0), err_msg=k)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))


def test_run_episodes_masks_done_episodes_and_stops_early():
    """An episode that ends keeps its state and contributes zeros; once
    every episode has ended the loop stops at the next check."""
    core = trao.make_reach_ao_core("reachao1", device="cpu")
    states, obs = core.batched_reset(3, torch.Generator().manual_seed(0))
    opos = states.obstacle_pos.clone()
    opos[:, 0] = obs["achieved_goal"]          # every env collides at once
    states = states.replace(obstacle_pos=opos)
    policy = lambda x: torch.zeros(x.shape[0], 7)
    done, ep_len, m = TB.run_episodes(core, policy, states, obs, 50)
    assert done.all() and (ep_len == 1).all()
    assert m["active"].shape == (TB.DONE_CHECK_EVERY, 3)
    assert m["collided"][0].all() and not m["collided"][1:].any()
    assert not m["active"][1:].any() and not m["effort"][1:].any()
    res = TB.summarize(ep_len, m, core.n_substeps)
    assert res["collision_rate"] == 1.0 and res["mean_ep_length"] == 1.0
    assert res["mean_reward"] == -101.0


def test_perform_benchmark_schema():
    """The results schema of the JAX package, rates in [0, 1] summing to
    1, from the port's own reset."""
    core = trao.make_reach_ao_core("reachao1", device="cpu")
    hp = Hyperparameters("TQC")
    hp.policy_kwargs = dict(hp.policy_kwargs, net_arch=[16, 16])
    learner = make_learner("TQC", 62, 7, hp, "cpu")
    ts = [learner.init(torch.Generator().manual_seed(s)) for s in range(2)]
    keys = None
    for strategy in (None, "mean", "confidence", "weighted_aggregation",
                     "bayesian_fusion"):
        res = TB.perform_benchmark(learner, ts, core, n_episodes=3,
                                   horizon=2, strategy=strategy, seed=1)
        keys = keys or list(res)
        assert list(res) == keys
        rates = [res[k] for k in ("success_rate", "collision_rate",
                                  "timeout_rate")]
        assert all(0.0 <= r <= 1.0 for r in rates) and sum(rates) == 1.0
        assert res["scenario_episodes"] == 3
    assert keys == ["scenario_episodes", "success_rate", "collision_rate",
                    "timeout_rate", "mean_ep_length", "mean_num_sim_steps",
                    "mean_effort", "mean_jerk", "mean_manipulability",
                    "mean_ee_speed", "mean_reward"]
    for strategy in ("prior", "bcf"):
        with pytest.raises(NotImplementedError, match="item 12"):
            TB.perform_benchmark(learner, ts, core, strategy=strategy)
    with pytest.raises(ValueError):
        TB.perform_benchmark(learner, ts, core, strategy="nope")
    assert TB.BENCHMARK_SCENARIOS == JB.BENCHMARK_SCENARIOS


def test_results_writer_matches_jax_files(tmp_path):
    """The CSV and JSON written from the reference's benchmark.json equal,
    byte for byte, the files the JAX package wrote (with pandas)."""
    src = os.path.join(ASSET, "benchmark.json")
    with open(src) as f:
        results = json.load(f)
    rows = TB.display_and_save_benchmark_results(results,
                                                 str(tmp_path / "b"))
    assert len(rows) == 13 and rows[0][0] == "reachao1"
    ref = os.path.join(ROOT, "training", "run_data", "round5_campaign",
                       "routed_gen", "benchmark")
    for ext in (".csv", ".json"):
        assert (tmp_path / f"b{ext}").read_bytes() == open(
            ref + ext, "rb").read(), ext


# ---------------------------------------------------------- run loading

def test_load_run_matches_jax():
    """The committed run dir: the same TrainConfig (hyperparameters
    included); it keeps no .ckpt, so the port finds its actor export."""
    cfg, ckpts = load_run(R4_GEN)
    jcfg, jckpts = jload_run(R4_GEN)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "hyperparams":
            assert a.as_dict() == b.as_dict()
        else:
            assert a == b, f.name
    assert jckpts == [] and ckpts == [os.path.join(R4_GEN,
                                                   "best_model.policy.npz")]
    assert R4_GEN in get_run_dirs("round4_campaign",
                                  os.path.join(ROOT, "training", "run_data"))
    assert get_run_dirs("no_such_group", str(ROOT)) == []


# ----------------------------------------------------------- entry points

def test_eval_cli_routed(tmp_path, monkeypatch):
    """The routed policy through the eval CLI at --device cpu, split over
    two calls whose part files merge; without a card the default raises."""
    out = tmp_path / "rb"
    args = ["--routed", POLICY, "--episodes", "2", "--horizon", "3",
            "--out", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ecli.main(args + ["--scenarios", "reachao1"])
    ecli.main(args + ["--scenarios", "narrow_tunnel", "--device", "cpu"])
    res = ecli.main(args + ["--scenarios", "reachao1", "--device", "cpu"])
    assert list(res) == ["reachao1", "narrow_tunnel"]
    assert sorted(os.listdir(out / "benchmark_parts")) == [
        "narrow_tunnel.json", "reachao1.json"]
    saved = json.loads((out / "benchmark.json").read_text())
    assert saved == res and saved["reachao1"]["scenario_episodes"] == 2
    assert (out / "benchmark.csv").read_text().startswith(
        ",scenario_episodes,success_rate")


def test_eval_cli_runs(tmp_path):
    """Run dirs through the eval CLI: the committed actor-only export, and
    a run the training CLI wrote (a torch.save checkpoint), fused."""
    res = ecli.main([R4_GEN, "--scenarios", "reachao1", "--episodes", "2",
                     "--horizon", "2", "--device", "cpu", "--out",
                     str(tmp_path / "r4")])
    assert res["reachao1"]["scenario_episodes"] == 2
    assert (tmp_path / "r4.csv").exists() and (tmp_path / "r4.json").exists()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        tcli.main(["--stages", "reachao1", "--n-envs", "2",
                   "--max-ep-steps", "2", "--max-timesteps", "4",
                   "--learning-starts", "2", "--eval-freq", "4",
                   "--n-eval-episodes", "2", "--update-batch-size", "8",
                   "--benchmark-eval-scenes", "--name", "e", "--device",
                   "cpu"])
    finally:
        os.chdir(cwd)
    run = str(tmp_path / "training" / "run_data" / "default" / "e")
    assert load_run(run)[1][-1].endswith("best_model.ckpt")
    with pytest.raises(SystemExit, match="disagree"):
        ecli.main([run, R4_GEN, "--device", "cpu"])
    res = ecli.main([run, run, "--strategy", "bayesian_fusion",
                     "--scenarios", "wall", "--episodes", "2", "--horizon",
                     "2", "--device", "cpu"])
    assert res["wall"]["scenario_episodes"] == 2
    assert os.path.exists(os.path.join(run, "benchmark.json"))

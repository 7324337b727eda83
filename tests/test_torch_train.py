"""The port's trainer (panda_gym_tpu_torch/rl/train.py), its mixture core and
its entry point, on the CPU.

Against JAX: ``_rollout_episode`` of both packages from the same carried
JAX reset with the same fixed linear policy tanh(x @ M), on Reach (B = 4,
T = 5) and on reachao1 (B = 8, T = 4) with envs 0-1 forced into collision,
so that the freeze and the terminal flag run; the JAX rollout runs op by op
with ``jax.lax.scan`` as a Python loop (tests/test_torch_collision.py says
why).  Observations atol 5e-4 (tests/test_reach_ao.py:154-155), actions
and rewards atol 5e-4, aux rtol 1e-3 with atol 5e-4 (speeds, efforts and
jerks of hundreds of units after a collision), ep_len, terminated, success
and collided exact.  Also the mixture core against JAX's capacity.

The port alone: the schedule against hand-derived numbers, stage advance
and the final stage with a stubbed evaluate, kill-and-resume bit for bit,
save / load with and without the buffer, the prior bootstrap, the
NotImplementedError paths and the CLI (with its --benchmark and
--prior-steps); a few Trainer.learn steps on Push and the classic-task CLI.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.panda_tasks import make_core as jax_make_core
from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.rl import train as JT

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core, make_reach_core
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.eval import benchmark as EB
from panda_gym_tpu_torch.rl import classic_cli, cli, her
from panda_gym_tpu_torch.rl import learners as TL
from panda_gym_tpu_torch.rl import train as TT
from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
from panda_gym_tpu_torch.rl.logging_utils import RunLogger

ATOL_OBS = 5e-4


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


class _JaxLinear:
    def __init__(self, M):
        self.M = jnp.asarray(M)

    def act(self, ts, x, key, deterministic=False, expl=None):
        return jnp.tanh(x @ self.M)


class _PortLinear:
    def __init__(self, M):
        self.M = torch.as_tensor(M)

    def act(self, ts, x, noise=None, deterministic=False, expl=None):
        return torch.tanh(x @ self.M)


def _rollouts(jcore, tcore, B, T, monkeypatch, edit=None):
    jv, tv = JT.VectorEnv(jcore, B, T), TT.VectorEnv(tcore, B, T)
    assert (tv.obs_dim, tv.goal_dim, tv.x_dim) == (jv.obs_dim, jv.goal_dim,
                                                   jv.x_dim)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates, jobs = jax.jit(jax.vmap(jcore.reset))(keys)
    if edit is not None:
        jstates = edit(jstates, jobs)
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    tobs = {k: torch.tensor(np.asarray(v)) for k, v in jobs.items()}
    jv.batch_reset = lambda key: (jstates, jobs)
    tv.batch_reset = lambda generator: (tstates, tobs)
    M = np.random.default_rng(1).normal(0, 0.3, (jv.x_dim, 7)).astype(
        np.float32)
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)
    jep, jst, _ = jv._rollout_episode(_JaxLinear(M), None,
                                      jax.random.PRNGKey(1),
                                      deterministic=True)
    tep, tst, _, _ = tv._rollout_episode(_PortLinear(M), None,
                                         torch.Generator(),
                                         deterministic=True)
    assert sorted(tep) == sorted(jep) and sorted(tst) == sorted(jst)
    for k in ("obs", "achieved", "desired", "action"):
        assert tep[k].shape == jep[k].shape, k
        np.testing.assert_allclose(tep[k].numpy(), np.asarray(jep[k]),
                                   atol=ATOL_OBS, rtol=0, err_msg=k)
    np.testing.assert_allclose(tep["aux"].numpy(), np.asarray(jep["aux"]),
                               rtol=1e-3, atol=ATOL_OBS, err_msg="aux")
    for k in ("ep_len", "terminated"):
        np.testing.assert_array_equal(tep[k].numpy(), np.asarray(jep[k]),
                                      err_msg=k)
    for k in ("success", "collided", "ep_len"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tst["ep_reward"].numpy(),
                               np.asarray(jst["ep_reward"]), atol=ATOL_OBS,
                               rtol=0)
    return tep, tst


def test_rollout_matches_jax_on_reach(monkeypatch):
    tep, tst = _rollouts(jax_make_core("reach"), make_core("reach",
                                                           device="cpu"),
                         4, 5, monkeypatch)
    assert tep["obs"].shape == (4, 6, 6) and (tst["ep_len"] == 5).all()


def test_rollout_matches_jax_on_reachao_with_collisions(monkeypatch):
    def collide(jstates, jobs):
        opos = np.asarray(jstates.obstacle_pos).copy()
        opos[:2, 0] = np.asarray(jobs["achieved_goal"])[:2]
        return jstates.replace(obstacle_pos=jnp.asarray(opos))

    tep, tst = _rollouts(jrao.make_reach_ao_core("reachao1"),
                         trao.make_reach_ao_core("reachao1", device="cpu"),
                         8, 4, monkeypatch, edit=collide)
    # envs 0-1 collide on the first step: terminal there, then frozen with
    # reward 0; the others run on
    assert (tst["collided"][:2] == 1).all() and (tst["ep_len"][:2] == 1).all()
    assert tep["terminated"][:2, 0].all() and not tep["terminated"][:2, 1:].any()
    assert (tep["obs"][:2, 2:] == tep["obs"][:2, 1:2]).all()
    assert (tst["ep_len"][2:] > 1).any()


@pytest.mark.parametrize("n_envs,horizon,cfg_kw,want", [
    # the TQC preset at the trainer's two batches (THROUGHPUT_r05.json)
    (64, 20, {}, (15_000, 256, 160, 8, 20_000, 10_000)),
    (512, 50, {}, (6_000, 256, 3_200, 64, 131_072, 10_000)),
    # the smoke run's: learning starts at 3840 // 4
    (64, 20, dict(max_timesteps=3840, learning_starts=1280,
                  interleave_min_buffer=640),
     (15_000, 256, 160, 8, 640, 960)),
    # few envs: round(0.5) is 0 -> 1 update per step; capacity >= n_envs
    (4, 5, dict(update_batch_size=16, utd=0.1, learning_starts=10),
     (60_000, 16, 2, 1, 20_000, 10)),
    (8, 100, dict(utd=1.0), (3_000, 256, 800, 8, 20_000, 10_000)),
])
def test_schedule(n_envs, horizon, cfg_kw, want):
    cfg = TrainConfig(n_envs=n_envs, **cfg_kw)
    s = TT.schedule(cfg, horizon)
    assert (s.capacity, s.batch_size, s.updates_per_rollout,
            s.n_upd_per_step, s.interleave_min, s.learning_starts) == want
    small = TrainConfig(n_envs=4096)
    small.hyperparams.buffer_size = 1000
    assert TT.schedule(small, 50).capacity == 4096


def _small_cfg(**kw):
    cfg = TrainConfig(n_envs=4, stages=["s0"], success_thresholds=[2.0],
                      max_ep_steps=[5], ee_error_thresholds=[0.05],
                      max_timesteps=60, learning_starts=10, eval_freq=10_000,
                      full_ckpt_freq=20, interleave_min_buffer=20,
                      benchmark_eval_scenes=[], n_eval_episodes=4)
    for k, v in kw.items():
        setattr(cfg, k, v)
    hp = cfg.hyperparams
    hp.policy_kwargs = dict(log_std_init=-3, net_arch=[32, 32])
    hp.n_quantiles, hp.batch_size = 5, 16
    return cfg


def _reach(scene, thr, spd):
    return make_reach_core(reward_type="dense", device="cpu")


def _rows(tr):
    return [(r["timesteps"], r["rollout_reward"], r["rollout_success"])
            for r in tr.metrics.history if "rollout_reward" in r]


def test_kill_and_resume_reproduces_run(tmp_path):
    cfg = _small_cfg()
    tr_a = TT.Trainer(cfg, _reach, logger=RunLogger(root=str(tmp_path),
                                                    name="a"))
    tr_a.learn(seed=0)
    rows_a = _rows(tr_a)
    assert len(rows_a) == 3      # 3 rollouts of 20 steps, 2 of them fused
    assert sum("critic_loss" in r and r["t_update"] == 0.0
               for r in tr_a.metrics.history) == 2
    root = os.path.join(tr_a.logger.dir, "full_state")
    ckpts = sorted(os.listdir(root), key=lambda d: int(d.split("_")[1]))
    assert ckpts == ["ckpt_40", "ckpt_60"]   # rolling, keep=2
    tr_b = TT.Trainer(cfg, _reach, logger=RunLogger(root=str(tmp_path),
                                                    name="b"))
    tr_b.load_full(os.path.join(root, ckpts[0]))
    assert tr_b.timesteps == 40
    tr_b.learn(seed=0)
    rows_b = _rows(tr_b)
    assert rows_b == [r for r in rows_a if r[0] > 40]
    a, b = TL.named_state(tr_a.ts), TL.named_state(tr_b.ts)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tr_a.ts.step == tr_b.ts.step
    assert torch.equal(tr_a.generator.get_state(), tr_b.generator.get_state())


def test_load_full_rejects_mismatches(tmp_path):
    cfg = _small_cfg(max_timesteps=20)
    tr = TT.Trainer(cfg, _reach, logger=RunLogger(root=str(tmp_path)))
    tr.learn(seed=0)
    root = os.path.join(tr.logger.dir, "full_state")
    other = _small_cfg(algorithm="SAC")
    with pytest.raises(ValueError, match="algorithm"):
        TT.Trainer(other, _reach).load_full(root)
    wide = _small_cfg()
    wide.hyperparams.policy_kwargs = dict(log_std_init=-3, net_arch=[48, 48])
    tr_w = TT.Trainer(wide, _reach)
    tr_w.load_full(root)
    with pytest.raises(ValueError, match="resume learner: leaf"):
        tr_w.learn(seed=0)


def test_stage_advance_and_final_stage(tmp_path):
    cfg = _small_cfg(stages=["a", "b"], success_thresholds=[0.9, 1.0],
                     ee_error_thresholds=[0.05, 0.05], max_ep_steps=[2],
                     max_timesteps=16, learning_starts=4, eval_freq=8,
                     full_ckpt_freq=0, interleave_min_buffer=8,
                     benchmark_eval_scenes=["x"])
    tr = TT.Trainer(cfg, _reach, logger=RunLogger(root=str(tmp_path)))
    calls = []

    def evaluate(venv, generator, n_episodes=100):
        calls.append(venv)
        return 1.0
    tr.evaluate = evaluate
    tr.learn(seed=0)
    hist = tr.metrics.history
    # stage a: one collect rollout, one burst, one eval at 1.0 >= 0.9: done
    # stage b (final): the threshold does not end it; 2 rollouts (collect
    # then fused), each followed by the stage eval and the bench eval
    assert [r["scenario"] for r in hist if "rollout_reward" in r] == \
        ["a", "b", "b"]
    assert sum("eval_success" in r for r in hist) == 3
    assert sum("x_eval_success" in r for r in hist) == 2
    assert len(calls) == 5
    assert tr.timesteps == 24
    # updates: a 1 (collect + burst); b 1, then 2 env steps x 1 fused
    assert tr.ts.step == 4
    for f in ("best_model.ckpt", "best_model_x.ckpt", "model_a_0.ckpt",
              "model_b_1.ckpt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(tr.logger.dir, f)), f


def test_save_and_load(tmp_path):
    cfg = _small_cfg(max_timesteps=20, full_ckpt_freq=0)
    tr = TT.Trainer(cfg, _reach)
    tr.learn(seed=0)
    tr.save(str(tmp_path / "with.ckpt"), include_buffer=True)
    tr.save(str(tmp_path / "without.ckpt"))
    venv = TT.VectorEnv(_reach("s0", 0.05, 0.5), 4, 5)
    for name, restore, has_buf in (("with.ckpt", True, True),
                                   ("with.ckpt", False, False),
                                   ("without.ckpt", True, False)):
        tr2 = TT.Trainer(_small_cfg(), _reach)
        tr2.load(str(tmp_path / name), restore_buffer=restore)
        assert tr2.timesteps == tr.timesteps == 20
        assert (tr2.buffer is not None) == has_buf
        tr2.generator = torch.Generator().manual_seed(0)
        tr2._ensure_learner(venv, 100)
        for k, v in TL.named_state(tr.ts).items():
            assert torch.equal(TL.named_state(tr2.ts)[k], v), k
        assert tr2.ts.step == tr.ts.step
        if has_buf:
            for k in ("obs", "ep_len", "terminated"):
                assert torch.equal(getattr(tr2.buffer, k),
                                   getattr(tr.buffer, k))
            assert tr2.buffer.n_stored == tr.buffer.n_stored == 4
        else:
            assert tr2.buffer.n_stored == 0 and tr2.buffer.capacity == 100
    # a squashed-Gaussian checkpoint under a gSDE config: load aligns it
    cfg_sq = _small_cfg()
    cfg_sq.hyperparams.use_sde = False
    tr_sq = TT.Trainer(cfg_sq, _reach)
    tr_sq.generator = torch.Generator().manual_seed(0)
    tr_sq._ensure_learner(venv, 100)
    tr_sq.save(str(tmp_path / "sq.ckpt"))
    tr3 = TT.Trainer(_small_cfg(), _reach)
    assert tr3.config.hyperparams.use_sde
    tr3.load(str(tmp_path / "sq.ckpt"))
    assert not tr3.config.hyperparams.use_sde


def test_prior_bootstrap_fires_on_an_empty_buffer_only(tmp_path,
                                                     monkeypatch):
    """prior_steps > 0: ceil(prior_steps / (n_envs horizon)) NEO rollouts
    fill the empty buffer before the first collect (train.py:432-442); a
    full-state resume that restores a buffer skips it, a resume of the
    learner alone (no buffer) runs it again."""
    calls = []
    fill = TT.fill_buffer_with_prior

    def spy(venv, buf, generator, n_rollouts):
        calls.append((buf.n_stored, n_rollouts, len(tr.metrics.history)))
        return fill(venv, buf, generator, n_rollouts=n_rollouts)

    monkeypatch.setattr(TT, "fill_buffer_with_prior", spy)
    cfg = _small_cfg(prior_steps=30, max_timesteps=40)
    tr = TT.Trainer(cfg, _reach, logger=RunLogger(root=str(tmp_path),
                                                  name="p"))
    tr.learn(seed=0)
    # 30 / (4 envs x 5 steps) -> 2 rollouts, before any collect rollout
    assert calls == [(0, 2, 0)]
    assert tr.timesteps == 40          # the prior's steps are not counted
    assert tr.buffer.n_stored == 2 * 4 + 2 * 4
    assert tr.ts.step > 0
    full = os.path.join(tr.logger.dir, "full_state")
    tr.save(str(tmp_path / "learner.ckpt"))

    calls.clear()
    tr = TT.Trainer(cfg, _reach)
    tr.load_full(full)
    assert tr._resume["buffer"] is not None
    tr.learn(seed=0)
    assert calls == []

    tr = TT.Trainer(cfg, _reach)
    tr.load(str(tmp_path / "learner.ckpt"), restore_buffer=False)
    tr.learn(seed=0)
    assert calls == [(0, 2, 0)]


def test_mixture_core():
    names = ["reachao1", "reachao2", "wall"]
    jcore = jrao.make_reach_ao_core("+".join(names))
    tcore = trao.make_reach_ao_core("+".join(names), device="cpu")
    assert isinstance(tcore, trao._MixtureReachAOEnv)
    assert tcore.task.n_obstacles == jcore.task.n_obstacles
    assert [c.task.n_obstacles for c in tcore._cores] == \
        [jcore.task.n_obstacles] * 3
    B = 12
    states, obs = tcore.batched_reset(B, torch.Generator().manual_seed(7))
    sid = torch.randint(0, 3, (B,), generator=torch.Generator().manual_seed(7))
    assert len(set(sid.tolist())) == 3
    # each env reset by its own scene's task: its roster of active obstacles
    for i, c in enumerate(tcore._cores):
        want = torch.as_tensor(c.task._obstacles0[3])      # active mask
        for b in (sid == i).nonzero().flatten().tolist():
            assert torch.equal(states.obstacle_active[b], want), (i, b)
    assert obs["observation"].shape == (B, tcore._cores[0]._get_obs(
        states)["observation"].shape[-1])
    # the physics is the same for every scene
    a = torch.as_tensor(np.random.default_rng(2).uniform(
        -1, 1, (B, 7)).astype(np.float32))
    outs = [c.batched_step(states, a) for c in (tcore, tcore._cores[2])]
    for k in ("q", "qd", "link_obstacle_dist", "is_collided"):
        assert torch.equal(getattr(outs[0][0], k), getattr(outs[1][0], k)), k
    assert torch.equal(outs[0][2], outs[1][2])


def test_cli(tmp_path, monkeypatch):
    args = ["--stages", "reachao1", "--n-envs", "2", "--max-ep-steps", "2",
            "--max-timesteps", "4", "--learning-starts", "2",
            "--eval-freq", "4", "--n-eval-episodes", "2",
            "--update-batch-size", "8", "--net-arch", "32", "32",
            "--full-ckpt-freq", "4", "--benchmark-eval-scenes",
            "--name", "t"]
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
    tr = cli.main(args + ["--device", "cpu"])
    run = tmp_path / "training" / "run_data" / "default" / "t"
    for f in ("metrics.jsonl", "config.json", "final.ckpt",
              "final_model.ckpt", "best_model.ckpt", "model_reachao1_0.ckpt",
              "full_state/ckpt_4"):
        assert (run / f).exists(), f
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["hyperparams"]["policy_kwargs"]["net_arch"] == [32, 32]
    assert cfg["benchmark_eval_scenes"] == []
    assert tr.ts.step >= 1 and tr.buffer.device.type == "cpu"
    # --prior-steps: ceil(3 / (2 envs x 2 steps)) = 1 NEO rollout of 2
    # episodes is stored before the run's own
    tr_p = cli.main(args + ["--device", "cpu", "--name", "p",
                            "--prior-steps", "3"])
    assert tr_p.buffer.n_stored == tr.buffer.n_stored + 2
    assert json.loads((run.parent / "p" / "config.json").read_text())[
        "prior_steps"] == 3
    # --benchmark scores the best snapshot on the protocol's scenes (here
    # two of them, at a horizon of 2) into <run>/benchmark.json and .csv
    monkeypatch.setattr(EB, "BENCHMARK_SCENARIOS", ["reachao1", "wall"])
    monkeypatch.setattr(cli, "BENCHMARK_HORIZON", 2)
    cli.main(args + ["--device", "cpu", "--name", "b", "--benchmark",
                     "--benchmark-episodes", "2"])
    bench = json.loads((run.parent / "b" / "benchmark.json").read_text())
    assert list(bench) == ["reachao1", "wall"]
    assert all(r["scenario_episodes"] == 2 and r["mean_ep_length"] <= 2
               for r in bench.values())
    assert (run.parent / "b" / "benchmark.csv").exists()


def test_trainer_learns_push(tmp_path):
    """A classic task through make_env, as tools/train_classic.py runs it:
    Push at n_envs 2, horizon 3, no benchmark scenes; the object block in
    the observations, the goal-task reward from the HER batch, updates
    that ran, and the buffer on the env's device."""
    cfg = _small_cfg(n_envs=2, max_ep_steps=[3], max_timesteps=18,
                     learning_starts=6, interleave_min_buffer=6,
                     full_ckpt_freq=0, stages=["push"])
    tr = TT.Trainer(cfg, lambda task, thr, spd: make_core(task, device="cpu"))
    tr.learn()
    assert tr.timesteps == 18 and tr.ts.step >= 1
    assert tr.buffer.obs.shape[-1] == 18 and tr.buffer.aux.shape[-1] == 0
    assert tr.buffer.device.type == "cpu"
    rows = [r for r in tr.metrics.history if "rollout_reward" in r]
    assert all(-3.0 <= r["rollout_reward"] <= 0.0 for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))


@pytest.mark.parametrize("task,obs_dim,goal_dim", [("stack", 31, 6),
                                                   ("flip", 20, 4)])
def test_trainer_learns_gripper_goals(tmp_path, task, obs_dim, goal_dim):
    """Stack's 6-D goal (both cubes) and Flip's quaternion goal through the
    Trainer, HER and reward_from_aux: n_envs 2, horizon 3; the HER batch's
    rewards are the task's own on the relabelled goals."""
    cfg = _small_cfg(n_envs=2, max_ep_steps=[3], max_timesteps=12,
                     learning_starts=6, interleave_min_buffer=6,
                     full_ckpt_freq=0, stages=[task])
    tr = TT.Trainer(cfg, lambda t, thr, spd: make_core(t, device="cpu"))
    tr.learn()
    assert tr.timesteps == 12 and tr.ts.step >= 1
    assert tr.buffer.obs.shape[-1] == obs_dim
    assert tr.buffer.desired.shape[-1] == goal_dim
    assert tr.buffer.achieved.shape[-1] == goal_dim
    env = make_core(task, device="cpu")
    batch = her.sample(tr.buffer, torch.Generator().manual_seed(0), 64,
                       tr._reward_fn(env))
    d = batch["achieved_next"] - batch["goal"]
    assert d.shape == (64, goal_dim)
    want = env.task.reward_from_aux(env, batch["achieved_next"],
                                    batch["goal"], None)
    assert torch.equal(batch["reward"], want)
    assert (batch["reward"] == 0).any() and (batch["reward"] == -1).any()
    rows = [r for r in tr.metrics.history if "rollout_reward" in r]
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))


def test_tqc_preset_is_tqc_pickandplace():
    """chip_smoke.py's phase 12 trains PickAndPlace under the TQC preset as
    the committed tqc_pickandplace run's configuration (the chip machine's
    copy leaves training/ out): every hyperparameter of that run, and its
    n_envs and horizon."""
    path = os.path.join(os.path.dirname(__file__), "..", "training",
                        "run_data", "round2_classic", "tqc_pickandplace",
                        "config.json")
    with open(path) as f:
        run = json.load(f)
    hp = Hyperparameters("TQC")
    for k, v in run["hyperparams"].items():
        assert getattr(hp, k) == v, k
    assert (run["n_envs"], run["max_ep_steps"]) == (64, [50])
    assert run["stages"] == ["pickandplace"]


def test_classic_cli(tmp_path, monkeypatch):
    args = ["--task", "push", "--n-envs", "2", "--max-ep-steps", "2",
            "--max-timesteps", "4", "--learning-starts", "2",
            "--eval-freq", "4", "--n-eval-episodes", "2", "--name", "t"]
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            classic_cli.main(args)
    tr = classic_cli.main(args + ["--device", "cpu"])
    run = tmp_path / "training" / "run_data" / "classic" / "t"
    for f in ("metrics.jsonl", "config.json", "final.ckpt",
              "final_model.ckpt", "model_push_0.ckpt"):
        assert (run / f).exists(), f
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["stages"] == ["push"] and cfg["control_type"] == "js"
    assert cfg["benchmark_eval_scenes"] == []
    assert tr.timesteps == 4
    slide = classic_cli.main(["--task", "slide", "--n-envs", "2",
                              "--max-ep-steps", "2", "--max-timesteps", "2",
                              "--name", "s", "--device", "cpu"])
    assert slide.learner.act_dim == 3
    pnp = classic_cli.main(["--task", "pickandplace", "--n-envs", "2",
                            "--max-ep-steps", "2", "--max-timesteps", "2",
                            "--name", "p", "--device", "cpu"])
    assert pnp.learner.act_dim == 4 and pnp.buffer.obs.shape[-1] == 19
    cfg = json.loads((run.parent / "p" / "config.json").read_text())
    assert cfg["stages"] == ["pickandplace"] and cfg["control_type"] == "ee"
    # the reference's defaults (tools/train_classic.py:29-43)
    assert classic_cli.task_defaults("stack") == ("ee", 100)
    assert classic_cli.task_defaults("flip") == ("ee", 50)
    assert classic_cli.task_defaults("mycobotreach") == ("js", 50)
    # TD3 and DDPG train (the deterministic actor, no alpha)
    for algo in ("TD3", "DDPG"):
        tr = classic_cli.main(["--task", "reach", "--n-envs", "2",
                               "--max-ep-steps", "3", "--max-timesteps", "12",
                               "--learning-starts", "6", "--eval-freq", "12",
                               "--n-eval-episodes", "2", "--device", "cpu",
                               "--algorithm", algo, "--name", algo])
        assert type(tr.learner).__name__ == f"{algo}Learner"
        assert tr.timesteps == 12 and tr.ts.step >= 1
        assert (run.parent / algo / "final_model.ckpt").exists()
        rows = [r for r in tr.metrics.history if "critic_loss" in r]
        assert rows and "alpha" not in rows[-1]
        assert all(np.isfinite(r["critic_loss"]) for r in rows)
    # the off-policy Trainer rejects the on-policy PPO, as JAX's does
    with pytest.raises(ValueError, match="on-policy"):
        TT.Trainer(_small_cfg(algorithm="PPO"), _reach).learn()

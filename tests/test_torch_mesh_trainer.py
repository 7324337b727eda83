"""The port's env mesh (panda_gym_tpu_torch/parallel/mesh.py) under the
Trainer, against itself, on the CPU over gloo.

Processes start with torch.multiprocessing spawn
(``parallel/smoke.py::launch``), their rendezvous a file store in a
temporary directory, never a fixed port; each group has a 30 s collective
timeout and each launch a limit of 90 s.  Held: a one-rank mesh (a real
gloo group of one) gives the single-process Trainer bit for bit
(parameters, buffer, the rows but their host clocks, the full-state
checkpoint); a 2-rank Trainer.learn on test_parallel's SAC Reach config
(n_envs 16, 150 steps; net_arch [32, 32]) ends with bitwise-equal
parameters and equal rows on both ranks, finite rows and a buffer of
capacity / 2 per rank; a 2-rank full-state resume reproduces the
uninterrupted run, and a 1-rank resume of it raises; counts that do not
divide raise; initialize_multihost without arguments is a no-op; the
smoke module writes its record.

This module imports no JAX: the spawned ranks import it for its workers.
tests/test_torch_mesh.py holds the mesh against the JAX package's.
"""
import json
import os
import subprocess
import sys
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from panda_gym_tpu_torch.envs.panda_tasks import make_reach_core
from panda_gym_tpu_torch.parallel import mesh as M
from panda_gym_tpu_torch.parallel.smoke import launch
from panda_gym_tpu_torch.rl import her
from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
from panda_gym_tpu_torch.rl.learners import named_state
from panda_gym_tpu_torch.rl.logging_utils import RunLogger
from panda_gym_tpu_torch.rl.train import Trainer, VectorEnv

TIMEOUT_S = 90
COLLECTIVE_TIMEOUT = timedelta(seconds=30)
CLOCKS = ("sps", "t_collect", "t_update")


def start_rank(store, nproc, rank):
    """One CPU rank of a gloo group (the spawned ranks share the host)."""
    torch.set_num_threads(1)
    M.initialize_multihost(store, nproc, rank, device="cpu",
                           timeout=COLLECTIVE_TIMEOUT)
    return M.make_env_mesh()


def mesh_cfg():
    """tests/test_parallel.py's SAC Reach config at net_arch [32, 32],
    batch 32, the fused gate open after one rollout, an evaluation of 24
    episodes at 128 steps (not a multiple of n_envs: the global order's
    cut runs) and a full-state checkpoint every 64."""
    cfg = TrainConfig(
        algorithm="SAC", n_envs=16, stages=["reach"],
        success_thresholds=[2.0], ee_error_thresholds=[0.05],
        speed_thresholds=[0.5], max_ep_steps=[4], max_timesteps=150,
        learning_starts=30, eval_freq=128, n_eval_episodes=24,
        interleave_min_buffer=64, full_ckpt_freq=64,
        benchmark_eval_scenes=[])
    cfg.hyperparams = Hyperparameters("SAC")
    cfg.hyperparams.buffer_size = 2_000
    cfg.hyperparams.batch_size = 32
    cfg.hyperparams.policy_kwargs = dict(cfg.hyperparams.policy_kwargs,
                                         net_arch=[32, 32])
    return cfg


def reach_env(scene, thr, spd):
    return make_reach_core(device="cpu")


def _run(trainer):
    """What a run leaves: rows, every learner tensor, the buffer, the
    generator."""
    return dict(rows=trainer.metrics.history,
                state={k: v.detach().clone()
                       for k, v in named_state(trainer.ts).items()},
                step=trainer.ts.step, buffer=her.save_state(trainer.buffer),
                generator=trainer.generator.get_state(),
                timesteps=trainer.timesteps)


def one_rank_worker(rank, nproc, store, root):
    """The same run with a one-rank mesh and without one, cut to two
    rollouts (a collect and its burst, a fused one, the evaluation)."""
    mesh = start_rank(store, nproc, rank)
    cfg = mesh_cfg()
    cfg.max_timesteps = 128
    try:
        out = {"group": mesh.group is not None}
        for name, m in (("mesh", mesh), ("none", None)):
            tr = Trainer(cfg, reach_env,
                         logger=RunLogger(root=root, name=name), mesh=m)
            tr.learn(seed=0)
            tr.logger.close()
            out[name] = _run(tr)
        return out
    finally:
        M.shutdown()


def two_rank_worker(rank, nproc, store, root):
    """Run a, uninterrupted; run b, resumed from a's full state at 128."""
    mesh = start_rank(store, nproc, rank)
    try:
        logger = RunLogger(root=root, name="a") if rank == 0 else None
        a = Trainer(mesh_cfg(), reach_env, logger=logger, mesh=mesh)
        a.learn(seed=0)
        if logger is not None:
            logger.close()
        M.barrier(mesh)
        b = Trainer(mesh_cfg(), reach_env, mesh=mesh)
        b.load_full(os.path.join(root, "default", "a", "full_state",
                                 "ckpt_128"))
        b.learn(seed=0)
        return {"a": _run(a), "b": _run(b), "capacity": a.buffer.capacity,
                "rank": mesh.rank}
    finally:
        M.shutdown()


def learner_hp(algo, sde):
    """tests/test_torch_learners.py's small learner: net_arch [32, 32],
    5 quantiles."""
    hp = Hyperparameters(algo)
    hp.policy_kwargs = dict(log_std_init=-3, net_arch=[32, 32])
    hp.use_sde = sde
    hp.n_quantiles = 5
    return hp


def jax_parity_worker(rank, nproc, store, payload):
    """tests/test_torch_mesh.py's port side on this rank's block: the Reach
    step, the metric means, and each learner update on its half of the
    batch (the whole gSDE noise matrix, which every sample shares; half of
    a per-sample draw)."""
    from panda_gym_tpu_torch import convert
    from panda_gym_tpu_torch.rl import learners as TL
    from panda_gym_tpu_torch.rl.networks import to_flax

    mesh = start_rank(store, nproc, rank)
    try:
        core = make_reach_core(device="cpu")
        states = convert.env_state(payload["states"], "cpu")
        s, o, r, *_ = core.batched_step(
            M.shard_env_batch(states, mesh),
            M.shard_env_batch(torch.as_tensor(payload["actions"]), mesh))
        out = {"step": {"observation": o["observation"].numpy(),
                        "reward": r.numpy(), "q": s.q.numpy()},
               "mean": {k: v.numpy() for k, v in M.global_metric_mean(
                   {k: M.shard_env_batch(torch.as_tensor(v), mesh)
                    for k, v in payload["metrics"].items()}, mesh).items()},
               "updates": []}
        for case in payload["updates"]:
            x_dim, act_dim, n = case["dims"]
            tl = TL.make_learner(case["algo"], x_dim, act_dim,
                                 learner_hp(case["algo"], case["sde"]), "cpu")
            tl.mesh = mesh
            ts = TL.load_state(tl.init(torch.Generator().manual_seed(0)),
                               case["state"])
            lo, hi = M.env_sharding(mesh, n)
            batch = {k: torch.as_tensor(v[lo:hi])
                     for k, v in case["batch"].items()}
            noise = tuple(torch.as_tensor(z if case["sde"] else z[lo:hi])
                          for z in case["noise"])
            ts, m = tl.update(ts, batch, noise)
            out["updates"].append({
                "metrics": {k: float(v) for k, v in m.items()},
                "params": {k: to_flax(getattr(ts, k))
                           for k in ("actor", "critic", "target_critic")},
                "log_alpha": ts.log_alpha.item(), "step": ts.step})
        return out
    finally:
        M.shutdown()


def _no_clocks(rows):
    return [{k: v for k, v in r.items() if k not in CLOCKS} for r in rows]


def _assert_runs_equal(x, y):
    assert _no_clocks(x["rows"]) == _no_clocks(y["rows"])
    assert x["step"] == y["step"] and x["timesteps"] == y["timesteps"]
    for k in x["state"]:
        assert torch.equal(x["state"][k], y["state"][k]), k
    for k, v in x["buffer"]["tensors"].items():
        assert torch.equal(v, y["buffer"]["tensors"][k]), k
    assert torch.equal(x["generator"], y["generator"])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh2"))
    return launch(two_rank_worker, 2, (root,), TIMEOUT_S), root


def test_initialize_multihost_without_markers_is_a_noop(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.initialize_multihost() == 1
    assert M.initialize_multihost(num_processes=1) == 1
    assert not dist.is_initialized()
    mesh = M.make_env_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)


def test_counts_that_do_not_divide_raise():
    two = M.EnvMesh(0, 2, torch.device("cpu"))
    assert M.env_sharding(M.EnvMesh(1, 2, torch.device("cpu")), 16) == (8, 16)
    with pytest.raises(ValueError, match="n_envs=15 does not divide"):
        VectorEnv(make_reach_core(device="cpu"), 15, 4, two)
    cfg = mesh_cfg()
    cfg.hyperparams.batch_size = 33
    with pytest.raises(ValueError, match="batch_size=33 does not divide"):
        Trainer(cfg, reach_env, mesh=two).learn(seed=0)


def test_one_rank_mesh_is_the_single_process_trainer(tmp_path):
    out, = launch(one_rank_worker, 1, (str(tmp_path),), TIMEOUT_S)
    assert out["group"]          # a real group of one ran the collectives
    _assert_runs_equal(out["mesh"], out["none"])
    ckpts = {}
    for name in ("mesh", "none"):
        d = os.path.join(tmp_path, "default", name, "full_state")
        ckpts[name] = torch.load(os.path.join(d, sorted(os.listdir(d))[-1]),
                                 weights_only=True)
    assert ckpts["mesh"].keys() == ckpts["none"].keys()
    assert "world_size" not in ckpts["mesh"]
    for k, v in ckpts["mesh"]["ts"]["tensors"].items():
        assert torch.equal(v, ckpts["none"]["ts"]["tensors"][k]), k


def test_two_ranks_stay_in_step(two_ranks):
    (r0, r1), _ = two_ranks
    a0, a1 = r0["a"], r1["a"]
    rows = [r for r in a0["rows"] if "rollout_reward" in r]
    assert len(rows) == 3 and a0["timesteps"] == 192
    assert all(all(v == v and abs(v) < float("inf") for v in r.values()
                   if isinstance(v, float)) for r in a0["rows"])
    assert any("critic_loss" in r for r in rows)
    assert sum("eval_success" in r for r in a0["rows"]) == 1
    # every rank logs the same rows, host clocks included (ranks' means)
    assert a0["rows"] == a1["rows"]
    assert a0["step"] == a1["step"] > 0
    for k in a0["state"]:
        assert torch.equal(a0["state"][k], a1["state"][k]), k
    # different envs: the ranks' generators and shards differ
    assert not torch.equal(a0["buffer"]["tensors"]["desired"],
                           a1["buffer"]["tensors"]["desired"])


def test_two_rank_buffer_is_half_the_capacity(two_ranks):
    (r0, r1), _ = two_ranks
    capacity = 2_000 // 4     # buffer_size // horizon, global
    assert r0["capacity"] == r1["capacity"] == capacity // 2
    for r in (r0, r1):
        assert r["a"]["buffer"]["n_stored"] == 3 * 16 // 2


def test_two_rank_resume_reproduces_the_run(two_ranks):
    (r0, r1), _ = two_ranks
    for r in (r0, r1):
        a, b = r["a"], r["b"]
        assert b["rows"][0]["timesteps"] == 192
        assert _no_clocks(b["rows"]) == [
            x for x in _no_clocks(a["rows"]) if x["timesteps"] > 128
            and "rollout_reward" in x]
        b = dict(b, rows=a["rows"])
        _assert_runs_equal(a, b)


def test_two_rank_checkpoint_resumes_on_two_ranks_only(two_ranks):
    _, root = two_ranks
    ckpt = os.path.join(root, "default", "a", "full_state", "ckpt_128")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["world_size"] == 2 and len(payload["ranks"]) == 2
    with pytest.raises(ValueError, match="holds the state of 2 ranks; this "
                                         "run has 1"):
        Trainer(mesh_cfg(), reach_env).load_full(ckpt)
    # its learner alone loads into a single-process Trainer
    tr = Trainer(mesh_cfg(), reach_env)
    tr.load(ckpt)
    assert tr.timesteps == 128
    assert os.path.exists(os.path.join(root, "default", "a",
                                       "best_model.ckpt"))


def test_smoke_module_writes_its_record(tmp_path):
    out = tmp_path / "smoke.json"
    r = subprocess.run(
        [sys.executable, "-m", "panda_gym_tpu_torch.parallel.smoke",
         "--nproc", "2", "--device", "cpu", "--n-envs", "4", "--steps", "2",
         "--out", str(out), "--timeout", str(TIMEOUT_S - 10)],
        capture_output=True, text=True, timeout=TIMEOUT_S,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["processes"] == 2
    assert rec["transport"] == "gloo on the CPU"
    assert rec["max_errors"] == {"observation": 0.0, "reward": 0.0, "q": 0.0}
    assert 0.0 <= rec["collective_overhead_fraction"] < 1.0

"""The port's campaign tools end to end at toy size on the CPU:
eval/build_router.py (tools/build_router.py), rl/distill_cli.py
(tools/distill_generalist.py) and rl/continue_population.py
(tools/continue_population.py).

The pool is 2 tiny TQC members ([32, 32], the routed generalist's config
otherwise) written as best_model.policy.npz under a run-data root as the
CONTROLLERS table names them (reachao1's tqc_r4_gen and library2's
tqc_ft21_library2); episodes of 3 steps.  Held: the router file's table
and its load in the eval CLI and in the JAX package's reader; collect-only
parts and training from them give the same router as one run; the
distilled student's export loads in the eval CLI and in the JAX package's
policy reader, and a second run resumes every part; a continued population
starts from its members' checkpoints, optimizer state included.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from panda_gym_tpu.eval.router import load_routed_policy as jax_load_routed
from panda_gym_tpu.rl.policy_io import load_policy as jax_load_policy

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.eval import build_router, cli
from panda_gym_tpu_torch.rl import continue_population, distill_cli
from panda_gym_tpu_torch.rl import population_cli
from panda_gym_tpu_torch.rl.checkpoint import load_checkpoint, save_checkpoint
from panda_gym_tpu_torch.rl.learners import make_learner, save_state
from panda_gym_tpu_torch.rl.logging_utils import load_config, write_config
from panda_gym_tpu_torch.rl.policy_io import export_policy, load_policy

ASSET_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "panda_gym_tpu_torch", "assets",
    "routed_gen", "config.json")
SCENES = ["reachao1", "library2"]
TINY = ["--device", "cpu"]


def _tiny_config():
    cfg = load_config(ASSET_CONFIG)
    cfg.hyperparams.policy_kwargs = dict(cfg.hyperparams.policy_kwargs,
                                         net_arch=[32, 32])
    cfg.hyperparams.use_sde = False
    return cfg


@pytest.fixture(scope="module")
def pool_root(tmp_path_factory):
    """A run-data root with the two members of SCENES' controllers."""
    root = tmp_path_factory.mktemp("run_data")
    cfg = _tiny_config()
    for i, sc in enumerate(SCENES):
        run = root / build_router.CONTROLLERS[sc][0]
        run.mkdir(parents=True)
        learner = make_learner("TQC", 62, 7, cfg.hyperparams, "cpu")
        ts = learner.init(torch.Generator().manual_seed(i))
        ckpt = save_checkpoint(str(run / "m.ckpt"), {
            "ts": save_state(ts), "timesteps": 0, "algorithm": "TQC"})
        export_policy(ckpt, str(run / "best_model.policy"), config=cfg)
        os.remove(ckpt)
        write_config(str(run), cfg)
    return root


def _router_args(root, out, *extra):
    return ["--root", str(root), "--out", str(out), "--scenarios", *SCENES,
            "--collect-episodes", "4", "--collect-horizon", "3",
            "--steps", "20", *TINY, *extra]


@pytest.fixture(scope="module")
def routed(pool_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("routed_gen")
    build_router.main(_router_args(pool_root, out))
    return out


def test_build_router_writes_the_routed_policy(routed, pool_root):
    with np.load(routed / "routed_policy.npz") as z:
        meta = json.loads(str(z["__meta__"]))
        assert z["masks"].tolist() == [[1.0, 0.0], [0.0, 1.0]]
        assert z["members/params/Dense_0/kernel"].shape == (2, 62, 32)
    members = [str(pool_root / build_router.CONTROLLERS[sc][0])
               for sc in SCENES]
    assert meta["members"] == members
    assert meta["scene_to_controller"] == {sc: sc for sc in SCENES}
    assert meta["controllers"] == {sc: [m] for sc, m in zip(SCENES, members)}
    assert meta["x_dim"] == 62 and meta["use_sde"] is False
    assert os.path.exists(routed / "config.json")
    # the JAX package reads the port's file
    policy, jmeta = jax_load_routed(str(routed / "routed_policy.npz"))
    assert jmeta == meta and policy.masks.shape == (2, 2)


def test_routed_policy_loads_in_the_eval_cli(routed, tmp_path):
    res = cli.main(["--routed", str(routed / "routed_policy.npz"),
                    "--scenarios", "reachao1", "--episodes", "2",
                    "--horizon", "3", "--out", str(tmp_path), *TINY])
    assert res["reachao1"]["scenario_episodes"] == 2
    assert os.path.exists(tmp_path / "benchmark.json")


def test_collect_only_then_train_from_data_is_one_run(routed, pool_root,
                                                      tmp_path):
    build_router.main(_router_args(pool_root, tmp_path, "--collect-only"))
    assert sorted(os.listdir(tmp_path / "data")) == [
        f"collect_{sc}.npz" for sc in sorted(SCENES)]
    assert not os.path.exists(tmp_path / "routed_policy.npz")
    build_router.main(_router_args(pool_root, tmp_path, "--train-from-data"))
    with np.load(routed / "routed_policy.npz") as a, \
            np.load(tmp_path / "routed_policy.npz") as b:
        for k in a.files:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), k


def _distill_args(routed, out):
    return ["--router", str(routed / "routed_policy.npz"), "--out", str(out),
            "--scenarios", *SCENES, "--bc-episodes", "4",
            "--dagger-rounds", "1", "--dagger-episodes", "4",
            "--horizon", "3", "--steps", "20", "--net-arch", "32", "32",
            "--episodes", "2", "--bench-horizon", "3", *TINY]


@pytest.fixture(scope="module")
def distilled(routed, tmp_path_factory):
    out = tmp_path_factory.mktemp("distilled_gen")
    return out, distill_cli.main(_distill_args(routed, out))


def test_distill_exports_a_student_both_readers_load(distilled, tmp_path):
    out, (mean, tag) = distilled
    meta = json.loads((out / "distill_meta.json").read_text())
    assert meta["best_round"] == tag and meta["mean_success"] == mean
    assert sorted(json.loads((out / "benchmark.json").read_text())) == \
        sorted(SCENES)
    actor, pmeta = load_policy(str(out / "best_model.policy.npz"))
    assert pmeta["net_arch"] == [32, 32] and pmeta["algorithm"] == "TQC"
    assert actor["params/Dense_0/kernel"].shape == (62, 32)
    jactor, jmeta = jax_load_policy(str(out / "best_model.policy.npz"))
    jactor = convert.flatten(jactor)
    assert jmeta == pmeta and jactor.keys() == actor.keys()
    for k, v in actor.items():
        assert np.array_equal(jactor[k], v), k
    # the export alone, in a run directory of its own, in the eval CLI
    run = tmp_path / "student"
    run.mkdir()
    for f in ("best_model.policy.npz", "config.json"):
        shutil.copy(out / f, run / f)
    res = cli.main([str(run), "--scenarios", "reachao1", "--episodes", "2",
                    "--horizon", "3", *TINY])
    assert res["reachao1"]["scenario_episodes"] == 2


def test_distill_resumes_every_part(distilled, routed, capsys):
    out, (mean, tag) = distilled
    capsys.readouterr()
    assert distill_cli.main(_distill_args(routed, out)) == (mean, tag)
    printed = capsys.readouterr().out
    assert printed.count("(resumed)") == 2 * len(SCENES)
    assert "resumed student_bc" in printed
    assert "resumed student_dagger1" in printed


def test_continue_population_starts_from_the_members(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    src = population_cli.main([
        "--members", "2", "--stages", "reachao1", "--n-envs", "2",
        "--max-ep-steps", "3", "--max-timesteps", "12",
        "--learning-starts", "6", "--interleave-min-buffer", "1",
        "--buffer-size", "60", "--name", "src", *TINY])
    assert src.pop.step > 0
    src_dir = os.path.join("training", "run_data", "default", "src")
    pt = continue_population.main([
        "--src", src_dir, "--ckpt", "final", "--stage", "reachao1",
        "--steps", "6", "--learning-starts", "6", "--name", "next",
        "--group", "g", "--root", str(tmp_path / "runs"), *TINY])
    # one collect rollout and no update: the members are the loaded ones,
    # optimizer state and update count included
    assert pt.K == 2 and pt.pop.step == src.pop.step
    assert 0 < pt.timesteps <= 2 * 2 * 3
    for i in range(2):
        a = load_checkpoint(os.path.join(src_dir, f"final_m{i}.ckpt"))
        b = load_checkpoint(str(tmp_path / "runs" / "g" / "next" /
                                f"final_m{i}.ckpt"))
        assert a["ts"]["step"] == b["ts"]["step"]
        for k, v in a["ts"]["tensors"].items():
            assert torch.equal(v, b["ts"]["tensors"][k]), k

"""Port parity: hyperparameter sweeps (panda_gym_tpu_torch/rl/sweep.py)
against panda_gym_tpu/rl/sweep.py.

The samplers are exact: every method draws the same configurations from
the same seed.  run_sweep with the same fake trainer (a deterministic
score of the configuration, one trial raising) writes the same JSONL and
returns the same order, with the clock held still.  The ReachAO objective
builds the port's Trainer on the scenario and reads its steps to the
threshold from the evaluation history.
"""
import json
import math
import time

import pytest

from panda_gym_tpu.rl import sweep as JS

from panda_gym_tpu_torch.rl import sweep as TS
from panda_gym_tpu_torch.rl import train as TT


def test_space_is_the_reference_space():
    assert TS.DEFAULT_TQC_SPACE.keys() == JS.DEFAULT_TQC_SPACE.keys()
    for k, d in TS.DEFAULT_TQC_SPACE.items():
        assert type(d).__name__ == type(JS.DEFAULT_TQC_SPACE[k]).__name__
        assert vars(d) == vars(JS.DEFAULT_TQC_SPACE[k]), k


@pytest.mark.parametrize("method", ["halton", "random", "grid"])
def test_samples_equal_jax(method):
    for seed in (0, 7):
        want = JS.sample_configs(JS.DEFAULT_TQC_SPACE, 25, method, seed)
        got = TS.sample_configs(TS.DEFAULT_TQC_SPACE, 25, method, seed)
        assert got == want
    space = {"lr": TS.Uniform(1e-4, 1e-2, log=True), "n": TS.IntUniform(1, 3),
             "c": TS.Categorical(("a", "b"))}
    jspace = {"lr": JS.Uniform(1e-4, 1e-2, log=True), "n": JS.IntUniform(1, 3),
              "c": JS.Categorical(("a", "b"))}
    assert (TS.sample_configs(space, 9, method, 3)
            == JS.sample_configs(jspace, 9, method, 3))


def _fake(cfg, seed):
    if seed == 2:
        raise FloatingPointError("diverged")
    steps = cfg["batch_size"] * 100 + cfg["train_freq"]
    return {"global_step": steps if cfg["use_sde"] else float("nan"),
            "final_success": round(cfg["tau"] * 10, 6)}


def test_run_sweep_jsonl_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 100.0)
    out = {}
    for name, mod in (("jax", JS), ("port", TS)):
        path = str(tmp_path / f"{name}.jsonl")
        ranked = mod.run_sweep(_fake, n_trials=6, method="halton", seed=0,
                               out_path=path)
        out[name] = ([r["trial"] for r in ranked],
                     (tmp_path / f"{name}.jsonl").read_text())
    assert out["port"] == out["jax"]
    rows = [json.loads(line) for line in out["port"][1].splitlines()]
    assert len(rows) == 6 and "error" in rows[2]["metrics"]
    assert math.isinf(rows[2]["metrics"]["global_step"])


def test_objective_trains_the_scenario(monkeypatch):
    built = {}

    def learn(self, seed=None):
        built.update(cfg=self.config, seed=seed,
                     core=self.make_env(self.config.stages[0], 0.05, 0.5))
        self.metrics.log(dict(eval_success=0.5, timesteps=100))
        self.metrics.log(dict(eval_success=0.95, timesteps=300))
        self.metrics.log(dict(eval_success=0.97, timesteps=500))

    monkeypatch.setattr(TT.Trainer, "learn", learn)
    fn = TS.tqc_reach_ao_objective("wall", n_envs=2, max_steps=10,
                                   success_threshold=0.9, device="cpu")
    got = fn({"net_arch": (32, 32), "batch_size": 16, "use_sde": False,
              "n_substeps": 5, "collision_reward": -50}, 4)
    assert got == {"global_step": 300, "final_success": 0.97}
    cfg = built["cfg"]
    assert cfg.stages == ["wall"] and cfg.n_envs == 2 and built["seed"] == 4
    assert cfg.hyperparams.policy_kwargs["net_arch"] == [32, 32]
    assert (cfg.hyperparams.batch_size, cfg.hyperparams.use_sde) == (16, False)
    assert (cfg.n_substeps, cfg.collision_reward) == (5, -50.0)
    assert built["core"].device.type == "cpu"

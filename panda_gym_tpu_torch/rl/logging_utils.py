"""Metrics logging and run directories (port of
panda_gym_tpu/rl/logging_utils.py).

RunLogger writes JSONL always and TensorBoard when asked, under
training/run_data/<group>/<name>/, beside ``config.json``, the reference's
run-dir layout (load_model_utils.py:14-50).  W&B stays off: the port
prints the JAX class's notice for it and logs to JSONL only.
``get_run_dirs`` and ``load_run`` find runs and rebuild their config for
evaluation.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, is_dataclass
from typing import Dict, Optional


class RunLogger:
    def __init__(self, group: str = "default", name: Optional[str] = None,
                 config=None, root: str = "training/run_data",
                 use_wandb: bool = False, use_tensorboard: bool = False,
                 project: str = "panda-gym-tpu"):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.name = name or f"run_{stamp}"
        self.dir = os.path.join(root, group, self.name)
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        if config is not None:
            write_config(self.dir, config)
        if use_wandb:
            print("wandb unavailable (the port does not log to W&B); "
                  "logging to JSONL only")
        if use_tensorboard:
            # reference: SB3 writes TB events, W&B syncs them
            # (setup_training.py:122 tensorboard_log, :163 sync_tensorboard)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"tensorboard unavailable ({e}); logging to JSONL only")
            else:
                self._tb = SummaryWriter(os.path.join(self.dir, "tb"))

    def log(self, row: Dict):
        row = dict(row, _t=time.time())
        self._fh.write(json.dumps(row, default=float) + "\n")
        self._fh.flush()
        if self._tb is not None:
            step = int(row.get("global_step", row.get("step", 0)) or 0)
            for k, v in row.items():
                if k.startswith("_"):
                    continue
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass  # non-scalar fields stay JSONL-only

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def write_config(run_dir: str, config) -> str:
    """A TrainConfig as the run's ``config.json``, its hyperparams as a
    plain dict, so that eval can rebuild the exact learner
    (load_model_utils.py:43-50)."""
    cfg = asdict(config) if is_dataclass(config) else dict(config)
    hp = cfg.pop("hyperparams", None)
    if hp is not None and hasattr(hp, "as_dict"):
        cfg["hyperparams"] = hp.as_dict()
    elif isinstance(hp, dict):
        cfg["hyperparams"] = hp
    path = os.path.join(run_dir, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1, default=str)
    return path


def get_run_dirs(group: str, root: str = "training/run_data"):
    """All run dirs of a group, sorted (load_model_utils.py:14-24)."""
    base = os.path.join(root, group)
    if not os.path.isdir(base):
        return []
    return sorted(os.path.join(base, d) for d in os.listdir(base)
                  if os.path.isdir(os.path.join(base, d)))


def load_config(path: str):
    """A TrainConfig from a run's ``config.json``, with its Hyperparameters
    rebuilt (net_arch overrides included; a config from before they were
    written gets its algorithm's preset)."""
    from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig

    cfg = TrainConfig()
    with open(path) as f:
        raw = json.load(f)
    hp_raw = raw.pop("hyperparams", None)
    for k, v in raw.items():
        if hasattr(cfg, k):
            setattr(cfg, k, v)
    hp = Hyperparameters(cfg.algorithm)
    if isinstance(hp_raw, dict):
        for k, v in hp_raw.items():
            setattr(hp, k, v)
    cfg.hyperparams = hp
    return cfg


# actor-only exports (rl/policy_io.py) of a run whose full checkpoints
# are not kept, in the order tools/evaluate.py:75-95 looks for them
POLICY_EXPORTS = ("best_model.policy.npz", "final_model.policy.npz")


def load_run(run_dir: str):
    """Rebuild the TrainConfig and find the checkpoints of a run dir
    (load_model_utils.py:26-50).

    Returns (config, checkpoint_paths) with the preferred evaluation
    checkpoint last: the stage checkpoints (``*.ckpt``, torch.save files),
    then final.ckpt, then best_model.ckpt (what the reference's loader
    resolves); per-scene best_model_<scene>.ckpt files are left out.  A run
    with no .ckpt gives its actor-only export instead, when it has one.
    """
    from panda_gym_tpu_torch.rl.config import TrainConfig

    cfg_path = os.path.join(run_dir, "config.json")
    cfg = load_config(cfg_path) if os.path.exists(cfg_path) else TrainConfig()
    ckpts = sorted(
        os.path.join(run_dir, f) for f in os.listdir(run_dir)
        if f.endswith(".ckpt") and f != "final.ckpt"
        and not f.startswith("best_model"))
    for name in ("final.ckpt", "best_model.ckpt"):
        if os.path.exists(os.path.join(run_dir, name)):
            ckpts.append(os.path.join(run_dir, name))
    if not ckpts:
        ckpts = [os.path.join(run_dir, n) for n in POLICY_EXPORTS
                 if os.path.exists(os.path.join(run_dir, n))][:1]
    return cfg, ckpts

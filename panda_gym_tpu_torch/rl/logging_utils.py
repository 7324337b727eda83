"""Metrics logging: JSONL always, TensorBoard when asked (port of the
RunLogger of panda_gym_tpu/rl/logging_utils.py:17-80).

The default sink is a JSONL run file under
training/run_data/<group>/<name>/, beside ``config.json``, the reference's
run-dir layout (load_model_utils.py:14-50).  W&B stays off: the port
prints the JAX class's notice for it and logs to JSONL only.
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
            cfg = asdict(config) if is_dataclass(config) else dict(config)
            # hyperparams as a plain dict, so that eval can rebuild the exact
            # learner (load_model_utils.py:43-50)
            hp = cfg.pop("hyperparams", None)
            if hp is not None and hasattr(hp, "as_dict"):
                cfg["hyperparams"] = hp.as_dict()
            elif isinstance(hp, dict):
                cfg["hyperparams"] = hp
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(cfg, f, indent=1, default=str)
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

"""Checkpoint / resume: learner + replay buffer + generator state (port of
panda_gym_tpu/rl/checkpoint.py, with torch.save in place of orbax).

A payload is a dict of tensors moved to the CPU, host numbers, strings and
each generator's ``get_state()``; it is written with ``torch.save`` to one
file per checkpoint and read back with ``torch.load``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch


def save_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)   # a kill mid-write leaves the last one whole
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def restore_tensors(live: Mapping[str, torch.Tensor],
                    saved: Mapping[str, torch.Tensor], what: str):
    """Copy saved tensors into the live ones, in place, after checking each
    against its live twin (a template built from the current config), so
    that a buffer_size / n_envs / net_arch mismatch fails loudly."""
    if list(live) != list(saved):
        diff = sorted(set(live) ^ set(saved))[:6]
        raise ValueError(
            f"resume {what}: checkpoint has {len(saved)} leaves, "
            f"config-built template has {len(live)} (differing: {diff}): "
            f"config does not match the checkpointed run")
    for k, t in live.items():
        v = saved[k]
        if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
            raise ValueError(
                f"resume {what}: leaf {k} is {tuple(v.shape)}/{v.dtype} in "
                f"the checkpoint but {tuple(t.shape)}/{t.dtype} under the "
                f"current config (check buffer_size, n_envs, max_ep_steps, "
                f"net_arch)")
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(saved[k])


class CheckpointManager:
    """Rolling checkpoints ``<root>/ckpt_<step>``, the newest ``keep`` kept
    (model.save per stage equivalent, setup_training.py:299)."""

    def __init__(self, root: str, keep: int = 5):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        path = save_checkpoint(os.path.join(self.root, f"ckpt_{step}"),
                               payload)
        self._gc()
        return path

    def _steps(self):
        return sorted((int(d.split("_")[1]), d) for d in os.listdir(self.root)
                      if d.startswith("ckpt_") and d[5:].isdigit())

    def latest(self) -> Optional[str]:
        cands = self._steps()
        return os.path.join(self.root, cands[-1][1]) if cands else None

    def _gc(self):
        for _, d in self._steps()[:-self.keep]:
            os.remove(os.path.join(self.root, d))

"""Actor-only policy export and import, the ``.policy.npz`` format of
panda_gym_tpu/rl/policy_io.py.

A policy file holds the actor's parameters under their Flax names
(``actor/params/Dense_0/kernel``, kernels (in, out)) and a JSON metadata
record (algorithm, net_arch, use_sde) enough to rebuild a matching learner
and graft the actor onto a template TrainState.  Both packages read and
write the same file: reading needs numpy only.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from panda_gym_tpu_torch.rl.checkpoint import load_checkpoint
from panda_gym_tpu_torch.rl.networks import flax_params, load_flax

FORMAT = "panda_gym_tpu.policy.v1"


def export_policy(ckpt_path: str, out_path: str, config=None) -> str:
    """Write the actor of a checkpoint (Trainer.save) to <out_path>
    (.policy.npz).  ``config`` (TrainConfig) supplies the metadata needed
    to rebuild the learner."""
    payload = load_checkpoint(ckpt_path)
    tensors = payload["ts"]["tensors"]
    meta: Dict[str, Any] = {"format": FORMAT,
                            "timesteps": int(payload.get("timesteps", 0)),
                            "algorithm": payload.get("algorithm")}
    if config is not None:
        pk = getattr(config.hyperparams, "policy_kwargs", {}) or {}
        meta.update(algorithm=config.algorithm,
                    net_arch=list(pk.get("net_arch", []) or []),
                    log_std_init=pk.get("log_std_init", None))
    # the checkpoint's ACTUAL actor type
    meta["use_sde"] = "actor/log_std_sde" in tensors
    return write_policy(out_path, flax_params(
        {k[len("actor/"):]: v for k, v in tensors.items()
         if k.startswith("actor/")}), meta)


def write_policy(out_path: str, arrays: Dict[str, np.ndarray],
                 meta: Dict[str, Any]) -> str:
    """An actor's Flax-named arrays and its metadata as a .policy.npz."""
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(out_path, __meta__=json.dumps(meta),
                        **{f"actor/{k}": v for k, v in arrays.items()})
    return out_path


def load_policy(npz_path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Return (the actor's Flax-flattened params, ``"params/Dense_0/kernel"``
    -> array, and the metadata dict)."""
    with np.load(npz_path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k[len("actor/"):]: z[k] for k in z.files
                  if k.startswith("actor/")}
    return arrays, meta


def graft_actor(ts, actor_params: Dict[str, np.ndarray]):
    """Template TrainState + exported actor -> evaluatable TrainState, in
    place.  Validates the names and shapes so that a net_arch / obs-dim
    mismatch fails loudly."""
    load_flax(ts.actor, actor_params)
    return ts

"""Carry model and state across from the JAX package.

This path has no learned weights: what crosses over is the model tables
and the env state.  Both arrive as numpy arrays (read off the JAX side with
``np.asarray``), so this module imports nothing of JAX:

    model = chain_model({k: getattr(jax_model, k) for k in ARRAY_FIELDS + STATIC_FIELDS})
    state = env_state({k: np.asarray(getattr(jax_states, k)) for k in FIELDS}, device)

Then both sides compute from the same model and the same state.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from panda_gym_tpu_torch.models.chain import (ARRAY_FIELDS, STATIC_FIELDS,
                                              ChainModel)
from panda_gym_tpu_torch.sim.state import FIELDS, EnvState

__all__ = ["ARRAY_FIELDS", "STATIC_FIELDS", "FIELDS", "chain_model",
           "env_state", "env_state_to_numpy"]

_INT_FIELDS = ("steps", "action_count", "obstacle_type")
_BOOL_FIELDS = ("is_collided", "goal_reached", "obstacle_active")


def chain_model(fields: Mapping[str, Any]) -> ChainModel:
    """A ChainModel from its array fields (numpy) and static fields."""
    kw = {}
    for k in ARRAY_FIELDS:
        a = np.asarray(fields[k])
        kw[k] = a.astype(np.int32 if a.dtype.kind in "iu" else np.float32)
    for k in STATIC_FIELDS:
        v = fields[k]
        kw[k] = tuple(v) if isinstance(v, (tuple, list)) else int(v)
    return ChainModel(**kw)


def env_state(arrays: Mapping[str, np.ndarray], device="cuda") -> EnvState:
    """A batched EnvState from numpy arrays with the batch leading.  Keys the
    port does not hold (the JAX PRNG ``key``, the free-body fields) are
    ignored; every field of the port's EnvState must be present."""
    kw: Dict[str, torch.Tensor] = {}
    for k in FIELDS:
        a = np.asarray(arrays[k])
        if k in _INT_FIELDS:
            a = a.astype(np.int32)
        elif k in _BOOL_FIELDS:
            a = a.astype(bool)
        else:
            a = a.astype(np.float32)
        kw[k] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return EnvState(**kw)


def env_state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """The inverse of ``env_state``: a dict of numpy arrays."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}

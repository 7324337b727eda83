"""Carry model and state across from the JAX package.

What crosses over: the model tables, the env state, a learner's TrainState
(Flax parameter trees and optax Adam states), a HER buffer and a routed
policy.  All arrive
as numpy arrays (read off the JAX side with ``np.asarray``), so this module
imports nothing of JAX:

    model = chain_model({k: getattr(jax_model, k) for k in ARRAY_FIELDS + STATIC_FIELDS})
    state = env_state({k: np.asarray(getattr(jax_states, k)) for k in FIELDS}, device)
    ts = learner_state(learner, actor, critic, target, (mu, nu, count), ...)
    buf = her_buffer({k: np.asarray(getattr(jax_buf, k)) for k in BUFFER_FIELDS}, device)
    policy = routed_policy(jax_policy.members, jax_policy.masks, jax_policy.router_params, device)

Then both sides compute from the same model, state, parameters and data.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from panda_gym_tpu_torch.eval.router import RoutedPolicy, build_routed_policy
from panda_gym_tpu_torch.models.chain import (ARRAY_FIELDS, STATIC_FIELDS,
                                              ChainModel)
from panda_gym_tpu_torch.rl import her
from panda_gym_tpu_torch.rl.learners import TrainState
from panda_gym_tpu_torch.rl.networks import from_flax, load_flax
from panda_gym_tpu_torch.sim.state import FIELDS, EnvState

__all__ = ["ARRAY_FIELDS", "STATIC_FIELDS", "FIELDS", "BUFFER_FIELDS",
           "chain_model", "env_state", "env_state_to_numpy", "flatten",
           "learner_state", "her_buffer", "routed_policy"]

BUFFER_FIELDS = her.TENSORS + ("write_idx", "n_stored")

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


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays (a Flax param tree) as {"a/b/c": array}."""
    if not isinstance(tree, Mapping):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def learner_state(learner, actor, critic, target, actor_opt, critic_opt,
                  log_alpha, alpha_opt, step: int = 0) -> TrainState:
    """The port's TrainState from a JAX one (rl/learners.py::TrainState):
    ``actor``, ``critic`` and ``target`` are Flax parameter trees and each
    ``*_opt`` an optax Adam state as (mu, nu, count), all numpy; the
    alpha optimizer's mu and nu are scalars.  ``learner`` (the port's
    make_learner) builds the template on its device."""
    ts = learner.init(torch.Generator(device=learner.device).manual_seed(0))
    dev = learner.device
    for module, tree in ((ts.actor, actor), (ts.critic, critic),
                         (ts.target_critic, target)):
        load_flax(module, flatten(tree))
    with torch.no_grad():
        for opt, module, (mu, nu, count) in (
                (ts.actor_opt, ts.actor, actor_opt),
                (ts.critic_opt, ts.critic, critic_opt)):
            mu, nu = from_flax(module, flatten(mu)), from_flax(module,
                                                               flatten(nu))
            for name, p in module.named_parameters():
                st = opt.state[p]
                st["exp_avg"].copy_(torch.tensor(mu[name]))
                st["exp_avg_sq"].copy_(torch.tensor(nu[name]))
                st["step"].fill_(float(count))
        mu, nu, count = alpha_opt
        st = ts.alpha_opt.state[ts.log_alpha]
        st["exp_avg"].fill_(float(mu))
        st["exp_avg_sq"].fill_(float(nu))
        st["step"].fill_(float(count))
        ts.log_alpha.copy_(torch.as_tensor(float(log_alpha), device=dev))
    ts.step = int(step)
    return ts


def her_buffer(arrays: Mapping[str, Any], device="cuda") -> her.HerBuffer:
    """The port's HerBuffer from a JAX one (rl/her.py::HerBuffer): its
    fields as numpy arrays, the counters as numbers."""
    dtypes = dict(ep_len=torch.int32, terminated=torch.bool)
    return her.HerBuffer(
        **{k: torch.tensor(np.asarray(arrays[k]),
                           dtype=dtypes.get(k, torch.float32), device=device)
           for k in her.TENSORS},
        write_idx=int(arrays["write_idx"]), n_stored=int(arrays["n_stored"]))


def routed_policy(members, masks, router_params, device="cuda") -> RoutedPolicy:
    """The port's RoutedPolicy from a JAX one (eval/router.py::RoutedPolicy):
    the stacked members' and the router's Flax parameter trees and the
    masks, all numpy, on ``device``."""
    return build_routed_policy(flatten(members), np.asarray(masks),
                               flatten(router_params), device)

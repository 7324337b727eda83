"""Carry model and state across from the JAX package.

What crosses over: the model tables, the env state, a learner's TrainState
(Flax parameter trees and optax Adam states; SAC, TQC, TD3, DDPG), a PPO
state, a population's stacked TrainState (the leaves of
``jax.vmap(learner.init)``), a HER buffer, a population's stacked HER
buffer and a routed policy.  All arrive
as numpy arrays (read off the JAX side with ``np.asarray``), so this module
imports nothing of JAX:

    model = chain_model({k: getattr(jax_model, k) for k in ARRAY_FIELDS + STATIC_FIELDS})
    state = env_state({k: np.asarray(getattr(jax_states, k)) for k in FIELDS}, device)
    ts = learner_state(learner, actor, critic, target, (mu, nu, count), ...)
    ps = ppo_state(ppo_learner, actor, value, (mu, nu, count), (mu, nu, count))
    pop = population_state(stacked_learner, <the same, each leaf (K, ...)>)
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
           "learner_state", "ppo_state", "population_state", "her_buffer",
           "stacked_her_buffer", "routed_policy"]

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
    """A batched EnvState from numpy arrays with the batch leading.  The key
    the port does not hold (the JAX PRNG ``key``) is ignored; every field of
    the port's EnvState must be present."""
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
    _load_adam(ts.actor_opt, ts.actor, actor_opt)
    _load_adam(ts.critic_opt, ts.critic, critic_opt)
    with torch.no_grad():
        mu, nu, count = alpha_opt
        st = ts.alpha_opt.state[ts.log_alpha]
        st["exp_avg"].fill_(float(mu))
        st["exp_avg_sq"].fill_(float(nu))
        st["step"].fill_(float(count))
        ts.log_alpha.copy_(torch.as_tensor(float(log_alpha), device=dev))
    ts.step = int(step)
    return ts


def _load_adam(opt, module, state):
    """An optax Adam state (mu, nu, count) into the torch Adam of
    ``module``'s parameters."""
    mu, nu, count = state
    mu, nu = from_flax(module, flatten(mu)), from_flax(module, flatten(nu))
    with torch.no_grad():
        for name, p in module.named_parameters():
            st = opt.state[p]
            st["exp_avg"].copy_(torch.tensor(mu[name]))
            st["exp_avg_sq"].copy_(torch.tensor(nu[name]))
            st["step"].fill_(float(count))


def ppo_state(learner, actor, value, actor_opt, value_opt, step: int = 0):
    """The port's PPOState from a JAX one (rl/ppo.py::PPOState): Flax
    parameter trees and, for each, the Adam state of its
    clip_by_global_norm + adam chain as (mu, nu, count), all numpy."""
    ts = learner.init(torch.Generator(device=learner.device).manual_seed(0))
    load_flax(ts.actor, flatten(actor))
    load_flax(ts.value, flatten(value))
    _load_adam(ts.actor_opt, ts.actor, actor_opt)
    _load_adam(ts.value_opt, ts.value, value_opt)
    ts.step = int(step)
    return ts


def _member(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _member(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_member(v, i) for v in tree)
    return np.asarray(tree)[i]


def population_state(stacked, actor, critic, target, actor_opt, critic_opt,
                     log_alpha, alpha_opt, step):
    """The port's PopState (rl/population.py) from a JAX population's
    stacked TrainState: the arguments of ``learner_state`` with a leading
    member axis on every leaf, Adam counts and ``step`` included.
    ``stacked`` is the port's StackedLearner."""
    K = np.asarray(log_alpha).shape[0]
    return stacked.stack([learner_state(
        stacked.learner, *(_member(t, i) for t in (
            actor, critic, target, actor_opt, critic_opt)),
        float(np.asarray(log_alpha)[i]), _member(alpha_opt, i),
        int(np.asarray(step)[i])) for i in range(K)])


def her_buffer(arrays: Mapping[str, Any], device="cuda") -> her.HerBuffer:
    """The port's HerBuffer from a JAX one (rl/her.py::HerBuffer): its
    fields as numpy arrays, the counters as numbers."""
    dtypes = dict(ep_len=torch.int32, terminated=torch.bool)
    return her.HerBuffer(
        **{k: torch.tensor(np.asarray(arrays[k]),
                           dtype=dtypes.get(k, torch.float32), device=device)
           for k in her.TENSORS},
        write_idx=int(arrays["write_idx"]), n_stored=int(arrays["n_stored"]))


def stacked_her_buffer(arrays: Mapping[str, Any], device="cuda"
                       ) -> her.StackedHerBuffer:
    """The port's StackedHerBuffer from a JAX population's buffer (a
    HerBuffer with a leading member axis): every field (K, ...), the
    counters (K,), equal across members."""
    dtypes = dict(ep_len=torch.int32, terminated=torch.bool)
    return her.StackedHerBuffer(
        **{k: torch.tensor(np.asarray(arrays[k]),
                           dtype=dtypes.get(k, torch.float32), device=device)
           for k in her.TENSORS},
        write_idx=int(np.asarray(arrays["write_idx"]).flat[0]),
        n_stored=int(np.asarray(arrays["n_stored"]).flat[0]))


def routed_policy(members, masks, router_params, device="cuda") -> RoutedPolicy:
    """The port's RoutedPolicy from a JAX one (eval/router.py::RoutedPolicy):
    the stacked members' and the router's Flax parameter trees and the
    masks, all numpy, on ``device``."""
    return build_routed_policy(flatten(members), np.asarray(masks),
                               flatten(router_params), device)

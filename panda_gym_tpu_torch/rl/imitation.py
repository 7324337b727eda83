"""Prior / pretrained-model replay-buffer bootstrap (port of
panda_gym_tpu/rl/imitation.py).

Replaces training/learning_methods/imitation_learning.py:
fill_replay_buffer_with_prior (:6-56, rolls the NEO QP controller) and
fill_replay_buffer_with_init_model (:58-106, rolls a pretrained policy),
vectorized: whole episode batches are rolled on the env's device through
VectorEnv and written into the HER buffer.
"""
from __future__ import annotations

import torch

from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.ops.neo import compute_action_neo
from panda_gym_tpu_torch.rl import her


def neo_policy_fn(core, scale: float = 0.5):
    """The NEO prior as a batched action policy, clip(scale * NEO, -1, 1)
    (imitation_learning.py:23): policy(x, states, generator) -> (B, 7)."""
    model = core.model
    ee_site = core.robot.ee_site

    def policy(x, states, generator):
        fk = K.fk_world(model, states.q)
        qd = compute_action_neo(model, ee_site, states, fk, states.goal)
        return torch.clamp(qd * scale, -1.0, 1.0)

    return policy


def fill_buffer_with_prior(venv, buffer, generator, n_rollouts: int = 4):
    """Roll the NEO prior, ``neo_policy_fn(venv.core)``, for n_rollouts
    episode batches into the buffer.  Returns (buffer, the last rollout's
    stats)."""
    policy = neo_policy_fn(venv.core)
    stats = None
    for _ in range(n_rollouts):
        episodes, stats = venv.rollout_episode(None, None, generator,
                                               policy_fn=policy)
        buffer = her.add_episodes(buffer, **episodes)
    return buffer, stats


def fill_buffer_with_model(venv, buffer, learner, ts, generator,
                           n_rollouts: int = 4):
    """Roll a pretrained policy, stochastically, into the buffer
    (fill_replay_buffer_with_init_model).  Returns (buffer, the last
    rollout's stats)."""
    stats = None
    for _ in range(n_rollouts):
        episodes, stats = venv.rollout_episode(learner, ts, generator)
        buffer = her.add_episodes(buffer, **episodes)
    return buffer, stats

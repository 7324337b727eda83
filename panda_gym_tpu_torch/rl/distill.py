"""Distill the per-scene expert controllers into ONE scene-blind network
(port of panda_gym_tpu/rl/distill.py).

Behavioural cloning from expert rollouts, then DAgger on the student's own
state distribution.  The teachers are masked precision-weighted fusions
over a member pool (eval/router.py); the student is one actor of the
campaign's architecture, so the result exports as a standard .policy.npz
and evaluates as ONE network.  Collection is the batched deterministic
rollout of the evaluation (N episodes in lockstep, one batched_step per env
step); training is minibatch MSE regression with Adam.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from panda_gym_tpu_torch.eval.router import (MemberStack,
                                             masked_bayesian_fusion,
                                             member_mean_std)
from panda_gym_tpu_torch.rl.learners import adam
from panda_gym_tpu_torch.rl.train import _keep, flat_x, keep_states


def draw_normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The drive noise's standard-normal draw of one step."""
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def collect_labeled(core, members: MemberStack, mask, n_episodes: int,
                    horizon: int, generator: torch.Generator,
                    student: Optional[nn.Module] = None,
                    drive_noise: float = 0.0):
    """Roll a policy on ``core`` and label every visited state with the
    TEACHER's action, the masked fusion of ``members`` (distill.py:38-107).

    student None  -> the teacher drives (a behavioural-cloning round);
    student given -> the STUDENT (an actor module) drives and the teacher
    only labels (DAgger).  drive_noise > 0 adds Gaussian noise to the
    DRIVING action only (DART-style injection); the labels stay the
    noiseless teacher's.  An env is frozen after it is done.

    Returns (X, A_teacher, active): (T, B, x_dim), (T, B, act_dim), (T, B).
    """
    states, obs = core.batched_reset(n_episodes, generator)
    done = torch.zeros(n_episodes, dtype=torch.bool, device=core.device)
    xs, labels, active = [], [], []
    for _ in range(horizon):
        x = flat_x(obs)
        a_t = masked_bayesian_fusion(*member_mean_std(members, x), mask)
        a_drive = a_t if student is None else torch.tanh(student(x)[0])
        if drive_noise > 0.0:
            a_drive = torch.clamp(a_drive + drive_noise * draw_normal(
                generator, a_drive.shape, a_drive.device), -1.0, 1.0)
        nstates, nobs, _r, term, trunc, _info = core.batched_step(states,
                                                                  a_drive)
        states = keep_states(done, states, nstates)
        obs = {k: _keep(done, obs[k], nobs[k]) for k in nobs}
        xs.append(x)
        labels.append(a_t)
        active.append(~done)
        done = done | term | trunc
    return torch.stack(xs), torch.stack(labels), torch.stack(active)


def bc_train(actor: nn.Module, X, A, *, steps: int = 4000,
             batch_size: int = 4096, lr: float = 3e-4, seed: int = 0,
             weights: Optional[np.ndarray] = None,
             log: Callable = print) -> Tuple[nn.Module, float]:
    """Minibatch MSE regression of tanh(student_mean(x)) onto the teacher's
    actions, in place on ``actor`` (distill.py:110-144).  X (N, x_dim) and
    A (N, act_dim) are tensors on the actor's device; each step's indices
    come from np.random.default_rng(seed).choice, the stream the JAX
    package draws.  Returns (actor, final loss)."""
    params = list(actor.parameters())
    opt = adam(params, lr)
    rng = np.random.default_rng(seed)
    p = None
    if weights is not None:
        p = np.asarray(weights, np.float64)
        p = p / p.sum()
    t0 = time.time()
    loss = None
    for step in range(steps):
        idx = torch.as_tensor(rng.choice(len(X), size=min(batch_size, len(X)),
                                         p=p), device=X.device)
        loss = torch.mean((torch.tanh(actor(X[idx])[0]) - A[idx]) ** 2)
        # a head the loss does not read (the squashed actor's log_std) gets
        # a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        for q, g in zip(params, grads):
            q.grad = g
        opt.step()
        # the loss is read back to the host rarely: each read waits for
        # the card
        if (step + 1) % 2000 == 0:
            log(f"bc step {step + 1}: loss {loss.item():.5f} "
                f"({time.time() - t0:.0f}s)")
    return actor, loss.item()


def init_student(learner, generator: torch.Generator) -> nn.Module:
    """A fresh student actor with the learner's (the campaign's) graph."""
    return learner.init(generator).actor


def student_as_trainstate(learner, student: nn.Module,
                          generator: Optional[torch.Generator] = None):
    """The distilled actor in a full TrainState (fresh critics and
    optimizers), to seed RL fine-tuning or be saved as the Trainer's
    checkpoint."""
    ts = learner.init(generator if generator is not None else
                      torch.Generator(device=learner.device).manual_seed(0))
    with torch.no_grad():
        for p, q in zip(ts.actor.parameters(), student.parameters()):
            p.copy_(q)
    return ts

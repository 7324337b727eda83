"""Ensemble action-fusion strategies (port of panda_gym_tpu/eval/ensemble.py:
evaluation/ensemble_utils/action_selection.py and the prior fusion of
evaluate.py:33-40).

Members lead every input: means and variances are (K, B, A).
"""
from __future__ import annotations

import torch


def bayesian_fusion(agent_means, agent_variances, sample=None):
    """Precision-weighted fusion (action_selection.py:4-27).  With
    ``sample`` a torch.Generator, or a pre-drawn standard normal of the
    fused mean's shape, the result is a draw from the fused Gaussian."""
    precisions = 1.0 / (agent_variances + 1e-8)
    fused_precision = torch.sum(precisions, 0)
    fused_mean = torch.sum(agent_means * precisions, 0) / fused_precision
    if sample is None:
        return fused_mean
    if isinstance(sample, torch.Generator):
        sample = torch.randn(fused_mean.shape, generator=sample,
                             device=sample.device)
    return fused_mean + torch.sqrt(1.0 / fused_precision) * sample


def weighted_aggregation(agent_variances, agent_means):
    """Inverse-variance weighted average (action_selection.py:29-35)."""
    weights = 1.0 / (agent_variances + 1e-8)
    weights = weights / torch.sum(weights, 0, keepdim=True)
    return torch.sum(agent_means * weights, 0)


def mean(agent_means):
    """action_selection.py:38-39."""
    return torch.mean(agent_means, 0)


def confidence(agent_means, agent_variances):
    """The member with the lowest variance, summed over the action dim
    (action_selection.py:42-44): (action (B, A), member index (B,))."""
    idx = torch.argmin(torch.sum(agent_variances, -1), 0)
    act = torch.take_along_dim(agent_means, idx[None, :, None], 0)[0]
    return act, idx


def fuse_controllers(prior_mu, prior_sigma, policy_mu, policy_sigma):
    """Multiplicative Gaussian fusion of a prior controller with the policy
    (evaluate.py:33-40, BCF-style): (mu, sigma)."""
    var_pi = torch.square(torch.as_tensor(policy_sigma))
    var_pr = torch.square(torch.as_tensor(prior_sigma))
    mu = (var_pi * prior_mu + var_pr * policy_mu) / (var_pi + var_pr)
    sigma = torch.sqrt((var_pr * var_pi) / (var_pi + var_pr))
    return mu, sigma

"""Policy and critic networks of the off-policy learners (port of
panda_gym_tpu/rl/networks.py).

Dict observations are flattened in the key order of SB3's CombinedExtractor.
Layers are initialised as Flax initialises ``nn.Dense``: kernels
lecun-normal (a normal truncated at two standard deviations, scaled to a
variance of 1/fan_in), biases zero, so that a fresh network draws from the
same distribution as the JAX package's.  The actors keep their layers in
Flax's order (``dense[i]`` is ``Dense_i``), and the critic ensemble keeps
Flax's ``nn.vmap`` layout, kernels (n_critics, in, out), so parameters cross
between the packages by name (``to_flax`` / ``load_flax``).

Every sampler takes its standard-normal draws as an argument (``eps``,
``W``, ``expl``); the learners draw them from an explicit
``torch.Generator``, and the tests hand both packages the same draws.
DeterministicActor and GaussianPolicy (TD3/DDPG, PPO) wait for ROADMAP item
15.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
# flax.linen.initializers.lecun_normal: the std of a unit normal truncated
# at +-2 is 0.8796...; dividing by it restores the variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def flatten_obs(obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Concat dict obs in SB3 CombinedExtractor key order (sorted)."""
    return torch.cat([obs[k] for k in ("achieved_goal", "desired_goal",
                                       "observation")], -1)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _dense(n_in: int, n_out: int, generator, device,
           bias: float = 0.0) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, device=device)
    lecun_normal_(layer.weight, n_in, generator)
    with torch.no_grad():
        layer.bias.fill_(bias)
    return layer


class _DenseStack(nn.Module):
    """``dense[i]`` is Flax's ``Dense_i``: the hidden layers, then heads."""

    def _build(self, in_dim, hidden, heads, generator, device):
        sizes = [in_dim, *hidden]
        layers = [_dense(a, b, generator, device)
                  for a, b in zip(sizes[:-1], sizes[1:])]
        layers += [_dense(sizes[-1], n, generator, device, bias)
                   for n, bias in heads]
        self.n_hidden = len(hidden)
        self.dense = nn.ModuleList(layers)

    def latent(self, x):
        for layer in self.dense[:self.n_hidden]:
            x = F.relu(layer(x))
        return x


class SquashedGaussianActor(_DenseStack):
    """tanh-Normal actor (SAC/TQC policy head)."""

    def __init__(self, in_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 log_std_init: float = -3.0, generator=None, device="cuda"):
        super().__init__()
        self._build(in_dim, hidden, [(action_dim, 0.0),
                                     (action_dim, log_std_init)],
                    generator, device)

    def forward(self, x):
        x = self.latent(x)
        mean = self.dense[-2](x)
        log_std = torch.clamp(self.dense[-1](x), LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std


class SDEGaussianActor(_DenseStack):
    """tanh-squashed actor with generalized State-Dependent Exploration
    (networks.py:76-109): the pre-tanh action is
    ``mean(s) + latent(s) @ (W * exp(log_std))`` with ``W`` drawn once per
    episode, and ``log_std_sde`` a (latent_dim, action_dim) parameter."""

    def __init__(self, in_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 log_std_init: float = -3.0, generator=None, device="cuda"):
        super().__init__()
        self._build(in_dim, hidden, [(action_dim, 0.0)], generator, device)
        self.log_std_sde = nn.Parameter(torch.full(
            (hidden[-1], action_dim), float(log_std_init), device=device))

    def forward(self, x):
        latent = self.latent(x)
        return (self.dense[-1](latent), latent,
                torch.clamp(self.log_std_sde, LOG_STD_MIN, LOG_STD_MAX))


class QCritic(nn.Module):
    """Ensemble of n_critics Q(s, a) MLPs applied as one batched product:
    ``kernel[i]`` is (n_critics, in, out), Flax's ``nn.vmap`` layout
    (networks.py:155-174); the output is (n_critics, batch, out_dim)."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 256),
                 out_dim: int = 1, n_critics: int = 2, generator=None,
                 device="cuda"):
        super().__init__()
        sizes = [in_dim, *hidden, out_dim]
        self.kernel = nn.ParameterList()
        self.bias = nn.ParameterList()
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = torch.empty(n_critics, a, b, device=device)
            self.kernel.append(nn.Parameter(lecun_normal_(w, a, generator)))
            self.bias.append(nn.Parameter(torch.zeros(n_critics, b,
                                                      device=device)))

    def forward(self, obs, act):
        x = torch.cat([obs, act], -1)
        x = x.expand(self.kernel[0].shape[0], *x.shape)    # (C, B, in)
        n = len(self.kernel)
        for i, (w, b) in enumerate(zip(self.kernel, self.bias)):
            x = torch.baddbmm(b[:, None], x, w)
            if i < n - 1:
                x = F.relu(x)
        return x


def sample_squashed(mean, log_std, eps):
    """tanh-squashed action and its log-probability; eps ~ N(0, 1) of
    mean's shape."""
    pre = mean + torch.exp(log_std) * eps
    logp = torch.sum(-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi)),
                     -1)
    logp = logp - torch.sum(
        2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre)), -1)
    return torch.tanh(pre), logp


def deterministic_action(mean):
    return torch.tanh(mean)


def sde_std(latent, log_std):
    """Analytic marginal std of latent @ (W * exp(log_std)), W ~ N(0, 1):
    sqrt(latent^2 @ sigma^2).  (B, L) x (L, A) -> (B, A)."""
    return torch.sqrt(torch.square(latent) @ torch.exp(2.0 * log_std) + 1e-6)


def sample_sde_squashed(mean, latent, log_std, W):
    """tanh-squashed gSDE action and log-probability with ONE exploration
    matrix W ~ N(0, 1) of shape (L, A) for the whole batch."""
    pre = mean + latent @ (W * torch.exp(log_std))
    std = sde_std(latent, log_std)
    logp = torch.sum(-0.5 * ((pre - mean) / std) ** 2 - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), -1)
    logp = logp - torch.sum(
        2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre)), -1)
    return torch.tanh(pre), logp


def sde_action_from_expl(mean, latent, log_std, expl):
    """Per-env episode-persistent gSDE action: expl is (B, L, A) standard
    normal, drawn once per episode."""
    noise = torch.einsum("bl,bla->ba", latent,
                         expl * torch.exp(log_std)[None])
    return torch.tanh(mean + noise)


# --------------------------------------------------------------------------
# parameters by Flax name
# --------------------------------------------------------------------------

def _flax_name(name: str) -> str:
    """The port's parameter name -> Flax's flattened name."""
    kind, *rest = name.split(".")
    if kind == "dense":                 # actors: dense.i.weight|bias
        i, leaf = rest
        return f"params/Dense_{i}/" + ("kernel" if leaf == "weight" else "bias")
    if kind in ("kernel", "bias"):      # critic ensemble: kernel.i, bias.i
        return f"params/VmapMLP_0/Dense_{rest[0]}/{kind}"
    return f"params/{name}"             # log_std_sde


def _to_flax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    # torch Linear (out, in) -> Flax Dense (in, out)
    return a.T.copy() if name.endswith(".weight") else a


def flax_params(named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Parameters by the port's names as Flax's flattened param dict of
    numpy arrays ("params/Dense_0/kernel": (in, out), ...)."""
    return {_flax_name(n): _to_flax_layout(n, p) for n, p in named.items()}


def to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    return flax_params(dict(module.named_parameters()))


def from_flax(module: nn.Module, flat: Mapping[str, np.ndarray]
              ) -> Dict[str, np.ndarray]:
    """A Flax flattened param dict (or one of its Adam moments) as arrays in
    the layout of ``module``'s parameters, by the port's names; the names
    and shapes must match (ValueError names the first that does not)."""
    ours = dict(module.named_parameters())
    by_flax = {_flax_name(n): n for n in ours}
    if set(by_flax) != set(flat):
        raise ValueError("param tree mismatch: "
                         f"{sorted(set(by_flax) ^ set(flat))[:6]}")
    out = {}
    for fname, name in by_flax.items():
        want = _to_flax_layout(name, ours[name]).shape
        a = np.asarray(flat[fname], np.float32)
        if a.shape != want:
            raise ValueError(
                f"leaf {fname}: given {a.shape} vs template {want} "
                f"(net_arch / obs-dim mismatch)")
        # Flax Dense (in, out) -> torch Linear (out, in)
        out[name] = np.ascontiguousarray(a.T if name.endswith(".weight")
                                         else a)
    return out


def load_flax(module: nn.Module, flat: Mapping[str, np.ndarray]):
    """Copy a Flax flattened param dict into ``module`` in place."""
    arrays = from_flax(module, flat)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.tensor(arrays[name]))
    return module

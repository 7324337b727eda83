"""Scene-blind routed generalist: route, don't average (port of
panda_gym_tpu/eval/router.py).

A routed policy is three parts:

  * member pool: K actors of one graph, held as stacked parameters and run
    as one batched product per layer (``MemberStack``, the layout of the
    critic ensemble in rl/networks.py);
  * controller table: C binary masks over the pool; a controller is the
    precision-weighted fusion of its masked members;
  * router: a small MLP x -> C logits (``RouterMLP``).

Per step the router's argmax picks a controller from the flat observation
x alone, and that controller's masked fusion acts.  ``RoutedLearner`` gives
it the act / act_with_std interface, so eval/benchmark.py drives it like
any learner.  Parameters keep Flax's names (``Dense_i``; members stacked on
a leading axis), so the ``panda_gym_tpu.routed_policy.v1`` file of the JAX
package loads here and the port's files load there.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panda_gym_tpu_torch.rl.networks import (LOG_STD_MAX, LOG_STD_MIN,
                                             _DenseStack, load_flax, sde_std,
                                             to_flax)

FORMAT = "panda_gym_tpu.routed_policy.v1"


class RouterMLP(_DenseStack):
    """Obs -> controller logits; ``dense[i]`` is Flax's ``Dense_i``."""

    def __init__(self, in_dim: int, n_controllers: int,
                 hidden: Sequence[int] = (128, 128), generator=None,
                 device="cuda"):
        super().__init__()
        self._build(in_dim, hidden, [(n_controllers, 0.0)], generator, device)

    def forward(self, x):
        return self.dense[-1](self.latent(x))


class MemberStack(nn.Module):
    """K actors of one graph with their parameters stacked on a leading
    axis: ``kernel[i]`` (K, in, out) and ``bias[i]`` (K, out) are Flax's
    ``Dense_i``, and ``log_std_sde`` (K, latent, act) is there for gSDE
    actors.  The legacy squashed-Gaussian actor has two heads (mean,
    log_std) after its hidden layers, the gSDE actor one (mean)."""

    def __init__(self, flat: Mapping[str, np.ndarray], device="cuda"):
        super().__init__()
        n = len([k for k in flat if k.endswith("/kernel")])
        self.kernel = nn.ParameterList()
        self.bias = nn.ParameterList()
        for i in range(n):
            for store, leaf in ((self.kernel, "kernel"), (self.bias, "bias")):
                store.append(nn.Parameter(torch.tensor(
                    np.asarray(flat[f"params/Dense_{i}/{leaf}"], np.float32),
                    device=device), requires_grad=False))
        self.sde = "params/log_std_sde" in flat
        if self.sde:
            self.log_std_sde = nn.Parameter(torch.tensor(
                np.asarray(flat["params/log_std_sde"], np.float32),
                device=device), requires_grad=False)
        self.n_hidden = n - (1 if self.sde else 2)

    def __len__(self):
        return self.kernel[0].shape[0]

    def flax_params(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, (w, b) in enumerate(zip(self.kernel, self.bias)):
            out[f"params/Dense_{i}/kernel"] = w.detach().cpu().numpy()
            out[f"params/Dense_{i}/bias"] = b.detach().cpu().numpy()
        if self.sde:
            out["params/log_std_sde"] = self.log_std_sde.detach().cpu().numpy()
        return out

    def _dense(self, i, h):
        return torch.baddbmm(self.bias[i][:, None], h, self.kernel[i])

    def forward(self, x):
        """(K, B, A) deterministic means and marginal stds of every member
        for flat observations x (B, in)."""
        h = x.expand(len(self), *x.shape)
        for i in range(self.n_hidden):
            h = F.relu(self._dense(i, h))
        mean = torch.tanh(self._dense(self.n_hidden, h))
        if self.sde:
            log_std = torch.clamp(self.log_std_sde, LOG_STD_MIN, LOG_STD_MAX)
            return mean, sde_std(h, log_std)
        log_std = torch.clamp(self._dense(self.n_hidden + 1, h),
                              LOG_STD_MIN, LOG_STD_MAX)
        return mean, torch.exp(log_std)


class RoutedPolicy(NamedTuple):
    """The routed generalist: members (MemberStack), masks (C, K) float32
    controller membership, router (RouterMLP)."""

    members: MemberStack
    masks: torch.Tensor
    router: RouterMLP


def stack_members(actors: List[nn.Module]) -> MemberStack:
    """K actors of one architecture (rl/networks.py) as one MemberStack on
    their device."""
    flats = [to_flax(a) for a in actors]
    device = next(actors[0].parameters()).device
    return MemberStack({k: np.stack([f[k] for f in flats]) for k in flats[0]},
                       device)


def member_mean_std(members: MemberStack, x):
    """(K, B, A) deterministic means and marginal stds of every member."""
    return members(x)


def masked_bayesian_fusion(means, stds, mask):
    """Precision-weighted fusion over the masked member subset.

    means/stds: (K, B, A); mask: (B, K) or (K,) in {0, 1}.  With an
    all-ones mask this is eval/ensemble.py::bayesian_fusion (deterministic
    branch)."""
    w = mask[:, None, None] if mask.dim() == 1 else mask.T[:, :, None]
    prec = w / (stds ** 2 + 1e-8)
    total = torch.sum(prec, 0)
    return torch.sum(means * prec, 0) / torch.clamp_min(total, 1e-12)


@torch.no_grad()
def routed_action(policy: RoutedPolicy, x, return_choice: bool = False):
    """Scene-blind routed action for flat observations x (B, in): the
    argmax of the router's logits picks a controller mask, and the masked
    fusion of the pool acts."""
    means, stds = member_mean_std(policy.members, x)
    choice = torch.argmax(policy.router(x), -1)
    act = masked_bayesian_fusion(means, stds, policy.masks[choice])
    if return_choice:
        return act, choice
    return act


class RoutedLearner:
    """Drives a RoutedPolicy through the learner interface:
    perform_benchmark(RoutedLearner(), [policy], core) calls
    act_with_std(policy, x)."""

    def act(self, ts: RoutedPolicy, x, noise=None, deterministic=True,
            expl=None):
        return routed_action(ts, x)

    def act_with_std(self, ts: RoutedPolicy, x):
        act = routed_action(ts, x)
        # the routed action is deterministic; a tiny std keeps the fusion
        # formulas downstream well-conditioned (benchmark's fallback)
        return act, torch.full_like(act, 1e-3)


def build_routed_policy(members: Mapping[str, np.ndarray], masks,
                        router: Mapping[str, np.ndarray],
                        device="cuda") -> RoutedPolicy:
    """A RoutedPolicy from Flax-flattened numpy leaves: the stacked
    members' ("params/Dense_0/kernel": (K, in, out), ...) and the
    router's (in, out), with masks (C, K)."""
    masks = torch.tensor(np.asarray(masks, np.float32), device=device)
    n_dense = len([k for k in router if k.endswith("/kernel")])
    in_dim = np.shape(router["params/Dense_0/kernel"])[0]
    hidden = [np.shape(router[f"params/Dense_{i}/kernel"])[1]
              for i in range(n_dense - 1)]
    r = RouterMLP(in_dim, masks.shape[0], hidden, device=device)
    load_flax(r, router)
    return RoutedPolicy(MemberStack(members, device), masks,
                        r.requires_grad_(False))


# --------------------------------------------------------------------------
# persistence: one .npz file, the JAX package's format
# --------------------------------------------------------------------------


def save_routed_policy(path: str, policy: RoutedPolicy, meta: Dict) -> str:
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = {f"members/{k}": v
              for k, v in policy.members.flax_params().items()}
    arrays.update({f"router/{k}": v for k, v in to_flax(policy.router).items()})
    arrays["masks"] = policy.masks.detach().cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path


def load_routed_policy(path: str, device="cuda"):
    """(RoutedPolicy on ``device``, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        members = {k[len("members/"):]: z[k] for k in z.files
                   if k.startswith("members/")}
        router = {k[len("router/"):]: z[k] for k in z.files
                  if k.startswith("router/")}
        masks = z["masks"]
    return build_routed_policy(members, masks, router, device), meta

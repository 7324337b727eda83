"""Env-batch data parallelism over torch.distributed (port of
panda_gym_tpu/parallel/mesh.py).

The JAX mesh is one program that XLA partitions over the devices of an
("env",) axis.  Every path of the port is host-bound (eager launches), so
one process driving W cards would queue W times the launches from one host
thread.  Here the mesh is one process per card ("rank"):

  * each rank steps its contiguous block of the env batch (the global env
    order is rank-major) and holds its shard of the replay;
  * the learner is replicated: broadcast from rank 0 once, then its
    gradients are all-reduced and averaged before every optimizer step;
  * every decision the host takes from data is taken on all-reduced values,
    so that the ranks run the same number of collectives.

Collectives on device tensors are ``broadcast``, ``all_reduce`` and
``barrier`` only: gloo runs those on CUDA tensors too, so two ranks may
share one card over gloo (NCCL refuses two ranks on one GPU).  The
checkpoint gather goes through CPU tensors on a gloo group.  A mesh
without a process group is the one-rank mesh, and every collective is the
identity; a one-rank group runs them, and each is exact at W = 1.

    W = initialize_multihost()          # torchrun's WORLD_SIZE / MASTER_ADDR
    mesh = make_env_mesh()
    Trainer(cfg, make_env, mesh=mesh).learn()
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from panda_gym_tpu_torch.envs.core import resolve_device

# a rank that diverges fails after this long instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=300)

# the device initialize_multihost bound this process to: the process group
# it starts is process-wide state, and so is this
_device: Optional[torch.device] = None


@dataclass(frozen=True)
class EnvMesh:
    """One rank's view of the env mesh: its rank, the world size, the
    device its envs, replay and learner live on, the process group (None:
    the one-rank mesh) and a gloo group for CPU tensors."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    cpu_group: Any = None


def _launcher_detected() -> bool:
    """True under a launcher that starts more than one process: torchrun's
    WORLD_SIZE > 1 with MASTER_ADDR (the JAX package reads TPU markers)."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return world > 1 and bool(os.environ.get("MASTER_ADDR"))


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda`` (the default) is cuda:LOCAL_RANK and
    raises without a card; ``cpu`` and ``cuda:N`` are taken as given."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank >= torch.cuda.device_count():
            raise ValueError(
                f"local rank {local_rank} has no card: "
                f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local_rank)
    return dev


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device=None, backend: Optional[str] = None,
                         timeout: timedelta = DEFAULT_TIMEOUT) -> int:
    """Start the process group of a multi-process mesh; a no-op for one
    process.  Returns the world size.

    With ``num_processes == 1`` and no address, or with no arguments and no
    launcher markers, it returns 1 and starts no group.  Otherwise the rank
    and world size come from the arguments or from torchrun's RANK and
    WORLD_SIZE, and the rendezvous from ``coordinator_address`` (``host:
    port``, or any init method such as ``file:///path``; default torchrun's
    ``env://``); an address with ``num_processes == 1`` starts a one-rank
    group, which runs every collective of the mesh path.  ``device`` is
    ``cuda`` by default: the card is cuda:LOCAL_RANK, set before the group
    starts, and there is none on a machine without a card.  The backend is
    NCCL on a card and gloo on the CPU; ``backend="gloo"`` on a card lets
    several ranks share one.
    """
    if num_processes == 1 and coordinator_address is None:
        return 1
    explicit = any(v is not None for v in (coordinator_address,
                                           num_processes, process_id))
    if not explicit and not _launcher_detected():
        return 1  # one process: leave torch.distributed untouched
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    world = (num_processes if num_processes is not None
             else int(os.environ["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and (dev.type != "cuda"
                              or not dist.is_nccl_available()):
        raise RuntimeError(f"NCCL needs a card and a torch built with it "
                           f"(device {dev}, NCCL available: "
                           f"{dist.is_nccl_available()})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    global _device
    _device = dev
    return dist.get_world_size()


def shutdown():
    """End the process group initialize_multihost started, if any."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def make_env_mesh(n_devices: Optional[int] = None, device=None) -> EnvMesh:
    """This rank's EnvMesh over every rank of the process group, or the
    one-rank mesh on ``device`` (default ``cuda``) when there is none.
    With a group every rank must call it: it makes the CPU group."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"n_devices={n_devices} without a process "
                             f"group: call initialize_multihost first")
        return EnvMesh(0, 1, resolve_device(device or "cuda"))
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"has {world} ranks: the mesh spans all of them")
    if device is not None:
        dev = resolve_device(device)
    elif _device is not None:
        dev = _device
    elif dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    group = dist.group.WORLD
    cpu_group = (group if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo"))
    return EnvMesh(dist.get_rank(), world, dev, group, cpu_group)


# ---------------------------------------------------------------- sharding


def split_count(n: int, mesh: Optional[EnvMesh], what: str = "count") -> int:
    """A global count's per-rank share; raises where it does not divide
    (JAX's NamedSharding refuses an axis that does not tile)."""
    if mesh is None:
        return n
    if n % mesh.world_size:
        raise ValueError(f"{what}={n} does not divide over "
                         f"{mesh.world_size} ranks")
    return n // mesh.world_size


def env_sharding(mesh: EnvMesh, n: int) -> Tuple[int, int]:
    """(start, stop) of this rank's block of a global env axis of n."""
    k = split_count(n, mesh, "n_envs")
    return mesh.rank * k, (mesh.rank + 1) * k


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    _tree_map(lambda t: out.append(t) or t, tree)
    return out


def shard_env_batch(tree, mesh: EnvMesh):
    """This rank's block of a batched tree (an EnvState, a dict of
    observations, a tensor) on the rank's device: every tensor with a
    leading env axis is cut to the block, a scalar is kept whole."""
    def place(x):
        if x.dim() == 0:
            return x.to(mesh.device)
        start, stop = env_sharding(mesh, x.shape[0])
        return x[start:stop].to(mesh.device)

    return _tree_map(place, tree)


# ------------------------------------------------------------- collectives


def replicate(tensors_or_module, mesh: Optional[EnvMesh]):
    """Rank 0's values broadcast into every rank's tensors, in place: a
    module's parameters and buffers, or the tensors of a tree."""
    if mesh is None or mesh.group is None:
        return tensors_or_module
    obj = tensors_or_module
    tensors = (list(obj.parameters()) + list(obj.buffers())
               if isinstance(obj, torch.nn.Module) else _leaves(obj))
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(mesh.device) for t in ts])
            dist.broadcast(flat, src=0, group=mesh.group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))
    return obj


def all_sum(values: Sequence[float], mesh: Optional[EnvMesh]) -> List[float]:
    """Host numbers summed over the ranks (float64: exact for counts up to
    2**53, and the identity at W = 1)."""
    if mesh is None or mesh.group is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return t.tolist()


def all_mean(values: Sequence[float], mesh: Optional[EnvMesh]) -> List[float]:
    """Host numbers averaged over the ranks."""
    w = 1 if mesh is None else mesh.world_size
    return [v / w for v in all_sum(values, mesh)]


def mean_gradients(grads: Sequence[torch.Tensor], mesh: Optional[EnvMesh]):
    """Gradients all-reduced and averaged over the ranks, in one collective:
    over equal per-rank batches the mean of the ranks' gradients of a mean
    loss is the gradient of the global batch.  Every rank gets the same
    bits, so replicated parameters stay equal."""
    if mesh is None or mesh.group is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    if mesh.world_size > 1:
        flat /= mesh.world_size
    return [v.view_as(g) for g, v in zip(grads, flat.split(
        [g.numel() for g in grads]))]


def global_metric_mean(tree, mesh: Optional[EnvMesh]):
    """Mean of per-env metric tensors over the whole env axis, on every
    rank: each leaf's local mean over axis 0 times its count, and the
    counts, summed over the ranks in one all_reduce.  At W = 1 it is the
    leaf's mean(0) bit for bit (a float32 mean times an integer count is
    exact in float64, and so is the division back)."""
    def local_mean(x):
        return (x if x.is_floating_point() else x.float()).mean(0)

    if mesh is None or mesh.group is None:
        return _tree_map(local_mean, tree)
    leaves = _leaves(tree)
    means = [local_mean(x) if x.shape[0] else
             torch.zeros(x.shape[1:], device=x.device) for x in leaves]
    counts = torch.tensor([float(x.shape[0]) for x in leaves],
                          dtype=torch.float64)
    vec = torch.cat([(m.double() * x.shape[0]).reshape(-1).to(mesh.device)
                     for m, x in zip(means, leaves)]
                    + [counts.to(mesh.device)])
    dist.all_reduce(vec, group=mesh.group)
    sums = vec[:-len(leaves)].split([m.numel() for m in means])
    out = iter([(s / n).to(m.dtype).view_as(m).to(m.device) for s, n, m in
                zip(sums, vec[-len(leaves):], means)])
    return _tree_map(lambda _: next(out), tree)


def barrier(mesh: Optional[EnvMesh]):
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def gather_to_rank0(obj, mesh: Optional[EnvMesh]) -> Optional[list]:
    """Every rank's ``obj`` (CPU tensors and host data) as a list on rank 0
    over the gloo group; None on the other ranks."""
    if mesh is None or mesh.group is None:
        return [obj]
    out = [None] * mesh.world_size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.cpu_group)
    return out


def rank_seed(seed: int, mesh: Optional[EnvMesh]) -> int:
    """The seed of a rank's generator: rank 0's is ``seed``, the
    single-process run's; every other rank's a distinct stream derived
    from (seed, rank), so that the ranks draw different envs."""
    rank = 0 if mesh is None else mesh.rank
    if rank == 0:
        return seed
    hi, lo = np.random.SeedSequence([seed, rank]).generate_state(2)
    return (int(hi) << 31) ^ int(lo)

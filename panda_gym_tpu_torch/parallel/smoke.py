"""Multi-process smoke run of the env mesh (the counterpart of
tools/multihost_smoke.py).

    python -m panda_gym_tpu_torch.parallel.smoke --nproc 2 --out smoke.json \\
        [--device cpu|cuda] [--backend gloo|nccl] [--n-envs 16] [--steps 30]

Starts N processes whose rendezvous is a file store in a temporary
directory (no TCP port), and checks in each of them:
  * ``initialize_multihost`` starts the process group of N ranks;
  * ``global_metric_mean`` across the ranks equals the host mean;
  * a sharded Reach ``batched_step`` on the rank's block agrees with the
    unsharded step of the whole batch on that block (observation 1e-5,
    reward 1e-6, q 1e-6: tests/test_parallel.py:46-49).
Then it times the sharded step with and without the collective (the
reward's global mean after each step) and writes the record of
MULTIHOST_SMOKE.json to ``--out``: ok, processes, ms per step with and
without the collective, the collective's share and the transport (gloo
on the CPU, gloo with several ranks on one card, or NCCL, one card per
rank).  A failed process makes it exit non-zero.  The device is ``cuda``
unless ``--device cpu`` is given; rank r takes card r modulo the cards
visible, and its default backend is NCCL, which takes one card per rank.

``launch`` is the process starter the mesh's tests and chip_smoke.py use.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, List, Sequence

import numpy as np
import torch

# tests/test_parallel.py:46-49: the sharded step against the unsharded one
ATOL_OBS, ATOL_REWARD, ATOL_Q = 1e-5, 1e-6, 1e-6


def _entry(rank: int, fn: Callable, nproc: int, store: str, result: str,
           args: Sequence):
    out = fn(rank, nproc, store, *args)
    torch.save(out, f"{result}.{rank}")


def launch(fn: Callable, nproc: int, args: Sequence = (),
           timeout: float = 600.0) -> List:
    """fn(rank, nproc, store, *args) in ``nproc`` spawned processes, whose
    rendezvous ``store`` (an init method for initialize_multihost) is a
    file in a temporary directory.  Returns each rank's return value
    (saved with torch.save, read back here).  Raises if a process fails or
    ``timeout`` seconds pass, and leaves no process running."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        result = os.path.join(tmp, "result")
        ctx = mp.start_processes(_entry, args=(fn, nproc, store, result,
                                               tuple(args)),
                                 nprocs=nproc, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nproc} ranks still running after "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        # the ranks wrote these files themselves
        return [torch.load(f"{result}.{r}", weights_only=False)
                for r in range(nproc)]


def rank_device(device: str, rank: int) -> str:
    """Rank r's device: the CPU, or card r modulo the cards visible."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def _rank(rank: int, nproc: int, store: str, device: str, backend: str,
          n_envs: int, steps: int):
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    from panda_gym_tpu_torch.parallel import mesh as M
    from panda_gym_tpu_torch.utils.profiling import sync

    if device == "cpu":
        torch.set_num_threads(1)   # N ranks share the host's cores
    n = M.initialize_multihost(store, nproc, rank,
                               device=rank_device(device, rank),
                               backend=backend)
    try:
        if n != nproc:
            raise RuntimeError(f"world size {n} != {nproc}")
        mesh = M.make_env_mesh()
        dev = mesh.device

        # the metric mean over the global env axis
        x = torch.arange(n_envs, dtype=torch.float32, device=dev)
        got = float(M.global_metric_mean(
            {"metric": M.shard_env_batch(x, mesh)}, mesh)["metric"])
        want = float(np.arange(n_envs, dtype=np.float32).mean())
        if abs(got - want) > 1e-6:
            raise RuntimeError(f"global_metric_mean {got} != {want}")

        # the sharded step against the unsharded one, on this rank's block
        core = make_core("reach", device=dev)
        states, _ = core.batched_reset(
            n_envs, torch.Generator(device=dev).manual_seed(0))
        actions = torch.tensor(np.random.default_rng(0).uniform(
            -1, 1, (n_envs, core.robot.action_dim)), dtype=torch.float32,
            device=dev)
        full = M.shard_env_batch(core.batched_step(states, actions)[:3],
                                 mesh)
        block = M.shard_env_batch(states, mesh)
        act = M.shard_env_batch(actions, mesh)
        mine = core.batched_step(block, act)[:3]
        errs = {
            "observation": (mine[1]["observation"]
                            - full[1]["observation"]).abs().max().item(),
            "reward": (mine[2] - full[2]).abs().max().item(),
            "q": (mine[0].q - full[0].q).abs().max().item()}
        tol = {"observation": ATOL_OBS, "reward": ATOL_REWARD, "q": ATOL_Q}
        if any(errs[k] > tol[k] for k in errs):
            raise RuntimeError(f"rank {rank}: the sharded step parts from "
                               f"the unsharded one: {errs} (atol {tol})")

        # ms per sharded step, without and with the collective, after two
        # of warm-up
        def run(collective: bool) -> float:
            s = block
            for i in range(steps + 2):
                if i == 2:
                    M.barrier(mesh)
                    sync(s.q)
                    t0 = time.perf_counter()
                s, _, r, *_ = core.batched_step(s, act)
                if collective:
                    M.global_metric_mean({"reward": r}, mesh)
            sync(s.q)
            return (time.perf_counter() - t0) / steps

        t_plain = run(False)
        t_coll = run(True)
        return {"psum_mean": got, "errors": errs, "device": str(dev),
                "t_step_ms": t_plain * 1e3,
                "t_step_with_collective_ms": t_coll * 1e3}
    finally:
        M.shutdown()


def transport(device: str, backend: str, nproc: int) -> str:
    if device == "cpu":
        return "gloo on the CPU"
    cards = torch.cuda.device_count()
    if backend == "gloo":
        return (f"gloo on CUDA tensors, {nproc} ranks on {min(nproc, cards)}"
                f" card(s) ({torch.cuda.get_device_name(0)})")
    return f"NCCL, one card per rank ({torch.cuda.get_device_name(0)})"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--out", required=True, help="where the record goes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--n-envs", type=int, default=16,
                   help="the global env batch, sharded over the ranks")
    p.add_argument("--steps", type=int, default=30,
                   help="timed steps, with and without the collective")
    p.add_argument("--timeout", type=float, default=600.0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu to run on the CPU")
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if backend == "nccl" and args.nproc > torch.cuda.device_count():
        raise SystemExit(f"NCCL takes one card per rank: {args.nproc} ranks,"
                         f" {torch.cuda.device_count()} card(s); use "
                         f"--backend gloo to share one")
    t0 = time.time()
    res = launch(_rank, args.nproc,
                 (args.device, backend, args.n_envs, args.steps),
                 args.timeout)
    plain = float(np.mean([r["t_step_ms"] for r in res]))
    coll = float(np.mean([r["t_step_with_collective_ms"] for r in res]))
    record = {
        "ok": True,
        "processes": args.nproc,
        "devices": [r["device"] for r in res],
        "n_envs": args.n_envs,
        "checks": ["initialize_multihost -> torch.distributed process group",
                   "global_metric_mean across processes == host mean",
                   "sharded Reach batched_step == unsharded on each block"],
        "max_errors": {k: max(r["errors"][k] for r in res)
                       for k in res[0]["errors"]},
        "t_step_ms": plain,
        "t_step_with_collective_ms": coll,
        "collective_overhead_fraction": max(coll - plain, 0.0)
        / max(coll, 1e-12),
        "transport": transport(args.device, backend, args.nproc),
        "wall_s": time.time() - t0,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()

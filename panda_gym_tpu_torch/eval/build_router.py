"""Build and evaluate the scene-blind ROUTED generalist, the counterpart of
tools/build_router.py.

 1. load the campaign's per-scene-best members (one shared actor graph)
    from their run directories and stack them into a member pool;
 2. for each scene, roll the scene's controller (the masked fusion of its
    members, rl/distill.py::collect_labeled with the teacher driving) on
    its home scene and collect the flat observations it visits, labelled
    with the controller's index;
 3. train eval/router.py::RouterMLP to classify obs -> controller (softmax
    cross-entropy, Adam 3e-4; the scene id is a training LABEL only: at
    evaluation the router sees nothing but x);
 4. save the routed policy as one file (routed_policy.npz, with the
    members' config.json beside it) and, with ``--benchmark``, score it on
    the reference's 13-scene table (eval/cli.py --routed: 100 episodes,
    horizon 300, seed 0).

    python -m panda_gym_tpu_torch.eval.build_router [--collect-episodes 64]
        [--steps 3000] [--root training/run_data]
        [--out training/run_data/round5_campaign/routed_gen]
        [--benchmark] [--episodes 100]

Options keep the tool's names and defaults.  ``--root`` is the run-data
root the CONTROLLERS table's run directories are under; each holds
best_model.policy.npz (or best_model.ckpt) and config.json.
``--scenarios`` cuts the table to those scenes: the pool is their
controllers' members, and only they are collected and benchmarked.
``--collect-only`` writes each scene's labelled observations to
``<out>/data/collect_<scene>.npz`` and stops (run several over scenario
subsets in parallel); ``--train-from-data`` trains from those parts;
``--benchmark-only`` scores the existing file.  The device is ``cuda``
unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

R2 = "round2_campaign"
R3 = "round3_campaign"
R4 = "round4_campaign"

# scene -> member run dirs (under --root).  These reproduce the round-4
# claim table's per-scene best controllers: a controller is the bayesian
# fusion of its members; a single-member controller is that member's
# deterministic policy (tools/build_router.py:49-70).
CONTROLLERS = {
    "reachao1": [f"{R4}/tqc_r4_gen"],
    "reachao2": [f"{R4}/tqc_r4_ao2_s1", f"{R4}/tqc_r4_rr_s1",
                 f"{R2}/tqc_ft21_reachao2"],
    "reachao3": [f"{R4}/tqc_r4_w3_s2", f"{R4}/tqc_r4_rr_s1",
                 f"{R3}/tqc_r3_wang3"],
    "wangexp-3": [f"{R4}/tqc_r4_w3_s2", f"{R4}/tqc_r4_rr_s1",
                  f"{R3}/tqc_r3_wang3"],
    "reachao_rand": [f"{R4}/tqc_r4_rr_s1", f"{R4}/tqc_r4_w3_s2",
                     f"{R3}/tqc_r3_wang3"],
    "reachao_rand_start": [f"{R4}/tqc_r4_rs_s3", f"{R4}/tqc_r4_rs_s1",
                           f"{R4}/tqc_r4_rs_s2", f"{R2}/tqc_ft21_rand_start"],
    "library1": [f"{R4}/tqc_r4_gen"],
    "library2": [f"{R2}/tqc_ft21_library2"],
    "narrow_tunnel": [f"{R4}/tqc_r4_gen", f"{R2}/tqc_gen_w_s2",
                      f"{R2}/tqc_gen_w_s3", f"{R2}/tqc_gen_w"],
    "tunnel": [f"{R2}/tqc_gen_w"],
    "workshop": [f"{R4}/tqc_r4_ws_s1"],
    "industrial": [f"{R2}/tqc_gen_w", f"{R2}/tqc_gen_w_s1",
                   f"{R2}/tqc_gen_w_s2", f"{R2}/tqc_gen_w_s3"],
    "wall": [f"{R4}/tqc_r4_wall_s1"],
}
ROUTER_HIDDEN = (128, 128)
BATCH = 4096


def load_actor_params(run_dir: str):
    """(the best_model actor's Flax-named arrays, whether it is the gSDE
    actor), from best_model.policy.npz (preferred) or best_model.ckpt.
    The campaign's members through round 4 carry the legacy
    squashed-Gaussian actor; the pool needs every member to agree."""
    from panda_gym_tpu_torch.rl.checkpoint import load_checkpoint
    from panda_gym_tpu_torch.rl.networks import flax_params
    from panda_gym_tpu_torch.rl.policy_io import load_policy

    npz = os.path.join(run_dir, "best_model.policy.npz")
    if os.path.exists(npz):
        actor, meta = load_policy(npz)
        return actor, bool(meta.get("use_sde", False))
    tensors = load_checkpoint(os.path.join(run_dir, "best_model.ckpt"))[
        "ts"]["tensors"]
    actor = flax_params({k[len("actor/"):]: v for k, v in tensors.items()
                         if k.startswith("actor/")})
    return actor, "actor/log_std_sde" in tensors


def controller_table(scenes):
    """(member run dirs, controller masks, controller names, scene ->
    controller index) of the table cut to ``scenes``: controller classes
    are the unique member masks (reachao3 and wangexp-3 collapse into
    one)."""
    member_dirs = []
    for sc in scenes:
        for r in CONTROLLERS[sc]:
            if r not in member_dirs:
                member_dirs.append(r)
    masks, names, scene_to_ctrl = [], [], {}
    for sc in scenes:
        mask = tuple(1.0 if d in CONTROLLERS[sc] else 0.0
                     for d in member_dirs)
        if mask not in masks:
            masks.append(mask)
            names.append(sc)
        scene_to_ctrl[sc] = masks.index(mask)
    return member_dirs, masks, names, scene_to_ctrl


def scene_generator(seed: int, scene: str, device) -> torch.Generator:
    """A scene's collection stream, folded from the scene's name (crc32,
    not hash(): str hashes are salted per process), so that sharding the
    collection over processes does not change the data."""
    return torch.Generator(device=device).manual_seed(
        (seed + 1234) * 2 ** 32 + zlib.crc32(scene.encode()))


def train_router(X, y, n_ctrl: int, steps: int, seed: int, device,
                 names, log=print):
    """RouterMLP on (X, y) with softmax cross-entropy and Adam 3e-4 over
    class-balanced minibatches of 4096, a tenth held out; returns (router,
    per-class validation accuracy)."""
    from panda_gym_tpu_torch.eval.router import RouterMLP
    from panda_gym_tpu_torch.rl.learners import adam

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    X, y = X[perm], y[perm]
    n_val = max(len(X) // 10, 1)
    Xv = torch.as_tensor(X[:n_val], device=device)
    yv = y[:n_val]
    Xt = torch.as_tensor(X[n_val:], device=device)
    yt = torch.as_tensor(y[n_val:], dtype=torch.long, device=device)
    # class-balanced sampling weights (scenes yield different step counts)
    counts = np.bincount(y[n_val:], minlength=n_ctrl).astype(np.float64)
    w = (1.0 / np.maximum(counts, 1))[y[n_val:]]
    w /= w.sum()

    router = RouterMLP(X.shape[1], n_ctrl, ROUTER_HIDDEN,
                       torch.Generator(device=device).manual_seed(seed),
                       device)
    params = list(router.parameters())
    opt = adam(params, 3e-4)
    t0 = time.time()
    for step in range(steps):
        idx = torch.as_tensor(rng.choice(len(Xt), size=BATCH, p=w),
                              device=device)
        loss = F.cross_entropy(router(Xt[idx]), yt[idx])
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()
        if (step + 1) % 500 == 0:
            with torch.no_grad():
                acc = float((router(Xv).argmax(-1).cpu().numpy()
                             == yv).mean())
            log(f"step {step + 1}: loss {loss.item():.4f} val acc "
                f"{acc:.4f} ({time.time() - t0:.0f}s)")
    with torch.no_grad():
        pred = router(Xv).argmax(-1).cpu().numpy()
    conf = np.zeros((n_ctrl, n_ctrl), int)
    np.add.at(conf, (yv, pred), 1)
    per_class = {names[c]: round(float(conf[c, c] / max(conf[c].sum(), 1)), 4)
                 for c in range(n_ctrl)}
    return router.requires_grad_(False), per_class


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--collect-episodes", type=int, default=64)
    p.add_argument("--collect-horizon", type=int, default=300)
    p.add_argument("--steps", type=int, default=3000,
                   help="router training steps")
    p.add_argument("--root", default="training/run_data",
                   help="the run-data root of the CONTROLLERS run dirs")
    p.add_argument("--out", default="training/run_data/round5_campaign/"
                                    "routed_gen")
    p.add_argument("--collect-only", action="store_true",
                   help="collect labelled obs for --scenarios (default "
                        "all) into <out>/data/collect_<scene>.npz and exit")
    p.add_argument("--train-from-data", action="store_true",
                   help="skip collection; train the router from the "
                        "<out>/data parts written by --collect-only")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--benchmark-only", action="store_true",
                   help="skip collection and training; benchmark the "
                        "existing <out>/routed_policy.npz")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scenarios", nargs="+", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, members and router")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from panda_gym_tpu_torch.envs.core import resolve_device
    from panda_gym_tpu_torch.eval import cli as eval_cli
    from panda_gym_tpu_torch.eval.router import (MemberStack, RoutedPolicy,
                                                 save_routed_policy)
    from panda_gym_tpu_torch.rl.distill import collect_labeled
    from panda_gym_tpu_torch.rl.logging_utils import load_config, write_config

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    artifact = os.path.join(args.out, "routed_policy.npz")
    scenes = args.scenarios or list(CONTROLLERS)
    unknown = sorted(set(scenes) - set(CONTROLLERS))
    if unknown:
        raise SystemExit(f"no controller for {unknown}")

    if not args.benchmark_only:
        member_dirs, ctrl_masks, ctrl_names, scene_to_ctrl = \
            controller_table(scenes)
        n_ctrl = len(ctrl_masks)
        print(f"pool: {len(member_dirs)} members, {n_ctrl} controllers")
        runs = [os.path.join(args.root, d) for d in member_dirs]
        loaded = [load_actor_params(r) for r in runs]
        sde = {d: s for d, (_a, s) in zip(member_dirs, loaded)}
        if len(set(sde.values())) != 1:
            raise SystemExit(f"pool mixes actor types: {sde}")
        pool_sde = next(iter(sde.values()))
        members = MemberStack({k: np.stack([a[k] for a, _s in loaded])
                               for k in loaded[0][0]}, device)
        masks = torch.tensor(ctrl_masks, dtype=torch.float32, device=device)
        # the envs and the file's config: the first member's (reachao1's
        # tqc_r4_gen under the whole table, as the tool's)
        cfg = load_config(os.path.join(runs[0], "config.json"))
        cfg.hyperparams.use_sde = pool_sde
        make_core = eval_cli.make_core_fn(cfg, device)

        data_dir = os.path.join(args.out, "data")
        os.makedirs(data_dir, exist_ok=True)
        Xs, ys = [], []
        for sc in scenes:
            part = os.path.join(data_dir, f"collect_{sc}.npz")
            if args.train_from_data:
                if not os.path.exists(part):
                    raise SystemExit(f"missing {part} (collect it first)")
                with np.load(part) as z:
                    Xs.append(z["X"])
                    ys.append(z["y"])
                print(f"loaded {part}: {len(Xs[-1])} obs", flush=True)
                continue
            t0 = time.time()
            X, _, act = collect_labeled(
                make_core(sc), members, masks[scene_to_ctrl[sc]],
                args.collect_episodes, args.collect_horizon,
                scene_generator(args.seed, sc, device))
            X = X.reshape(-1, X.shape[-1])[act.reshape(-1)].cpu().numpy()
            y = np.full(len(X), scene_to_ctrl[sc], np.int32)
            np.savez_compressed(part, X=X.astype(np.float32), y=y)
            Xs.append(X)
            ys.append(y)
            print(f"collect {sc:>20s}: {len(X):7d} obs "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.collect_only:
            return None
        X, y = np.concatenate(Xs), np.concatenate(ys)

        router, per_class = train_router(X, y, n_ctrl, args.steps, args.seed,
                                         device, ctrl_names)
        print("per-class val acc:", json.dumps(per_class, indent=1))
        meta = {
            "format": "panda_gym_tpu.routed_policy.v1",
            "members": runs,
            "controllers": {ctrl_names[c]: [runs[i] for i, v in
                                            enumerate(ctrl_masks[c]) if v]
                            for c in range(n_ctrl)},
            "scene_to_controller": {sc: ctrl_names[scene_to_ctrl[sc]]
                                    for sc in scenes},
            "router_hidden": list(ROUTER_HIDDEN),
            "use_sde": pool_sde,
            "x_dim": int(X.shape[1]),
            "val_acc_per_class": per_class,
            "train_obs": int(len(X) - max(len(X) // 10, 1)),
        }
        save_routed_policy(artifact, RoutedPolicy(members, masks, router),
                           meta)
        # the eval CLI evaluates a routed file under the config beside it
        write_config(args.out, cfg)
        print(f"saved {artifact}")

    if args.benchmark or args.benchmark_only:
        argv = ["--routed", artifact, "--out", args.out, "--episodes",
                str(args.episodes), "--seed", str(args.seed), "--device",
                str(device)]
        if args.scenarios:
            argv += ["--scenarios", *args.scenarios]
        return eval_cli.main(argv)
    return artifact


if __name__ == "__main__":
    main()

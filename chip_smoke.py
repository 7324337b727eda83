#!/usr/bin/env python3
"""Smoke run of the PyTorch port (panda_gym_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one progress line each:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of the main path with nvcc (sm_90a);
  3. kernels: holds K1 against its plain PyTorch version on the card
     (B 4096 and 4100, position and velocity control, 20 substeps);
  4. main path: batched Reach, make_core("reach") -> batched_reset(4096) ->
     50 batched_step calls; K1's launch count must rise by exactly 50, the
     outputs must be finite and within the joint limits, and the first two
     steps must agree with the plain physics;
  5. times, with CUDA events: K1 per launch at B 4096 and 65536 beside its
     bound, the plain version once, and batched_step env-steps/s;
  6. profile: torch.profiler over 5 batched_step calls, the card's busy
     share and the kernels that take the most device time.

The line before the last is one JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero before
those lines.  Imports torch, numpy, the standard library and the port only.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN = 4096
N_STEPS = 50
N_SUBSTEPS = 20
DT = 1.0 / 500.0
SEED = 0
# tests/test_dynamics.py:295-296: the scalarized path against the TPU kernel
ATOL_Q = 2e-5
ATOL_QD = 2e-3
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores,
# and device memory bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def say(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def motor_inputs(model, B, ctrl_mode, rng, device):
    """States as tests/test_dynamics.py draws them: q in the joint limits,
    qd ~ N(0, 0.5); position targets near q, velocity targets ~ N(0, 1)."""
    lo, hi = np.asarray(model.q_lo), np.asarray(model.q_hi)
    q = rng.uniform(lo, hi, (B, 7))
    qd = rng.normal(0.0, 0.5, (B, 7))
    if ctrl_mode == 0:
        tgt = q + rng.normal(0.0, 0.05, (B, 7))
    else:
        tgt = rng.normal(0.0, 1.0, (B, 7))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (q, qd, tgt))


def count_plain_ops(model, ctrl_mode):
    """fp32 operations per env and policy step of the plain version, counted
    by running it for one env on the CPU under a dispatch mode: every
    elementwise operator call on a (1,) tensor is one operation (arithmetic,
    sqrt, sin, cos, compare, select, logical); views, copies, stacks and
    tensor creation are not counted.  The loops have fixed trip counts, so
    the count does not depend on the data."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from panda_gym_tpu_torch.ops import scalarized as S

    moves = {"select", "slice", "stack", "cat", "unsqueeze", "view",
             "expand", "clone", "copy_", "_to_copy", "detach", "alias",
             "empty", "lift_fresh", "lift_fresh_copy", "scalar_tensor",
             "full", "zeros", "ones", "t", "transpose", "squeeze",
             "as_strided", "unbind", "_local_scalar_dense"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__ not in moves
                    and isinstance(out, torch.Tensor)):
                Count.n += out.numel()
            return out

    step = S.make_batched_motor_steps(model, n_substeps=N_SUBSTEPS, dt=DT,
                                      ctrl_mode=ctrl_mode)
    q, qd, tgt = motor_inputs(model, 1, ctrl_mode,
                              np.random.default_rng(SEED), "cpu")
    with Count():
        step(q, qd, tgt)
    return Count.n


def time_cuda(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_step(env, states, acts, card):
    """Where a batched_step's time goes: torch.profiler over 5 steps, the
    card's busy share of the wall time and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(5):
                states, *_ = env.batched_step(states, acts[i % len(acts)])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")
                   and getattr(e, "self_device_time_total", 0) > 0]
    except Exception as e:  # a measurement, not a check: report and go on
        say(f"phase 6 profile: not measured ({type(e).__name__}: {e})")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        say("phase 6 profile: the profiler saw no device time (not measured)")
        return
    n_launch = sum(e.count for e in kernels)
    say(f"phase 6 profile of 5 batched_step at B={B_MAIN}: wall "
        f"{wall_us / 5:.0f} us/step, card busy {busy_us / 5:.0f} us/step "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch / 5:.0f} kernel "
        f"launches/step | {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"  {e.self_device_time_total / 5:9.1f} us/step "
            f"{e.count / 5:6.1f}x  {e.key[:90]}")


def main():
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from panda_gym_tpu_torch.envs.core import _hi_prec
        from panda_gym_tpu_torch.envs.panda_tasks import make_core
        from panda_gym_tpu_torch.models.panda import make_panda_model
        from panda_gym_tpu_torch.ops import _build
        from panda_gym_tpu_torch.ops import cuda_dynamics as CD
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"phase 1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
        f"{card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------------- 2
    lib = _build.load(CD.KERNEL)
    info = _build.BUILD_INFO[CD.KERNEL]
    say(f"phase 2 build: {CD.KERNEL} built in {info['seconds']:.1f} s "
        f"({lib._name})")
    for ln in info["ptxas"]:
        say(f"  ptxas: {ln}")

    # ---------------------------------------------------------------- 3
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    rng = np.random.default_rng(SEED)
    err_q = err_qd = 0.0
    plain_ms = None
    for ctrl_mode in (0, 1):
        k1 = CD.make_cuda_motor_steps(model, n_substeps=N_SUBSTEPS, dt=DT,
                                      ctrl_mode=ctrl_mode)
        for B in (B_MAIN, B_MAIN + 4):
            q, qd, tgt = motor_inputs(model, B, ctrl_mode, rng, dev)
            qk, qdk = k1(q, qd, tgt)
            torch.cuda.synchronize()
            if ctrl_mode == 0 and B == B_MAIN:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            qp, qdp = k1.plain(q, qd, tgt)
            if ctrl_mode == 0 and B == B_MAIN:
                t1.record()
                torch.cuda.synchronize()
                plain_ms = t0.elapsed_time(t1)
            eq = (qk - qp).abs().max().item()
            eqd = (qdk - qdp).abs().max().item()
            ok = eq <= ATOL_Q and eqd <= ATOL_QD
            say(f"phase 3 K1 vs plain: ctrl_mode={ctrl_mode} B={B} "
                f"max|dq|={eq:.3e} (atol {ATOL_Q}) "
                f"max|dqd|={eqd:.3e} (atol {ATOL_QD}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad = ((qk - qp).abs() > ATOL_Q).any(1) | (
                    (qdk - qdp).abs() > ATOL_QD).any(1)
                fail(f"K1 disagrees with its plain version on "
                     f"{int(bad.sum())} of {B} envs")
            err_q, err_qd = max(err_q, eq), max(err_qd, eqd)

    # ---------------------------------------------------------------- 4
    env = make_core("reach", device="cuda")
    motor = env.physics_step_batched.motor
    q_lo = torch.as_tensor(env.model.q_lo, device=dev)
    q_hi = torch.as_tensor(env.model.q_hi, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = env.batched_reset(B_MAIN, gen)
    motor.launches = 0
    for i in range(N_STEPS):
        actions = torch.rand(B_MAIN, env.robot.action_dim, generator=gen,
                             device=dev) * 2.0 - 1.0
        if i < 2:
            s_in = _hi_prec(env.robot.set_action)(states, actions)
            q_ref, qd_ref = motor.plain(s_in.q, s_in.qd, s_in.ctrl_target)
        states, obs, reward, terminated, truncated, info = env.batched_step(
            states, actions)
        if i < 2:
            eq = (states.q - q_ref).abs().max().item()
            eqd = (states.qd - qd_ref).abs().max().item()
            say(f"phase 4 step {i} vs plain physics: max|dq|={eq:.3e} "
                f"max|dqd|={eqd:.3e}")
            if eq > ATOL_Q or eqd > ATOL_QD:
                fail(f"main-path step {i} disagrees with the plain physics")
            err_q, err_qd = max(err_q, eq), max(err_qd, eqd)
    torch.cuda.synchronize()
    launches = motor.launches
    if launches != N_STEPS:
        fail(f"K1 launched {launches} times in {N_STEPS} steps")
    checks = {
        "obs finite": bool(torch.isfinite(obs["observation"]).all()),
        "obs shape": tuple(obs["observation"].shape) == (B_MAIN, 6),
        "reward finite": bool(torch.isfinite(reward).all()),
        "reward in {-1, 0}": bool(((reward == 0) | (reward == -1)).all()),
        "q finite": bool(torch.isfinite(states.q).all()),
        "q in limits": bool(((states.q >= q_lo) & (states.q <= q_hi)).all()),
        "steps": bool((states.steps == N_STEPS).all()),
    }
    say(f"phase 4 main path: {N_STEPS} batched_step at B={B_MAIN}, "
        f"K1 launches {launches}, success rate "
        f"{info['is_success'].float().mean().item():.4f}, checks {checks}")
    if not all(checks.values()):
        fail(f"main-path checks failed: {checks}")

    # ---------------------------------------------------------------- 5
    k1 = CD.make_cuda_motor_steps(model, n_substeps=N_SUBSTEPS, dt=DT,
                                  ctrl_mode=0)
    n_ops = count_plain_ops(model, 0)
    times = {}
    for B, reps in ((B_MAIN, 20), (65536, 5)):
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        ms = time_cuda(lambda: k1(q, qd, tgt), reps)
        bound_ms = max(140.0 * B / PEAK_BYTES, float(n_ops) * B
                       / PEAK_FP32_OPS) * 1e3
        times[B] = (ms, bound_ms)
        say(f"phase 5 K1 B={B}: {ms:.4f} ms/launch, bound {bound_ms:.5f} ms "
            f"({n_ops} fp32 ops/env counted from the plain version, "
            f"{140 * B} bytes), {ms / bound_ms:.1f}x the bound | {card}")
    say(f"phase 5 plain version B={B_MAIN}: {plain_ms:.1f} ms for one call "
        f"| {card}")
    say("phase 5 library: no single PyTorch call computes K1's function")
    acts = [torch.rand(B_MAIN, env.robot.action_dim, generator=gen,
                       device=dev) * 2.0 - 1.0 for _ in range(4)]
    for a in acts[:2]:
        states, *_ = env.batched_step(states, a)
    torch.cuda.synchronize()
    n_timed = 20
    t0 = time.perf_counter()
    for i in range(n_timed):
        states, *_ = env.batched_step(states, acts[i % len(acts)])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    say(f"phase 5 batched_step B={B_MAIN}: {step_s * 1e3:.3f} ms/step, "
        f"{B_MAIN / step_s:.0f} env-steps/s | {card}")

    profile_step(env, states, acts, card)

    ms, bound_ms = times[B_MAIN]
    row = {
        "name": "K1 motor_steps", "route": "cuda",
        "source": "panda_gym_tpu_torch/ops/csrc/motor_steps.cu",
        "replaces": "panda_gym_tpu/ops/pallas_dynamics.py:96",
        "launches": launches, "max_abs_err": max(err_q, err_qd),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if float(n_ops) / PEAK_FP32_OPS
        > 140.0 / PEAK_BYTES else "bytes",
        "library_ms": None,
    }
    say(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

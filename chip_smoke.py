#!/usr/bin/env python3
"""Smoke run of the PyTorch port (panda_gym_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --times ROOT

K1, the motor dynamics, is two kernels of one source: the lane-group kernel
(8 lanes per env) and the one-env-per-thread kernel; the wrapper picks one
from B and the card.  Phases, one progress line each:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of the main path with nvcc (sm_90a) and
     prints ptxas's registers and spill, each kernel's static SASS size and
     largest loop (the substep loop) and the card's occupancy query;
  3. kernels: holds each K1 kernel against its plain PyTorch version on the
     card (B 1, 4096 and 4100, position and velocity control, 20
     substeps); at bench.py's B = 65536 the two kernels must agree bit for
     bit, and the one picked there must agree with the plain version on
     every env but at most 16 near-ties: envs whose plain result itself
     jumps by more than the tolerance when the state moves by 1e-6 (an
     active-set or joint-limit decision at the rounding level), on one of
     whose perturbed copies the kernel must agree;
  4. main path: batched Reach, make_core("reach") -> batched_reset(B) ->
     batched_step, at the main path's B = 4096 (50 steps) and at bench.py's
     B = 65536 (10 steps); each K1 kernel's launch count is set to 0 before
     each run and must rise by one per step for the kernel the wrapper
     picks at that B and stay 0 for the other; the outputs must be finite
     and within the joint limits, and the first two steps must agree with
     the plain physics (at 65536 with phase 3's rule for near-ties);
  5. times, with CUDA events: K1 per launch as the wrapper picks it, and
     each kernel, at B 64, 512, 4096, 8192, 16384 and 65536, beside the
     bound (device time: the stream waits while the host queues them); the plain version once at 4096 and 65536; batched_step
     env-steps/s at B 4096 and 65536;
  6. profile: torch.profiler over 5 batched_step calls at each of those two
     batches, the card's busy share and the kernels that take the most
     device time;
  7. ReachAO: make_reach_ao_core("reachao1") at B = 4096 (3 steps) and
     "reachao2" at bench.py's ReachAO batch B = 16384 (2 steps), the first
     obstacle of envs 0-7 moved onto their end effector first; K1 runs cold
     at n_substeps=1, once per collision substep, so its count must rise by
     20 per step, on the lane-group kernel at 4096 and one env per thread at
     16384; the forced envs must collide, truncate and stay frozen at their
     colliding substep's pose; the K1 route of the collision physics is held
     against the plain route (the plain cold substep) on the first step's
     states: q, qd and link distances within 2e-5, 2e-3 and 1e-4, collided
     flags equal, on every env but at most 16, each of which must be a
     contact tie (the plain least distance within 1e-4 m of 0 where the
     routes part) or an active-set near-tie (phase 3's perturbation test,
     there); then the step's time (the median of 10 steps timed one by
     one, with their spread) and the plain route's, one profiled step, and
     K1 at n_substeps=1 beside its bound.

The line before the last is one JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero before
those lines.  Imports torch, numpy, the standard library and the port only.

``--times ROOT`` runs phases 1, 2, 5 and 6 only (K1 as the wrapper picks
it, no plain version), and phase 7's step times where ROOT has ReachAO, on
the port of the checkout at ROOT (for example the parent commit, unpacked
with ``git archive``), and prints no result line:
running it on two checkouts in turns (A, B, B, A) compares two versions on
one card in one call.
"""
import argparse
import copy
import inspect
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN = 4096
# bench.py's batch, the JAX package's headline throughput
B_BENCH = 65536
# K1 timed at the trainer's batches (n_envs 64 and 512, THROUGHPUT_r05.json),
# the main path's, two past one wave of the lane-group kernel, and bench.py's
B_TIMED = (64, 512, B_MAIN, 8192, 16384, B_BENCH)
N_STEPS = 50
N_STEPS_BENCH = 10
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


def sass_loops(lib_path, nvcc):
    """For each kernel in the library: its static SASS instruction count and
    the sizes of its loops (a backward branch closes one), largest first,
    from cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()}")
    parts = re.split(r"Function : (\S+)", out.stdout)
    result = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]
        loops = []
        for addr, op in ins:
            m = re.search(r"BRA\s+(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                loops.append((addr - int(m.group(1), 16)) // 16 + 1)
        result[name] = (len(ins), sorted(loops, reverse=True))
    if not result:
        fail("cuobjdump listed no kernel")
    return result


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


def count_plain_ops(model, ctrl_mode, n_substeps=N_SUBSTEPS, warm_start=True):
    """fp32 operations per env and launch of the plain version, counted
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

    step = S.make_batched_motor_steps(model, n_substeps=n_substeps, dt=DT,
                                      ctrl_mode=ctrl_mode,
                                      warm_start=warm_start)
    q, qd, tgt = motor_inputs(model, 1, ctrl_mode,
                              np.random.default_rng(SEED), "cpu")
    with Count():
        step(q, qd, tgt)
    return Count.n


def reach_k1(CD, model, ctrl_mode):
    """K1 as the Reach step builds it: 20 warm substeps.  A checkout from
    before the wrapper's ``warm_start`` argument (``--times``) always ran
    warm."""
    kw = dict(n_substeps=N_SUBSTEPS, dt=DT, ctrl_mode=ctrl_mode)
    if "warm_start" in inspect.signature(CD.make_cuda_motor_steps).parameters:
        kw["warm_start"] = True
    return CD.make_cuda_motor_steps(model, **kw)


def time_cuda(fn, reps, warmup=2, queued=False):
    """Milliseconds per call of fn between two CUDA events.  ``queued``
    first holds the stream in a ~10 ms spin, so that the host queues every
    call before the first runs and the events read the kernels' own time,
    not the host's rate of launching them (a one-substep K1 launch is
    shorter than its host call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k1_bound_ms(n_ops, B):
    """Least time for K1 at batch B: the larger of its bytes (140 per env)
    over the memory rate and its fp32 operations over the fp32 peak."""
    return max(140.0 * B / PEAK_BYTES, float(n_ops) * B / PEAK_FP32_OPS) * 1e3


def time_k1(fn, model, ctrl_mode, B, rng, device):
    """Time per launch of fn(q, qd, target) at batch B, with CUDA events."""
    q, qd, tgt = motor_inputs(model, B, ctrl_mode, rng, device)
    return time_cuda(lambda: fn(q, qd, tgt), 10 if B > B_MAIN else 20,
                     queued=True)


def time_step(make_core, B, dev, card):
    """batched_step's wall time at batch B, host clock over 20 steps after 2
    of warm-up, ending in a synchronize; returns what profile_step needs."""
    env = make_core("reach", device="cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, _ = env.batched_reset(B, gen)
    acts = [torch.rand(B, env.robot.action_dim, generator=gen,
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
    say(f"phase 5 batched_step B={B}: {step_s * 1e3:.3f} ms/step, "
        f"{B / step_s:.0f} env-steps/s | {card}")
    return env, states, acts


def profile_step(env, states, acts, card, n=5, tag="phase 6"):
    """Where a batched_step's time goes: torch.profiler over n steps, the
    card's busy share of the wall time and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile

    B = states.q.shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            states, *_ = env.batched_step(states, acts[i % len(acts)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        fail(f"{tag} profile: the profiler saw no device time")
    n_launch = sum(e.count for e in kernels)
    say(f"{tag} profile of {n} batched_step at B={B}: wall "
        f"{wall_us / n:.0f} us/step, card busy {busy_us / n:.0f} us/step "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch / n:.0f} kernel "
        f"launches/step | {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"  {e.self_device_time_total / n:9.1f} us/step "
            f"{e.count / n:6.1f}x  {e.key[:90]}")


def k1_times(CD, model, rng, dev, card, each_kernel):
    """Phase 5's K1 times at B_TIMED beside the bound: as the wrapper picks
    the kernel and, with each_kernel, each kernel.  Returns {(B, lanes per
    env): ms} for each kernel, and the operation count."""
    k1 = reach_k1(CD, model, 0)
    n_ops = count_plain_ops(model, 0)
    times = {}
    for B in B_TIMED:
        ms = time_k1(k1, model, 0, B, rng, dev)
        bound_ms = k1_bound_ms(n_ops, B)
        line = (f"phase 5 K1 B={B}: {ms:.4f} ms/launch, bound "
                f"{bound_ms:.5f} ms ({n_ops} fp32 ops/env counted from the "
                f"plain version, {140 * B} bytes), {ms / bound_ms:.1f}x the "
                f"bound")
        if each_kernel:
            for lanes in (CD.LANES, CD.THREAD):
                times[B, lanes] = time_k1(
                    lambda q, qd, t: k1.launch(q, qd, t, lanes), model, 0, B,
                    rng, dev)
            picked = CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
            line += (f"; lane-group kernel {times[B, CD.LANES]:.4f} ms, "
                     f"one env per thread {times[B, CD.THREAD]:.4f} ms, "
                     f"picked: {KERNEL_NAMES[picked]}")
        say(f"{line} | {card}")
    return times, n_ops


def step_times(make_core, dev, card):
    """Phase 5's batched_step times and phase 6's profiles, at the main
    path's batch and at bench.py's."""
    runs = [time_step(make_core, B, dev, card) for B in (B_MAIN, B_BENCH)]
    for env, states, acts in runs:
        profile_step(env, states, acts, card)


KERNEL_NAMES = {8: "lane-group", 1: "one env per thread"}
# phase 3 at bench.py's batch: most envs that may sit at a near-tie
MAX_TIES = 16


def is_near_tie(k1, lanes, q, qd, tgt, b, dev):
    """Whether env b sits where the plain version is discontinuous (an
    active-set or joint-limit decision whose margin is at the rounding
    level).  Its state is copied 16 times, copies 1-15 scaled by 1 + 1e-6 N(0,
    1): it is a near-tie if the plain results of the copies spread by more
    than the tolerance, and the kernel agrees with the plain version within
    the tolerance on at least one copy.  Returns (near-tie, copies agreeing,
    plain spread in qd)."""
    g = torch.Generator(device=dev).manual_seed(b)
    noise = 1e-6 * torch.randn(16, 7, generator=g, device=dev)
    noise[0] = 0.0
    x = [(t[b:b + 1] * (1.0 + noise)).contiguous() for t in (q, qd, tgt)]
    qp, qdp = k1.plain(*x)
    qk, qdk = k1.launch(*x, lanes)
    spread_q = (qp - qp[:1]).abs().max().item()
    spread_qd = (qdp - qdp[:1]).abs().max().item()
    agree = (((qk - qp).abs() <= ATOL_Q) & ((qdk - qdp).abs() <= ATOL_QD)
             ).all(1)
    tie = (spread_q > ATOL_Q or spread_qd > ATOL_QD) and bool(agree.any())
    return tie, int(agree.sum()), spread_qd


def check_at_bench(CD, k1, q, qd, tgt, dev, err):
    """Phase 3 at bench.py's batch: the two kernels must agree bit for bit,
    and the one the wrapper picks there must agree with the plain version
    within the tolerance on every env but a few near-ties (is_near_tie).
    Returns the plain version's time in ms."""
    B = q.shape[0]
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    qp, qdp = k1.plain(q, qd, tgt)
    t1.record()
    torch.cuda.synchronize()
    out = {lanes: k1.launch(q, qd, tgt, lanes)
           for lanes in (CD.LANES, CD.THREAD)}
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out[CD.LANES],
                                                  out[CD.THREAD]))
    say(f"phase 3 K1 B={B} ctrl_mode={k1.ctrl_mode}: the two kernels agree "
        f"bit for bit: {same}")
    if not same:
        fail(f"the two K1 kernels disagree at B={B}")
    lanes = CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
    e = hold_with_ties(k1, lanes, (q, qd, tgt), out[lanes], (qp, qdp),
                       f"phase 3 K1 {KERNEL_NAMES[lanes]} vs plain: "
                       f"ctrl_mode={k1.ctrl_mode} B={B}", dev)
    for k in out:
        err[k] = max(err[k], e)
    return t0.elapsed_time(t1)


def hold_with_ties(k1, lanes, x, out, ref, label, dev):
    """Hold a kernel's (q, qd) against the plain version's on inputs x at
    bench.py's batch: every env within the tolerance, or at most MAX_TIES of
    them near-ties (is_near_tie).  Returns the largest error over the envs
    within the tolerance."""
    (qk, qdk), (qp, qdp) = out, ref
    bad = (((qk - qp).abs() > ATOL_Q) | ((qdk - qdp).abs() > ATOL_QD)
           ).any(1).nonzero().flatten().tolist()
    good = torch.ones(qk.shape[0], dtype=torch.bool, device=dev)
    good[bad] = False
    eq = (qk - qp)[good].abs().max().item()
    eqd = (qdk - qdp)[good].abs().max().item()
    say(f"{label} max|dq|={eq:.3e} (atol {ATOL_Q}) max|dqd|={eqd:.3e} "
        f"(atol {ATOL_QD}) on {int(good.sum())} envs; {len(bad)} outside "
        f"the tolerance")
    if eq > ATOL_Q or eqd > ATOL_QD or len(bad) > MAX_TIES:
        fail(f"{label}: K1 disagrees with its plain version")
    for b in bad:
        tie, n_agree, spread = is_near_tie(k1, lanes, *x, b, dev)
        say(f"  env {b}: max|dq|={(qk - qp)[b].abs().max().item():.3e} "
            f"max|dqd|={(qdk - qdp)[b].abs().max().item():.3e}; 16 copies "
            f"perturbed by 1e-6: plain spread in qd {spread:.3e}, kernel "
            f"agrees on {n_agree}: {'near-tie' if tie else 'FAIL'}")
        if not tie:
            fail(f"{label}: K1 disagrees with its plain version on env {b}")
    return max(eq, eqd)


def drive(make_core, _hi_prec, CD, B, n_steps, dev):
    """The main path at batch B: batched_reset, then n_steps batched_step
    calls with random actions, K1's counts set to 0 just before and read
    just after.  Returns the per-kernel launch counts, the largest error of
    the first two steps against the plain physics, and the checks."""
    env = make_core("reach", device="cuda")
    motor = env.physics_step_batched.motor
    # a second wrapper of the same kernels for the near-tie checks, whose
    # launches stay out of the main path's counts
    twin = CD.make_cuda_motor_steps(env.model, n_substeps=motor.n_substeps,
                                    dt=motor.dt, ctrl_mode=motor.ctrl_mode,
                                    warm_start=True)
    q_lo = torch.as_tensor(env.model.q_lo, device=dev)
    q_hi = torch.as_tensor(env.model.q_hi, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = env.batched_reset(B, gen)
    err = 0.0
    picked = CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    for i in range(n_steps):
        actions = torch.rand(B, env.robot.action_dim, generator=gen,
                             device=dev) * 2.0 - 1.0
        if i < 2:
            s_in = _hi_prec(env.robot.set_action)(states, actions)
            q_ref, qd_ref = motor.plain(s_in.q, s_in.qd, s_in.ctrl_target)
        states, obs, reward, terminated, truncated, info = env.batched_step(
            states, actions)
        if i < 2 and B == B_BENCH:
            err = max(err, hold_with_ties(
                twin, picked, (s_in.q, s_in.qd, s_in.ctrl_target),
                (states.q, states.qd), (q_ref, qd_ref),
                f"phase 4 B={B} step {i} vs plain physics:", dev))
        elif i < 2:
            eq = (states.q - q_ref).abs().max().item()
            eqd = (states.qd - qd_ref).abs().max().item()
            say(f"phase 4 B={B} step {i} vs plain physics: max|dq|={eq:.3e} "
                f"max|dqd|={eqd:.3e}")
            if eq > ATOL_Q or eqd > ATOL_QD:
                fail(f"main-path step {i} at B={B} disagrees with the plain "
                     f"physics")
            err = max(err, eq, eqd)
    torch.cuda.synchronize()
    counts = dict(motor.kernel_launches)
    checks = {
        "obs finite": bool(torch.isfinite(obs["observation"]).all()),
        "obs shape": tuple(obs["observation"].shape) == (B, 6),
        "reward finite": bool(torch.isfinite(reward).all()),
        "reward in {-1, 0}": bool(((reward == 0) | (reward == -1)).all()),
        "q finite": bool(torch.isfinite(states.q).all()),
        "q in limits": bool(((states.q >= q_lo) & (states.q <= q_hi)).all()),
        "steps": bool((states.steps == n_steps).all()),
    }
    say(f"phase 4 main path: {n_steps} batched_step at B={B}, K1 launches "
        f"{ {KERNEL_NAMES[k]: v for k, v in counts.items()} }, success rate "
        f"{info['is_success'].float().mean().item():.4f}, checks {checks}")
    if not all(checks.values()):
        fail(f"main-path checks at B={B} failed: {checks}")
    want = {CD.LANES: 0, CD.THREAD: 0}
    want[picked] = n_steps
    if counts != want:
        fail(f"K1 launches at B={B} were {counts}, expected {want}")
    return counts, err


# ------------------------------------------------------------------ phase 7
# ReachAO: reachao1 at the main path's B and reachao2 at bench.py's ReachAO
# batch (bench.py:97-101), a few steps each
REACH_AO = (("reachao1", B_MAIN, 3), ("reachao2", 16384, 2))
N_FORCED = 8
# steps timed one by one after the main path's, each between two syncs
N_TIMED = 10
# link distances of the two motor routes (the plain version's contact tie
# margin is the same 1e-4 m)
ATOL_LINK = 1e-4


def take(states, idx):
    """The envs idx of a batched EnvState."""
    return states.replace(**{k: getattr(states, k)[idx]
                             for k in states.__dataclass_fields__})


def route_diff(a, b):
    """Per env, whether two physics results part beyond the tolerances."""
    return (((a.q - b.q).abs() > ATOL_Q).any(1)
            | ((a.qd - b.qd).abs() > ATOL_QD).any(1)
            | ((a.link_obstacle_dist - b.link_obstacle_dist).abs()
               > ATOL_LINK).any(1)
            | (a.is_collided != b.is_collided))


def classify_split(one, CD, states, b, dev):
    """Replay env b of a differing pair substep by substep along both routes
    (``one`` is the collision physics at one substep) and find where they
    part.  There the env is a contact tie if the plain route's least
    distance is within 1e-4 m of 0, or an active-set near-tie by phase 3's
    perturbation test (is_near_tie) on the plain route's state.  Returns
    (substep, verdict)."""
    k_cur = p_cur = take(states, slice(b, b + 1))
    for k in range(N_SUBSTEPS):
        k_next = one(k_cur)
        p_next = one(p_cur, one.plain_substep_step)
        if not route_diff(k_next, p_next).any():
            k_cur, p_cur = k_next, p_next
            continue
        gd, td = one.substep_distances(p_next.q, p_next)
        least = min(gd[:, 1:].min().item(), td.min().item())
        if abs(least) <= ATOL_LINK:
            return k, f"contact tie (plain least distance {least:.2e} m)"
        tie, n_agree, spread = is_near_tie(
            one.motor, CD.LANES, p_cur.q, p_cur.qd, p_cur.ctrl_target, 0, dev)
        if tie:
            return k, (f"active-set near-tie (16 copies perturbed by 1e-6: "
                       f"plain spread in qd {spread:.3e}, K1 agrees on "
                       f"{n_agree})")
        return k, (f"FAIL: no tie (least distance {least:.2e} m, plain "
                   f"spread in qd {spread:.3e})")
    return None, "FAIL: the routes do not part when the env runs alone"


def hold_routes(cmp, one, CD, s_in, label, dev, card):
    """One policy step of the collision physics on both motor routes from the
    same states: K1 (one launch per substep) and the plain cold substep.
    Every env agrees within the tolerances, or at most MAX_TIES envs are
    contact ties or active-set near-ties (classify_split).  Returns the
    largest error over the agreeing envs and the plain route's time."""
    out_k = cmp(s_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = cmp(s_in, cmp.plain_substep_step)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    bad = route_diff(out_k, out_p).nonzero().flatten().tolist()
    good = torch.ones(s_in.q.shape[0], dtype=torch.bool, device=dev)
    good[bad] = False
    errs = [(out_k.q - out_p.q)[good].abs().max().item(),
            (out_k.qd - out_p.qd)[good].abs().max().item(),
            (out_k.link_obstacle_dist - out_p.link_obstacle_dist)[good]
            .abs().max().item()]
    n_coll = int(out_p.is_collided.sum())
    say(f"{label}: K1 route vs plain route, max|dq|={errs[0]:.3e} (atol "
        f"{ATOL_Q}) max|dqd|={errs[1]:.3e} (atol {ATOL_QD}) max|dlink|="
        f"{errs[2]:.3e} m (atol {ATOL_LINK}) on {int(good.sum())} envs, "
        f"collided flags equal there ({n_coll} collided); {len(bad)} "
        f"outside the tolerance; plain route {plain_s * 1e3:.1f} ms | {card}")
    if (errs[0] > ATOL_Q or errs[1] > ATOL_QD or errs[2] > ATOL_LINK
            or len(bad) > MAX_TIES):
        fail(f"{label}: the K1 route disagrees with the plain route")
    for b in bad:
        k, verdict = classify_split(one, CD, s_in, b, dev)
        say(f"  env {b}: max|dq|={(out_k.q - out_p.q)[b].abs().max().item():.3e}"
            f" max|dqd|={(out_k.qd - out_p.qd)[b].abs().max().item():.3e} "
            f"collided {bool(out_k.is_collided[b])}/"
            f"{bool(out_p.is_collided[b])}; routes part at substep {k}: "
            f"{verdict}")
        if verdict.startswith("FAIL"):
            fail(f"{label}: the K1 route disagrees with the plain route on "
                 f"env {b}")
    return max(errs[:2]), plain_s


def lcp_convergence(model, s_in, label, card):
    """Why the ReachAO route runs K1 cold: the first motor substep of a step
    solved cold with the reference's 3 refinements, and warm-seeded (a cold
    seed and one warm refinement, K1's warm mode), each held against a cold
    solve with 12 refinements; prints the envs off it by more than the qd
    tolerance."""
    from panda_gym_tpu_torch.ops import dynamics as D
    from panda_gym_tpu_torch.ops import scalarized as S

    mc = S.consts_from_model(model)
    cols = [[t[:, d] for d in range(7)]
            for t in (s_in.q, s_in.qd, s_in.ctrl_target)]

    def qd_after(iters, warm):
        saved = D.MOTOR_LCP_ITERS
        D.MOTOR_LCP_ITERS = iters
        try:
            if not warm:
                return torch.stack(S.motor_substep(mc, *cols, DT, 0)[1], -1)
            _, _, w = S.motor_substep(mc, *cols, DT, 0, return_warm=True)
            return torch.stack(S.motor_substep(mc, *cols, DT, 0, warm=w)[1],
                               -1)
        finally:
            D.MOTOR_LCP_ITERS = saved

    ref = qd_after(12, False)
    for what, qd in (("cold, 3 refinements", qd_after(3, False)),
                     ("warm-seeded", qd_after(3, True))):
        off = ((qd - ref).abs() > ATOL_QD).any(1)
        say(f"{label}: first motor substep {what}: {int(off.sum())} of "
            f"{off.numel()} envs off the 12-refinement cold solve by more "
            f"than {ATOL_QD} in qd (max {(qd - ref).abs().max().item():.3e})"
            f" | {card}")


def drive_reach_ao(make_reach_ao_core, _hi_prec, CD, name, B, n_steps, dev,
                   card):
    """Phase 7 for one scenario at batch B: the main path (batched_reset,
    the first obstacle of envs 0-7 moved onto their end effector, n_steps
    batched_step calls), K1's counts set to 0 just before and read just
    after; then the freeze checks, the two motor routes held against each
    other on the first step's states, the step's time and a profile."""
    env = make_reach_ao_core(name, device="cuda")
    phys = env.physics_step_batched
    motor = phys.motor
    picked = CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
    # a second K1 wrapper for the checks, whose launches stay out of the
    # main path's counts
    twin = CD.make_cuda_motor_steps(env.model, n_substeps=1, dt=DT,
                                    ctrl_mode=motor.ctrl_mode,
                                    warm_start=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = env.batched_reset(B, gen)
    opos = states.obstacle_pos.clone()
    opos[:N_FORCED, 0] = obs["achieved_goal"][:N_FORCED]
    states = states.replace(obstacle_pos=opos)
    acts = [torch.rand(B, env.robot.action_dim, generator=gen, device=dev)
            * 2.0 - 1.0 for _ in range(n_steps + 1 + N_TIMED)]
    s_in = _hi_prec(env.robot.set_action)(states, acts[0])

    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    frozen_q = []
    s = states
    for i in range(n_steps):
        s, obs, reward, terminated, truncated, info = env.batched_step(
            s, acts[i])
        frozen_q.append(s.q[:N_FORCED].clone())
        if i == 0:
            forced = (bool(s.is_collided[:N_FORCED].all())
                      and bool(truncated[:N_FORCED].all()))
    torch.cuda.synchronize()
    counts = dict(motor.kernel_launches)

    # the forced envs collide in the first substep: their q is that
    # substep's K1 pose, and it stays there
    q1, _ = twin.launch(s_in.q.contiguous(), s_in.qd.contiguous(),
                        s_in.ctrl_target.contiguous(), picked)
    q_lo = torch.as_tensor(env.model.q_lo, device=dev)
    q_hi = torch.as_tensor(env.model.q_hi, device=dev)
    checks = {
        "forced envs collided and truncated": forced,
        "forced envs frozen at the colliding substep's pose": all(
            torch.equal(q, q1[:N_FORCED]) for q in frozen_q),
        "obs finite": bool(torch.isfinite(obs["observation"]).all()),
        "obs shape": tuple(obs["observation"].shape) == (B, 56),
        "reward in {0, -1, -101}": bool(
            ((reward == 0) | (reward == -1) | (reward == -101)).all()),
        "q finite": bool(torch.isfinite(s.q).all()),
        "q in limits": bool(((s.q >= q_lo) & (s.q <= q_hi)).all()),
        "steps": bool((s.steps == n_steps).all()),
    }
    say(f"phase 7 main path: {name}, {n_steps} batched_step at B={B}, K1 "
        f"launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"collided {int(s.is_collided.sum())}, success rate "
        f"{info['is_success'].float().mean().item():.4f}, checks {checks}")
    if not all(checks.values()):
        fail(f"phase 7 checks of {name} at B={B} failed: {checks}")
    want = {CD.LANES: 0, CD.THREAD: 0}
    want[picked] = N_SUBSTEPS * n_steps
    if counts != want or motor.launches != N_SUBSTEPS * n_steps:
        fail(f"K1 launches on {name} at B={B} were {counts}, expected {want}")

    # the two motor routes on the first step's states
    cmp, one = copy.copy(phys), copy.copy(phys)
    cmp.motor = one.motor = twin
    one.n_substeps = 1
    err, plain_s = hold_routes(cmp, one, CD, s_in, f"phase 7 {name} B={B}",
                               dev, card)
    lcp_convergence(env.model, s_in, f"phase 7 {name} B={B}", card)

    time_reach_ao(env, s, acts[n_steps:], name, card,
                  f", the plain route {plain_s * 1e3:.1f} ms for the "
                  f"physics of one step")
    return counts, err, plain_s


def time_reach_ao(env, s, acts, name, card, note=""):
    """The ReachAO step's time: one step to warm up, then each of the
    remaining steps timed alone between two synchronizes (median, min and
    max); then one profiled step."""
    B = s.q.shape[0]
    s, *_ = env.batched_step(s, acts[0])
    ms = []
    for a in acts[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, *_ = env.batched_step(s, a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(ms))
    say(f"phase 7 {name} batched_step B={B}: median {step_ms:.1f} ms/step "
        f"over {len(ms)} steps (min {min(ms):.1f}, max {max(ms):.1f}; "
        f"{B / step_ms * 1e3:.0f} env-steps/s at the median) on the K1 "
        f"route{note} | {card}")
    profile_step(env, s, acts[:1], card, n=1, tag=f"phase 7 {name}")


def reach_ao_times(make_reach_ao_core, dev, card):
    """Phase 7's step times alone, for ``--times``."""
    for name, B, _ in REACH_AO:
        env = make_reach_ao_core(name, device="cuda")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        s, _ = env.batched_reset(B, gen)
        acts = [torch.rand(B, env.robot.action_dim, generator=gen,
                           device=dev) * 2.0 - 1.0
                for _ in range(N_TIMED + 1)]
        time_reach_ao(env, s, acts, name, card)


def k1_one_substep_times(CD, model, rng, dev, card):
    """K1 at n_substeps=1 and cold, as the ReachAO step launches it, at
    phase 7's two batches: time per launch beside the bound, and the plain
    version's time for one call.  Returns {B: (ms, plain_ms, bound_ms)}."""
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    n_ops = count_plain_ops(model, 0, n_substeps=1, warm_start=False)
    out = {}
    for _, B, _ in REACH_AO:
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        ms = time_cuda(lambda: k1(q, qd, tgt), 20, queued=True)
        plain_ms = time_cuda(lambda: k1.plain(q, qd, tgt), 1, warmup=1)
        bound = k1_bound_ms(n_ops, B)
        out[B] = (ms, plain_ms, bound)
        say(f"phase 7 K1 n_substeps=1 cold B={B}: {ms:.4f} ms/launch, bound "
            f"{bound:.6f} ms ({n_ops} fp32 ops/env counted from the plain "
            f"version), {ms / bound:.1f}x the bound; plain version "
            f"{plain_ms:.1f} ms for one call | {card}")
    return out, n_ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", metavar="ROOT",
                    help="only build, time and profile the port of the "
                         "checkout at ROOT")
    args = ap.parse_args()
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    root = os.path.abspath(args.times or os.path.dirname(__file__))
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
    for name, (n_ins, loops) in sass_loops(lib._name,
                                           _build.nvcc_path()).items():
        say(f"phase 2 SASS {name}: {n_ins} instructions, largest loops "
            f"{loops[:4]}")
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    rng = np.random.default_rng(SEED)
    if args.times:
        say(f"times of the port in {root}")
        k1_times(CD, model, rng, dev, card, each_kernel=False)
        step_times(make_core, dev, card)
        try:
            from panda_gym_tpu_torch.envs.tasks.reach_ao import (
                make_reach_ao_core)
        except ImportError:
            say(f"phase 7: no ReachAO in {root}")
        else:
            reach_ao_times(make_reach_ao_core, dev, card)
        print(card, flush=True)
        return 0
    for lanes in (CD.LANES, CD.THREAD):
        occ = CD.occupancy(dev.index, lanes)
        say(f"phase 2 occupancy, {KERNEL_NAMES[lanes]} kernel: {occ['regs']} "
            f"registers/thread, {occ['local_bytes']} bytes local "
            f"memory/thread, {occ['blocks_per_sm']} blocks of "
            f"{occ['threads_per_block']} threads ({occ['warps_per_sm']} "
            f"warps) resident per SM")
    say(f"phase 2 dispatch: the lane-group kernel up to "
        f"{CD.lanes_wave(dev.index)} envs (one wave on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs), "
        f"one env per thread past it")

    # ---------------------------------------------------------------- 3
    err = {CD.LANES: 0.0, CD.THREAD: 0.0}
    plain_ms = {}
    for ctrl_mode in (0, 1):
        k1 = reach_k1(CD, model, ctrl_mode)
        for B in (1, B_MAIN, B_MAIN + 4, B_BENCH):
            q, qd, tgt = motor_inputs(model, B, ctrl_mode, rng, dev)
            if B == B_BENCH:
                plain_ms[B] = check_at_bench(CD, k1, q, qd, tgt, dev, err)
                continue
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            qp, qdp = k1.plain(q, qd, tgt)
            t1.record()
            torch.cuda.synchronize()
            if ctrl_mode == 0:
                plain_ms[B] = t0.elapsed_time(t1)
            for lanes in (CD.LANES, CD.THREAD):
                qk, qdk = k1.launch(q, qd, tgt, lanes)
                torch.cuda.synchronize()
                eq = (qk - qp).abs().max().item()
                eqd = (qdk - qdp).abs().max().item()
                ok = eq <= ATOL_Q and eqd <= ATOL_QD
                say(f"phase 3 K1 {KERNEL_NAMES[lanes]} vs plain: "
                    f"ctrl_mode={ctrl_mode} B={B} max|dq|={eq:.3e} (atol "
                    f"{ATOL_Q}) max|dqd|={eqd:.3e} (atol {ATOL_QD}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad = ((qk - qp).abs() > ATOL_Q).any(1) | (
                        (qdk - qdp).abs() > ATOL_QD).any(1)
                    fail(f"K1 ({KERNEL_NAMES[lanes]}) disagrees with its "
                         f"plain version on {int(bad.sum())} of {B} envs")
                err[lanes] = max(err[lanes], eq, eqd)

    # ---------------------------------------------------------------- 4
    launches = {}
    for B, n_steps in ((B_MAIN, N_STEPS), (B_BENCH, N_STEPS_BENCH)):
        counts, e = drive(make_core, _hi_prec, CD, B, n_steps, dev)
        for lanes, n in counts.items():
            if n:
                launches[lanes] = (B, n)
                err[lanes] = max(err[lanes], e)
    if set(launches) != {CD.LANES, CD.THREAD}:
        fail(f"a K1 kernel was launched on no main path: {launches}")

    # ---------------------------------------------------------------- 5
    times, n_ops = k1_times(CD, model, rng, dev, card, each_kernel=True)
    for B, ms in plain_ms.items():
        if B in (B_MAIN, B_BENCH):
            say(f"phase 5 plain version B={B}: {ms:.1f} ms for one call "
                f"| {card}")
    say("phase 5 library: no single PyTorch call computes K1's function")
    step_times(make_core, dev, card)

    # ---------------------------------------------------------------- 7
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    ao_launches, ao_err = {}, {}
    for name, B, n_steps in REACH_AO:
        counts, ao_err[B], _ = drive_reach_ao(
            make_reach_ao_core, _hi_prec, CD, name, B, n_steps, dev, card)
        ao_launches[B] = sum(counts.values())
    served = {CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
              for _, B, _ in REACH_AO}
    if served != {CD.LANES, CD.THREAD}:
        fail(f"phase 7: the two ReachAO batches did not run both K1 kernels")
    ao_times, ao_ops = k1_one_substep_times(CD, make_panda_model(), rng, dev,
                                            card)

    rows = []
    for lanes, tag in ((CD.LANES, "lanes"), (CD.THREAD, "thread")):
        B, n = launches[lanes]
        rows.append({
            "name": f"K1 motor_steps_{tag}_kernel (B={B})", "route": "cuda",
            "source": "panda_gym_tpu_torch/ops/csrc/motor_steps.cu",
            "replaces": "panda_gym_tpu/ops/pallas_dynamics.py:96",
            "launches": n, "max_abs_err": err[lanes],
            "ms": times[B, lanes], "plain_ms": plain_ms[B],
            "bound_ms": k1_bound_ms(n_ops, B),
            "bound_by": "operations" if float(n_ops) / PEAK_FP32_OPS
            > 140.0 / PEAK_BYTES else "bytes",
            "library_ms": None,
        })
    B_AO = REACH_AO[-1][1]
    ms, p_ms, bound = ao_times[B_AO]
    rows.append({
        "name": f"K1 at n_substeps=1, cold, on the ReachAO collision step, "
                f"{KERNEL_NAMES[CD.THREAD]} (B={B_AO})", "route": "cuda",
        "source": "panda_gym_tpu_torch/ops/csrc/motor_steps.cu",
        "replaces": "panda_gym_tpu/ops/pallas_dynamics.py:96",
        "launches": ao_launches[B_AO], "max_abs_err": ao_err[B_AO],
        "ms": ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": "operations" if float(ao_ops) / PEAK_FP32_OPS
        > 140.0 / PEAK_BYTES else "bytes",
        "library_ms": None,
    })
    say(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

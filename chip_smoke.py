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
     K1 at n_substeps=1 beside its bound;
  8. training: Trainer.learn (TQC + HER, the TQC preset at full width:
     [256, 256], 25 quantiles, 2 critics, batch 256, gSDE) on reachao1 at
     n_envs = 64, cut to 3840 env steps of horizon 20 (a collect rollout and
     its burst of 160 updates, then fused rollouts with 8 updates after each
     env step), one evaluation, full-state checkpoints every 1280 steps,
     in a temporary run directory; checks: K1 rose by 20 launches per env
     step of every rollout and the evaluation, all on the lane-group kernel,
     the learner's step equals the schedule's update count, losses, alpha
     and parameters are finite and on the card with the buffer, the last
     full-state checkpoint reloads (load_checkpoint, load_full) equal to the
     live state, best_model.ckpt exists; the trained state copied to the
     CPU: one HER batch from the same draws equal on both devices, and one
     TQC update from the same state, batch and noise within rtol 1e-4
     (losses, alpha) and rtol 1e-4 / atol 1e-6 (every gradient); K1 held
     against its plain version on a training step's states; then ms per
     collect and per fused env step, training env-steps/s, ms per TQC
     update (CUDA events, median of 50), launches and busy share of one
     profiled update and one fused env step, and K1 at one cold substep at
     B = 64 and 512 beside its bound;
  9. evaluation: the routed generalist (17 squashed-Gaussian members
     [256, 256], x_dim 62, a router 62 -> 128 -> 128 -> 10) from the port's
     asset copy under its training config, through perform_benchmark's
     parts (batched_reset, run_episodes, summarize) at 64 episodes and
     horizon 100, on reachao1 and on narrow_tunnel (its starts IK'd from
     ik_range targets by the batched dls_ik); checks: K1 rose by exactly
     20 launches per eval step, all on the lane-group kernel, every start
     lies in the joint limits and either clears the obstacles by more than
     0.05 and the table by more than 0 or is the neutral fallback (whose
     share is printed), the rates lie in [0, 1] and sum to 1, success is at
     least 0.85 on both scenes (the JAX package's: 0.98 and 1.00), and the
     routed action on one obs batch agrees between the card and the CPU
     (rtol 1e-5, atol 1e-6; choices equal where the router's top two
     logits differ by more than 1e-5); K1 is held against its plain version
     on an eval step's states; then ms per eval step (median, least and
     most), ms per reset with its IK, episodes/s and one profiled eval
     step's launches and busy share.

The line before the last is one JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero before
those lines.  Imports torch, numpy, the standard library and the port only.

``--times ROOT`` runs phases 1, 2, 5 and 6 only (K1 as the wrapper picks
it, no plain version), phase 7's step times where ROOT has ReachAO, and
phase 8's env-step and update times (a 2560-step run) where ROOT has the
trainer, on
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
import tempfile
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


def k1_one_substep_times(CD, model, rng, dev, card, batches,
                         label="phase 7"):
    """K1 at n_substeps=1 and cold, as the ReachAO step launches it, at the
    given batches: time per launch beside the bound, and the plain
    version's time for one call.  Returns {B: (ms, plain_ms, bound_ms)}."""
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    n_ops = count_plain_ops(model, 0, n_substeps=1, warm_start=False)
    out = {}
    for B in batches:
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        ms = time_cuda(lambda: k1(q, qd, tgt), 20, queued=True)
        plain_ms = time_cuda(lambda: k1.plain(q, qd, tgt), 1, warmup=1)
        bound = k1_bound_ms(n_ops, B)
        out[B] = (ms, plain_ms, bound)
        say(f"{label} K1 n_substeps=1 cold B={B}: {ms:.4f} ms/launch, bound "
            f"{bound:.6f} ms ({n_ops} fp32 ops/env counted from the plain "
            f"version), {ms / bound:.1f}x the bound; plain version "
            f"{plain_ms:.1f} ms for one call | {card}")
    return out, n_ops


# ------------------------------------------------------------------ phase 8
# TQC + HER training on reachao1 through the Trainer, at the trainer's
# n_envs = 64 (THROUGHPUT_r05.json, equal_budget) and the TQC preset's full
# width (rl/config.py); only the depth is cut: 3840 env steps, three
# rollouts of 64 x 20 when no episode ends early
N_ENVS = 64
HORIZON = 20
TRAIN_STEPS = 3840
# K1 at one cold substep, at the trainer's two batches
B_TRAIN = (N_ENVS, 512)
# the learner on the card against the CPU
RTOL_LEARN, ATOL_GRAD = 1e-4, 1e-6
N_UPDATE_TIMED = 50


def train_config(max_timesteps=None):
    """The smoke run's TrainConfig: learning starts at max_timesteps // 4,
    the interleave gate opens at 640 stored transitions (even when
    collisions end episodes early), one evaluation (at the last rollout)
    and a full-state checkpoint every 1280 steps.  No benchmark scenes:
    phase 9 drives the evaluation."""
    from panda_gym_tpu_torch.rl.config import TrainConfig
    max_timesteps = max_timesteps or TRAIN_STEPS
    return TrainConfig(
        n_envs=N_ENVS, stages=["reachao1"], max_ep_steps=[HORIZON],
        max_timesteps=max_timesteps, learning_starts=TRAIN_STEPS // 3,
        interleave_min_buffer=TRAIN_STEPS // 6, eval_freq=max_timesteps,
        n_eval_episodes=N_ENVS, full_ckpt_freq=TRAIN_STEPS // 3,
        benchmark_eval_scenes=[])


def run_trainer(cfg, dev, run_root, CD=None):
    """Trainer.learn() on the card, the envs built by make_reach_ao_core as
    the CLI builds them; K1's counts are set to 0 as the env is made, just
    before the run.  Returns (trainer, core, seconds)."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.train import Trainer

    cores = []

    def make_env(sc, thr, spd):
        core = make_reach_ao_core(sc, config=cfg, ee_error_threshold=thr,
                                  speed_threshold=spd, device=dev.type)
        motor = core.physics_step_batched.motor
        motor.launches = 0
        if CD is not None:
            motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
        cores.append(core)
        return core

    logger = RunLogger(group="chip_smoke", name="phase8", config=cfg,
                       root=run_root)
    trainer = Trainer(cfg, make_env, logger=logger)
    t0 = time.perf_counter()
    trainer.learn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    logger.close()
    return trainer, cores[0], seconds


def rollout_rows(trainer):
    """The rollout rows, split: collect-only, collect + one burst, fused."""
    rows = [r for r in trainer.metrics.history if "rollout_reward" in r]
    fused = [r for r in rows if "critic_loss" in r and r["t_update"] == 0.0]
    burst = [r for r in rows if r["t_update"] > 0.0]
    return rows, burst, fused


def train_step_times(trainer, seconds, card):
    """ms per collect and per fused env step from the rollout rows (host
    clock; each rollout ends in a read of its lengths, a synchronize), and
    training env-steps/s over the whole run."""
    from panda_gym_tpu_torch.rl.train import schedule

    rows, _, fused = rollout_rows(trainer)
    coll = [r for r in rows if r not in fused]
    n_upd = schedule(trainer.config, HORIZON).n_upd_per_step
    for name, rs in (("collect", coll),
                     (f"fused ({n_upd} updates after each)", fused)):
        ms = [r["t_collect"] * 1e3 / HORIZON for r in rs]
        say(f"phase 8 {name} env step at B={N_ENVS}: "
            f"{', '.join(f'{m:.1f}' for m in ms)} ms per env step over "
            f"{len(ms)} rollouts of {HORIZON} | {card}")
    say(f"phase 8 training: {trainer.timesteps} env steps in {seconds:.2f} s"
        f", {trainer.timesteps / seconds:.1f} env-steps/s (evaluation, "
        f"checkpoints and set-up included) | {card}")


def profile_once(fn, label, card):
    """fn once under torch.profiler: its launches, the card's busy share of
    the wall time and the kernels that take most.  Returns (launches,
    busy us, wall us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the optimizers' record_function ranges appear on the device timeline
    # as user annotations spanning their kernels: not kernels themselves
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        fail(f"{label} profile: the profiler saw no device time")
    n_launch = sum(e.count for e in kernels)
    say(f"{label}: wall {wall_us:.0f} us, card busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch} kernel launches | "
        f"{card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        say(f"  {e.self_device_time_total:9.1f} us {e.count:5d}x  "
            f"{e.key[:90]}")
    return n_launch, busy_us, wall_us


def update_times(trainer, core, card):
    """ms per TQC update (CUDA events around each, the median of 50 after 5
    of warm-up), alone and with its HER sample; one profiled update and one
    profiled fused env step (the env step and its burst of 8 updates)."""
    from panda_gym_tpu_torch.rl import her
    from panda_gym_tpu_torch.rl.train import VectorEnv, learner_batch, schedule

    learner, ts, buf, gen = (trainer.learner, trainer.ts, trainer.buffer,
                             trainer.generator)
    sched = schedule(trainer.config, HORIZON)
    bs = sched.batch_size
    rf = trainer._reward_fn(core)
    batch = learner_batch(her.sample(buf, gen, bs, rf))
    noise = learner.update_noise(gen, bs)

    def timed(fn):
        for _ in range(5):
            fn()
        ms = []
        for _ in range(N_UPDATE_TIMED):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return float(np.median(ms)), min(ms), max(ms)

    upd = timed(lambda: learner.update(ts, batch, noise))
    burst = timed(lambda: trainer.update_burst(ts, buf, gen, 1, bs, rf))
    say(f"phase 8 TQC update (batch {bs}, net_arch "
        f"{list(learner.net_arch)}, {learner.N_QUANTILES} quantiles x "
        f"{learner.n_critics} critics): median {upd[0]:.3f} ms (min "
        f"{upd[1]:.3f}, max {upd[2]:.3f}) over {N_UPDATE_TIMED}; with its "
        f"HER sample {burst[0]:.3f} ms (min {burst[1]:.3f}, max "
        f"{burst[2]:.3f}) | {card}")
    n_upd, busy_upd, wall_upd = profile_once(
        lambda: learner.update(ts, batch, noise),
        "phase 8 profile of one TQC update", card)

    venv = VectorEnv(core, N_ENVS, HORIZON)
    states, obs = venv.batch_reset(gen)
    dev = states.q.device
    done = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
    ep_len = torch.zeros(N_ENVS, dtype=torch.int32, device=dev)
    expl = learner.sample_expl(ts, gen, N_ENVS)

    def fused_step():
        venv.env_step(learner, ts, states, obs, done, ep_len, gen, False, expl)
        trainer.update_burst(ts, buf, gen, sched.n_upd_per_step, bs, rf)

    fused_step()
    n_step, busy_step, wall_step = profile_once(
        fused_step, f"phase 8 profile of one fused env step at B={N_ENVS} "
                    f"({sched.n_upd_per_step} updates)", card)
    return dict(update_ms=upd[0], update_launches=n_upd,
                update_busy=busy_upd / wall_upd, step_launches=n_step,
                step_busy=busy_step / wall_step)


def drive_training(CD, dev, card, run_root):
    """Phase 8: the trainer's main path on the card and its checks, the
    learner held against the CPU, then the times."""
    from panda_gym_tpu_torch.rl.checkpoint import CheckpointManager, load_checkpoint
    from panda_gym_tpu_torch.rl.learners import named_state, save_state
    from panda_gym_tpu_torch.rl.train import Trainer, schedule

    cfg = train_config()
    trainer, core, seconds = run_trainer(cfg, dev, run_root, CD)
    motor = core.physics_step_batched.motor
    counts = dict(motor.kernel_launches)
    sched = schedule(cfg, HORIZON)
    rows, burst, fused = rollout_rows(trainer)
    n_evals = sum("eval_success" in r for r in trainer.metrics.history)
    eval_rounds = n_evals * -(-cfg.n_eval_episodes // N_ENVS)
    env_steps = HORIZON * (len(rows) + eval_rounds)
    want_updates = (len(burst) * sched.updates_per_rollout
                    + len(fused) * HORIZON * sched.n_upd_per_step)
    ts, buf = trainer.ts, trainer.buffer
    state = named_state(ts)
    run_dir = trainer.logger.dir
    latest = CheckpointManager(os.path.join(run_dir, "full_state")).latest()
    payload = load_checkpoint(latest) if latest else None
    resumed = Trainer(cfg, None)
    if latest:
        resumed.load_full(os.path.join(run_dir, "full_state"))
    live = save_state(ts)
    metrics = [v for r in rows for k, v in r.items()
               if k in ("critic_loss", "actor_loss", "alpha")]
    checks = {
        "K1: 20 launches per env step, all on the lane-group kernel":
            counts == {CD.LANES: N_SUBSTEPS * env_steps, CD.THREAD: 0}
            and motor.launches == N_SUBSTEPS * env_steps,
        "a collect rollout, a burst and a fused rollout":
            len(rows) > len(fused) > 0 and len(burst) > 0,
        "one evaluation": n_evals == 1,
        "learner step equals the schedule's update count":
            ts.step == want_updates,
        "losses and alpha finite": bool(metrics) and all(
            np.isfinite(v) for v in metrics),
        "parameters finite": all(bool(torch.isfinite(v).all())
                                 for k, v in state.items()),
        "learner and buffer on cuda": all(
            v.device.type == "cuda" for k, v in state.items()
            if "_opt/" not in k or not k.endswith("/step"))
            and all(getattr(buf, k).device.type == "cuda"
                    for k in ("obs", "achieved", "desired", "action", "aux",
                              "ep_len", "terminated")),
        "full-state checkpoint equals the live state": payload is not None
            and resumed._resume is not None
            and resumed.timesteps == trainer.timesteps
            and all(torch.equal(payload["ts"]["tensors"][k], v)
                    and torch.equal(resumed._resume["ts"]["tensors"][k], v)
                    for k, v in live["tensors"].items())
            and payload["ts"]["step"] == ts.step
            and all(torch.equal(payload["buffer"]["tensors"][k],
                                getattr(buf, k).cpu())
                    for k in payload["buffer"]["tensors"])
            and torch.equal(payload["generator"],
                            trainer.generator.get_state()),
        "best_model.ckpt": os.path.exists(os.path.join(run_dir,
                                                       "best_model.ckpt")),
    }
    say(f"phase 8 main path: Trainer.learn on reachao1 at n_envs={N_ENVS}, "
        f"{len(rows)} rollouts ({len(rows) - len(fused)} collect, "
        f"{len(burst)} followed by a burst of {sched.updates_per_rollout}, "
        f"{len(fused)} fused with {sched.n_upd_per_step} updates per env "
        f"step) and {eval_rounds} evaluation rollout(s): {env_steps} env "
        f"steps, K1 launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}"
        f", {ts.step} updates, {trainer.timesteps} transitions, eval success "
        f"{[r['eval_success'] for r in trainer.metrics.history if 'eval_success' in r]}"
        f", checks {checks}")
    if not all(checks.values()):
        fail(f"phase 8 checks failed: {checks}")
    learner_vs_cpu(trainer, core, card)
    train_step_times(trainer, seconds, card)
    times = update_times(trainer, core, card)
    return counts[CD.LANES], core, times


def learner_vs_cpu(trainer, core, card):
    """The trained state copied to the CPU: one HER batch from the same
    draws on both devices must be equal, and one TQC update from the same
    state, batch and noise must agree (losses and alpha rtol 1e-4, every
    gradient rtol 1e-4 and atol 1e-6; gradients, not the new parameters:
    Adam maps each gradient element to about +-lr, so one at the rounding
    level may flip by 2 lr)."""
    from panda_gym_tpu_torch.rl import her
    from panda_gym_tpu_torch.rl.learners import load_state, make_learner, save_state
    from panda_gym_tpu_torch.rl.train import learner_batch

    learner, ts, buf, gen = (trainer.learner, trainer.ts, trainer.buffer,
                             trainer.generator)
    cfg = trainer.config
    cpu = make_learner(cfg.algorithm, learner.obs_dim, learner.act_dim,
                       cfg.hyperparams, "cpu")
    ts_cpu = load_state(cpu.init(torch.Generator().manual_seed(0)),
                        save_state(ts))
    buf_cpu = buf.to("cpu")
    rf = trainer._reward_fn(core)
    bs = cfg.hyperparams.batch_size
    draws = her.draw(buf, gen, bs)
    b_card = her.gather(buf, draws, rf)
    b_cpu = her.gather(buf_cpu, {k: v.cpu() for k, v in draws.items()}, rf)
    same = {k: torch.equal(b_card[k].cpu(), b_cpu[k]) for k in b_card}
    say(f"phase 8 HER batch of {bs} on the card and on the CPU from the same "
        f"draws: equal {same}")
    if not all(same.values()):
        fail(f"the HER batch differs between the card and the CPU: {same}")
    noise = learner.update_noise(gen, bs)
    _, m_card = learner.update(ts, learner_batch(b_card), noise)
    _, m_cpu = cpu.update(ts_cpu, learner_batch(b_cpu),
                          tuple(n.cpu() for n in noise))
    worst = {}
    for k in ("critic_loss", "actor_loss", "alpha"):
        a, b = float(m_card[k]), float(m_cpu[k])
        worst[k] = abs(a - b) / max(abs(b), 1e-30)
    grads = {}
    for name in ("actor", "critic"):
        for (n, p), (_, q) in zip(getattr(ts, name).named_parameters(),
                                  getattr(ts_cpu, name).named_parameters()):
            grads[f"{name}.{n}"] = (p.grad.cpu(), q.grad)
    grads["log_alpha"] = (ts.log_alpha.grad.cpu(), ts_cpu.log_alpha.grad)
    over = {k: int(((a - b).abs() > ATOL_GRAD + RTOL_LEARN * b.abs()).sum())
            for k, (a, b) in grads.items()}
    err = max((a - b).abs().max().item() for a, b in grads.values())
    say(f"phase 8 one TQC update, card vs CPU: relative differences "
        f"{ {k: f'{v:.2e}' for k, v in worst.items()} } (rtol {RTOL_LEARN}); "
        f"gradients of {len(grads)} tensors, max |d| {err:.3e}, elements "
        f"outside rtol {RTOL_LEARN} atol {ATOL_GRAD}: {sum(over.values())} "
        f"| {card}")
    if max(worst.values()) > RTOL_LEARN or any(over.values()):
        fail(f"the TQC update on the card disagrees with the CPU: {worst}, "
             f"{ {k: v for k, v in over.items() if v} }")


def k1_train_error(CD, core, dev):
    """K1 at one cold substep against its plain version on one training
    step's states at B = N_ENVS (a second wrapper, whose launches stay out
    of the main path's counts).  Returns the largest error."""
    from panda_gym_tpu_torch.envs.core import _hi_prec

    motor = core.physics_step_batched.motor
    twin = CD.make_cuda_motor_steps(core.model, n_substeps=1, dt=DT,
                                    ctrl_mode=motor.ctrl_mode,
                                    warm_start=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, _ = core.batched_reset(N_ENVS, gen)
    a = torch.rand(N_ENVS, core.robot.action_dim, generator=gen,
                   device=dev) * 2.0 - 1.0
    s_in = _hi_prec(core.robot.set_action)(states, a)
    x = (s_in.q.contiguous(), s_in.qd.contiguous(),
         s_in.ctrl_target.contiguous())
    qk, qdk = twin(*x)
    qp, qdp = twin.plain(*x)
    eq = (qk - qp).abs().max().item()
    eqd = (qdk - qdp).abs().max().item()
    say(f"phase 8 K1 n_substeps=1 cold vs plain on a training step's states "
        f"at B={N_ENVS}: max|dq|={eq:.3e} (atol {ATOL_Q}) max|dqd|="
        f"{eqd:.3e} (atol {ATOL_QD})")
    if eq > ATOL_Q or eqd > ATOL_QD:
        fail("K1 disagrees with its plain version on the training states")
    return max(eq, eqd)


# ------------------------------------------------------------------ phase 9
# evaluation of the routed generalist, the repo's headline policy, on the
# 13-scene protocol's first scene and on one whose starts are IK'd; cut in
# depth only (64 episodes, horizon 100, where the protocol runs 100 and 300)
EVAL_SCENES = ("reachao1", "narrow_tunnel")
EVAL_EPISODES = 64
EVAL_HORIZON = 100
EVAL_MIN_SUCCESS = 0.85
# the routed action on the card against the CPU
RTOL_ACT, ATOL_ACT, ROUTER_TIE = 1e-5, 1e-6, 1e-5


def routed_vs_cpu(policy, npz, x, card):
    """The routed action and the router's choice on one obs batch, on the
    card and on the CPU.  Returns the largest action difference."""
    from panda_gym_tpu_torch.eval.router import (load_routed_policy,
                                                 routed_action)

    cpu, _ = load_routed_policy(npz, "cpu")
    a_card, c_card = routed_action(policy, x, return_choice=True)
    a_cpu, c_cpu = routed_action(cpu, x.cpu(), return_choice=True)
    top2 = torch.topk(cpu.router(x.cpu()), 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > ROUTER_TIE
    d = (a_card.cpu() - a_cpu).abs()
    over = int((d > ATOL_ACT + RTOL_ACT * a_cpu.abs()).sum())
    same = bool(torch.equal(c_card.cpu()[clear], c_cpu[clear]))
    say(f"phase 9 routed action on {x.shape[0]} observations, card vs CPU: "
        f"max |d| {d.max().item():.3e}, {over} elements outside rtol "
        f"{RTOL_ACT} atol {ATOL_ACT}; choices equal on the {int(clear.sum())}"
        f" without a near-tie: {same} ({len(set(c_cpu.tolist()))} "
        f"controllers chosen) | {card}")
    if over or not same:
        fail("the routed action on the card disagrees with the CPU")
    return d.max().item()


def k1_eval_error(CD, core, s_in):
    """K1 at one cold substep against its plain version on an eval step's
    states (a second wrapper, whose launches stay out of the main path's
    counts).  Returns the largest error."""
    motor = core.physics_step_batched.motor
    twin = CD.make_cuda_motor_steps(core.model, n_substeps=1, dt=DT,
                                    ctrl_mode=motor.ctrl_mode,
                                    warm_start=False)
    x = (s_in.q.contiguous(), s_in.qd.contiguous(),
         s_in.ctrl_target.contiguous())
    qk, qdk = twin(*x)
    qp, qdp = twin.plain(*x)
    eq = (qk - qp).abs().max().item()
    eqd = (qdk - qdp).abs().max().item()
    say(f"phase 9 K1 n_substeps=1 cold vs plain on an eval step's states at "
        f"B={x[0].shape[0]}: max|dq|={eq:.3e} (atol {ATOL_Q}) max|dqd|="
        f"{eqd:.3e} (atol {ATOL_QD})")
    if eq > ATOL_Q or eqd > ATOL_QD:
        fail("K1 disagrees with its plain version on the eval states")
    return max(eq, eqd)


def drive_eval(CD, root, dev, card):
    """Phase 9: for each scene, the reset (timed, with its IK) and its start
    checks, the main path (run_episodes with the routed policy, K1's counts
    set to 0 just before and read just after; each eval step timed from one
    policy call to the next, a synchronize in between), the results and
    their checks, K1 against its plain version, one profiled eval step;
    then the routed action on the card against the CPU.  Returns (K1
    launches over both scenes, the largest K1 error)."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.eval import benchmark as EB
    from panda_gym_tpu_torch.eval.cli import make_core_fn
    from panda_gym_tpu_torch.eval.router import (RoutedLearner,
                                                 load_routed_policy)
    from panda_gym_tpu_torch.rl.logging_utils import load_config
    from panda_gym_tpu_torch.rl.networks import flatten_obs

    asset = os.path.join(root, "panda_gym_tpu_torch", "assets", "routed_gen")
    npz = os.path.join(asset, "routed_policy.npz")
    policy, meta = load_routed_policy(npz, dev)
    with open(os.path.join(asset, "benchmark.json")) as f:
        reference = json.load(f)
    make_core = make_core_fn(load_config(os.path.join(asset, "config.json")),
                             dev)
    act = EB.make_policy(RoutedLearner(), [policy])
    launches, k1_err, xs = 0, 0.0, []
    for sc in EVAL_SCENES:
        core = make_core(sc)
        motor = core.physics_step_batched.motor
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, obs = core.batched_reset(EVAL_EPISODES, gen)
        torch.cuda.synchronize()
        reset_ms = (time.perf_counter() - t0) * 1e3
        xs.append(flatten_obs(obs))
        q = states.q
        neutral = torch.as_tensor(core.robot.neutral, device=dev)
        is_neutral = (q == neutral).all(1)
        clear = core.task.robot_pose_mask(core, states, q[:, None])[:, 0]
        in_limits = bool(((q >= torch.as_tensor(core.model.q_lo, device=dev))
                          & (q <= torch.as_tensor(core.model.q_hi,
                                                  device=dev))).all())

        marks = []

        def timed_policy(x):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return act(x)

        motor.launches = 0
        motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
        t0 = time.perf_counter()
        done, ep_len, m = EB.run_episodes(core, timed_policy, states, obs,
                                          EVAL_HORIZON)
        res = EB.summarize(ep_len, m, core.n_substeps)
        run_s = time.perf_counter() - t0
        counts = dict(motor.kernel_launches)
        n_steps = m["active"].shape[0]
        launches += motor.launches
        rates = [res[k] for k in ("success_rate", "collision_rate",
                                  "timeout_rate")]
        checks = {
            "K1: 20 launches per eval step, all on the lane-group kernel":
                counts == {CD.LANES: N_SUBSTEPS * n_steps, CD.THREAD: 0}
                and motor.launches == N_SUBSTEPS * n_steps,
            "starts in the joint limits": in_limits,
            "starts clear (obstacles > 0.05, table > 0) or neutral": bool(
                (clear | is_neutral).all()),
            "rates in [0, 1], summing to 1": all(0 <= r <= 1 for r in rates)
                and abs(sum(rates) - 1.0) < 1e-9,
            f"success >= {EVAL_MIN_SUCCESS}":
                res["success_rate"] >= EVAL_MIN_SUCCESS,
            "metrics finite": all(np.isfinite(v) for v in res.values()),
        }
        ms = np.diff(marks) * 1e3
        say(f"phase 9 main path: {sc}, routed generalist, {EVAL_EPISODES} "
            f"episodes, {n_steps} of {EVAL_HORIZON} eval steps (every "
            f"episode ended: {bool(done.all())}), K1 launches "
            f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}; starts: "
            f"{int(is_neutral.sum())} of {EVAL_EPISODES} neutral (fallback "
            f"share {is_neutral.float().mean().item():.3f}), "
            f"{int(clear.sum())} clear; success {res['success_rate']:.4f} "
            f"collision {res['collision_rate']:.4f} timeout "
            f"{res['timeout_rate']:.4f} mean_ep_length "
            f"{res['mean_ep_length']:.2f} (JAX package, 100 episodes, "
            f"horizon 300: success {reference[sc]['success_rate']}, "
            f"mean_ep_length {reference[sc]['mean_ep_length']}); checks "
            f"{checks}")
        if not all(checks.values()):
            fail(f"phase 9 checks of {sc} failed: {checks}")
        say(f"phase 9 {sc} times: eval step median {np.median(ms):.1f} ms "
            f"(least {ms.min():.1f}, most {ms.max():.1f}, over {len(ms)} "
            f"steps, policy to policy); reset with its IK {reset_ms:.1f} ms;"
            f" {EVAL_EPISODES / (run_s + reset_ms / 1e3):.1f} episodes/s "
            f"(reset and {n_steps} eval steps in "
            f"{run_s + reset_ms / 1e3:.2f} s) | {card}")

        s_in = _hi_prec(core.robot.set_action)(states, act(xs[-1]))
        k1_err = max(k1_err, k1_eval_error(CD, core, s_in))
        profile_once(lambda: EB.run_episodes(core, act, states, obs, 1),
                     f"phase 9 profile of one eval step ({sc}, "
                     f"B={EVAL_EPISODES}: policy, batched_step, metrics)",
                     card)
    routed_vs_cpu(policy, npz, torch.cat(xs), card)
    return launches, k1_err


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
        try:
            from panda_gym_tpu_torch.rl import train  # noqa: F401
        except ImportError:
            say(f"phase 8: no trainer in {root}")
        else:
            with tempfile.TemporaryDirectory() as run_root:
                trainer, core, seconds = run_trainer(
                    train_config(TRAIN_STEPS * 2 // 3), dev, run_root)
                train_step_times(trainer, seconds, card)
                update_times(trainer, core, card)
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
    ao_times, ao_ops = k1_one_substep_times(
        CD, make_panda_model(), rng, dev, card, [B for _, B, _ in REACH_AO])

    # ---------------------------------------------------------------- 8
    with tempfile.TemporaryDirectory() as run_root:
        train_launches, train_core, _ = drive_training(CD, dev, card,
                                                       run_root)
    train_err = k1_train_error(CD, train_core, dev)
    tr_times, _ = k1_one_substep_times(CD, make_panda_model(), rng, dev,
                                       card, B_TRAIN, "phase 8")

    # ---------------------------------------------------------------- 9
    eval_launches, eval_err = drive_eval(CD, root, dev, card)

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
    ms, p_ms, bound = tr_times[N_ENVS]
    rows.append({
        "name": f"K1 at n_substeps=1, cold, on the training path (Trainer on "
                f"reachao1), {KERNEL_NAMES[CD.LANES]} (B={N_ENVS})",
        "route": "cuda",
        "source": "panda_gym_tpu_torch/ops/csrc/motor_steps.cu",
        "replaces": "panda_gym_tpu/ops/pallas_dynamics.py:96",
        "launches": train_launches, "max_abs_err": train_err,
        "ms": ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": "operations" if float(ao_ops) / PEAK_FP32_OPS
        > 140.0 / PEAK_BYTES else "bytes",
        "library_ms": None,
    })
    ms, p_ms, bound = tr_times[EVAL_EPISODES]
    rows.append({
        "name": f"K1 at n_substeps=1, cold, on the evaluation path (the "
                f"routed generalist through perform_benchmark on "
                f"{' and '.join(EVAL_SCENES)}), {KERNEL_NAMES[CD.LANES]} "
                f"(B={EVAL_EPISODES})",
        "route": "cuda",
        "source": "panda_gym_tpu_torch/ops/csrc/motor_steps.cu",
        "replaces": "panda_gym_tpu/ops/pallas_dynamics.py:96",
        "launches": eval_launches, "max_abs_err": eval_err,
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

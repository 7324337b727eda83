#!/usr/bin/env python3
"""Smoke run of the PyTorch port (panda_gym_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --times ROOT

K1, the motor dynamics, is two kernels of one source: the lane-group kernel
(8 lanes per env) and the one-env-per-thread kernel; the wrapper picks one
from B and the card for the welded Panda, and runs the one-env-per-thread
kernel, built for each chain, for MyCobot and the 9-dof Panda.  Phases, one progress line each:
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

  10. the NEO prior and the ee/pcc control modes, every path through K1:
     a. Reach under ee at B = 4096 (10 steps) and 65536 (3), and under pcc
        at 4096 (10), through phase 4's main path and checks (K1 once per
        step on the kernel the wrapper picks, the first two steps against
        the plain physics by phase 4's rule); the ee IK targets of the
        first step on the card against the CPU (atol 1e-5); ms per step and
        a profile;
     b. NEO alone at B = 64 and 4096 on reachao1 (1 sphere), tunnel (3
        boxes) and industrial (16 boxes), env 0 with an obstacle ~0.1 m from
        its end effector: the card against the CPU (atol 1e-4), ms per call
        (CUDA events over 10), the operations counted on the CPU and one
        profiled call's launches and busy share;
     c. reachao1 with the prior observation at B = 4096, 3 steps: K1 rose
        by 20 per step, the observation's last 7 entries are NEO on the
        post-step states; the step's time (median of 10) and a profile;
     d. Trainer.learn under tqc_ft2_tunnel's configuration (TQC at full
        width, n_envs 64, tunnel), cut to one bootstrap rollout and the
        collect rollouts of horizon 20 that 640 env steps take: the
        bootstrap ran on an empty buffer before any update, K1 rose by 20
        per prior env step, the buffer holds both, each rollout's burst
        ran, losses finite; ms per bootstrap env step;
     e. the prior strategy (no members, TrainConfig()) and bcf (d's
        trained state) on reachao_rand_start, 64 episodes, horizon 100:
        K1 rose by 20 per eval step, rates in [0, 1] summing to 1, ms per
        eval step; the bcf action on one obs batch on the card against the
        CPU (atol 1e-4).
     Where a card result parts from the CPU's by more than its tolerance,
     at most 16 envs may, each a tie of the reference: the CPU result of
     16 copies of the env, q scaled by 1 + 1e-6 N(0, 1), spreads by more
     than the tolerance and the card agrees with one copy.
  11. the contact tasks, K1 once per substep with the contact torque
     tau_ext and the warm active set carried from launch to launch (a seed
     launch and 20 substep launches per step): make_core("push") at
     bench.py's B = 16384 and at the trainer's 64, make_core("slide") (ee)
     at 4096, 5 steps each, the object of envs 0-7 put beside the end
     effector; checks: K1 rose by exactly 21 per step on the kernel the
     wrapper picks, the pushed envs have a non-zero tau_ext and their
     object moved, untouched objects rest on the table (z within 1e-3),
     everything finite; the K1 route held against the plain route on the
     first step's states (q 2e-5, qd 2e-3, observation 2e-4, reward 1e-5,
     at most 16 envs ties: 16 perturbed copies through both routes, the
     plain copies spread beyond the tolerance and the routes agree on one);
     the step's median of 10 with its spread and a profile (launches, busy
     share); reachao1 under PANDA_LCP_WARM=1 at 4096, one step, 21
     launches, held against the plain warm route by the same rule;
     Trainer.learn on Push at n_envs 64 with the full-width TQC preset,
     2560 env steps (21 launches per env step, losses finite, the buffer
     on the card; ms per collect env step and per TQC update); K1 per warm
     one-substep launch with tau_ext at B 64, 4096 and 16384 beside its
     bound.
  12. K1 on MyCobot's 6 dofs and on the 9-dof Panda with prismatic fingers
     (the one-env-per-thread kernel at every B; phase 2 reports both
     instantiations): MyCobot against its plain version at B 1, 4096 and
     4100 and at 65536 by phase 3's near-tie rule (20 warm substeps,
     position and velocity control); the 9-dof Panda's seed launch and one
     warm substep with tau_ext from the carried set at B 1, 4096 and 4100
     (q 2e-5, qd 2e-3, the sets equal); make_core("mycobotreach") through
     phase 4's main path at 4096 (10 steps) and 65536 (3), K1 once per
     step, the first two steps against the plain physics, and the step's
     median of 10; PickAndPlace at 16384 and 64, Flip and Stack at 4096,
     ee control, 3 steps, envs 0-7 with the cube between open fingers and
     a closing action, Stack's envs 8-15 with the second cube 1.5 mm into
     the first: K1 rose by 21 per step, tau_ext on both finger dofs, the
     fingers and the cube moved, the stacked cube rests on the first (its
     z within 1e-3 of the first's + 0.04), untouched cubes rest on the
     table, the K1 route held against the plain route by phase 11's rule
     (PickAndPlace's and Flip's gripped envs' object velocities at 3e-3,
     the gap printed), the step's median of
     10 and a profile; Trainer.learn on PickAndPlace under tqc_pickandplace's
     configuration (TQC at full width, n_envs 64, horizon 50), cut to one
     collect rollout and its burst (21 launches per env step, losses
     finite, the buffer on the card); K1 per launch beside its bound
     (MyCobot's 20 warm substeps at B 64, 4096 and 65536, the 9-dof
     Panda's warm substep with tau_ext at 64, 4096 and 16384); the phase's
     wall time.
  13. the other learners and population training: PopulationTrainer.learn
     (4 members of the TQC preset at full width, 64 envs each: the
     round-5 campaign's pop_rs run, tools/campaign_round5.sh:25-34) on
     reachao_rand_start_p25, cut to horizon 20 and three rollouts of 64 x
     20 per member (a collect rollout, then fused rollouts with 8 stacked
     updates after each env step) and one evaluation; checks: every env
     step one batched_step of 256 envs with 20 K1 launches, all on the
     lane-group kernel, the stacked update count, finite losses, the state
     stacked on the card, the members distinct, the stacked replay on the
     card, each member's checkpoints; the K1 route held against the plain
     route on one env step of the population's own actions (phase 7's
     rule); one stacked update against the CPU and against each member's
     own update on the card (losses, alpha and gradients rtol 1e-4 / atol
     1e-6, the members' new state within 1e-5); ms per stacked update at
     K = 4 beside one member's, ms per collect and fused env step at 256
     beside one member's at 64, the launches of each, aggregate
     env-steps/s and the replay's bytes.  TD3 and DDPG through
     Trainer.learn on Reach at 64 envs (three rollouts of 50, one K1
     launch per env step), one update each against the CPU, the update's
     time.  One train_ppo iteration on Reach at the PPO preset (16 envs,
     n_steps 512, 20 epochs of 128), one launch per env step, then one
     update against the CPU (the first minibatch's gradients by phase 8's
     rule; the whole update, 1280 Adam steps that amplify rounding, held
     against the same update in float64 on the CPU: the card's relative
     distance from it at most 4x the float32 CPU's).  collect_labeled with
     the routed generalist on reachao1 (64 episodes of 50 steps, drive
     noise 0.2; 20 K1 launches per step) and 200 bc_train steps of a
     TQC-preset student, held by the same float64 rule.  In every update
     held against the CPU, the actor's gradient is taken on both sides
     from the same stepped critic and ReLU pattern, and each hidden ReLU
     input on the other side of 0 on the card must be a tie (|z| <=
     1e-5).  K1 beside its bound at the population's B = 256 and at 16
     and 64.

 14. the gym surface and the stateful Simulation: K1 with a gravity
     vector (0.3, -0.2, -9.0) against its plain version (both kernels, B 1
     and 4096, 20 warm substeps and one cold); the reference's five Bullet
     goldens through Simulation in the "exact" mode (one K1 launch, the
     step held against the plain route) and the "pgs" mode (no launch),
     each printing its route; every env class of the JAX package's gym
     surface as one env through its adapter (a reset and 5 steps, K1's
     launches per step counted, the first step held against the plain
     route by phase 11's rule), and gym.make where gymnasium imports (the
     card's machine may lack it: the gymnasium-free adapters are then the
     layer driven, and the line says so); the vector adapter on Reach at
     65536 and reachao1 at 4096 through an autoreset of every env; the
     Simulation with a falling body beside a moving obstacle (the flag
     raised, no freeze) and under gravity (0, 0, -1.62); ms per adapter,
     vector and Simulation step, and K1 at B = 1 beside its bound.
 15. env-batch data parallelism over torch.distributed and the campaign
     tools: a. initialize_multihost starts a one-rank NCCL group on the
     card and Trainer.learn on reachao1 at n_envs 64, cut to one rollout
     (1280 env steps) and its burst, with that mesh equals the same run
     with no mesh bit for bit (parameters and Adam state, buffer,
     generator, the rows but their host clocks, the full-state
     checkpoints), 20 K1 launches per env step on the lane-group kernel;
     b. two spawned ranks share card 0 over gloo (NCCL refuses two ranks on
     one GPU): reachao1 at global n_envs 128, 64 per rank, one rollout, its
     burst and one evaluation: K1 rose by 20 per env step on each rank on
     the lane-group kernel, the rows are equal and the parameters bitwise
     equal on both ranks, each buffer holds capacity / 2 episodes, the
     full-state checkpoint holds both ranks; c. on each rank one sharded
     batched_step of reachao1 at global 4096 (forced collisions in both
     blocks) against the unsharded step on its block by phase 7's
     tolerances (envs outside them at most 16, each a contact tie); d.
     utils.profiling times a and b (StepTimer, sync, device_memory_stats):
     env-steps/s at W = 1 and W = 2 on the one card, and the smoke tool's
     ms per sharded Reach step at 4096 with and without the collective
     (gloo on the card); e. the campaign tools cut to 16 episodes of 20
     steps on reachao1 and narrow_tunnel: continue_population from phase
     13's member checkpoints (one rollout, the members' update count kept),
     distill_cli on the asset's routed generalist (200 BC steps, one
     DAgger round, each round benchmarked; its .policy.npz through the eval
     CLI), build_router from a run-data root made of the asset's members
     (200 router steps; the routed action card vs CPU by phase 9's rule);
     K1's launches counted over every wrapper each tool makes.

The line before the last is one JSON object with a row per kernel path
(K1 on each path above); the last line is {"ok": true, "device": {...}}.
Any failure exits non-zero before those lines.  Imports torch, numpy, the
standard library and the port only.

``--bootstrap`` builds K1 and times tqc_ft2_tunnel's full prior bootstrap
(4 rollouts of 64 x 100 NEO steps, then one collect rollout) and prints no
result line.

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
import shutil
import subprocess
import sys
import tempfile
import time
import types

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
    n = lo.shape[0]
    q = rng.uniform(lo, hi, (B, n))
    qd = rng.normal(0.0, 0.5, (B, n))
    if ctrl_mode == 0:
        tgt = q + rng.normal(0.0, 0.05, (B, n))
    else:
        tgt = rng.normal(0.0, 1.0, (B, n))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (q, qd, tgt))


def count_plain_ops(model, ctrl_mode, n_substeps=N_SUBSTEPS, warm_start=True,
                    step=None):
    """fp32 operations per env and launch of the plain version, counted
    by running it for one env on the CPU under a dispatch mode: every
    elementwise operator call on a (1,) tensor is one operation (arithmetic,
    sqrt, sin, cos, compare, select, logical); views, copies, stacks and
    tensor creation are not counted.  The loops have fixed trip counts, so
    the count does not depend on the data.  ``step(q, qd, target)``, when
    given, is counted in place of the n-substep motor steps."""
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

    step = step or S.make_batched_motor_steps(
        model, n_substeps=n_substeps, dt=DT, ctrl_mode=ctrl_mode,
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


# bytes per env of a K1 launch of an n-dof chain: q, qd, target read and q,
# qd written (20 n); and of a one-substep launch of the contact step, which
# also reads tau_ext and the carried set (sat as bytes, sign) and writes
# the set (34 n)
def k1_bytes(n):
    return 5 * n * 4


def k1_substep_bytes(n):
    return 4 * n * 4 + n + 4 * n + 2 * n * 4 + n + 4 * n


K1_BYTES = k1_bytes(7)
K1_SUBSTEP_BYTES = k1_substep_bytes(7)


def k1_bound_ms(n_ops, B, bytes_per_env=K1_BYTES):
    """Least time for K1 at batch B: the larger of its bytes (140 per env
    unless given) over the memory rate and its fp32 operations over the
    fp32 peak."""
    return max(bytes_per_env * B / PEAK_BYTES,
               float(n_ops) * B / PEAK_FP32_OPS) * 1e3


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


# the device work of a torch.profiler trace: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_work(prof):
    """A profiled run's device work, {name: [launches, us]}, read from its
    Chrome trace: parsing the trace takes ~2 s for a step of ~26k launches,
    key_averages() ~10 times as long."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if str(e.get("cat", "")).lower() in DEVICE_CATS and e.get("dur", 0) > 0:
            w = out.setdefault(e["name"], [0, 0.0])
            w[0] += 1
            w[1] += e["dur"]
    return out


def key_average_work(prof):
    """The same profile's device work as key_averages() reads it, the
    device-side CUDA events with self time (the profiles' reader before the
    Chrome trace), {name: [launches, us]}."""
    out = {}
    for e in prof.key_averages():
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and getattr(e, "self_device_time_total", 0) > 0
                and not getattr(e, "is_user_annotation", False)):
            out[e.key] = [e.count, e.self_device_time_total]
    return out


def profile_step(env, states, acts, card, n=5, tag="phase 6",
                 both_readers=False):
    """Where a batched_step's time goes: torch.profiler over n steps, the
    card's busy share of the wall time and the kernels that take most.
    With ``both_readers``, the same profile also read by key_averages(),
    and the kernels whose launches the two readers count differently."""
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
    work = device_work(prof)
    busy_us = sum(us for _, us in work.values())
    if busy_us == 0:
        fail(f"{tag} profile: the profiler saw no device time")
    n_launch = sum(k for k, _ in work.values())
    say(f"{tag} profile of {n} batched_step at B={B}: wall "
        f"{wall_us / n:.0f} us/step, card busy {busy_us / n:.0f} us/step "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch / n:.0f} kernel "
        f"launches/step | {card}")
    for name, (k, us) in sorted(work.items(), key=lambda w: -w[1][1])[:8]:
        say(f"  {us / n:9.1f} us/step {k / n:6.1f}x  {name[:90]}")
    if both_readers:
        old = key_average_work(prof)
        say(f"{tag} the same profile read by key_averages(): "
            f"{sum(us for _, us in old.values()) / n:.0f} us/step busy, "
            f"{sum(k for k, _ in old.values()) / n:.0f} launches/step | "
            f"{card}")
        for name in sorted(set(work) | set(old)):
            a, b = work.get(name, [0])[0], old.get(name, [0])[0]
            if a != b:
                say(f"  trace {a / n:.1f}x, key_averages() {b / n:.1f}x per "
                    f"step  {name[:90]}")


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
        profile_step(env, states, acts, card, both_readers=True)


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
    noise = 1e-6 * torch.randn(16, q.shape[1], generator=g, device=dev)
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


def drive(make_core, _hi_prec, CD, B, n_steps, dev, control="js",
          tag="phase 4", task="reach"):
    """The main path at batch B: batched_reset, then n_steps batched_step
    calls with random actions (Reach, or MyCobotReach, under ``control``),
    K1's counts set to 0 just before and read just after.  Returns the
    per-kernel launch counts, the largest error of the first two steps
    against the plain physics, and the first step's states and actions."""
    env = make_core(task, control_type=control, device="cuda")
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
    picked = motor.pick(states.q)
    first = None
    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    for i in range(n_steps):
        actions = torch.rand(B, env.robot.action_dim, generator=gen,
                             device=dev) * 2.0 - 1.0
        if i == 0:
            first = (states, actions)
        if i < 2:
            s_in = _hi_prec(env.robot.set_action)(states, actions)
            q_ref, qd_ref = motor.plain(s_in.q, s_in.qd, s_in.ctrl_target)
        states, obs, reward, terminated, truncated, info = env.batched_step(
            states, actions)
        if i < 2 and B == B_BENCH:
            err = max(err, hold_with_ties(
                twin, picked, (s_in.q, s_in.qd, s_in.ctrl_target),
                (states.q, states.qd), (q_ref, qd_ref),
                f"{tag} B={B} step {i} vs plain physics:", dev))
        elif i < 2:
            eq = (states.q - q_ref).abs().max().item()
            eqd = (states.qd - qd_ref).abs().max().item()
            say(f"{tag} B={B} step {i} vs plain physics: max|dq|={eq:.3e} "
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
    say(f"{tag} main path: {task}, {n_steps} batched_step at B={B} "
        f"({control} control), K1 launches "
        f"{ {KERNEL_NAMES[k]: v for k, v in counts.items()} }, success rate "
        f"{info['is_success'].float().mean().item():.4f}, checks {checks}")
    if not all(checks.values()):
        fail(f"main-path checks at B={B} failed: {checks}")
    want = {CD.LANES: 0, CD.THREAD: 0}
    want[picked] = n_steps
    if counts != want:
        fail(f"K1 launches at B={B} were {counts}, expected {want}")
    return counts, err, env, first


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
        p_next = one(p_cur, plain=True)
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
    out_p = cmp(s_in, plain=True)
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
# a hidden ReLU input this close to 0 may take either side on the card and
# the CPU (fp32 sums of ~256 terms of order 1 round at ~1e-6)
TIE_Z = 1e-5
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


def run_trainer(cfg, dev, run_root, CD=None, build=None, name="phase8"):
    """Trainer.learn() on the card, the envs built by make_reach_ao_core as
    the CLI builds them (or by ``build(stage)``); K1's counts are set to 0
    as the env is made, just before the run.  Returns (trainer, core,
    seconds)."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.train import Trainer

    cores = []

    def make_env(sc, thr, spd):
        core = (build(sc) if build else
                make_reach_ao_core(sc, config=cfg, ee_error_threshold=thr,
                                   speed_threshold=spd, device=dev.type))
        motor = core.physics_step_batched.motor
        motor.launches = 0
        if CD is not None:
            motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
        cores.append(core)
        return core

    logger = RunLogger(group="chip_smoke", name=name, config=cfg,
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
    # as user annotations spanning their kernels, a category of their own
    work = device_work(prof)
    busy_us = sum(us for _, us in work.values())
    if busy_us == 0:
        fail(f"{label} profile: the profiler saw no device time")
    n_launch = sum(k for k, _ in work.values())
    say(f"{label}: wall {wall_us:.0f} us, card busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch} kernel launches | "
        f"{card}")
    for name, (k, us) in sorted(work.items(), key=lambda w: -w[1][1])[:6]:
        say(f"  {us:9.1f} us {k:5d}x  {name[:90]}")
    return n_launch, busy_us, wall_us


def event_times(fn, n=N_UPDATE_TIMED):
    """ms of fn between two CUDA events, each call alone between two
    synchronizes, after 5 of warm-up: (median, min, max) over n."""
    for _ in range(5):
        fn()
    ms = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return float(np.median(ms)), min(ms), max(ms)


def update_times(trainer, core, card, tag="phase 8"):
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

    upd = event_times(lambda: learner.update(ts, batch, noise))
    burst = event_times(lambda: trainer.update_burst(ts, buf, gen, 1, bs,
                                                     rf))
    say(f"{tag} TQC update (batch {bs}, net_arch "
        f"{list(learner.net_arch)}, {learner.N_QUANTILES} quantiles x "
        f"{learner.n_critics} critics): median {upd[0]:.3f} ms (min "
        f"{upd[1]:.3f}, max {upd[2]:.3f}) over {N_UPDATE_TIMED}; with its "
        f"HER sample {burst[0]:.3f} ms (min {burst[1]:.3f}, max "
        f"{burst[2]:.3f}) | {card}")
    n_upd, busy_upd, wall_upd = profile_once(
        lambda: learner.update(ts, batch, noise),
        f"{tag} profile of one TQC update", card)

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
        fused_step, f"{tag} profile of one fused env step at B={N_ENVS} "
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


def learner_vs_cpu(trainer, core, card, tag="phase 8"):
    """The trained state copied to the CPU: one HER batch from the same
    draws on both devices must be equal, and one update from the same
    state, batch and noise must agree (losses and alpha rtol 1e-4, every
    gradient rtol 1e-4 and atol 1e-6; gradients, not the new parameters:
    Adam maps each gradient element to about +-lr, so one at the rounding
    level may flip by 2 lr).  Each gradient is compared from the same
    inputs: the actor's, which reads the stepped critic and its own hidden
    ReLUs, is taken on the card again with the CPU's stepped critic and the
    CPU's ReLU pattern, and every input of those ReLUs that lies on the
    other side of 0 on the card must be a tie (|z| <= TIE_Z).  Returns the
    largest gradient difference."""
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
    say(f"{tag} HER batch of {bs} on the card and on the CPU from the same "
        f"draws: equal {same}")
    if not all(same.values()):
        fail(f"the HER batch differs between the card and the CPU: {same}")
    noise = learner.update_noise(gen, bs)
    actor0, actor0_cpu = copy.deepcopy(ts.actor), copy.deepcopy(ts_cpu.actor)
    batch = learner_batch(b_card)
    _, m_card = learner.update(ts, batch, noise)
    _, m_cpu = cpu.update(ts_cpu, learner_batch(b_cpu),
                          tuple(n.cpu() for n in noise))
    worst = {}
    for k in ("critic_loss", "actor_loss", "alpha"):
        if k in m_cpu:
            a, b = float(m_card[k]), float(m_cpu[k])
            worst[k] = abs(a - b) / max(abs(b), 1e-30)
    grads = {f"critic.{n}": (p.grad.cpu(), q.grad) for (n, p), q in zip(
        ts.critic.named_parameters(), ts_cpu.critic.parameters())}
    # The actor's gradient is taken again on the card from the same inputs:
    # the CPU's stepped critic (Adam may move an element at the rounding
    # level by +-lr on one device only) and the CPU's ReLU pattern in the
    # actor's hidden layers (a pre-activation at the rounding level of 0
    # may take either side; each such flip must be a tie, |z| <= TIE_Z)
    critic = copy.deepcopy(ts.critic)
    with torch.no_grad():
        for p, q in zip(critic.parameters(), ts_cpu.critic.parameters()):
            p.copy_(q)
    flips, tie_z, masks = 0, 0.0, []
    with torch.no_grad():
        h, h_cpu = batch["x"], learner_batch(b_cpu)["x"]
        for layer, layer_cpu in zip(actor0.dense[:actor0.n_hidden],
                                    actor0_cpu.dense[:actor0.n_hidden]):
            z, z_cpu = layer(h), layer_cpu(h_cpu)
            flip = (z.cpu() > 0) != (z_cpu > 0)
            flips += int(flip.sum())
            if flip.any():
                tie_z = max(tie_z, z_cpu[flip].abs().max().item())
            masks.append((z_cpu > 0).to(z.device, z.dtype))
            h, h_cpu = torch.relu(z), torch.relu(z_cpu)

    def latent(self, x):
        for layer, m in zip(self.dense[:self.n_hidden], masks):
            x = layer(x) * m
        return x

    actor0.latent = types.MethodType(latent, actor0)
    names, params = zip(*actor0.named_parameters())
    # alpha as the update used it, exp(log_alpha) before the step
    g = torch.autograd.grad(learner.actor_loss(
        actor0, critic, batch["x"], learner.split_noise(noise)[1],
        m_card.get("alpha"))[0], params)
    # TD3's delayed actor steps on a zero gradient
    keep = learner.actor_steps(ts.step - 1)
    grads.update({f"actor.{n}": (a.cpu() * keep, q.grad) for n, a, q in zip(
        names, g, ts_cpu.actor.parameters())})
    if learner.uses_alpha:
        grads["log_alpha"] = (ts.log_alpha.grad.cpu(), ts_cpu.log_alpha.grad)
    over = {k: int(((a - b).abs() > ATOL_GRAD + RTOL_LEARN * b.abs()).sum())
            for k, (a, b) in grads.items()}
    err = max((a - b).abs().max().item() for a, b in grads.values())
    name = type(learner).__name__.replace("Learner", "")
    say(f"{tag} one {name} update, card vs CPU: relative differences "
        f"{ {k: f'{v:.2e}' for k, v in worst.items()} } (rtol {RTOL_LEARN}); "
        f"gradients of {len(grads)} tensors, max |d| {err:.3e}, elements "
        f"outside rtol {RTOL_LEARN} atol {ATOL_GRAD}: {sum(over.values())}; "
        f"{flips} hidden ReLU inputs of the actor on the other side of 0 on "
        f"the card, the largest |z| among them {tie_z:.2e} (a tie up to "
        f"{TIE_Z}) | {card}")
    if (max(worst.values()) > RTOL_LEARN or any(over.values())
            or tie_z > TIE_Z):
        fail(f"the {name} update on the card disagrees with the CPU: "
             f"{worst}, { {k: v for k, v in over.items() if v} }")
    return err


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


def routed_vs_cpu(policy, npz, x, card, tag="phase 9"):
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
    say(f"{tag} routed action on {x.shape[0]} observations, card vs CPU: "
        f"max |d| {d.max().item():.3e}, {over} elements outside rtol "
        f"{RTOL_ACT} atol {ATOL_ACT}; choices equal on the {int(clear.sum())}"
        f" without a near-tie: {same} ({len(set(c_cpu.tolist()))} "
        f"controllers chosen) | {card}")
    if over or not same:
        fail("the routed action on the card disagrees with the CPU")
    return d.max().item()


def k1_eval_error(CD, core, s_in, what="phase 9 K1 n_substeps=1 cold vs "
                                        "plain on an eval step's states"):
    """K1 at one cold substep against its plain version on a step's states
    (a second wrapper, whose launches stay out of the main path's counts).
    Returns the largest error."""
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
    say(f"{what} at B={x[0].shape[0]}: max|dq|={eq:.3e} (atol {ATOL_Q}) "
        f"max|dqd|={eqd:.3e} (atol {ATOL_QD})")
    if eq > ATOL_Q or eqd > ATOL_QD:
        fail(f"{what}: K1 disagrees with its plain version")
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

        def timed_policy(x, states):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return act(x, states)

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


# ----------------------------------------------------------------- phase 10
# the NEO prior and the ee/pcc control modes.  a: Reach under ee at the
# main path's and bench.py's batches and under pcc; b: NEO alone at the
# trainer's n_envs and the main path's B on one sphere (reachao1), three
# boxes (tunnel) and the protocol's largest scene (industrial, 16 boxes);
# c: reachao1 with the prior observation; d: Trainer.learn under
# tqc_ft2_tunnel's configuration (training/run_data/round1_campaign), cut in
# depth to one bootstrap rollout and one collect rollout of horizon 20;
# e: the prior and bcf strategies on reachao_rand_start, cut in depth
CONTROL_RUNS = (("ee", B_MAIN, 10), ("ee", B_BENCH, 3), ("pcc", B_MAIN, 10))
NEO_SCENES = ("reachao1", "tunnel", "industrial")
NEO_BATCHES = (N_ENVS, B_MAIN)
# the NEO command and the ee IK target, card against CPU
ATOL_NEO, ATOL_IK = 1e-4, 1e-5
PRIOR_OBS = {"obstacles": "vectors+closest_per_link", "prior": "rrmc_neo"}
PRIOR_OBS_STEPS = 3
PRIOR_EVAL_SCENE = "reachao_rand_start"
# tqc_ft2_tunnel: TQC preset, n_envs 64, horizon 100, tunnel, prior_steps
# 20000 (4 rollouts of 64 x 100); here horizon 20 and one rollout
FT2 = dict(stages=["tunnel"], max_ep_steps=[100],
           prior_steps=20_000, reward_type="kumar", learning_starts=10_000,
           max_timesteps=400_000, ee_error_thresholds=[0.05],
           speed_thresholds=[0.5], success_thresholds=[1.0])


def count_ops(fn):
    """Operator calls of fn on CPU tensors other than views: what the card
    launches for it, one kernel each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = {"expand", "view", "_unsafe_view", "unsqueeze", "transpose",
             "select", "slice", "alias", "t", "permute", "squeeze",
             "reshape", "detach", "unbind", "split", "as_strided",
             "lift_fresh", "_local_scalar_dense"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func.overloadpacket.__name__ not in views
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def to_cpu(states):
    return states.replace(**{k: getattr(states, k).cpu()
                             for k in states.__dataclass_fields__})


def neo_call(model, ee_site, states):
    """NEO's command toward each env's goal, as the prior policies call it."""
    from panda_gym_tpu_torch.ops import kinematics as K
    from panda_gym_tpu_torch.ops.neo import compute_action_neo

    return compute_action_neo(model, ee_site, states,
                              K.fk_world(model, states.q), states.goal)


def hold_jumps(label, got, ref, atol, rerun, card):
    """Hold a card result against the CPU's, per env within atol, or at
    most MAX_TIES envs at a discontinuity of the reference: rerun(b)
    returns the CPU result for 16 copies of env b, copies 1-15 with q
    scaled by 1 + 1e-6 N(0, 1); the env is a tie if the copies spread by
    more than atol and the card agrees with at least one copy.  Returns the
    largest error over the envs within atol."""
    d = (got.cpu() - ref).abs().amax(1)
    bad = (d > atol).nonzero().flatten().tolist()
    err = d[d <= atol].max().item() if len(bad) < d.numel() else 0.0
    say(f"{label}: card vs CPU max |d| {err:.3e} (atol {atol}) on "
        f"{d.numel() - len(bad)} envs; {len(bad)} outside | {card}")
    if len(bad) > MAX_TIES:
        fail(f"{label}: the card disagrees with the CPU on {len(bad)} envs")
    for b in bad:
        copies = rerun(b)
        spread = (copies - copies[:1]).abs().max().item()
        agree = int(((copies - got[b].cpu()).abs().amax(1) <= atol).sum())
        tie = spread > atol and agree > 0
        say(f"  env {b}: |d| {d[b].item():.3e}; 16 copies perturbed by "
            f"1e-6: CPU spread {spread:.3e}, card agrees with {agree}: "
            f"{'tie' if tie else 'FAIL'}")
        if not tie:
            fail(f"{label}: the card disagrees with the CPU on env {b}")
    return err


def perturbed(states, b):
    """16 copies of env b, copies 1-15 with q scaled by 1 + 1e-6 N(0, 1)."""
    s = take(states, [b] * 16)
    g = torch.Generator().manual_seed(b)
    noise = 1e-6 * torch.randn(s.q.shape, generator=g)
    noise[0] = 0.0
    return s.replace(q=s.q * (1.0 + noise))


def ik_vs_cpu(env, states, actions, label, card):
    """The ee IK targets (set_action's ctrl_target) on the card against the
    CPU from the same states and actions (hold_jumps)."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.envs.panda_tasks import make_core

    cpu_env = make_core("reach", control_type="ee", device="cpu")
    set_cpu = _hi_prec(cpu_env.robot.set_action)
    got = _hi_prec(env.robot.set_action)(states, actions).ctrl_target
    s_cpu, a_cpu = to_cpu(states), actions.cpu()
    ref = set_cpu(s_cpu, a_cpu).ctrl_target

    def rerun(b):
        return set_cpu(perturbed(s_cpu, b), a_cpu[[b] * 16]).ctrl_target

    return hold_jumps(f"{label} ee IK targets", got, ref, ATOL_IK, rerun,
                      card)


def control_times(env, states, gen, card, tag, n=10):
    """ms per step (host clock over n steps after 2 of warm-up, ending in a
    synchronize) and one profiled step's launches and busy share."""
    B = states.batch_size
    acts = [torch.rand(B, env.robot.action_dim, generator=gen,
                       device=states.q.device) * 2.0 - 1.0 for _ in range(4)]
    for a in acts[:2]:
        states, *_ = env.batched_step(states, a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        states, *_ = env.batched_step(states, acts[i % 4])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    say(f"{tag} batched_step B={B}: {ms:.3f} ms/step over {n} | {card}")
    profile_step(env, states, acts, card, n=3, tag=tag)
    return ms


def drive_control(make_core, _hi_prec, CD, dev, card):
    """Phase 10a: Reach under ee and pcc through phase 4's main path (K1's
    counts, the plain physics on the first two steps), the ee IK targets
    card vs CPU on the first step, then times.  Returns {(control, B):
    (per-kernel launches, K1 error, ms/step)}."""
    out = {}
    for control, B, n_steps in CONTROL_RUNS:
        tag = f"phase 10a {control}"
        counts, err, env, (s0, a0) = drive(make_core, _hi_prec, CD, B,
                                           n_steps, dev, control, tag)
        if control == "ee":
            ik_vs_cpu(env, s0, a0, f"{tag} B={B}", card)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        states, _ = env.batched_reset(B, gen)
        ms = control_times(env, states, gen, card, f"{tag}")
        out[control, B] = (counts, err, ms)
    return out


def neo_scene(name, B, dev):
    """B reset envs of a scene under the default config; env 0's first
    obstacle is moved to ~0.1 m of its end effector."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core

    core = make_reach_ao_core(name, device="cuda")
    states, obs = core.batched_reset(
        B, torch.Generator(device=dev).manual_seed(SEED))
    opos = states.obstacle_pos.clone()
    opos[0, 0] = obs["achieved_goal"][0] + torch.tensor([0.0, 0.1, 0.1],
                                                         device=dev)
    return core, states.replace(obstacle_pos=opos)


def drive_neo(dev, card):
    """Phase 10b: NEO alone on each scene and batch: the card against the
    CPU (hold_jumps), ms per call (CUDA events over 10 calls), the
    operations counted on the CPU and one profiled call's launches and busy
    share.  Returns {(scene, B): (ms, launches)}."""
    out = {}
    for name in NEO_SCENES:
        for B in NEO_BATCHES:
            core, states = neo_scene(name, B, dev)
            model, ee = core.model, core.robot.ee_site
            got = neo_call(model, ee, states)
            s_cpu = to_cpu(states)
            ref = neo_call(model, ee, s_cpu)
            label = f"phase 10b NEO {name} B={B}"
            hold_jumps(label, got, ref, ATOL_NEO,
                       lambda b: neo_call(model, ee, perturbed(s_cpu, b)),
                       card)
            n_ops = count_ops(lambda: neo_call(model, ee,
                                               take(s_cpu, [0, 1])))
            ms = time_cuda(lambda: neo_call(model, ee, states), 10)
            n, busy, wall = profile_once(
                lambda: neo_call(model, ee, states),
                f"{label} profile of one call ({n_ops} operations counted "
                f"on the CPU, {states.obstacle_pos.shape[1]} obstacles)",
                card)
            say(f"{label}: {ms:.2f} ms per call | {card}")
            out[name, B] = (ms, n)
    return out


def drive_prior_obs(CD, dev, card):
    """Phase 10c: reachao1 with the prior observation at B = 4096, K1's
    counts set to 0 just before the steps and read just after; the last 7
    entries of each step's observation equal NEO on the post-step states;
    then the step's time.  Returns (K1 launches, K1 error, ms/step)."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.config import TrainConfig

    cfg = TrainConfig(task_observations=dict(PRIOR_OBS))
    env = make_reach_ao_core("reachao1", config=cfg, device="cuda")
    motor = env.physics_step_batched.motor
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s, obs = env.batched_reset(B_MAIN, gen)
    acts = [torch.rand(B_MAIN, 7, generator=gen, device=dev) * 2.0 - 1.0
            for _ in range(PRIOR_OBS_STEPS + 1 + N_TIMED)]
    s_in = _hi_prec(env.robot.set_action)(s, acts[0])
    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    errs = []
    for i in range(PRIOR_OBS_STEPS):
        s, obs, *_ = env.batched_step(s, acts[i])
        prior = _hi_prec(neo_call)(env.model, env.robot.ee_site, s)
        errs.append((obs["observation"][:, -7:] - prior).abs().max().item())
    torch.cuda.synchronize()
    counts = dict(motor.kernel_launches)
    checks = {
        "K1: 20 launches per step, all on the lane-group kernel":
            counts == {CD.LANES: N_SUBSTEPS * PRIOR_OBS_STEPS, CD.THREAD: 0},
        "obs shape": tuple(obs["observation"].shape) == (B_MAIN, 56 + 7),
        "obs finite": bool(torch.isfinite(obs["observation"]).all()),
        "the last 7 entries are NEO on the post-step states":
            max(errs) <= 1e-6,
    }
    say(f"phase 10c main path: reachao1 with the prior observation, "
        f"{PRIOR_OBS_STEPS} batched_step at B={B_MAIN}, K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, prior entries "
        f"vs NEO max |d| {max(errs):.2e}, checks {checks}")
    if not all(checks.values()):
        fail(f"phase 10c checks failed: {checks}")
    err = k1_eval_error(CD, env, s_in, "phase 10c K1 n_substeps=1 cold vs "
                                       "plain on a prior-observation step")
    ms = []
    for a in acts[PRIOR_OBS_STEPS + 1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, *_ = env.batched_step(s, a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    say(f"phase 10c reachao1 prior-observation batched_step B={B_MAIN}: "
        f"median {np.median(ms):.1f} ms/step over {len(ms)} (min "
        f"{min(ms):.1f}, max {max(ms):.1f}) | {card}")
    profile_step(env, s, acts[:1], card, n=1, tag="phase 10c")
    return counts[CD.LANES], err, float(np.median(ms))


def ft2_config(horizon, rollouts, run_steps):
    """tqc_ft2_tunnel's TrainConfig, cut in depth: ``rollouts`` bootstrap
    rollouts of 64 x horizon and run_steps env steps of training (learning
    from the first rollout on, no evaluation)."""
    from panda_gym_tpu_torch.rl.config import TrainConfig

    cfg = TrainConfig(n_envs=N_ENVS, **FT2)
    cfg.max_ep_steps = [horizon]
    cfg.prior_steps = rollouts * N_ENVS * horizon
    cfg.max_timesteps = run_steps
    cfg.learning_starts = 1
    cfg.eval_freq = 10 ** 9
    cfg.benchmark_eval_scenes = []
    return cfg


def run_bootstrap(cfg, dev, run_root, CD, card):
    """Trainer.learn under cfg with fill_buffer_with_prior watched: its K1
    launches, its time and the buffer and update count when it starts.
    Returns (trainer, core, {what: value})."""
    from panda_gym_tpu_torch.rl import train as T

    fill = T.fill_buffer_with_prior
    seen = {}

    def watched(venv, buf, generator, n_rollouts):
        motor = venv.core.physics_step_batched.motor
        seen.update(stored=buf.n_stored, rollouts=n_rollouts,
                    updates=trainer_box[0].ts.step,
                    launches0=motor.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fill(venv, buf, generator, n_rollouts=n_rollouts)
        torch.cuda.synchronize()
        seen.update(seconds=time.perf_counter() - t0,
                    launches=motor.launches - seen["launches0"],
                    stored_after=out[0].n_stored,
                    steps=n_rollouts * venv.horizon)
        return out

    trainer_box = [None]
    T.fill_buffer_with_prior = watched
    try:
        from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
        from panda_gym_tpu_torch.rl.logging_utils import RunLogger

        cores = []

        def make_env(sc, thr, spd):
            core = make_reach_ao_core(sc, config=cfg, ee_error_threshold=thr,
                                      speed_threshold=spd, device=dev.type)
            core.physics_step_batched.motor.launches = 0
            core.physics_step_batched.motor.kernel_launches = {
                CD.LANES: 0, CD.THREAD: 0}
            cores.append(core)
            return core

        logger = RunLogger(group="chip_smoke", name="phase10", config=cfg,
                           root=run_root)
        trainer = T.Trainer(cfg, make_env, logger=logger)
        trainer_box[0] = trainer
        t0 = time.perf_counter()
        trainer.learn()
        torch.cuda.synchronize()
        seen["run_seconds"] = time.perf_counter() - t0
        logger.close()
    finally:
        T.fill_buffer_with_prior = fill
    if not seen.get("steps"):
        fail("the prior bootstrap did not run")
    say(f"prior bootstrap: {seen['rollouts']} rollout(s) of {N_ENVS} x "
        f"{seen['steps'] // seen['rollouts']} NEO steps in "
        f"{seen['seconds']:.2f} s, {seen['seconds'] / seen['steps'] * 1e3:.1f}"
        f" ms per env step, {seen['launches']} K1 launches | {card}")
    return trainer, cores[0], seen


def drive_bootstrap(CD, dev, card, run_root):
    """Phase 10d: Trainer.learn under tqc_ft2_tunnel's configuration (TQC at
    full width, n_envs 64, tunnel) cut to one bootstrap rollout and one
    collect rollout of horizon 20 and its update burst; checks: the
    bootstrap ran first, on an empty buffer and before any update, K1 rose
    by 20 per prior env step on the lane-group kernel, the buffer holds the
    prior's episodes and the run's, losses finite; K1 against its plain
    version on a bootstrap step's states.  Returns (trainer, launches, K1
    error, ms per bootstrap env step)."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.rl.imitation import neo_policy_fn

    from panda_gym_tpu_torch.rl.train import schedule

    horizon = HORIZON
    cfg = ft2_config(horizon, 1, N_ENVS * horizon // 2)
    trainer, core, seen = run_bootstrap(cfg, dev, run_root, CD, card)
    rows = [r for r in trainer.metrics.history if "rollout_reward" in r]
    burst = schedule(cfg, horizon).updates_per_rollout
    losses = [v for r in rows for k, v in r.items()
              if k in ("critic_loss", "actor_loss", "alpha")]
    checks = {
        "bootstrap on an empty buffer, before any update":
            seen["stored"] == 0 and seen["updates"] == 0,
        "K1: 20 launches per prior env step":
            seen["launches"] == N_SUBSTEPS * seen["steps"],
        "the buffer holds the prior's episodes and the run's":
            seen["stored_after"] == N_ENVS
            and trainer.buffer.n_stored == N_ENVS * (1 + len(rows)),
        "a burst of updates after each collect rollout":
            len(rows) >= 1 and trainer.ts.step == burst * len(rows),
        "losses finite": bool(losses) and all(np.isfinite(v) for v in losses),
    }
    say(f"phase 10d main path: Trainer.learn under tqc_ft2_tunnel's config "
        f"(tunnel, n_envs {N_ENVS}, horizon {horizon}, prior_steps "
        f"{cfg.prior_steps}), {len(rows)} collect rollout(s), "
        f"{trainer.ts.step} updates, checks {checks}")
    if not all(checks.values()):
        fail(f"phase 10d checks failed: {checks}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = core.batched_reset(N_ENVS, gen)
    with torch.no_grad():
        a = neo_policy_fn(core)(None, states, gen)
    s_in = _hi_prec(core.robot.set_action)(states, a)
    err = k1_eval_error(CD, core, s_in, "phase 10d K1 n_substeps=1 cold vs "
                                        "plain on a bootstrap step's states")
    return trainer, seen["launches"], err, seen["seconds"] / seen["steps"] * 1e3


def drive_prior_eval(CD, trainer, dev, card):
    """Phase 10e: the prior strategy (no members, TrainConfig()) and bcf
    (phase d's trained state, prior_sigma 0.3) through run_episodes on
    reachao_rand_start at 64 episodes and horizon 100, K1's counts set to 0
    just before and read just after; rates in [0, 1] summing to 1; the bcf
    action on one obs batch card vs CPU.  Returns (K1 launches, K1 error,
    {strategy: (results, ms per eval step)})."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.eval import benchmark as EB
    from panda_gym_tpu_torch.eval.cli import make_core_fn
    from panda_gym_tpu_torch.rl.config import TrainConfig
    from panda_gym_tpu_torch.rl.learners import load_state, make_learner, save_state
    from panda_gym_tpu_torch.rl.networks import flatten_obs

    core = make_core_fn(TrainConfig(), dev)(PRIOR_EVAL_SCENE)
    motor = core.physics_step_batched.motor
    learner, ts = trainer.learner, trainer.ts
    launches, out = 0, {}
    for strategy, members in (("prior", []), ("bcf", [ts])):
        act = EB.make_policy(learner, members, strategy, core)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        states, obs = core.batched_reset(EVAL_EPISODES, gen)
        marks = []

        def timed_policy(x, s):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return act(x, s)

        motor.launches = 0
        motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
        done, ep_len, m = EB.run_episodes(core, timed_policy, states, obs,
                                          EVAL_HORIZON)
        res = EB.summarize(ep_len, m, core.n_substeps)
        counts = dict(motor.kernel_launches)
        n_steps = m["active"].shape[0]
        launches += motor.launches
        rates = [res[k] for k in ("success_rate", "collision_rate",
                                  "timeout_rate")]
        checks = {
            "K1: 20 launches per eval step, all on the lane-group kernel":
                counts == {CD.LANES: N_SUBSTEPS * n_steps, CD.THREAD: 0},
            "rates in [0, 1], summing to 1": all(0 <= r <= 1 for r in rates)
                and abs(sum(rates) - 1.0) < 1e-9,
            "metrics finite": all(np.isfinite(v) for v in res.values()),
        }
        ms = np.diff(marks) * 1e3
        say(f"phase 10e main path: {PRIOR_EVAL_SCENE}, strategy {strategy}, "
            f"{EVAL_EPISODES} episodes, {n_steps} of {EVAL_HORIZON} eval "
            f"steps, K1 launches "
            f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}; success "
            f"{res['success_rate']:.4f} collision {res['collision_rate']:.4f}"
            f" timeout {res['timeout_rate']:.4f} mean_ep_length "
            f"{res['mean_ep_length']:.2f}; eval step median "
            f"{np.median(ms):.1f} ms (least {ms.min():.1f}, most "
            f"{ms.max():.1f}); checks {checks} | {card}")
        if not all(checks.values()):
            fail(f"phase 10e checks of {strategy} failed: {checks}")
        out[strategy] = (res, float(np.median(ms)))
        with torch.no_grad():
            a = act(flatten_obs(obs), states)
        s_in = _hi_prec(core.robot.set_action)(states, a)
    err = k1_eval_error(CD, core, s_in, "phase 10e K1 n_substeps=1 cold vs "
                                        "plain on a bcf eval step's states")

    # the bcf action on the card against the CPU, from the same obs batch
    cfg = trainer.config
    cpu_learner = make_learner(cfg.algorithm, learner.obs_dim,
                               learner.act_dim, cfg.hyperparams, "cpu")
    ts_cpu = load_state(cpu_learner.init(torch.Generator().manual_seed(0)),
                        save_state(ts))
    cpu_core = make_core_fn(TrainConfig(), "cpu")(PRIOR_EVAL_SCENE)
    bcf_cpu = EB.make_policy(cpu_learner, [ts_cpu], "bcf", cpu_core)
    bcf = EB.make_policy(learner, [ts], "bcf", core)
    x = flatten_obs(obs)
    s_cpu = to_cpu(states)
    with torch.no_grad():
        got = bcf(x, states)
        ref = bcf_cpu(x.cpu(), s_cpu)
        hold_jumps("phase 10e bcf action", got, ref, ATOL_NEO,
                   lambda b: bcf_cpu(x.cpu()[[b] * 16], perturbed(s_cpu, b)),
                   card)
    return launches, err, out

# ----------------------------------------------------------------- phase 11
# the contact tasks: Push at bench.py's B = 16384 (bench.py:97-101, the
# free-body row) and the trainer's n_envs, Slide (ee control) at the main
# path's B, 5 steps each; the object of envs 0-7 put beside the end
# effector first, its face 1 cm from the fingertip, so that the arm pushes
# it.  K1 runs one seed launch and 20 warm one-substep launches with the
# contact torque per step.
CONTACT = (("push", 16384, 5), ("push", N_ENVS, 5), ("slide", B_MAIN, 5))
K1_PER_CONTACT_STEP = N_SUBSTEPS + 1
# tests/test_dynamics.py:240-245: observations and rewards of the batched
# contact step against the per-env one
ATOL_OBS, ATOL_REWARD = 2e-4, 1e-5
# K1 timed per warm one-substep launch with tau_ext at these batches
B_CONTACT_TIMED = (N_ENVS, B_MAIN, 16384)
# Push training: the TQC preset at full width on n_envs 64, horizon 20,
# cut to 2560 env steps (a collect rollout and its burst, then a fused one)
PUSH_TRAIN_STEPS = 2560


def rest_height(scene):
    """The height of a body's centre resting on the table: the depth of its
    lowest contact sample."""
    smp, mask = scene.body_samples[0], scene.body_sample_mask[0] > 0
    return float(-(smp[mask, 2] - smp[mask, 3]).min())


def contact_diff(env, a, b):
    """Per env, whether two contact-step results part beyond the
    tolerances: q, qd, the observation and the reward after the step."""
    sa, oa, ra, *_ = env._step_post(a)
    sb, ob, rb, *_ = env._step_post(b)
    return (((a.q - b.q).abs() > ATOL_Q).any(1)
            | ((a.qd - b.qd).abs() > ATOL_QD).any(1)
            | ((oa["observation"] - ob["observation"]).abs()
               > ATOL_OBS).any(1)
            | ((ra - rb).abs() > ATOL_REWARD))


def route_tie(phys, states, b, diff, dev):
    """Whether env b of a step that parts between the K1 route and the plain
    route sits at a tie of the reference: its state copied 16 times, q of
    copies 1-15 scaled by 1 + 1e-6 N(0, 1), through both routes; a tie if
    the plain results of the copies spread beyond the tolerance and the two
    routes agree on at least one copy.  ``diff(a, b, idx)`` compares two
    batches whose rows are the envs ``idx``.  Returns (tie, copies
    agreeing)."""
    g = torch.Generator(device=dev).manual_seed(b)
    noise = 1e-6 * torch.randn(16, states.q.shape[1], generator=g,
                               device=dev)
    noise[0] = 0.0
    s16 = take(states, [b] * 16)
    s16 = s16.replace(q=(s16.q * (1.0 + noise)).contiguous())
    k, p = phys(s16), phys(s16, plain=True)
    idx = torch.full((16,), b, device=dev)
    spread = bool(diff(p, take(p, [0] * 16), idx).any())
    agree = ~diff(k, p, idx)
    return spread and bool(agree.any()), int(agree.sum())


def hold_step_routes(phys, s_in, diff, label, dev, card):
    """One policy step of ``phys`` on its K1 route and its plain route from
    the same states: every env within the tolerances (``diff(a, b, idx)``,
    idx the envs of the rows), or at most MAX_TIES of them ties
    (route_tie).  Returns ((the K1 route's output, the plain route's), the
    largest q/qd error over the agreeing envs, the plain route's ms)."""
    out_k = phys(s_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = phys(s_in, plain=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = diff(out_k, out_p, torch.arange(s_in.q.shape[0], device=dev)
               ).nonzero().flatten().tolist()
    good = torch.ones(s_in.q.shape[0], dtype=torch.bool, device=dev)
    good[bad] = False
    err = max((out_k.q - out_p.q)[good].abs().max().item(),
              (out_k.qd - out_p.qd)[good].abs().max().item())
    say(f"{label}: K1 route vs plain route, max|dq|, max|dqd| "
        f"{err:.3e} over {int(good.sum())} envs within the tolerances (q "
        f"{ATOL_Q}, qd {ATOL_QD}, observation {ATOL_OBS}, reward "
        f"{ATOL_REWARD} / link distances {ATOL_LINK} and the flags); "
        f"{len(bad)} outside; plain route {plain_ms:.1f} ms | {card}")
    if len(bad) > MAX_TIES:
        fail(f"{label}: the K1 route disagrees with the plain route on "
             f"{len(bad)} envs")
    for b in bad:
        tie, n_agree = route_tie(phys, s_in, b, diff, dev)
        say(f"  env {b}: 16 copies perturbed by 1e-6: the routes agree on "
            f"{n_agree}: {'tie' if tie else 'FAIL'}")
        if not tie:
            fail(f"{label}: the K1 route disagrees with the plain route on "
                 f"env {b}")
    return (out_k, out_p), err, plain_ms


def push_objects(env, states, dev):
    """Put the object of envs 0-7 beside the end effector, alternately on
    either side along x, its face 1 cm from the fingertip."""
    from panda_gym_tpu_torch.ops import kinematics as K

    ee = env.robot.ee_position(K.fk_world(env.model, states.q))
    half = float(env.task.scene.body_size[0][0])
    side = torch.tensor([[(-1.0) ** b * (half + 0.01), 0.0, 0.0]
                         for b in range(N_FORCED)], device=dev)
    pos = states.body_pos.clone()
    pos[:N_FORCED, 0] = ee[:N_FORCED] + side
    return states.replace(body_pos=pos)


def drive_contact(make_core, _hi_prec, CD, task, B, n_steps, dev, card):
    """Phase 11 for one task at batch B: the main path (batched_reset, the
    objects of envs 0-7 pushed, n_steps batched_step calls), K1's counts
    set to 0 just before and read just after; the checks; the two motor
    routes held against each other on the first step's states; the step's
    time and a profile.  Returns (counts, largest K1 error, step ms)."""
    env = make_core(task)
    phys = env.physics_step_batched
    motor = phys.motor
    picked = CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
    twin = CD.make_cuda_motor_steps(env.model, n_substeps=1, dt=DT,
                                    ctrl_mode=motor.ctrl_mode,
                                    warm_start=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, _ = env.batched_reset(B, gen)
    states = push_objects(env, states, dev)
    start = states.body_pos[:, 0].clone()
    acts = [torch.rand(B, env.robot.action_dim, generator=gen, device=dev)
            * 2.0 - 1.0 for _ in range(n_steps + 1 + N_TIMED)]
    s_in = _hi_prec(env.robot.set_action)(states, acts[0])
    *_, tau0, _ = _hi_prec(phys.forces)(s_in.q, s_in.qd, s_in.body_pos,
                                        s_in.body_quat, s_in.body_vel,
                                        s_in.body_ang)

    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    s = states
    for i in range(n_steps):
        s, obs, reward, terminated, truncated, info = env.batched_step(
            s, acts[i])
    torch.cuda.synchronize()
    counts = dict(motor.kernel_launches)
    want = {CD.LANES: 0, CD.THREAD: 0}
    want[picked] = K1_PER_CONTACT_STEP * n_steps

    moved = (s.body_pos[:, 0] - start).abs().amax(1)
    # untouched: the arm never reached the object (it did not move on the
    # table); it must rest on the table
    untouched = (s.body_pos[:, 0, :2] - start[:, :2]).abs().amax(1) < 1e-4
    untouched[:N_FORCED] = False
    rest = rest_height(env.task.scene)
    q_lo = torch.as_tensor(env.model.q_lo, device=dev)
    q_hi = torch.as_tensor(env.model.q_hi, device=dev)
    body = torch.cat([s.body_pos, s.body_quat, s.body_vel, s.body_ang], -1)
    checks = {
        f"K1: {K1_PER_CONTACT_STEP} launches per step (a seed and "
        f"{N_SUBSTEPS} substeps), all on the {KERNEL_NAMES[picked]} kernel":
            counts == want and motor.launches == sum(want.values()),
        "pushed envs: non-zero tau_ext": bool(
            (tau0[:N_FORCED].abs().amax(1) > 1e-3).all()),
        "pushed envs: the object moved": bool((moved[:N_FORCED] > 1e-3).all()),
        "untouched objects rest on the table (z within 1e-3)": bool(
            ((s.body_pos[untouched, 0, 2] - rest).abs() < 1e-3).all()),
        "obs, reward, state finite": bool(
            torch.isfinite(obs["observation"]).all()
            and torch.isfinite(reward).all() and torch.isfinite(body).all()
            and torch.isfinite(s.q).all() and torch.isfinite(s.qd).all()),
        "obs shape": tuple(obs["observation"].shape) == (B, 18),
        "reward in {-1, 0}": bool(((reward == 0) | (reward == -1)).all()),
        "q in limits": bool(((s.q >= q_lo) & (s.q <= q_hi)).all()),
        "steps": bool((s.steps == n_steps).all()),
    }
    say(f"phase 11 main path: {task}, {n_steps} batched_step at B={B}, K1 "
        f"launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"tau_ext of the pushed envs at the first substep max "
        f"{tau0[:N_FORCED].abs().amax().item():.3f} N m, objects moved by "
        f"{moved[:N_FORCED].min().item():.4f}-"
        f"{moved[:N_FORCED].max().item():.4f} m, {int(untouched.sum())} "
        f"untouched at z {s.body_pos[untouched, 0, 2].min().item():.5f}-"
        f"{s.body_pos[untouched, 0, 2].max().item():.5f} (rest {rest}), "
        f"success rate {info['is_success'].float().mean().item():.4f}, "
        f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 11 checks of {task} at B={B} failed: {checks}")

    cmp = copy.copy(phys)
    cmp.motor = twin
    _, err, plain_ms = hold_step_routes(
        cmp, s_in, lambda a, b, idx: contact_diff(env, a, b),
        f"phase 11 {task} B={B}", dev, card)
    step_ms = time_contact(env, s, acts[n_steps:], task, card,
                           f", the plain route {plain_ms:.1f} ms for the "
                           f"physics of one step")
    return counts, err, step_ms


def time_contact(env, s, acts, task, card, note="", tag="phase 11",
                 warm_up=True, profile=True, both_readers=False):
    """The contact step's time: one step to warm up (unless the caller's
    steps warmed it), then each of the remaining steps timed alone between
    two synchronizes (median, min and max); then, with ``profile``, one
    profiled step, its launches and the card's busy share."""
    B = s.q.shape[0]
    if warm_up:
        s, *_ = env.batched_step(s, acts[0])
        acts = acts[1:]
    ms = []
    for a in acts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, *_ = env.batched_step(s, a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(ms))
    say(f"{tag} {task} batched_step B={B}: median {step_ms:.1f} ms/step "
        f"over {len(ms)} steps (min {min(ms):.1f}, max {max(ms):.1f}; "
        f"{B / step_ms * 1e3:.0f} env-steps/s at the median) on the K1 "
        f"route{note} | {card}")
    if profile:
        profile_step(env, s, acts[:1], card, n=1, tag=f"{tag} {task}",
                     both_readers=both_readers)
    return step_ms


def k1_substep_times(CD, model, rng, dev, card):
    """K1 per warm one-substep launch with tau_ext, as the contact step
    launches it, at B_CONTACT_TIMED: time per launch beside the bound
    (operations counted on the plain substep's trace, bytes with tau_ext
    and the set), and the plain version's time for one call.  Returns
    ({B: (ms, plain_ms, bound_ms)}, ops)."""
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)

    # the substep alone, from a given set (the seed is a launch of its own)
    tau1 = torch.full((1, 7), 10.0)
    warm1 = (torch.zeros(1, 7, dtype=torch.bool), torch.ones(1, 7))
    n_ops = count_plain_ops(
        model, 0, step=lambda q, qd, tgt: k1.plain_substep(q, qd, tgt, tau1,
                                                           warm1))
    out = {}
    for B in B_CONTACT_TIMED:
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        tau = 10.0 * torch.randn(B, 7, device=dev)
        warm = k1.seed(q, qd, tgt)
        ms = time_cuda(lambda: k1.substep(q, qd, tgt, tau, warm), 20,
                       queued=True)
        plain_ms = time_cuda(lambda: k1.plain_substep(q, qd, tgt, tau, warm),
                             1, warmup=1)
        bound = k1_bound_ms(n_ops, B, K1_SUBSTEP_BYTES)
        out[B] = (ms, plain_ms, bound)
        say(f"phase 11 K1 one warm substep with tau_ext B={B}: {ms:.4f} "
            f"ms/launch, bound {bound:.6f} ms ({n_ops} fp32 ops/env counted "
            f"from the plain substep, {K1_SUBSTEP_BYTES} bytes/env), "
            f"{ms / bound:.1f}x the bound; plain version {plain_ms:.1f} ms "
            f"for one call | {card}")
    return out, n_ops


def drive_reach_ao_warm(CD, _hi_prec, dev, card):
    """Phase 11, ReachAO under PANDA_LCP_WARM=1: one reachao1 step at the
    main path's B, K1 one seed and 20 warm one-substep launches (counts set
    to 0 just before the step and read just after), the K1 route held
    against the plain warm route.  Returns (launches, largest error)."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.ops import dynamics as D

    saved = os.environ.get("PANDA_LCP_WARM"), D.LCP_WARM_START
    os.environ["PANDA_LCP_WARM"], D.LCP_WARM_START = "1", True
    try:
        env = make_reach_ao_core("reachao1", device="cuda")
    finally:
        if saved[0] is None:
            del os.environ["PANDA_LCP_WARM"]
        else:
            os.environ["PANDA_LCP_WARM"] = saved[0]
        D.LCP_WARM_START = saved[1]
    phys = env.physics_step_batched
    motor = phys.motor
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, _ = env.batched_reset(B_MAIN, gen)
    a = torch.rand(B_MAIN, 7, generator=gen, device=dev) * 2.0 - 1.0
    s_in = _hi_prec(env.robot.set_action)(states, a)
    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    s, obs, *_ = env.batched_step(states, a)
    torch.cuda.synchronize()
    counts = dict(motor.kernel_launches)
    checks = {
        "warm": phys.warm_start,
        f"K1: {K1_PER_CONTACT_STEP} launches, all on the lane-group kernel":
            counts == {CD.LANES: K1_PER_CONTACT_STEP, CD.THREAD: 0},
        "obs finite": bool(torch.isfinite(obs["observation"]).all()),
    }
    say(f"phase 11 main path: reachao1 under PANDA_LCP_WARM=1, one "
        f"batched_step at B={B_MAIN}, K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, checks "
        f"{checks}")
    if not all(checks.values()):
        fail(f"phase 11 ReachAO warm checks failed: {checks}")
    cmp = copy.copy(phys)
    cmp.motor = CD.make_cuda_motor_steps(env.model, n_substeps=1, dt=DT,
                                         ctrl_mode=motor.ctrl_mode,
                                         warm_start=False)
    _, err, _ = hold_step_routes(cmp, s_in,
                                 lambda a, b, idx: route_diff(a, b),
                                 f"phase 11 reachao1 warm B={B_MAIN}", dev,
                                 card)
    return motor.launches, err


def drive_push_training(CD, dev, card, run_root):
    """Phase 11, Push training: Trainer.learn at n_envs 64 with the TQC
    preset at full width, cut to PUSH_TRAIN_STEPS env steps of horizon 20,
    K1's counts set to 0 as the env is made.  Checks: 21 K1 launches per
    env step, losses finite, the buffer on the card.  Times: ms per collect
    env step and per TQC update.  Returns the K1 launches of the run."""
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    from panda_gym_tpu_torch.rl.config import TrainConfig

    cfg = TrainConfig(
        n_envs=N_ENVS, stages=["push"], max_ep_steps=[HORIZON],
        max_timesteps=PUSH_TRAIN_STEPS,
        learning_starts=PUSH_TRAIN_STEPS // 2,
        interleave_min_buffer=PUSH_TRAIN_STEPS // 4,
        eval_freq=10 * PUSH_TRAIN_STEPS, ee_error_thresholds=[0.05],
        success_thresholds=[2.0], benchmark_eval_scenes=[])
    trainer, core, seconds = run_trainer(
        cfg, dev, run_root, CD, build=lambda sc: make_core(sc),
        name="phase11")
    motor = core.physics_step_batched.motor
    counts = dict(motor.kernel_launches)
    rows, burst, fused = rollout_rows(trainer)
    env_steps = HORIZON * len(rows)
    buf = trainer.buffer
    metrics = [v for r in rows for k, v in r.items()
               if k in ("critic_loss", "actor_loss", "alpha")]
    checks = {
        f"K1: {K1_PER_CONTACT_STEP} launches per env step, all on the "
        f"lane-group kernel":
            counts == {CD.LANES: K1_PER_CONTACT_STEP * env_steps,
                       CD.THREAD: 0},
        "a burst and a fused rollout": len(burst) > 0 and len(fused) > 0,
        "losses and alpha finite": bool(metrics) and all(
            np.isfinite(v) for v in metrics),
        "buffer on cuda": all(getattr(buf, k).device.type == "cuda"
                              for k in ("obs", "achieved", "desired",
                                        "action", "aux")),
        "obs of the contact task": buf.obs.shape[-1] == 18,
    }
    say(f"phase 11 main path: Trainer.learn on push at n_envs={N_ENVS}, "
        f"{len(rows)} rollouts ({len(fused)} fused), {env_steps} env steps, "
        f"K1 launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"{trainer.ts.step} updates, checks {checks}")
    if not all(checks.values()):
        fail(f"phase 11 Push training checks failed: {checks}")
    coll = [r for r in rows if r not in fused]
    ms = [r["t_collect"] * 1e3 / HORIZON for r in coll]
    say(f"phase 11 Push collect env step at B={N_ENVS}: "
        f"{', '.join(f'{m:.1f}' for m in ms)} ms per env step over "
        f"{len(ms)} rollouts of {HORIZON}; training {trainer.timesteps} env "
        f"steps in {seconds:.2f} s | {card}")
    update_times(trainer, core, card, "phase 11 Push")
    return counts[CD.LANES]


# ----------------------------------------------------------------- phase 12
# K1 on the chains besides the welded Panda: MyCobot's 6 serial revolute
# dofs (MyCobotReach, robot-only: one launch of 20 warm substeps per step)
# and the 9-dof Panda whose prismatic fingers hang from link 6
# (PickAndPlace, Flip and Stack on the contact path: a seed and 20 warm
# one-substep launches with tau_ext per step).  Both run the
# one-env-per-thread kernel at every B.
CHAIN_CHECK_B = (1, B_MAIN, B_MAIN + 4)
MYCOBOT_MAIN = ((B_MAIN, 10), (B_BENCH, 3))
# PickAndPlace at bench.py's free-body batch and the trainer's n_envs,
# Flip and Stack at the main path's B; 3 steps each on the main path
GRIPPER = (("pickandplace", 16384), ("pickandplace", N_ENVS),
           ("flip", B_MAIN), ("stack", B_MAIN))
GRIPPER_STEPS = 3
# envs 0-7: the cube between the open fingers (3 cm each, the capsules
# 2 mm deep in its faces) and a closing action (2 mm of width per step);
# Stack's envs 8-15: the second cube 1.5 mm into the top of the first
FINGER_Q, FINGER_CLOSE = 0.03, -0.02
STACKED = 0.04 - 0.0015
# a cube squeezed by two fingers is stiff in rotation (the JAX package's own
# two steps part by up to 1.4e-2 in its velocities over 3 steps,
# tests/test_torch_gripper.py): on an H100 the K1 route and the plain route
# part by up to 1.13e-3 (PickAndPlace) and 1.48e-3 (Flip) in the gripped
# envs' last 6 observation entries (the object's velocities) from this
# script's states, which are held at twice that
ATOL_GRIP_VEL = 3e-3
# K1 timed: MyCobot's 20 warm substeps, the 9-dof Panda's warm substep
# with tau_ext
B_MYCOBOT_TIMED = (N_ENVS, B_MAIN, B_BENCH)
B_GRIPPER_TIMED = (N_ENVS, B_MAIN, 16384)
# Trainer.learn on PickAndPlace under the committed
# training/run_data/round2_classic/tqc_pickandplace/config.json (the chip
# machine's copy leaves training/ out): TQC at full width [256, 256], 25
# quantiles, n_envs 64, horizon 50, the reference's ee control (the file
# records TrainConfig's js default of its day); cut to one collect rollout
# of 64 x 50 and its burst
PNP_TRAIN = dict(n_envs=64, horizon=50, net_arch=[256, 256], n_quantiles=25)


def chain_models():
    """MyCobot (the reference's zero efforts) and the 9-dof Panda, at the
    classic tasks' base."""
    from panda_gym_tpu_torch.models.mycobot import make_mycobot_model
    from panda_gym_tpu_torch.models.panda import make_panda_model

    base = (-0.6, 0.0, 0.0)
    return {"mycobot": make_mycobot_model(base_position=base),
            "panda9": make_panda_model(base_position=base,
                                       gripper="prismatic")}


def check_mycobot_k1(CD, model, rng, dev):
    """K1 on MyCobot against its plain version, 20 warm substeps, position
    and velocity control, at B 1, 4096 and 4100, and at bench.py's 65536
    under phase 3's near-tie rule.  Returns the largest error."""
    err = 0.0
    for ctrl_mode in (0, 1):
        k1 = CD.make_cuda_motor_steps(model, n_substeps=N_SUBSTEPS, dt=DT,
                                      ctrl_mode=ctrl_mode, warm_start=True)
        for B in CHAIN_CHECK_B + (B_BENCH,):
            q, qd, tgt = motor_inputs(model, B, ctrl_mode, rng, dev)
            qp, qdp = k1.plain(q, qd, tgt)
            out = k1.launch(q, qd, tgt, CD.THREAD)
            label = (f"phase 12 K1 MyCobot (6 dofs) vs plain: ctrl_mode="
                     f"{ctrl_mode} B={B}")
            err = max(err, hold_with_ties(k1, CD.THREAD, (q, qd, tgt), out,
                                          (qp, qdp), label, dev))
    return err


def check_gripper_k1(CD, model, rng, dev):
    """K1 on the 9-dof Panda against its plain version at B 1, 4096 and
    4100: the seed launch (its active set equal to the plain seed's), then
    one warm substep with a contact torque from the carried set (q, qd
    within the tolerances, the set equal).  Returns the largest error."""
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    err = 0.0
    for B in CHAIN_CHECK_B:
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        tau = 5.0 * torch.randn(B, 9, device=dev)
        warm = k1.seed(q, qd, tgt)
        psat, _ = k1.plain_seed(q, qd, tgt)
        qk, qdk, wk = k1.substep(q, qd, tgt, tau, warm)
        qp, qdp, wp = k1.plain_substep(q, qd, tgt, tau, warm)
        torch.cuda.synchronize()
        eq = (qk - qp).abs().max().item()
        eqd = (qdk - qdp).abs().max().item()
        ok = (eq <= ATOL_Q and eqd <= ATOL_QD and torch.equal(warm[0], psat)
              and torch.equal(wk[0], wp[0]) and torch.equal(wk[1], wp[1]))
        say(f"phase 12 K1 9-dof Panda vs plain: seed, then one warm substep "
            f"with tau_ext, B={B}: seed set equal "
            f"{torch.equal(warm[0], psat)}, max|dq|={eq:.3e} (atol "
            f"{ATOL_Q}) max|dqd|={eqd:.3e} (atol {ATOL_QD}), carried set "
            f"equal {torch.equal(wk[0], wp[0])} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 on the 9-dof Panda disagrees with its plain version "
                 f"at B={B}")
        err = max(err, eq, eqd)
    return err


def chain_k1_times(CD, models, rng, dev, card):
    """K1 per launch on the two chains beside its bound: MyCobot's 20 warm
    substeps at B_MYCOBOT_TIMED, the 9-dof Panda's warm substep with
    tau_ext at B_GRIPPER_TIMED (operations counted on the chain's plain
    version, bytes from its dofs), and the plain version's time.  Returns
    {chain: ({B: (ms, plain_ms, bound_ms)}, ops, bytes per env)}."""
    out = {}
    model = models["mycobot"]
    k1 = CD.make_cuda_motor_steps(model, n_substeps=N_SUBSTEPS, dt=DT,
                                  ctrl_mode=0, warm_start=True)
    ops, nbytes = count_plain_ops(model, 0), k1_bytes(6)
    times = {}
    for B in B_MYCOBOT_TIMED:
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        ms = time_cuda(lambda: k1(q, qd, tgt), 10 if B > B_MAIN else 20,
                       queued=True)
        plain_ms = time_cuda(lambda: k1.plain(q, qd, tgt), 1, warmup=0)
        bound = k1_bound_ms(ops, B, nbytes)
        times[B] = (ms, plain_ms, bound)
        say(f"phase 12 K1 MyCobot 20 warm substeps B={B}: {ms:.4f} ms/launch, "
            f"bound {bound:.6f} ms ({ops} fp32 ops/env counted from the plain "
            f"version, {nbytes} bytes/env), {ms / bound:.1f}x the bound; "
            f"plain version {plain_ms:.1f} ms | {card}")
    out["mycobot"] = (times, ops, nbytes)
    model = models["panda9"]
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=DT, ctrl_mode=0,
                                  warm_start=False)
    tau1 = torch.full((1, 9), 10.0)
    warm1 = (torch.zeros(1, 9, dtype=torch.bool), torch.ones(1, 9))
    ops = count_plain_ops(model, 0, step=lambda q, qd, tgt: k1.plain_substep(
        q, qd, tgt, tau1, warm1))
    nbytes = k1_substep_bytes(9)
    times = {}
    for B in B_GRIPPER_TIMED:
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        tau = 10.0 * torch.randn(B, 9, device=dev)
        warm = k1.seed(q, qd, tgt)
        ms = time_cuda(lambda: k1.substep(q, qd, tgt, tau, warm), 20,
                       queued=True)
        plain_ms = time_cuda(lambda: k1.plain_substep(q, qd, tgt, tau, warm),
                             1, warmup=1)
        bound = k1_bound_ms(ops, B, nbytes)
        times[B] = (ms, plain_ms, bound)
        say(f"phase 12 K1 9-dof Panda one warm substep with tau_ext B={B}: "
            f"{ms:.4f} ms/launch, bound {bound:.6f} ms ({ops} fp32 ops/env "
            f"counted from the plain substep, {nbytes} bytes/env), "
            f"{ms / bound:.1f}x the bound; plain version {plain_ms:.1f} ms "
            f"| {card}")
    out["panda9"] = (times, ops, nbytes)
    return out


def grip_objects(env, states, dev):
    """Envs 0-7 with open fingers and the cube between them, turned with the
    hand; Stack's envs 8-15 with the second cube put on the first."""
    from panda_gym_tpu_torch.ops import kinematics as K

    n = N_FORCED
    q = states.q.clone()
    q[:n, 7:9] = FINGER_Q
    p0, p1 = K.capsule_endpoints_world(env.model, K.fk_world(env.model, q))
    mid = 0.5 * (p0 + p1)
    left, right = (env.model.cap_body_tuple.index(d) for d in (7, 8))
    d = mid[:n, right] - mid[:n, left]
    yaw = torch.atan2(d[:, 1], d[:, 0])
    pos, quat = states.body_pos.clone(), states.body_quat.clone()
    pos[:n, 0] = 0.5 * (mid[:n, left] + mid[:n, right])
    zero = torch.zeros_like(yaw)
    quat[:n, 0] = torch.stack([zero, zero, torch.sin(yaw / 2),
                               torch.cos(yaw / 2)], -1)
    if env.task.scene.nb > 1:
        pos[n:2 * n, 1] = pos[n:2 * n, 0] + torch.tensor([0.0, 0.0, STACKED],
                                                         device=dev)
        quat[n:2 * n, 1] = quat[n:2 * n, 0]
    return states.replace(q=q, ctrl_target=q.clone(), body_pos=pos,
                          body_quat=quat)


def gripper_diff(env, a, b, idx):
    """contact_diff; with one object (PickAndPlace, Flip), the last 6
    observation entries (the object's velocity and angular velocity) of the
    gripped envs held at ATOL_GRIP_VEL.  Stack is held by phase 11's rule
    throughout."""
    sa, oa, ra, *_ = env._step_post(a)
    sb, ob, rb, *_ = env._step_post(b)
    atol = torch.full_like(oa["observation"], ATOL_OBS)
    if env.task.scene.nb == 1:
        atol[idx < N_FORCED, -6:] = ATOL_GRIP_VEL
    return (((a.q - b.q).abs() > ATOL_Q).any(1)
            | ((a.qd - b.qd).abs() > ATOL_QD).any(1)
            | ((oa["observation"] - ob["observation"]).abs() > atol).any(1)
            | ((ra - rb).abs() > ATOL_REWARD))


def drive_gripper(make_core, _hi_prec, CD, task, B, dev, card,
                  profile=True):
    """Phase 12 for one gripper task at batch B: the main path
    (batched_reset, grip_objects, GRIPPER_STEPS batched_step calls under ee
    control, the gripped envs closing), K1's counts set to 0 just before
    and read just after; the checks; the K1 route held against the plain
    route on the first step's states; the step's time and, with
    ``profile``, a profile.  Returns (counts, largest K1 error, step ms)."""
    env = make_core(task)
    phys = env.physics_step_batched
    motor = phys.motor
    twin = CD.make_cuda_motor_steps(env.model, n_substeps=1, dt=DT,
                                    ctrl_mode=motor.ctrl_mode,
                                    warm_start=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, _ = env.batched_reset(B, gen)
    states = grip_objects(env, states, dev)
    start = states.body_pos.clone()
    acts = [torch.rand(B, 4, generator=gen, device=dev) * 2.0 - 1.0
            for _ in range(GRIPPER_STEPS + N_TIMED)]
    for a in acts:
        a[:N_FORCED, 3] = FINGER_CLOSE
    s_in = _hi_prec(env.robot.set_action)(states, acts[0])
    *_, tau0, _ = _hi_prec(phys.forces)(s_in.q, s_in.qd, s_in.body_pos,
                                        s_in.body_quat, s_in.body_vel,
                                        s_in.body_ang)
    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    s = states
    for i in range(GRIPPER_STEPS):
        s, obs, reward, terminated, truncated, info = env.batched_step(
            s, acts[i])
    torch.cuda.synchronize()
    counts = dict(motor.kernel_launches)
    want = {CD.LANES: 0, CD.THREAD: K1_PER_CONTACT_STEP * GRIPPER_STEPS}
    n = N_FORCED
    moved = (s.body_pos[:, 0] - start[:, 0]).abs().amax(1)
    fingers = (s.q[:n, 7:9] - states.q[:n, 7:9]).abs().amin(1)
    rest = rest_height(env.task.scene)
    stacked = task == "stack"
    # untouched: not gripped (nor stacked), the arm never reached the
    # object; in Stack the second cube, dropped by the reset 4 cm above the
    # table, must also have fallen clear of the first
    untouched = (s.body_pos[:, 0, :2] - start[:, 0, :2]).abs().amax(1) < 1e-4
    untouched[:2 * n if stacked else n] = False
    if stacked:
        untouched &= (s.body_pos[:, 1, :2] - s.body_pos[:, 0, :2]).norm(
            dim=1) > 0.045
    q_lo = torch.as_tensor(env.model.q_lo, device=dev)
    q_hi = torch.as_tensor(env.model.q_hi, device=dev)
    body = torch.cat([s.body_pos, s.body_quat, s.body_vel, s.body_ang], -1)
    obs_dim = {"pickandplace": 19, "flip": 20, "stack": 31}[task]
    checks = {
        f"K1: {K1_PER_CONTACT_STEP} launches per step (a seed and "
        f"{N_SUBSTEPS} substeps), all on the one-env-per-thread kernel":
            counts == want and motor.launches == sum(want.values()),
        "gripped envs: tau_ext on both finger dofs": bool(
            (tau0[:n, 7:9].abs() > 1e-3).all()),
        "gripped envs: the finger dofs moved": bool((fingers > 1e-4).all()),
        "gripped envs: the cube moved": bool((moved[:n] > 1e-4).all()),
        "untouched objects rest on the table (z within 1e-3)": bool(
            ((s.body_pos[untouched, 0, 2] - rest).abs() < 1e-3).all()),
        "obs, reward, state finite": bool(
            torch.isfinite(obs["observation"]).all()
            and torch.isfinite(reward).all() and torch.isfinite(body).all()
            and torch.isfinite(s.q).all() and torch.isfinite(s.qd).all()),
        "obs shape": tuple(obs["observation"].shape) == (B, obs_dim),
        "reward in {-1, 0}": bool(((reward == 0) | (reward == -1)).all()),
        "q in limits": bool(((s.q >= q_lo) & (s.q <= q_hi)).all()),
        "steps": bool((s.steps == GRIPPER_STEPS).all()),
    }
    note = ""
    if stacked:
        top = s.body_pos[n:2 * n, 1]
        rise = top[:, 2] - s.body_pos[n:2 * n, 0, 2]
        off = (top[:, :2] - s.body_pos[n:2 * n, 0, :2]).abs().amax(1)
        checks["stacked envs: the second cube rests on the first (its z "
               "within 1e-3 of the first's + 0.04, x and y within 1e-3)"] = \
            bool(((rise - 0.04).abs() < 1e-3).all() and (off < 1e-3).all())
        note = (f", stacked cubes at z {top[:, 2].min().item():.5f}-"
                f"{top[:, 2].max().item():.5f} (first cube "
                f"{s.body_pos[n:2 * n, 0, 2].min().item():.5f}-"
                f"{s.body_pos[n:2 * n, 0, 2].max().item():.5f})")
    say(f"phase 12 main path: {task} (ee), {GRIPPER_STEPS} batched_step at "
        f"B={B}, K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, tau_ext on "
        f"the fingers of the gripped envs at the first substep "
        f"{tau0[:n, 7:9].abs().min().item():.3f}-"
        f"{tau0[:n, 7:9].abs().max().item():.3f} N, fingers moved by "
        f"{fingers.min().item():.5f}+ m, gripped cubes moved by "
        f"{moved[:n].min().item():.4f}-{moved[:n].max().item():.4f} m{note}, "
        f"{int(untouched.sum())} untouched at z "
        f"{s.body_pos[untouched, 0, 2].min().item():.5f}-"
        f"{s.body_pos[untouched, 0, 2].max().item():.5f} (rest {rest}), "
        f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 12 checks of {task} at B={B} failed: {checks}")

    cmp = copy.copy(phys)
    cmp.motor = twin
    t = time.perf_counter()
    (out_k, out_p), err, plain_ms = hold_step_routes(
        cmp, s_in, lambda a, b, idx: gripper_diff(env, a, b, idx),
        f"phase 12 {task} B={B}", dev, card)
    if env.task.scene.nb == 1:
        gap = (env._step_post(out_k)[1]["observation"][:N_FORCED]
               - env._step_post(out_p)[1]["observation"][:N_FORCED]).abs()
        say(f"phase 12 {task} B={B}: the gripped envs' largest observation "
            f"gap between the routes (ties included) "
            f"{gap[:, -6:].max().item():.3e} on the object's velocities "
            f"(held at {ATOL_GRIP_VEL}), {gap[:, :-6].max().item():.3e} on "
            f"the other entries (held at {ATOL_OBS})")
    say(f"phase 12 {task} B={B}: holding the routes took "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    step_ms = time_contact(env, s, acts[GRIPPER_STEPS:], task, card,
                           f", the plain route {plain_ms:.1f} ms for the "
                           f"physics of one step", tag="phase 12",
                           warm_up=False, profile=profile)
    say(f"phase 12 {task} B={B}: the step's timing and profile took "
        f"{time.perf_counter() - t:.1f} s")
    return counts, err, step_ms


def drive_gripper_training(CD, dev, card, run_root):
    """Phase 12, PickAndPlace training: Trainer.learn under PNP_TRAIN, cut
    to one collect rollout and its burst, K1's counts set to 0 as the env
    is made.  Checks: 21 K1 launches per env step, the burst ran, losses
    finite, the buffer on the card.  Returns the K1 launches of the run."""
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig

    n_envs, horizon = PNP_TRAIN["n_envs"], PNP_TRAIN["horizon"]
    steps = n_envs * horizon
    cfg = TrainConfig(
        n_envs=n_envs, stages=["pickandplace"], max_ep_steps=[horizon],
        max_timesteps=steps, learning_starts=steps, eval_freq=10 * steps,
        ee_error_thresholds=[0.05], success_thresholds=[2.0],
        benchmark_eval_scenes=[], control_type="ee")
    cfg.hyperparams = Hyperparameters("TQC")
    hp = cfg.hyperparams
    if (hp.policy_kwargs["net_arch"] != PNP_TRAIN["net_arch"]
            or hp.n_quantiles != PNP_TRAIN["n_quantiles"]):
        fail(f"the TQC preset is not tqc_pickandplace's: {hp}")
    trainer, core, seconds = run_trainer(
        cfg, dev, run_root, CD, build=lambda sc: make_core(sc),
        name="phase12")
    motor = core.physics_step_batched.motor
    counts = dict(motor.kernel_launches)
    rows, burst, _ = rollout_rows(trainer)
    env_steps = horizon * len(rows)
    buf = trainer.buffer
    metrics = [v for r in rows for k, v in r.items()
               if k in ("critic_loss", "actor_loss", "alpha")]
    checks = {
        f"K1: {K1_PER_CONTACT_STEP} launches per env step, all on the "
        f"one-env-per-thread kernel":
            counts == {CD.LANES: 0,
                       CD.THREAD: K1_PER_CONTACT_STEP * env_steps},
        "a collect rollout and its burst": len(burst) >= 1
        and trainer.ts.step > 0,
        "losses and alpha finite": bool(metrics) and all(
            np.isfinite(v) for v in metrics),
        "buffer on cuda": all(getattr(buf, k).device.type == "cuda"
                              for k in ("obs", "achieved", "desired",
                                        "action", "aux")),
        "obs of PickAndPlace": buf.obs.shape[-1] == 19,
    }
    say(f"phase 12 main path: Trainer.learn on pickandplace at n_envs="
        f"{n_envs}, horizon {horizon}, {len(rows)} rollout, {env_steps} env "
        f"steps, K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"{trainer.ts.step} updates, checks {checks}")
    if not all(checks.values()):
        fail(f"phase 12 PickAndPlace training checks failed: {checks}")
    r = rows[0]
    say(f"phase 12 PickAndPlace collect env step at B={n_envs}: "
        f"{r['t_collect'] * 1e3 / horizon:.1f} ms; the burst of "
        f"{trainer.ts.step} updates {r['t_update']:.2f} s; training "
        f"{trainer.timesteps} env steps in {seconds:.2f} s | {card}")
    return counts[CD.THREAD]


def phase12(make_core, _hi_prec, CD, rng, dev, card):
    """Phase 12; returns what the kernels line needs."""
    t0 = time.perf_counter()
    mark = lambda what: say(  # noqa: E731
        f"phase 12 {what} at {time.perf_counter() - t0:.1f} s")
    models = chain_models()
    cob_err = check_mycobot_k1(CD, models["mycobot"], rng, dev)
    grip_err = check_gripper_k1(CD, models["panda9"], rng, dev)
    mark("K1 checks done")
    cob = {}
    for B, n_steps in MYCOBOT_MAIN:
        counts, e, _, _ = drive(make_core, _hi_prec, CD, B, n_steps, dev,
                                tag="phase 12", task="mycobotreach")
        if counts != {CD.LANES: 0, CD.THREAD: n_steps}:
            fail(f"phase 12 MyCobotReach K1 launches at B={B} were {counts}")
        cob[B] = (counts[CD.THREAD], max(e, cob_err))
    for B, _ in MYCOBOT_MAIN:
        env = make_core("mycobotreach")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        states, _ = env.batched_reset(B, gen)
        acts = [torch.rand(B, 6, generator=gen, device=dev) * 2.0 - 1.0
                for _ in range(N_TIMED + 1)]
        cob[B] += (time_contact(env, states, acts, "mycobotreach", card,
                                tag="phase 12", both_readers=True),)
    mark("MyCobotReach done")
    grip = {}
    for i, (task, B) in enumerate(GRIPPER):
        # one profile per task
        first = all(t != task for t, _ in GRIPPER[:i])
        counts, e, step_ms = drive_gripper(make_core, _hi_prec, CD, task, B,
                                           dev, card, profile=first)
        grip[task, B] = (counts[CD.THREAD], max(e, grip_err), step_ms)
        mark(f"{task} at B={B} done")
    with tempfile.TemporaryDirectory() as run_root:
        train_launches = drive_gripper_training(CD, dev, card, run_root)
    mark("training done")
    times = chain_k1_times(CD, models, rng, dev, card)
    say(f"phase 12 done in {time.perf_counter() - t0:.1f} s")
    return cob, grip, train_launches, times


# ----------------------------------------------------------------- phase 13
# population training: the round-5 campaign's pop_rs run
# (tools/campaign_round5.sh:25-34) at its width, 4 members of the TQC preset
# ([256, 256], 25 quantiles, 2 critics, batch 256, gSDE) with 64 envs each
# on its first stage; cut in depth only: horizon 20 for 100, and a
# per-member budget of three rollouts of 64 x 20 (a collect rollout, then
# fused ones) with one evaluation at its end
POP_MEMBERS = 4
POP_SCENE = "reachao_rand_start_p25"
POP_STEPS = 3 * N_ENVS * HORIZON
# TD3 and DDPG through the Trainer on Reach at the trainer's n_envs, the
# reference's Reach horizon, three rollouts
REACH_HORIZON = 50
# one PPO iteration at the PPO preset (rl/config.py): 16 envs, n_steps 512,
# 20 epochs of minibatches of 128
PPO_ENVS = 16
# distillation: the routed generalist labels 64 episodes of reachao1 (a
# behavioural-cloning round with DART drive noise), then 200 BC steps
DISTILL_HORIZON = 50
DISTILL_NOISE = 0.2
BC_STEPS = 200
# whole runs of many Adam steps (PPO's 1280, BC's 200) amplify rounding
# chaotically, so neither device is the other's reference: both are held
# against the same run in float64 on the CPU, and the card's relative
# distance from it (the new parameters, the policy's actions on the data,
# the losses) may be at most RUN_FACTOR times the float32 CPU's, plus
# RUN_FLOOR
RUN_FACTOR, RUN_FLOOR = 4.0, 1e-6


def pop_config():
    """The population run's TrainConfig: learning starts and the buffer
    gate opens after the first rollout; the evaluation falls at the end."""
    from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
    cfg = TrainConfig(
        n_envs=N_ENVS, stages=[POP_SCENE], max_ep_steps=[HORIZON],
        max_timesteps=POP_STEPS, learning_starts=N_ENVS * HORIZON // 4,
        interleave_min_buffer=N_ENVS * HORIZON // 4, eval_freq=POP_STEPS,
        success_thresholds=[2.0], ee_error_thresholds=[0.05],
        speed_thresholds=[0.5], benchmark_eval_scenes=[])
    cfg.hyperparams = Hyperparameters("TQC")
    return cfg


def reset_counts(CD, core):
    motor = core.physics_step_batched.motor
    motor.launches = 0
    motor.kernel_launches = {CD.LANES: 0, CD.THREAD: 0}
    return motor


def k1_core_error(CD, core, B, dev, label):
    """K1 as the core launches it (its substeps, warm or cold) against its
    plain version on one step's states at batch B: a reset and random
    actions (a second wrapper, whose launches stay out of the main path's
    counts).  Returns the largest error."""
    from panda_gym_tpu_torch.envs.core import _hi_prec

    motor = core.physics_step_batched.motor
    twin = CD.make_cuda_motor_steps(core.model, n_substeps=motor.n_substeps,
                                    dt=motor.dt, ctrl_mode=motor.ctrl_mode,
                                    warm_start=motor.warm_start)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, _ = core.batched_reset(B, gen)
    a = torch.rand(B, core.robot.action_dim, generator=gen,
                   device=dev) * 2.0 - 1.0
    s_in = _hi_prec(core.robot.set_action)(states, a)
    x = (s_in.q.contiguous(), s_in.qd.contiguous(),
         s_in.ctrl_target.contiguous())
    qk, qdk = twin(*x)
    qp, qdp = twin.plain(*x)
    eq = (qk - qp).abs().max().item()
    eqd = (qdk - qdp).abs().max().item()
    say(f"{label}: K1 ({motor.n_substeps} substep(s), "
        f"{'warm' if motor.warm_start else 'cold'}) vs plain at B={B}: "
        f"max|dq|={eq:.3e} (atol {ATOL_Q}) max|dqd|={eqd:.3e} (atol "
        f"{ATOL_QD})")
    if eq > ATOL_Q or eqd > ATOL_QD:
        fail(f"{label}: K1 disagrees with its plain version")
    return max(eq, eqd)


def run_population(CD, dev, run_root):
    """PopulationTrainer.learn on the card, every batched_step's batch
    recorded and K1's counts set to 0 as the env is made, just before the
    run.  Returns (trainer, core, logged rows, batches, seconds)."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.population import PopulationTrainer

    cfg = pop_config()
    cores, batches, rows = [], [], []

    def make_env(sc, thr, spd):
        core = make_reach_ao_core(sc, config=cfg, ee_error_threshold=thr,
                                  speed_threshold=spd, device=dev.type)
        step = core.batched_step

        def counted(states, actions):
            batches.append(actions.shape[0])
            return step(states, actions)

        core.batched_step = counted
        reset_counts(CD, core)
        cores.append(core)
        return core

    logger = RunLogger(group="chip_smoke", name="phase13", config=cfg,
                       root=run_root)
    log = logger.log
    logger.log = lambda row: (rows.append(row), log(row))
    pt = PopulationTrainer(cfg, make_env, POP_MEMBERS, logger=logger)
    t0 = time.perf_counter()
    pt.learn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    logger.close()
    del cores[0].batched_step
    return pt, cores[0], rows, batches, seconds


def stacked_vs_cpu_and_members(pt, core, card):
    """One stacked update of the trained population on the card against
    the same update on the CPU (the state copied) and against each member's
    own update on the card (member_slice), from the same state, batch and
    noise: losses and alpha rtol 1e-4, every gradient rtol 1e-4 / atol
    1e-6 (phase 8's rule, each gradient from the same inputs: the actor's,
    which reads the stepped critic, taken again with the other side's); the
    members' new parameters and moments within atol 1e-5 of the stacked
    update's (tests/test_population.py's rule).  Returns the batch, the
    noise and the members, for the times."""
    from torch.func import vmap

    from panda_gym_tpu_torch.rl import her
    from panda_gym_tpu_torch.rl.learners import make_learner, named_state
    from panda_gym_tpu_torch.rl.population import (StackedLearner,
                                                   member_slice,
                                                   pop_named_state)
    from panda_gym_tpu_torch.rl.train import learner_batch, schedule

    cfg, stacked, pop, buf, gen = (pt.config, pt.stacked, pt.pop, pt.buffer,
                                   pt.generator)
    L, K = stacked.learner, stacked.K
    dev = pop.log_alpha.device
    bs = schedule(cfg, HORIZON).batch_size

    def rf(achieved_next, goal, aux):
        return core.task.reward_from_aux(core, achieved_next, goal, aux)

    batch = learner_batch(her.gather_stacked(
        buf, her.draw_stacked(buf, gen, bs), rf))
    noise = stacked.update_noise(gen, bs)
    noise_a = L.split_noise(noise)[1]
    cpu = StackedLearner(make_learner(cfg.algorithm, L.obs_dim, L.act_dim,
                                      cfg.hyperparams, "cpu"), K)
    pop_cpu = cpu.init(torch.Generator().manual_seed(0))
    live = pop_named_state(pop)
    with torch.no_grad():
        for k, t in pop_named_state(pop_cpu).items():
            t.copy_(live[k].cpu())
    pop_cpu.step = pop.step
    members = [member_slice(stacked, pop, i) for i in range(K)]
    actors0 = [copy.deepcopy(ts.actor) for ts in members]
    actor0 = {k: v.detach().clone() for k, v in pop.actor.items()}
    alpha = torch.exp(pop.log_alpha.detach())
    _, m_card = stacked.update(pop, batch, noise)
    _, m_cpu = cpu.update(pop_cpu, {k: v.cpu() for k, v in batch.items()},
                          tuple(n.cpu() for n in noise))
    m_mem = [L.update(members[i], {k: v[i] for k, v in batch.items()},
                      tuple(n[i] for n in noise))[1] for i in range(K)]

    def stacked_actor_grads(critic):
        """The stacked actor loss's gradients at the pre-update actor under
        ``critic`` (stacked leaves on the card)."""
        pa = {k: v.clone().requires_grad_(True) for k, v in actor0.items()}

        def loss(pa_, pc, x, n, al):
            nets = stacked._nets(actor=pa_, critic=pc)
            return L.actor_loss(nets.actor, nets.critic, x, n, al)[0]

        total = vmap(loss, in_dims=(0, 0, 0, None if noise_a is None
                                    else 0, 0))(
            pa, critic, batch["x"], noise_a, alpha).sum()
        return dict(zip(pa, torch.autograd.grad(total, list(pa.values()))))

    def over(a, b):
        return int(((a - b).abs() > ATOL_GRAD + RTOL_LEARN * b.abs()).sum())

    rel = lambda a, b: (a - b).abs().max().item() / max(  # noqa: E731
        b.abs().max().item(), 1e-30)
    m_keys = ("critic_loss", "actor_loss", "alpha")
    # the card against the CPU
    g_card = {f"critic/{k}": v.grad for k, v in pop.critic.items()}
    g_card["log_alpha"] = pop.log_alpha.grad
    g_card.update({f"actor/{k}": v for k, v in stacked_actor_grads(
        {k: v.to(dev) for k, v in pop_cpu.critic.items()}).items()})
    g_cpu = {f"critic/{k}": v.grad for k, v in pop_cpu.critic.items()}
    g_cpu["log_alpha"] = pop_cpu.log_alpha.grad
    g_cpu.update({f"actor/{k}": v.grad for k, v in pop_cpu.actor.items()})
    worst_cpu = max(rel(m_card[k].cpu(), m_cpu[k]) for k in m_keys)
    n_cpu = sum(over(g_card[k].cpu(), g_cpu[k]) for k in g_cpu)
    err_cpu = max((g_card[k].cpu() - g_cpu[k]).abs().max().item()
                  for k in g_cpu)
    # the stacked update against each member's own, on the card
    worst_mem, n_mem, err_mem, par_mem = 0.0, 0, 0.0, 0.0
    after = pop_named_state(pop)
    for i, ts in enumerate(members):
        worst_mem = max([worst_mem] + [rel(m_card[k][i], m_mem[i][k])
                                       for k in m_keys])
        critic = copy.deepcopy(ts.critic)
        with torch.no_grad():
            for (n, p) in critic.named_parameters():
                p.copy_(pop.critic[n][i])
        names, params = zip(*actors0[i].named_parameters())
        g = torch.autograd.grad(L.actor_loss(
            actors0[i], critic, batch["x"][i], noise_a[i], alpha[i])[0],
            params)
        mine = {f"critic/{n}": p.grad for n, p in ts.critic.named_parameters()}
        mine["log_alpha"] = ts.log_alpha.grad
        mine.update({f"actor/{n}": a for n, a in zip(names, g)})
        for k, gm in mine.items():
            gs = (pop.log_alpha.grad[i] if k == "log_alpha" else
                  getattr(pop, k.split("/")[0])[k.split("/", 1)[1]].grad[i])
            n_mem += over(gs, gm)
            err_mem = max(err_mem, (gs - gm).abs().max().item())
        for k, t in named_state(ts).items():
            if not k.endswith("/step"):
                par_mem = max(par_mem, (after[k][i] - t).abs().max().item())
    say(f"phase 13 one stacked TQC update of {K} members, card vs CPU: "
        f"losses and alpha relative difference {worst_cpu:.2e} (rtol "
        f"{RTOL_LEARN}), gradients max |d| {err_cpu:.3e}, {n_cpu} elements "
        f"outside rtol {RTOL_LEARN} atol {ATOL_GRAD} | {card}")
    say(f"phase 13 the stacked update vs each member's own update on the "
        f"card: losses and alpha {worst_mem:.2e}, gradients max |d| "
        f"{err_mem:.3e} ({n_mem} elements outside), new parameters and Adam "
        f"moments max |d| {par_mem:.3e} (atol 1e-5) | {card}")
    if (worst_cpu > RTOL_LEARN or n_cpu or worst_mem > RTOL_LEARN or n_mem
            or par_mem > 1e-5):
        fail("phase 13: the stacked update disagrees with the CPU or with "
             "the members' own updates")
    return batch, noise, members


def population_times(CD, pt, core, batch, noise, members, seconds, card):
    """ms per stacked update at K = 4 beside one member's update (CUDA
    events, median of 50), the launches of each (one profile); ms per
    collect and per fused env step at B = K * n_envs beside one member's
    env step at n_envs, K1's launches and all launches of each (one
    profile); aggregate env-steps/s; the replay bytes."""
    from panda_gym_tpu_torch.rl.train import VectorEnv, schedule

    stacked, pop, buf, gen = pt.stacked, pt.pop, pt.buffer, pt.generator
    L, K = stacked.learner, stacked.K
    sched = schedule(pt.config, HORIZON)
    b0 = {k: v[0] for k, v in batch.items()}
    n0 = tuple(n[0] for n in noise)
    upd = event_times(lambda: stacked.update(pop, batch, noise))
    one = event_times(lambda: L.update(members[0], b0, n0))
    say(f"phase 13 stacked TQC update at K={K} (batch {sched.batch_size} "
        f"per member): median {upd[0]:.3f} ms (min {upd[1]:.3f}, max "
        f"{upd[2]:.3f}); one member's update {one[0]:.3f} ms (min "
        f"{one[1]:.3f}, max {one[2]:.3f}); {upd[0] / one[0]:.2f}x for "
        f"{K}x the work | {card}")
    n_upd, _, _ = profile_once(lambda: stacked.update(pop, batch, noise),
                               f"phase 13 profile of one stacked update "
                               f"(K={K})", card)
    n_one, _, _ = profile_once(lambda: L.update(members[0], b0, n0),
                               "phase 13 profile of one member's update",
                               card)
    rf = lambda a, g, x: core.task.reward_from_aux(core, a, g, x)  # noqa

    def stepper(learner, ts, B):
        venv = VectorEnv(core, B, HORIZON)
        states, obs = venv.batch_reset(gen)
        done = torch.zeros(B, dtype=torch.bool, device=states.q.device)
        ep_len = torch.zeros(B, dtype=torch.int32, device=states.q.device)
        expl = venv._sample_expl(learner, ts, gen)
        return lambda: venv.env_step(learner, ts, states, obs, done, ep_len,
                                     gen, False, expl)

    B = K * N_ENVS
    pop_step = stepper(stacked, pop, B)
    one_step = stepper(L, members[0], N_ENVS)

    def fused():
        pop_step()
        pt.update_burst(pop, buf, gen, sched.n_upd_per_step,
                        sched.batch_size, rf)

    res = {}
    for name, fn in (("population collect", pop_step),
                     (f"population fused ({sched.n_upd_per_step} stacked "
                      f"updates after it)", fused),
                     ("one member's collect", one_step)):
        fn()
        ms = []
        for _ in range(N_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[name] = float(np.median(ms))
        say(f"phase 13 {name} env step: median {res[name]:.1f} ms (min "
            f"{min(ms):.1f}, max {max(ms):.1f}) over {N_TIMED} | {card}")
    k1 = {}
    for name, fn in (("population", pop_step), ("member", one_step)):
        motor = reset_counts(CD, core)
        fn()
        torch.cuda.synchronize()
        k1[name] = {KERNEL_NAMES[k]: v
                    for k, v in motor.kernel_launches.items()}
    n_pop, busy_pop, wall_pop = profile_once(
        pop_step, f"phase 13 profile of one population env step at B={B}",
        card)
    n_mem, busy_mem, wall_mem = profile_once(
        one_step, f"phase 13 profile of one member's env step at "
                  f"B={N_ENVS}", card)
    fused_ms = res[[k for k in res if k.startswith("population fused")][0]]
    say(f"phase 13 launches per env step: {n_pop} for the population's "
        f"{K} x {N_ENVS} envs (K1: {k1['population']}) against {n_mem} for "
        f"one member's {N_ENVS} (K1: {k1['member']}), {n_pop / n_mem:.2f}x;"
        f" card busy {100 * busy_pop / wall_pop:.1f}% and "
        f"{100 * busy_mem / wall_mem:.1f}%; per update: {n_upd} stacked "
        f"against {n_one} for one member ({n_upd / n_one:.2f}x) | {card}")
    if k1["population"] != {KERNEL_NAMES[CD.LANES]: N_SUBSTEPS,
                            KERNEL_NAMES[CD.THREAD]: 0}:
        fail(f"phase 13: K1 launches of one population env step were "
             f"{k1['population']}")
    say(f"phase 13 aggregate: {B / fused_ms * 1e3:.0f} env-steps/s over the "
        f"members in fused rollouts ({B} envs per {fused_ms:.1f} ms step); "
        f"the whole run {pt.timesteps} env steps in {seconds:.2f} s, "
        f"{pt.timesteps / seconds:.1f} env-steps/s (evaluation, checkpoints "
        f"and set-up included); stacked replay {buf.nbytes} bytes "
        f"({buf.nbytes / 2 ** 20:.1f} MiB: {K} x {buf.capacity} episodes of "
        f"{buf.ep_horizon} steps) | {card}")


def drive_population(CD, dev, card, run_root):
    """Phase 13's population path: the run and its checks, K1's route held
    against the plain route on one env step of the population's own
    actions (phase 7's rule), the stacked update against the CPU and the
    members, then the times.  Returns (K1 launches, the largest K1 error,
    the core)."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.rl.population import pop_named_state
    from panda_gym_tpu_torch.rl.train import flat_x, schedule, stage_tag

    pt, core, rows, batches, seconds = run_population(CD, dev, run_root)
    motor = core.physics_step_batched.motor
    counts = dict(motor.kernel_launches)
    cfg, pop, buf = pt.config, pt.pop, pt.buffer
    B = POP_MEMBERS * N_ENVS
    sched = schedule(cfg, HORIZON)
    roll = [r for r in rows if "rollout_success" in r]
    fused = [r for r in roll if "critic_loss" in r]
    evals = [r for r in rows if "eval_success" in r]
    named = pop_named_state(pop)
    run_dir = os.path.join(run_root, "chip_smoke", "phase13")
    ckpts = [f"best_model_m{i}.ckpt" for i in range(POP_MEMBERS)] + [
        f"model_{stage_tag(POP_SCENE)}_0_m{i}.ckpt"
        for i in range(POP_MEMBERS)]
    a = pop.actor["dense.0.weight"]
    checks = {
        f"one batched_step of {B} envs per env step": set(batches) == {B},
        "K1: 20 launches per env step, all on the lane-group kernel":
            counts == {CD.LANES: N_SUBSTEPS * len(batches), CD.THREAD: 0}
            and motor.launches == N_SUBSTEPS * len(batches),
        "the env steps of every rollout and the evaluation":
            len(batches) == HORIZON * (len(roll) + len(evals)),
        "a collect rollout, then two or more fused":
            "critic_loss" not in roll[0] and len(fused) >= 2
            and len(roll) - len(fused) >= 1,
        "one evaluation of every member": len(evals) == 1
            and len(evals[0]["eval_success"]) == POP_MEMBERS,
        "stacked updates: the schedule's count":
            pop.step == len(fused) * HORIZON * sched.n_upd_per_step,
        "losses and alpha finite": all(
            np.isfinite(r[k]) for r in fused
            for k in ("critic_loss", "actor_loss", "alpha")),
        "state finite, stacked, on the card": a.shape[0] == POP_MEMBERS
            and all(bool(torch.isfinite(v).all()) for v in named.values())
            and all(v.device.type == "cuda" for k, v in named.items()
                    if not k.endswith("/step")),
        "members differ": not torch.equal(a[0], a[1]),
        "stacked replay (K, E, ...) on the card": buf.members == POP_MEMBERS
            and buf.capacity == sched.capacity
            and buf.obs.device.type == "cuda",
        "member checkpoints": all(os.path.exists(os.path.join(run_dir, c))
                                  for c in ckpts),
    }
    say(f"phase 13 main path: PopulationTrainer.learn, {POP_MEMBERS} "
        f"members x {N_ENVS} envs on {POP_SCENE}, horizon {HORIZON}: "
        f"{len(roll)} rollouts ({len(roll) - len(fused)} collect, "
        f"{len(fused)} fused with {sched.n_upd_per_step} stacked updates per"
        f" env step) and {len(evals)} evaluation rollout: {len(batches)} "
        f"batched_step calls at B={sorted(set(batches))}, K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, {pop.step} "
        f"stacked updates, {pt.timesteps} transitions over the members, "
        f"eval success {evals[0]['eval_success'] if evals else None}, "
        f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 13 population checks failed: {checks}")

    # the two motor routes on one env step of the population's own actions
    phys = core.physics_step_batched
    twin = CD.make_cuda_motor_steps(core.model, n_substeps=1, dt=DT,
                                    ctrl_mode=phys.motor.ctrl_mode,
                                    warm_start=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = core.batched_reset(B, gen)
    act = pt.stacked.act(pop, flat_x(obs), deterministic=True)
    s_in = _hi_prec(core.robot.set_action)(states, act)
    cmp, one = copy.copy(phys), copy.copy(phys)
    cmp.motor = one.motor = twin
    one.n_substeps = 1
    err, _ = hold_routes(cmp, one, CD, s_in, f"phase 13 {POP_SCENE} B={B}",
                         dev, card)
    batch, noise, members = stacked_vs_cpu_and_members(pt, core, card)
    population_times(CD, pt, core, batch, noise, members, seconds, card)
    return counts[CD.LANES], err, core


def drive_td3_ddpg(CD, dev, card, run_root):
    """TD3 and DDPG through Trainer.learn on Reach at n_envs 64 and their
    presets (three rollouts of horizon 50: a collect rollout and its burst,
    then fused rollouts; one evaluation), K1's counts set to 0 as the env is
    made; checks, one update on the card against the CPU, the update's
    time.  Returns {algorithm: (K1 launches, the largest error)}."""
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    from panda_gym_tpu_torch.rl import her
    from panda_gym_tpu_torch.rl.config import Hyperparameters, TrainConfig
    from panda_gym_tpu_torch.rl.train import learner_batch, schedule

    out = {}
    steps = N_ENVS * REACH_HORIZON
    for algo in ("TD3", "DDPG"):
        cfg = TrainConfig(
            algorithm=algo, n_envs=N_ENVS, stages=["reach"],
            max_ep_steps=[REACH_HORIZON], max_timesteps=3 * steps,
            learning_starts=steps, interleave_min_buffer=steps // 2,
            eval_freq=3 * steps, n_eval_episodes=N_ENVS,
            success_thresholds=[2.0], ee_error_thresholds=[0.05],
            benchmark_eval_scenes=[])
        cfg.hyperparams = Hyperparameters(algo)
        trainer, core, seconds = run_trainer(
            cfg, dev, run_root, CD, build=lambda sc: make_core(sc),
            name=f"phase13_{algo}")
        motor = core.physics_step_batched.motor
        counts = dict(motor.kernel_launches)
        sched = schedule(cfg, REACH_HORIZON)
        rows = [r for r in trainer.metrics.history if "rollout_reward" in r]
        fused = [r for r in rows if "critic_loss" in r
                 and r["t_update"] == 0.0]
        burst = [r for r in rows if r["t_update"] > 0.0]
        n_evals = sum("eval_success" in r for r in trainer.metrics.history)
        env_steps = REACH_HORIZON * (len(rows) + n_evals)
        metrics = [v for r in rows for k, v in r.items()
                   if k in ("critic_loss", "actor_loss")]
        checks = {
            f"{algo}Learner": type(trainer.learner).__name__
            == f"{algo}Learner",
            "K1: one 20-substep launch per env step, on the lane-group "
            "kernel": counts == {CD.LANES: env_steps, CD.THREAD: 0},
            "a burst and fused rollouts": len(burst) >= 1 and len(fused) >= 1,
            "updates: the schedule's count": trainer.ts.step == (
                len(burst) * sched.updates_per_rollout
                + len(fused) * REACH_HORIZON * sched.n_upd_per_step),
            "losses finite, no alpha": bool(metrics) and all(
                np.isfinite(v) for v in metrics)
            and not any("alpha" in r for r in rows),
            "buffer on cuda": trainer.buffer.obs.device.type == "cuda",
        }
        say(f"phase 13 main path: Trainer.learn with {algo} on reach at "
            f"n_envs={N_ENVS}, horizon {REACH_HORIZON}: {len(rows)} "
            f"rollouts, {n_evals} evaluation(s), {env_steps} env steps, K1 "
            f"launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
            f"{trainer.ts.step} updates in {seconds:.2f} s, checks {checks}")
        if not all(checks.values()):
            fail(f"phase 13 {algo} checks failed: {checks}")
        err = learner_vs_cpu(trainer, core, card, tag=f"phase 13 {algo}")
        learner = trainer.learner
        batch = learner_batch(her.sample(
            trainer.buffer, trainer.generator, sched.batch_size,
            trainer._reward_fn(core)))
        noise = learner.update_noise(trainer.generator, sched.batch_size)
        upd = event_times(lambda: learner.update(trainer.ts, batch, noise))
        coll = [r["t_collect"] * 1e3 / REACH_HORIZON
                for r in rows if r not in fused]
        say(f"phase 13 {algo} update (batch {sched.batch_size}, net_arch "
            f"{list(learner.net_arch)}, {learner.n_critics} critic(s)): "
            f"median {upd[0]:.3f} ms (min {upd[1]:.3f}, max {upd[2]:.3f}); "
            f"collect env step at B={N_ENVS}: "
            f"{', '.join(f'{m:.2f}' for m in coll)} ms | {card}")
        out[algo] = (counts[CD.LANES],
                     max(err, k1_core_error(CD, core, N_ENVS, dev,
                                            f"phase 13 {algo}")))
    return out


def copy_ppo_state(src, dst):
    """Every tensor of one PPOState into another, in place."""
    with torch.no_grad():
        for m, o in (("actor", "actor_opt"), ("value", "value_opt")):
            for p, q in zip(getattr(src, m).parameters(),
                            getattr(dst, m).parameters()):
                q.copy_(p)
                so, do = getattr(src, o).state[p], getattr(dst, o).state[q]
                for k in so:
                    do[k].copy_(so[k])
    dst.step = src.step


def to_float64(modules, opts=()):
    """Modules and their Adams' moments in float64, in place."""
    for m in modules:
        m.double()
    for opt in opts:
        for st in opt.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].double()


def rel_dist(a, b):
    """||a - b|| / ||b|| over lists of tensors, on the CPU in float64."""
    num = sum(float(((x.detach().cpu().double() - y.detach().cpu().double())
                     ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y.detach().cpu().double() ** 2).sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def referee64(label, card_run, cpu_run, ref_run, card):
    """Hold a whole run on the card against the CPU by the float64 run:
    each entry of the dicts (a list of tensors) is the run's result; fails
    unless the card's relative distance from float64 is at most RUN_FACTOR
    times the float32 CPU's plus RUN_FLOOR."""
    parts, ok = [], True
    for k in ref_run:
        dc = rel_dist(card_run[k], ref_run[k])
        dp = rel_dist(cpu_run[k], ref_run[k])
        ok &= dc <= RUN_FACTOR * dp + RUN_FLOOR
        parts.append(f"{k} {dc:.2e} (CPU {dp:.2e})")
    say(f"{label}, relative distance from the float64 run on the CPU, card "
        f"(float32 CPU): {'; '.join(parts)}; allowed {RUN_FACTOR}x the "
        f"CPU's + {RUN_FLOOR} | {card}")
    if not ok:
        fail(f"{label}: the card is further from the float64 run than the "
             f"CPU allows")


def drive_ppo(CD, dev, card):
    """One train_ppo iteration on Reach at the PPO preset, K1's counts set
    to 0 just before; checks; then a rollout of the trained state and one
    update on the card against the CPU from the same state, rollout and
    permutations: the first minibatch's gradients by phase 8's rule, and
    the whole update (1280 Adam steps) against the same update in float64
    on the CPU (referee64: the new parameters, the policy's mean actions
    on the rollout, the metrics).  Returns (K1
    launches, the largest error)."""
    from panda_gym_tpu_torch.envs.panda_tasks import make_core
    from panda_gym_tpu_torch.rl.config import Hyperparameters
    from panda_gym_tpu_torch.rl.ppo import (PPOLearner, collect_rollout,
                                            train_ppo)

    hp = Hyperparameters("PPO")
    core = make_core("reach")
    motor = reset_counts(CD, core)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner, ts, hist = train_ppo(core, hp, total_steps=hp.n_steps * PPO_ENVS,
                                  n_envs=PPO_ENVS, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(motor.kernel_launches)
    checks = {
        "one iteration": len(hist) == 1 and ts.step == 1,
        "K1: one launch per env step, on the lane-group kernel":
            counts == {CD.LANES: hp.n_steps, CD.THREAD: 0},
        "metrics finite": all(np.isfinite(v) for v in hist[0].values()),
        "state on cuda": next(ts.actor.parameters()).device.type == "cuda",
    }
    say(f"phase 13 main path: train_ppo on reach, one iteration of "
        f"{hp.n_steps} steps x {PPO_ENVS} envs, {hp.n_epochs} epochs of "
        f"minibatches of {hp.batch_size}: K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, metrics "
        f"{ {k: round(v, 5) for k, v in hist[0].items()} }, {seconds:.2f} s,"
        f" checks {checks}")
    if not all(checks.values()):
        fail(f"phase 13 PPO checks failed: {checks}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = core.batched_reset(PPO_ENVS, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, obs, rollout, _ = collect_rollout(core, learner, ts, states, obs,
                                              gen, hp.n_steps)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    N = rollout["x"].shape[0]
    perms = learner.update_perms(gen, N)
    cpu = PPOLearner(learner.obs_dim, learner.act_dim, hp, "cpu")
    ts_cpu = cpu.init(torch.Generator().manual_seed(0))
    ts64 = cpu.init(torch.Generator().manual_seed(0))
    to_float64((ts64.actor, ts64.value), (ts64.actor_opt, ts64.value_opt))
    copy_ppo_state(ts, ts_cpu)
    copy_ppo_state(ts, ts64)
    ro_cpu = {k: v.cpu() for k, v in rollout.items()}

    # the first minibatch's gradients, from the same state
    adv = rollout["adv"]
    idx = perms[0, :hp.batch_size]
    mb = dict(rollout, adv=(adv - adv.mean()) / (adv.std(unbiased=False)
                                                 + 1e-8))
    mb = {k: v[idx] for k, v in mb.items()}
    params = list(ts.actor.parameters()) + list(ts.value.parameters())
    params_cpu = (list(ts_cpu.actor.parameters())
                  + list(ts_cpu.value.parameters()))
    g = torch.autograd.grad(learner.loss(ts, mb)[0], params)
    g_cpu = torch.autograd.grad(
        cpu.loss(ts_cpu, {k: v.cpu() for k, v in mb.items()})[0], params_cpu)
    n_over = sum(int(((a.cpu() - b).abs()
                      > ATOL_GRAD + RTOL_LEARN * b.abs()).sum())
                 for a, b in zip(g, g_cpu))
    g_err = max((a.cpu() - b).abs().max().item() for a, b in zip(g, g_cpu))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m_card = learner.update(ts, rollout, perms)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    _, m_cpu = cpu.update(ts_cpu, ro_cpu, perms.cpu())
    _, m64 = cpu.update(ts64, {k: v.double() for k, v in ro_cpu.items()},
                        perms.cpu())
    n_steps = perms.shape[0] * (N // hp.batch_size)
    say(f"phase 13 PPO, card vs CPU: the first minibatch's gradients max "
        f"|d| {g_err:.3e}, {n_over} elements outside rtol {RTOL_LEARN} atol "
        f"{ATOL_GRAD} | {card}")
    if n_over:
        fail("phase 13: the PPO gradients on the card disagree with the CPU")

    def result(learner_, ts_, x, metrics):
        return dict(
            parameters=list(ts_.actor.parameters())
            + list(ts_.value.parameters()),
            actions=[learner_.act(ts_, x, deterministic=True)],
            metrics=[torch.tensor([float(metrics[k])
                                   for k in sorted(metrics)])])

    card_run = result(learner, ts, rollout["x"], m_card)
    cpu_run = result(cpu, ts_cpu, ro_cpu["x"], m_cpu)
    ref_run = result(cpu, ts64, ro_cpu["x"].double(), m64)
    referee64(f"phase 13 PPO, the whole update ({n_steps} minibatch steps)",
              card_run, cpu_run, ref_run, card)
    say(f"phase 13 PPO times: rollout {collect_s * 1e3 / hp.n_steps:.2f} ms "
        f"per env step at B={PPO_ENVS} (policy, step, value, one reset of "
        f"the batch); update {update_s:.2f} s for {n_steps} minibatch steps "
        f"({update_s * 1e3 / n_steps:.2f} ms each); the iteration "
        f"{seconds:.2f} s | {card}")
    return counts[CD.LANES], max(g_err, k1_core_error(CD, core, PPO_ENVS,
                                                      dev, "phase 13 PPO"))


def drive_distill(CD, root, dev, card):
    """Distillation: collect_labeled with the routed generalist (the
    controller its router picks most on reachao1's first observations) as
    the teacher, 64 episodes of reachao1 with DART drive noise, K1's counts
    set to 0 just before; checks; K1 against its plain version on the
    first step's states; then BC_STEPS of bc_train of a TQC-preset student
    on the card, the CPU and in float64 on the CPU from the same initial
    student and numpy index stream, held by referee64.  Returns (K1
    launches, the largest error)."""
    from panda_gym_tpu_torch.envs.core import _hi_prec
    from panda_gym_tpu_torch.eval.cli import make_core_fn
    from panda_gym_tpu_torch.eval.router import (load_routed_policy,
                                                 masked_bayesian_fusion,
                                                 member_mean_std)
    from panda_gym_tpu_torch.rl.config import Hyperparameters
    from panda_gym_tpu_torch.rl.distill import (bc_train, collect_labeled,
                                                init_student)
    from panda_gym_tpu_torch.rl.learners import make_learner
    from panda_gym_tpu_torch.rl.logging_utils import load_config
    from panda_gym_tpu_torch.rl.train import flat_x

    asset = os.path.join(root, "panda_gym_tpu_torch", "assets", "routed_gen")
    policy, _ = load_routed_policy(os.path.join(asset, "routed_policy.npz"),
                                   dev)
    core = make_core_fn(load_config(os.path.join(asset, "config.json")),
                        dev)("reachao1")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = core.batched_reset(EVAL_EPISODES, gen)
    choice = int(torch.mode(torch.argmax(policy.router(flat_x(obs)),
                                         -1)).values)
    mask = policy.masks[choice]
    a0 = masked_bayesian_fusion(*member_mean_std(policy.members,
                                                 flat_x(obs)), mask)
    s_in = _hi_prec(core.robot.set_action)(states, a0)
    motor = reset_counts(CD, core)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, A, active = collect_labeled(core, policy.members, mask,
                                   EVAL_EPISODES, DISTILL_HORIZON, gen,
                                   drive_noise=DISTILL_NOISE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(motor.kernel_launches)
    checks = {
        "K1: 20 launches per env step, on the lane-group kernel":
            counts == {CD.LANES: N_SUBSTEPS * DISTILL_HORIZON,
                       CD.THREAD: 0},
        "shapes": tuple(X.shape) == (DISTILL_HORIZON, EVAL_EPISODES, 62)
            and tuple(A.shape) == (DISTILL_HORIZON, EVAL_EPISODES, 7),
        "finite labels in [-1, 1]": bool(torch.isfinite(A).all())
            and bool((A.abs() <= 1).all()),
        "every episode active at its first step": bool(active[0].all()),
    }
    say(f"phase 13 main path: collect_labeled, the routed generalist's "
        f"controller {choice} ({int(mask.sum())} members) labelling "
        f"{EVAL_EPISODES} episodes of reachao1, horizon {DISTILL_HORIZON}, "
        f"drive noise {DISTILL_NOISE}: {int(active.sum())} labelled states,"
        f" K1 launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"{seconds * 1e3 / DISTILL_HORIZON:.1f} ms per env step, checks "
        f"{checks} | {card}")
    if not all(checks.values()):
        fail(f"phase 13 distillation checks failed: {checks}")
    err = k1_eval_error(CD, core, s_in, "phase 13 K1 n_substeps=1 cold vs "
                                        "plain on a labelling step's states")

    hp = Hyperparameters("TQC")
    Xa, Aa = X[active], A[active]
    learner = make_learner("TQC", Xa.shape[1], Aa.shape[1], hp, dev)
    student = init_student(learner, torch.Generator(device=dev)
                           .manual_seed(SEED))
    cpu = make_learner("TQC", Xa.shape[1], Aa.shape[1], hp, "cpu")
    student_cpu = init_student(cpu, torch.Generator().manual_seed(0))
    student64 = init_student(cpu, torch.Generator().manual_seed(0))
    to_float64([student64])
    init = {k: v.cpu() for k, v in student.state_dict().items()}
    student_cpu.load_state_dict(init)
    student64.load_state_dict(init)
    with torch.no_grad():
        loss0 = float(torch.mean((torch.tanh(student(Xa)[0]) - Aa) ** 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = bc_train(student, Xa, Aa, steps=BC_STEPS, seed=SEED,
                       log=lambda s: None)
    bc_s = time.perf_counter() - t0
    X_cpu, A_cpu = Xa.cpu(), Aa.cpu()
    _, loss_cpu = bc_train(student_cpu, X_cpu, A_cpu, steps=BC_STEPS,
                           seed=SEED, log=lambda s: None)
    _, loss64 = bc_train(student64, X_cpu.double(), A_cpu.double(),
                         steps=BC_STEPS, seed=SEED, log=lambda s: None)
    say(f"phase 13 bc_train, {BC_STEPS} steps on {Xa.shape[0]} labelled "
        f"states (batch {min(4096, Xa.shape[0])}): loss {loss0:.5f} -> "
        f"{loss:.5f} on the card, {loss_cpu:.5f} on the CPU, {loss64:.5f} "
        f"in float64; {bc_s * 1e3 / BC_STEPS:.2f} ms per step on the card "
        f"| {card}")
    if not loss < loss0:
        fail("phase 13: bc_train did not lower the loss")
    with torch.no_grad():
        runs = [dict(parameters=list(m.parameters()),
                     actions=[torch.tanh(m(x)[0])],
                     loss=[torch.tensor([lv])])
                for m, x, lv in ((student, Xa, loss),
                                 (student_cpu, X_cpu, loss_cpu),
                                 (student64, X_cpu.double(), loss64))]
    referee64(f"phase 13 bc_train, {BC_STEPS} steps", *runs, card)
    return counts[CD.LANES], err


def phase13(CD, root, rng, dev, card, run_root):
    """Phase 13, its runs under run_root (phase 15 continues the
    population's members); returns what the kernels line needs."""
    t0 = time.perf_counter()
    mark = lambda what: say(  # noqa: E731
        f"phase 13 {what} at {time.perf_counter() - t0:.1f} s")
    pop = drive_population(CD, dev, card, run_root)
    mark("population done")
    off = drive_td3_ddpg(CD, dev, card, run_root)
    mark("TD3 and DDPG done")
    ppo = drive_ppo(CD, dev, card)
    mark("PPO done")
    distill = drive_distill(CD, root, dev, card)
    mark("distillation done")
    from panda_gym_tpu_torch.models.panda import make_panda_model
    model = make_panda_model()
    pop_times, _ = k1_one_substep_times(CD, model, rng, dev, card,
                                        [POP_MEMBERS * N_ENVS], "phase 13")
    k1 = reach_k1(CD, model, 0)
    reach_times = {}
    for B in (PPO_ENVS, N_ENVS):
        q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
        reach_times[B] = (time_k1(k1, model, 0, B, rng, dev),
                          time_cuda(lambda: k1.plain(q, qd, tgt), 1,
                                    warmup=1))
        say(f"phase 13 K1 20 warm substeps B={B}: {reach_times[B][0]:.4f} "
            f"ms/launch; plain version {reach_times[B][1]:.1f} ms | {card}")
    say(f"phase 13 done in {time.perf_counter() - t0:.1f} s")
    return pop, pop_times, off, ppo, distill, reach_times


# ----------------------------------------------------------------- phase 14
# The gym surface and the stateful Simulation: K1 with a gravity vector; the
# reference's Bullet goldens through Simulation in both motor-LCP modes;
# every env class as one env through its adapter (the per-env entry point,
# a batch of one); the vector adapter at bench.py's Reach batch and the main
# path's reachao1 batch through an autoreset; Simulation with a free body
# and a moving obstacle, and with a non-default gravity.
GRAVITY = (0.3, -0.2, -9.0)
# (class, module under panda_gym_tpu_torch.envs, constructor arguments)
ENV_CLASSES = (
    ("PandaReachEnv", "panda_tasks", {}),
    ("PandaReachCheckerEnv", "panda_tasks", {}),
    ("PandaPushEnv", "panda_tasks", {}),
    ("PandaSlideEnv", "panda_tasks", {}),
    ("PandaPickAndPlaceEnv", "panda_tasks", {}),
    ("PandaStackEnv", "panda_tasks", {}),
    ("PandaFlipEnv", "panda_tasks", {}),
    ("MyCobotReachEnv", "panda_tasks", {}),
    ("PandaReachAOEnv", "tasks.reach_ao", {"scenario": "reachao1"}),
)
ADAPTER_STEPS = 5
# steps of each adapter held against the plain route
ADAPTER_HELD = 1
# the vector adapter: Reach at bench.py's batch, ReachAO at the main path's
VECTOR = (("reach", B_BENCH), ("reachao", B_MAIN))
# the adapter's step limit: every env autoresets on step VECTOR_EP + 1
VECTOR_EP = 2
# the reference's golden numbers (tests/test_bullet_goldens.py)
GOLDEN = {"link 1 CoM": [0.000, 0.060, 0.373],
          "link 5 velocity": [-0.0068, 0.0000, 0.1186],
          "link 5 angular velocity": [0.000, -2.969, 0.000],
          "joint 5 angle": [0.063],
          "link 5 orientation": [0.707, -0.02, 0.02, 0.707]}
ATOL_GOLDEN = 1e-3
NEUTRAL7 = [0.0, -0.3, 0.0, -2.2, 0.0, 2.0, 0.785]


def zero_counts(motor):
    motor.launches = 0
    for k in motor.kernel_launches:
        motor.kernel_launches[k] = 0


def counts_of(motor):
    return motor.launches, dict(motor.kernel_launches)


def restore_counts(motor, counts):
    motor.launches, kl = counts
    motor.kernel_launches.update(kl)


def check_gravity_k1(CD, model, rng, dev, card):
    """K1 with the gravity vector GRAVITY against its plain version with
    the same gravity, both kernels, B 1 and 4096: 20 warm substeps, and one
    cold substep; the gravity must move the result."""
    err = 0.0
    for n_sub, warm in ((N_SUBSTEPS, True), (1, False)):
        kw = dict(n_substeps=n_sub, dt=DT, ctrl_mode=0, warm_start=warm)
        k1 = CD.make_cuda_motor_steps(model, gravity=GRAVITY, **kw)
        ref = CD.make_cuda_motor_steps(model, **kw)
        for B in (1, B_MAIN):
            q, qd, tgt = motor_inputs(model, B, 0, rng, dev)
            qp, qdp = k1.plain(q, qd, tgt)
            moved = (ref.plain(q, qd, tgt)[1] - qdp).abs().max().item()
            for lanes in (CD.LANES, CD.THREAD):
                qk, qdk = k1.launch(q, qd, tgt, lanes)
                torch.cuda.synchronize()
                eq = (qk - qp).abs().max().item()
                eqd = (qdk - qdp).abs().max().item()
                ok = eq <= ATOL_Q and eqd <= ATOL_QD
                say(f"phase 14 K1 {KERNEL_NAMES[lanes]} with gravity "
                    f"{GRAVITY} vs plain: {n_sub} {'warm' if warm else 'cold'}"
                    f" substeps B={B} max|dq|={eq:.3e} (atol {ATOL_Q}) "
                    f"max|dqd|={eqd:.3e} (atol {ATOL_QD}); the gravity moves "
                    f"qd by {moved:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"phase 14: K1 with a gravity vector disagrees "
                         f"with its plain version ({KERNEL_NAMES[lanes]}, "
                         f"B={B})")
                err = max(err, eq, eqd)
            if B > 1 and moved <= 10 * max(err, 1e-7):
                fail("phase 14: the gravity vector does not move K1's result")
    return err


def bullet_goldens(dev, card):
    """The reference's five Bullet goldens through Simulation on the card,
    in the "exact" mode (K1; its step first held against the plain route)
    and the "pgs" mode (plain PyTorch PGS).  Returns the exact mode's (K1
    launches, K1 route's largest error against the plain route)."""
    from panda_gym_tpu_torch.ops import dynamics as D
    from panda_gym_tpu_torch.sim.facade import Simulation
    out = {}
    for mode in ("exact", "pgs"):
        D.set_lcp_mode(mode)
        try:
            s = Simulation(n_substeps=N_SUBSTEPS, device="cuda")
            s.load_robot(base_position=(0.0, 0.0, 0.0), inertia="stock")
            s.set_joint_angles("robot", list(range(7)), [0.0] * 7)
            got = {"link 1 CoM": s.get_link_position("robot", 1)}
            s.control_joints("robot", [5], [0.3], [5.0])
            phys = s.physics
            route_err = 0.0
            if mode == "exact":
                _, route_err, _ = hold_step_routes(
                    phys, s._state, facade_diff,
                    "phase 14 Bullet golden step", dev, card)
            zero_counts(phys.motor)
            t0 = time.perf_counter()
            s.step()
            step_ms = (time.perf_counter() - t0) * 1e3
            n, route = phys.motor.launches, phys.route
            got["link 5 velocity"] = s.get_link_velocity("robot", 5)
            got["link 5 angular velocity"] = s.get_link_angular_velocity(
                "robot", 5)
            got["joint 5 angle"] = [s.get_joint_angle("robot", 5)]
            got["link 5 orientation"] = s.get_link_orientation("robot", 5)
        finally:
            D.set_lcp_mode("exact")
        errs = {k: float(np.abs(np.asarray(v, np.float64)
                                - np.asarray(GOLDEN[k])).max())
                for k, v in got.items()}
        want = 1 if mode == "exact" else 0
        ok = max(errs.values()) <= ATOL_GOLDEN and n == want
        say(f"phase 14 Bullet goldens, {mode} mode: route {route}, "
            f"{n} K1 launches (want {want}), Simulation.step {step_ms:.1f} "
            f"ms; |err| " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
            + f" (atol {ATOL_GOLDEN}) {'ok' if ok else 'FAIL'} | {card}")
        if not ok:
            fail(f"phase 14: the Bullet goldens fail in the {mode} mode")
        out[mode] = (n, route_err)
    return out["exact"]


def adapter_diff(env):
    """Per env, whether two physics results part beyond the tolerances
    after the step's observation and reward (contact_diff), and for a
    collision step its link distances and flag (route_diff)."""
    def diff(a, b, idx):
        d = contact_diff(env, a, b)
        if env.task.check_collision:
            d = d | route_diff(a, b)
        return d
    return diff


def drive_adapters(CD, _hi_prec, dev, card):
    """Every env class as one env on the card through its adapter: a reset
    and ADAPTER_STEPS steps of seeded actions, K1's launches counted on the
    per-env step (physics_step) and held against the launches the class's
    physics makes per step; the first ADAPTER_HELD steps held against the
    plain route by phase 11's rule (launches for that not counted).
    Returns {class: (launches, kernel launches, largest error, median
    ms/step)}."""
    import importlib
    out = {}
    for name, mod, kw in ENV_CLASSES:
        cls = getattr(importlib.import_module(
            f"panda_gym_tpu_torch.envs.{mod}"), name)
        env = cls(device="cuda", **kw)
        core, phys = env.env, env.env.physics_step
        per_step = (N_SUBSTEPS if core.task.check_collision
                    else K1_PER_CONTACT_STEP if core.task.scene.nb else 1)
        obs, _ = env.reset(seed=SEED)
        rng = np.random.default_rng(SEED)
        zero_counts(phys.motor)
        err, ms = 0.0, []
        for t in range(ADAPTER_STEPS):
            a = rng.uniform(-1, 1, env.action_shape).astype(np.float32)
            if t < ADAPTER_HELD:
                kept = counts_of(phys.motor)
                s_in = _hi_prec(core.robot.set_action)(
                    env.state, torch.as_tensor(a, device=dev)[None])
                _, e, _ = hold_step_routes(
                    phys, s_in, adapter_diff(core),
                    f"phase 14 {name} step {t}", dev, card)
                err = max(err, e)
                restore_counts(phys.motor, kept)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs, r, term, trunc, info = env.step(a)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not all(np.isfinite(v).all() for v in obs.values()):
                fail(f"phase 14 {name}: a non-finite observation")
            if {k: v.shape for k, v in obs.items()} != env.observation_shapes:
                fail(f"phase 14 {name}: observation shapes "
                     f"{ {k: v.shape for k, v in obs.items()} }")
        n, kl = counts_of(phys.motor)
        ok = n == per_step * ADAPTER_STEPS
        med = float(np.median(ms[1:]))
        say(f"phase 14 {name}: reset and {ADAPTER_STEPS} steps through the "
            f"adapter, route {phys.route}, {n} K1 launches (want "
            f"{per_step} per step; {kl[CD.LANES]} lane-group, "
            f"{kl[CD.THREAD]} one env per thread); step median {med:.2f} "
            f"ms (first {ms[0]:.1f} ms) {'ok' if ok else 'FAIL'} | {card}")
        if not ok:
            fail(f"phase 14 {name}: K1 launches {n}, want "
                 f"{per_step * ADAPTER_STEPS}")
        out[name] = (n, kl, err, med)
    try:
        import gymnasium as gym
    except ImportError:
        say("phase 14 gymnasium is not installed on this machine: the "
            "classes above are the gymnasium-free layer (EnvAdapter) that "
            "the gymnasium.Env classes of envs/gym_envs.py subclass; "
            "gym.make is not driven here")
    else:
        import panda_gym_tpu_torch
        panda_gym_tpu_torch.register_envs(50)
        g = gym.make("panda_gym_tpu_torch/PandaReach-v3")
        g.reset(seed=SEED)
        g.step(g.action_space.sample())
        say("phase 14 gym.make('panda_gym_tpu_torch/PandaReach-v3') reset "
            "and stepped on the card")
    return out


def drive_vector(CD, dev, card):
    """The vector adapter (gymnasium's vector API without gymnasium) on
    Reach at B_BENCH and reachao1 at B_MAIN: a reset and VECTOR_EP + 2
    steps; an env that ended (ReachAO's collisions and successes, and
    every env at the step limit VECTOR_EP) resets on the next step with
    reward 0 and no flags; one batched_step and its K1 launches per step.
    Returns {task: (B, launches, kernel launches, median ms/step, autoreset
    step ms)}."""
    from panda_gym_tpu_torch.envs.vector_adapter import (VectorAdapter,
                                                         make_vector_core)
    out = {}
    for task, B in VECTOR:
        core = make_vector_core(task, "reachao1", device="cuda")
        v = VectorAdapter(core, B, max_episode_steps=VECTOR_EP)
        v.reset(seed=SEED)
        motor = core.physics_step_batched.motor
        zero_counts(motor)
        rng = np.random.default_rng(SEED)
        ms, resets = [], []
        for t in range(VECTOR_EP + 2):
            a = rng.uniform(-1, 1, (B, core.robot.action_dim)).astype(
                np.float32)
            mask = v._needs_reset.copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs, r, term, trunc, info = v.step(a)
            ms.append((time.perf_counter() - t0) * 1e3)
            resets.append(int(mask.sum()))
            ended = term | trunc
            if not np.isfinite(obs["observation"]).all():
                fail(f"phase 14 vector {task}: a non-finite observation")
            # an env ended on the step before resets: reward 0, no flags
            if (r[mask] != 0).any() or ended[mask].any():
                fail(f"phase 14 vector {task}: an autoreset env has a "
                     f"reward or a flag")
            # the step limit ends every env that did not reset on the way
            if t == VECTOR_EP - 1 and not (ended | mask).all():
                fail(f"phase 14 vector {task}: the step limit did not end "
                     f"every env")
        if resets[VECTOR_EP] < B // 2:
            fail(f"phase 14 vector {task}: {resets[VECTOR_EP]} autoresets "
                 f"on step {VECTOR_EP + 1}")
        per_step = N_SUBSTEPS if core.task.check_collision else 1
        n, kl = counts_of(motor)
        ok = n == per_step * (VECTOR_EP + 2)
        med = float(np.median(ms[1:]))
        say(f"phase 14 vector {task} B={B}: {VECTOR_EP + 2} steps, the envs "
            f"reset per step {resets} (the step limit {VECTOR_EP}, and envs "
            f"that ended earlier), {n} K1 launches (want {per_step} per "
            f"step; {kl[CD.LANES]} lane-group, {kl[CD.THREAD]} one env per "
            f"thread); step median {med:.1f} ms, the step that resets "
            f"{resets[VECTOR_EP]} envs {ms[VECTOR_EP]:.1f} ms, every step "
            f"{[round(m, 1) for m in ms]} {'ok' if ok else 'FAIL'} | {card}")
        if not ok:
            fail(f"phase 14 vector {task}: K1 launches {n}")
        out[task] = (B, n, kl, med, ms[VECTOR_EP])
    return out


def facade_diff(a, b, idx):
    """Per env, whether two facade steps part beyond the tolerances: q, qd,
    the bodies' positions and velocities, the link distances and the
    flag."""
    return (((a.q - b.q).abs() > ATOL_Q).any(1)
            | ((a.qd - b.qd).abs() > ATOL_QD).any(1)
            | ((a.body_pos - b.body_pos).abs() > ATOL_OBS).flatten(1).any(1)
            | ((a.body_vel - b.body_vel).abs() > ATOL_OBS).flatten(1).any(1)
            | ((a.link_obstacle_dist - b.link_obstacle_dist).abs()
               > ATOL_LINK).any(1)
            | (a.is_collided != b.is_collided))


def drive_facade(dev, card):
    """Simulation on the card: a falling sphere beside a sphere obstacle
    moving into the hand at 1 m/s (3 steps: one cold K1 launch with the
    contact torque per substep, the flag raised without a freeze), and a
    robot-only scene under gravity (0, 0, -1.62) (K1 with the gravity
    vector, 3 steps); the first step of each held against the plain route.
    Returns {scene: (launches, kernel launches, error, median ms/step)}."""
    from panda_gym_tpu_torch.sim.facade import Simulation
    out = {}
    for scene in ("body and moving obstacle", "gravity (0, 0, -1.62)"):
        if scene.startswith("body"):
            s = Simulation(n_substeps=N_SUBSTEPS, device="cuda")
            per_step = N_SUBSTEPS
        else:
            s = Simulation(n_substeps=N_SUBSTEPS, device="cuda",
                           gravity=(0.0, 0.0, -1.62))
            per_step = 1
        s.load_robot(base_position=(-0.6, 0.0, 0.0))
        s.create_plane(z_offset=-0.4)
        s.create_table(length=1.1, width=0.7, height=0.4)
        s.set_joint_angles("robot", list(range(7)), NEUTRAL7)
        if scene.startswith("body"):
            s.create_sphere("ball", radius=0.03, mass=1.0,
                            position=(0.2, -0.2, 0.5))
            ee = s.get_link_position("robot", 11)
            s.create_sphere("mover", radius=0.03, mass=0.0,
                            position=ee + np.array([0.14, 0.0, 0.0]))
            s.set_base_velocity("mover", np.array([-1.0, 0.0, 0.0]))
        tgt = list(NEUTRAL7)
        tgt[6] = 1.5
        s.control_joints("robot", list(range(7)), tgt)
        phys = s.physics
        kept = counts_of(phys.motor)
        _, err, _ = hold_step_routes(phys, s._state, facade_diff,
                                     f"phase 14 Simulation, {scene}", dev,
                                     card)
        restore_counts(phys.motor, kept)
        zero_counts(phys.motor)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.step()
            ms.append((time.perf_counter() - t0) * 1e3)
        n, kl = counts_of(phys.motor)
        ok = n == 3 * per_step
        if scene.startswith("body"):
            vz = float(s.get_base_velocity("ball")[2])
            ok &= s.is_collided and abs(vz + 9.81 * 3 * s.dt) < 1e-3
            extra = f"flag {s.is_collided}, the ball's vz {vz:.4f} m/s"
        else:
            extra = f"gravity pointer {phys.motor.gravity}"
        med = float(np.median(ms[1:]))
        say(f"phase 14 Simulation, {scene}: route {phys.route}, {n} K1 "
            f"launches (want {per_step} per step), {extra}; step median "
            f"{med:.1f} ms (first {ms[0]:.1f} ms) {'ok' if ok else 'FAIL'} "
            f"| {card}")
        if not ok:
            fail(f"phase 14 Simulation, {scene}: the checks failed")
        out[scene] = (n, kl, err, med)
    return out


# K1 at B = 1 as the per-env entry points launch it: (kind, chain, substeps,
# warm, with tau_ext, gravity)
B1_KINDS = (("warm20", "panda7", N_SUBSTEPS, True, False, None),
            ("warm20 gravity", "panda7", N_SUBSTEPS, True, False, GRAVITY),
            ("warm20", "mycobot", N_SUBSTEPS, True, False, None),
            ("cold1", "panda7", 1, False, False, None),
            ("cold1 tau", "panda7", 1, False, True, None),
            ("warm1 tau", "panda7", 1, True, True, None),
            ("warm1 tau", "panda9", 1, True, True, None))


def k1_times_b1(CD, models, rng, dev, card):
    """K1 at B = 1 beside its bound, one row of B1_KINDS each: 20 warm
    substeps (Reach's welded Panda, with and without a gravity vector, and
    MyCobot), one cold substep (ReachAO), one cold substep with tau_ext (the
    facade's bodies beside obstacles), one warm substep with tau_ext (the
    contact tasks of both Pandas).  Operations are counted on the plain
    version's trace, bytes as each launch reads and writes them.  Returns
    {(kind, chain): (ms, plain_ms, bound_ms, ops, bytes)}."""
    out = {}
    for kind, key, n_sub, warm, with_tau, grav in B1_KINDS:
        model = models[key]
        n = model.ndof
        k1 = CD.make_cuda_motor_steps(model, n_substeps=n_sub, dt=DT,
                                      ctrl_mode=0, warm_start=warm,
                                      gravity=grav)
        q, qd, tgt = motor_inputs(model, 1, 0, rng, dev)
        if with_tau:
            tau1 = torch.full((1, n), 10.0)
            w1 = ((torch.zeros(1, n, dtype=torch.bool), torch.ones(1, n))
                  if warm else None)
            ops = count_plain_ops(model, 0, step=lambda a, b, c:
                                  k1.plain_substep(a, b, c, tau1, w1))
            tau = 10.0 * torch.randn(1, n, device=dev)
            w = k1.seed(q, qd, tgt) if warm else None
            ms = time_cuda(lambda: k1.substep(q, qd, tgt, tau, w), 20,
                           queued=True)
            p_ms = time_cuda(lambda: k1.plain_substep(q, qd, tgt, tau, w),
                             1, warmup=1)
            nbytes = k1_substep_bytes(n) if warm else 6 * 4 * n
        else:
            ops = count_plain_ops(model, 0, n_substeps=n_sub,
                                  warm_start=warm, step=k1.plain)
            ms = time_cuda(lambda: k1(q, qd, tgt), 20, queued=True)
            p_ms = time_cuda(lambda: k1.plain(q, qd, tgt), 1, warmup=1)
            nbytes = k1_bytes(n)
        bound = k1_bound_ms(ops, 1, nbytes)
        out[kind, key] = (ms, p_ms, bound, ops, nbytes)
        say(f"phase 14 K1 B=1 {kind} ({key}): {ms:.4f} ms/launch, bound "
            f"{bound:.3e} ms ({ops} fp32 ops, {nbytes} bytes), "
            f"{ms / bound:.0f}x the bound; plain version {p_ms:.1f} ms | "
            f"{card}")
    return out


def phase14(CD, _hi_prec, model, rng, dev, card):
    """Phase 14; returns what the kernels line needs."""
    t0 = time.perf_counter()
    gravity_err = check_gravity_k1(CD, model, rng, dev, card)
    golden = bullet_goldens(dev, card)
    adapters = drive_adapters(CD, _hi_prec, dev, card)
    vector = drive_vector(CD, dev, card)
    facade = drive_facade(dev, card)
    from panda_gym_tpu_torch.models.mycobot import make_mycobot_model
    from panda_gym_tpu_torch.models.panda import make_panda_model
    times = k1_times_b1(CD, {"panda7": model,
                             "mycobot": make_mycobot_model(),
                             "panda9": make_panda_model(gripper="prismatic")},
                        rng, dev, card)
    say(f"phase 14 done in {time.perf_counter() - t0:.1f} s")
    return gravity_err, golden, adapters, vector, facade, times


# ----------------------------------------------------------------- phase 15
# Env-batch data parallelism over torch.distributed (parallel/mesh.py): one
# rank on NCCL against the single-process Trainer; two ranks sharing the
# card over gloo (NCCL refuses two ranks on one GPU), each with its block of
# the env batch and its shard of the replay; the sharded ReachAO step
# against the unsharded one; the smoke tool's collective share.  The
# profiling hooks (utils/profiling.py) time it.  Then the campaign tools,
# cut down.
MESH_STEPS = N_ENVS * HORIZON       # one rollout of 64 envs per rank
MESH_TIMEOUT_S = 600.0
CLOCKS = ("sps", "t_collect", "t_update")
CAMPAIGN_SCENES = ("reachao1", "narrow_tunnel")
CAMPAIGN_EPISODES = 16
# phase 8's horizon: the tools' rounds cut to 20 steps keep phase 15
# near its time
CAMPAIGN_HORIZON = HORIZON
CAMPAIGN_STEPS = 200


def mesh_config(n_envs, evaluate):
    """Phase 8's TrainConfig cut to one rollout of n_envs (global) envs and
    its burst, a full-state checkpoint after it and, with ``evaluate``, an
    evaluation of 64 episodes."""
    cfg = train_config(MESH_STEPS)
    cfg.n_envs = n_envs
    if not evaluate:
        cfg.eval_freq = 10 * MESH_STEPS
    return cfg


def mesh_run(CD, cfg, dev, run_root, name, mesh=None):
    """Trainer.learn on the card with ``mesh``, K1's counts set to 0 as the
    env is made, just before the run; a profiling.StepTimer around it,
    ending in profiling.sync.  Returns (trainer, K1's counts, seconds)."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.rl.logging_utils import RunLogger
    from panda_gym_tpu_torch.rl.train import Trainer
    from panda_gym_tpu_torch.utils import profiling as P

    cores = []

    def make_env(sc, thr, spd):
        core = make_reach_ao_core(sc, config=cfg, ee_error_threshold=thr,
                                  speed_threshold=spd, device=dev)
        reset_counts(CD, core)
        cores.append(core)
        return core

    logger = (RunLogger(group="chip_smoke", name=name, config=cfg,
                        root=run_root)
              if mesh is None or mesh.rank == 0 else None)
    trainer = Trainer(cfg, make_env, logger=logger, mesh=mesh)
    timer = P.StepTimer()
    with timer:
        trainer.learn()
        P.sync(trainer.buffer.ep_len)
    if logger is not None:
        logger.close()
    counts = dict(cores[0].physics_step_batched.motor.kernel_launches)
    return trainer, counts, timer.samples[-1]


def mesh_env_steps(trainer):
    """A rank's env steps: its rollouts' and its evaluation rounds'."""
    hist = trainer.metrics.history
    n_evals = sum("eval_success" in r for r in hist)
    rounds = -(-trainer.config.n_eval_episodes // trainer.config.n_envs)
    return HORIZON * (sum("rollout_reward" in r for r in hist)
                      + n_evals * rounds)


def rollout_ms(rows, n_updates, n_envs):
    """ms per collect env step, the n_envs envs' env-steps/s while
    collecting and ms per update of the burst, from a run's first rollout
    row (host clock; under a mesh the ranks' means)."""
    r = next(r for r in rows if "rollout_reward" in r)
    return (f"collect {r['t_collect'] * 1e3 / HORIZON:.1f} ms per env step "
            f"({n_envs * HORIZON / r['t_collect']:.1f} env-steps/s over "
            f"{n_envs} envs), {r['t_update'] * 1e3 / n_updates:.2f} ms per "
            f"update of the burst")


def no_clocks(rows):
    return [{k: v for k, v in r.items() if k not in CLOCKS} for r in rows]


def latest_full_state(run_root, name):
    from panda_gym_tpu_torch.rl.checkpoint import (CheckpointManager,
                                                   load_checkpoint)
    latest = CheckpointManager(os.path.join(
        run_root, "chip_smoke", name, "full_state")).latest()
    return None if latest is None else load_checkpoint(latest)


def mesh_one_rank(CD, dev, card, run_root):
    """Phase 15a: initialize_multihost starts a one-rank NCCL group on the
    card; Trainer.learn with its mesh and with no mesh, the same config:
    the parameters and Adam state, the buffer, the generator, the rows but
    their host clocks and the full-state checkpoints bit for bit.  Returns
    (env-steps/s at W = 1, K1's launches, env steps)."""
    import torch.distributed as dist
    from panda_gym_tpu_torch.parallel import mesh as M
    from panda_gym_tpu_torch.rl import her
    from panda_gym_tpu_torch.rl.learners import named_state
    from panda_gym_tpu_torch.rl.train import schedule
    from panda_gym_tpu_torch.utils import profiling as P

    M.initialize_multihost("file://" + os.path.join(run_root, "nccl_store"),
                           1, 0, device=dev)
    try:
        mesh = M.make_env_mesh()
        backend = dist.get_backend()
        runs = {name: mesh_run(CD, mesh_config(N_ENVS, False), dev, run_root,
                               f"phase15a_{name}", m)
                for name, m in (("mesh", mesh), ("none", None))}
    finally:
        M.shutdown()
    (tm, cm, sm), (tn, cn, sn) = runs["mesh"], runs["none"]
    steps = mesh_env_steps(tm)
    a, b = named_state(tm.ts), named_state(tn.ts)
    ba, bb = her.save_state(tm.buffer), her.save_state(tn.buffer)
    pa, pb = (latest_full_state(run_root, f"phase15a_{n}")
              for n in ("mesh", "none"))
    checks = {
        "a one-rank NCCL group": backend == "nccl" and mesh.world_size == 1
            and mesh.group is not None,
        "K1: 20 launches per env step, all on the lane-group kernel, in "
        "both runs": cm == cn == {CD.LANES: N_SUBSTEPS * steps,
                                  CD.THREAD: 0},
        "a collect rollout and its burst": tm.ts.step == tn.ts.step
            == schedule(tm.config, HORIZON).updates_per_rollout,
        "rows equal but their host clocks":
            no_clocks(tm.metrics.history) == no_clocks(tn.metrics.history),
        "parameters and Adam state bitwise equal": all(
            torch.equal(a[k], b[k]) for k in a),
        "buffer bitwise equal": (ba["write_idx"], ba["n_stored"])
            == (bb["write_idx"], bb["n_stored"]) and all(
            torch.equal(v, bb["tensors"][k])
            for k, v in ba["tensors"].items()),
        "generators equal": torch.equal(tm.generator.get_state(),
                                        tn.generator.get_state()),
        "full-state checkpoints equal": pa is not None and pb is not None
            and pa.keys() == pb.keys() and all(
            torch.equal(v, pb["ts"]["tensors"][k])
            for k, v in pa["ts"]["tensors"].items()) and all(
            torch.equal(v, pb["buffer"]["tensors"][k])
            for k, v in pa["buffer"]["tensors"].items()),
    }
    say(f"phase 15a one rank on {backend}: Trainer.learn on reachao1 at "
        f"n_envs={N_ENVS}, {steps} env steps, {tm.ts.step} updates, K1 "
        f"launches {({KERNEL_NAMES[k]: v for k, v in cm.items()})}, checks "
        f"{checks}")
    say(f"phase 15 W=1: {tm.timesteps} env steps in {sm:.2f} s, "
        f"{tm.timesteps / sm:.1f} env-steps/s with the mesh (a collect "
        f"rollout, its burst of {tm.ts.step} updates, set-up included), "
        f"{tn.timesteps / sn:.1f} without; "
        f"{rollout_ms(tm.metrics.history, tm.ts.step, N_ENVS)} | {card}")
    say(f"phase 15 device_memory_stats: {P.device_memory_stats()} | {card}")
    if not all(checks.values()):
        fail(f"phase 15a checks failed: {checks}")
    return tm.timesteps / sm, cm[CD.LANES], steps


def sharded_step(mesh):
    """Phase 15c on one rank: one batched_step of reachao1 at the global
    B_MAIN (the first obstacle of envs 0-7 of each block on its end
    effector) and the rank's block of it stepped alone, by phase 7's rule:
    q, qd and link distances within 2e-5, 2e-3 and 1e-4, collided flags
    equal, on every env of the block but at most 16 contact ties."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.parallel import mesh as M

    dev = mesh.device
    env = make_reach_ao_core("reachao1", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = env.batched_reset(B_MAIN, gen)
    forced = torch.cat([torch.arange(N_FORCED) + b * B_MAIN // 2
                        for b in range(2)]).to(dev)
    opos = states.obstacle_pos.clone()
    opos[forced, 0] = obs["achieved_goal"][forced]
    states = states.replace(obstacle_pos=opos)
    a = torch.rand(B_MAIN, env.robot.action_dim, generator=gen,
                   device=dev) * 2.0 - 1.0
    full = M.shard_env_batch(env.batched_step(states, a)[0], mesh)
    mine = env.batched_step(M.shard_env_batch(states, mesh),
                            M.shard_env_batch(a, mesh))[0]
    bad = route_diff(mine, full)
    good = ~bad
    least = full.link_obstacle_dist.abs().amin(1)
    return {"block": M.env_sharding(mesh, B_MAIN), "outside": int(bad.sum()),
            "ties": bool((least[bad] <= ATOL_LINK).all()),
            "collided": int(full.is_collided.sum()),
            "errors": [(mine.q - full.q)[good].abs().max().item(),
                       (mine.qd - full.qd)[good].abs().max().item(),
                       (mine.link_obstacle_dist - full.link_obstacle_dist)
                       [good].abs().max().item()]}


def mesh_rank(rank, nproc, store, run_root):
    """Phases 15b and c on one of the ranks that share card 0 over gloo:
    the sharded step, then Trainer.learn with the mesh."""
    from panda_gym_tpu_torch.ops import cuda_dynamics as CD
    from panda_gym_tpu_torch.parallel import mesh as M
    from panda_gym_tpu_torch.rl.learners import named_state
    from panda_gym_tpu_torch.utils import profiling as P

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M.initialize_multihost(store, nproc, rank, device="cuda:0",
                           backend="gloo")
    try:
        mesh = M.make_env_mesh()
        sharded = sharded_step(mesh)
        trainer, counts, seconds = mesh_run(
            CD, mesh_config(nproc * N_ENVS, True), mesh.device, run_root,
            "phase15b", mesh)
        return dict(
            counts=counts, seconds=seconds, steps=mesh_env_steps(trainer),
            rows=trainer.metrics.history, step=trainer.ts.step,
            state={k: v.detach().cpu()
                   for k, v in named_state(trainer.ts).items()},
            capacity=trainer.buffer.capacity,
            n_stored=trainer.buffer.n_stored, timesteps=trainer.timesteps,
            sharded=sharded, memory=P.device_memory_stats())
    finally:
        M.shutdown()


def mesh_two_ranks(CD, card, run_root):
    """Phases 15b and c: two spawned ranks on card 0 over gloo, reachao1 at
    global n_envs 128, 64 per rank, one rollout and its burst, one
    evaluation and a full-state checkpoint.  Returns (env-steps/s at W = 2,
    K1's launches on each rank, env steps on each)."""
    from panda_gym_tpu_torch.parallel.smoke import launch
    from panda_gym_tpu_torch.rl.train import schedule

    cfg = mesh_config(2 * N_ENVS, True)
    r0, r1 = launch(mesh_rank, 2, (run_root,), MESH_TIMEOUT_S)
    sched = schedule(cfg, HORIZON)
    payload = latest_full_state(run_root, "phase15b")
    metrics = [v for r in r0["rows"] for k, v in r.items()
               if k in ("critic_loss", "actor_loss", "alpha")]
    for r in (r0, r1):
        sh = r["sharded"]
        say(f"phase 15c rank block {sh['block']}: sharded reachao1 step vs "
            f"the unsharded step at B={B_MAIN}: max|dq|={sh['errors'][0]:.3e}"
            f" (atol {ATOL_Q}) max|dqd|={sh['errors'][1]:.3e} (atol "
            f"{ATOL_QD}) max|dlink|={sh['errors'][2]:.3e} m (atol "
            f"{ATOL_LINK}), {sh['collided']} collided, {sh['outside']} "
            f"outside the tolerance (contact ties: {sh['ties']})")
    checks = {
        "K1: 20 launches per env step on each rank, all on the lane-group "
        "kernel": r0["steps"] == r1["steps"] > 0 and r0["counts"]
            == r1["counts"] == {CD.LANES: N_SUBSTEPS * r0["steps"],
                                CD.THREAD: 0},
        "one evaluation": sum("eval_success" in r for r in r0["rows"]) == 1,
        "the rows equal on both ranks": r0["rows"] == r1["rows"],
        "the parameters bitwise equal on both ranks": all(
            torch.equal(v, r1["state"][k]) for k, v in r0["state"].items()),
        "the update count": r0["step"] == r1["step"]
            == sched.updates_per_rollout,
        "losses and alpha finite": bool(metrics) and all(
            np.isfinite(v) for v in metrics),
        "each buffer holds capacity / 2 episodes":
            r0["capacity"] == r1["capacity"] == sched.capacity // 2
            and r0["n_stored"] == r1["n_stored"] == N_ENVS,
        "the full-state checkpoint holds both ranks": payload is not None
            and payload["world_size"] == 2 and len(payload["ranks"]) == 2,
        "the sharded step agrees with the unsharded one on each block": all(
            r["sharded"]["errors"][0] <= ATOL_Q
            and r["sharded"]["errors"][1] <= ATOL_QD
            and r["sharded"]["errors"][2] <= ATOL_LINK
            and r["sharded"]["outside"] <= MAX_TIES
            and r["sharded"]["ties"] for r in (r0, r1)),
    }
    seconds = max(r0["seconds"], r1["seconds"])
    say(f"phase 15b two ranks on card 0 over gloo: Trainer.learn on reachao1 "
        f"at n_envs={2 * N_ENVS} ({N_ENVS} per rank), {r0['steps']} env "
        f"steps per rank, {r0['step']} updates on batches of "
        f"{sched.batch_size // 2} per rank, K1 launches per rank "
        f"{({KERNEL_NAMES[k]: v for k, v in r0['counts'].items()})}, buffer "
        f"{r0['capacity']} of {sched.capacity} episodes per rank, checks "
        f"{checks}")
    say(f"phase 15 W=2: {rollout_ms(r0['rows'], r0['step'], 2 * N_ENVS)} "
        f"(the ranks' "
        f"means) | {card}")
    say(f"phase 15 W=2: {r0['timesteps']} env steps in {seconds:.2f} s, "
        f"{r0['timesteps'] / seconds:.1f} env-steps/s (ranks "
        f"{r0['seconds']:.2f} and {r1['seconds']:.2f} s; a collect rollout, "
        f"its burst, one "
        f"evaluation, set-up included); device_memory_stats of rank 0 "
        f"{r0['memory']} | {card}")
    if not all(checks.values()):
        fail(f"phase 15b/c checks failed: {checks}")
    return r0["timesteps"] / seconds, r0["counts"][CD.LANES], r0["steps"]


def mesh_smoke(card, run_root):
    """Phase 15d: the smoke tool with two ranks on card 0 over gloo, Reach
    at B_MAIN: ms per sharded step with and without the collective."""
    from panda_gym_tpu_torch.parallel import smoke

    rec = smoke.main(["--nproc", "2", "--device", "cuda", "--backend",
                      "gloo", "--n-envs", str(B_MAIN), "--out",
                      os.path.join(run_root, "multihost_smoke.json")])
    say(f"phase 15d smoke tool: {rec['processes']} ranks, Reach at "
        f"n_envs={B_MAIN}: {rec['t_step_ms']:.3f} ms per sharded step, "
        f"{rec['t_step_with_collective_ms']:.3f} with the collective, "
        f"collective_overhead_fraction {rec['collective_overhead_fraction']:.4f}"
        f", errors {rec['max_errors']}, transport {rec['transport']} | "
        f"{card}")
    return rec


class NewK1Wrappers:
    """Every K1 wrapper made inside the block, whose counts start at 0 as
    it is made: a campaign tool builds its own cores."""

    def __init__(self, CD):
        self.CD, self.made = CD, []

    def __enter__(self):
        init = self._init = self.CD.CudaMotorSteps.__init__
        made = self.made

        def record(wrapper, *a, **kw):
            init(wrapper, *a, **kw)
            made.append(wrapper)

        self.CD.CudaMotorSteps.__init__ = record
        return self

    def __exit__(self, *exc):
        self.CD.CudaMotorSteps.__init__ = self._init

    def counts(self):
        out = {self.CD.LANES: 0, self.CD.THREAD: 0}
        for w in self.made:
            for k, v in w.kernel_launches.items():
                out[k] += v
        return out


def drive_continue(CD, card, run_root):
    """Phase 15e: continue_population from phase 13's member checkpoints
    (best_model_m<k>.ckpt), one collect rollout of its 4 x 64 envs (a
    budget of one env step: episodes that end early would leave a rollout
    short of 64 x 20)."""
    from panda_gym_tpu_torch.rl import continue_population
    from panda_gym_tpu_torch.rl.checkpoint import load_checkpoint

    src = os.path.join(run_root, "chip_smoke", "phase13")
    step0 = load_checkpoint(os.path.join(src, "best_model_m0.ckpt"))[
        "ts"]["step"]
    t0 = time.perf_counter()
    with NewK1Wrappers(CD) as k1:
        pt = continue_population.main([
            "--src", src, "--ckpt", "best_model", "--stage", POP_SCENE,
            "--steps", "1", "--learning-starts", str(MESH_STEPS),
            "--root", run_root, "--group", "chip_smoke", "--name",
            "phase15_continue", "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = k1.counts()
    out = os.path.join(run_root, "chip_smoke", "phase15_continue")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rollouts = sum("rollout_success" in json.loads(ln) for ln in f)
    checks = {
        "one rollout": rollouts == 1,
        "K1: 20 launches per env step, on the lane-group kernel":
            counts == {CD.LANES: N_SUBSTEPS * HORIZON, CD.THREAD: 0},
        "the members resumed with their update count":
            pt.K == POP_MEMBERS and pt.pop.step == step0,
        "the final member checkpoints": all(os.path.exists(os.path.join(
            out, f"final_m{i}.ckpt")) for i in range(POP_MEMBERS)),
    }
    say(f"phase 15e continue_population: {pt.K} members from phase 13 "
        f"(update count {step0}), one rollout of {pt.K} x {N_ENVS} envs, K1 "
        f"launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"{seconds:.1f} s, checks {checks} | {card}")
    if not all(checks.values()):
        fail(f"phase 15e continue_population checks failed: {checks}")
    return counts[CD.LANES]


def drive_distill_cli(CD, root, card, run_root):
    """Phase 15e: distill_cli on the asset's routed generalist, reachao1
    and narrow_tunnel, BC then one DAgger round, each round's benchmark;
    its .policy.npz through the eval CLI."""
    from panda_gym_tpu_torch.eval import cli as eval_cli
    from panda_gym_tpu_torch.rl import distill_cli

    asset = os.path.join(root, "panda_gym_tpu_torch", "assets", "routed_gen")
    out = os.path.join(run_root, "distilled_gen")
    t0 = time.perf_counter()
    with NewK1Wrappers(CD) as k1:
        mean, tag = distill_cli.main([
            "--router", os.path.join(asset, "routed_policy.npz"), "--out",
            out, "--scenarios", *CAMPAIGN_SCENES, "--bc-episodes",
            str(CAMPAIGN_EPISODES), "--dagger-rounds", "1",
            "--dagger-episodes", str(CAMPAIGN_EPISODES), "--horizon",
            str(CAMPAIGN_HORIZON), "--steps", str(CAMPAIGN_STEPS),
            "--episodes", str(CAMPAIGN_EPISODES), "--bench-horizon",
            str(CAMPAIGN_HORIZON), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = k1.counts()
    # the export alone, in a run directory of its own
    run = os.path.join(run_root, "student")
    os.makedirs(run)
    for f in ("best_model.policy.npz", "config.json"):
        shutil.copy(os.path.join(out, f), os.path.join(run, f))
    res = eval_cli.main([run, "--scenarios", CAMPAIGN_SCENES[0], "--episodes",
                         str(CAMPAIGN_EPISODES), "--horizon", "2", "--device",
                         "cuda"])
    collect = N_SUBSTEPS * CAMPAIGN_HORIZON * len(CAMPAIGN_SCENES) * 2
    checks = {
        "K1: 20 launches per env step, on the lane-group kernel (the "
        "collections' steps and at most the benchmarks')":
            counts[CD.THREAD] == 0 and counts[CD.LANES] % N_SUBSTEPS == 0
            and collect < counts[CD.LANES] <= 2 * collect,
        "the student's rates in [0, 1]": 0.0 <= mean <= 1.0,
        "its .policy.npz runs in the eval CLI":
            res[CAMPAIGN_SCENES[0]]["scenario_episodes"] == CAMPAIGN_EPISODES,
    }
    say(f"phase 15e distill_cli: {CAMPAIGN_EPISODES} episodes of "
        f"{CAMPAIGN_HORIZON} steps on {' and '.join(CAMPAIGN_SCENES)}, "
        f"{CAMPAIGN_STEPS} BC steps a round, one DAgger round: best round "
        f"{tag}, mean success {mean:.4f}; K1 launches "
        f"{({KERNEL_NAMES[k]: v for k, v in counts.items()})}, {seconds:.1f} "
        f"s, checks {checks} | {card}")
    if not all(checks.values()):
        fail(f"phase 15e distill_cli checks failed: {checks}")
    return counts[CD.LANES]


def drive_build_router(CD, root, dev, card, run_root):
    """Phase 15e: build_router from a run-data root made of the asset's
    members (reachao1's and narrow_tunnel's controllers), 200 training
    steps; the saved policy loads, and its routed action on the card
    equals the CPU's by phase 9's rule."""
    from panda_gym_tpu_torch.eval import build_router
    from panda_gym_tpu_torch.eval.router import load_routed_policy
    from panda_gym_tpu_torch.rl.policy_io import FORMAT, write_policy

    asset = os.path.join(root, "panda_gym_tpu_torch", "assets", "routed_gen")
    data_root = os.path.join(run_root, "run_data")
    with np.load(os.path.join(asset, "routed_policy.npz")) as z:
        meta = json.loads(str(z["__meta__"]))
        members = {k[len("members/"):]: z[k] for k in z.files
                   if k.startswith("members/")}
    for sc in CAMPAIGN_SCENES:
        for rel in build_router.CONTROLLERS[sc]:
            run = os.path.join(data_root, rel)
            if os.path.exists(run):
                continue
            i = [m.endswith("/" + rel) for m in meta["members"]].index(True)
            write_policy(os.path.join(run, "best_model.policy.npz"),
                         {k: v[i] for k, v in members.items()},
                         {"format": FORMAT, "algorithm": "TQC",
                          "use_sde": bool(meta["use_sde"])})
            shutil.copy(os.path.join(asset, "config.json"), run)
    out = os.path.join(run_root, "routed_gen")
    t0 = time.perf_counter()
    with NewK1Wrappers(CD) as k1:
        build_router.main([
            "--root", data_root, "--out", out, "--scenarios",
            *CAMPAIGN_SCENES, "--collect-episodes", str(CAMPAIGN_EPISODES),
            "--collect-horizon", str(CAMPAIGN_HORIZON), "--steps",
            str(CAMPAIGN_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = k1.counts()
    npz = os.path.join(out, "routed_policy.npz")
    policy, rmeta = load_routed_policy(npz, dev)
    with np.load(os.path.join(out, "data",
                              f"collect_{CAMPAIGN_SCENES[1]}.npz")) as z:
        x = torch.as_tensor(z["X"][:EVAL_EPISODES], device=dev)
    err = routed_vs_cpu(policy, npz, x, card, "phase 15e build_router")
    checks = {
        "K1: 20 launches per env step, on the lane-group kernel": counts
            == {CD.LANES: N_SUBSTEPS * CAMPAIGN_HORIZON * len(CAMPAIGN_SCENES),
                CD.THREAD: 0},
        "the table's pool and controllers": len(policy.members) == len(
            {m for sc in CAMPAIGN_SCENES for m in build_router.CONTROLLERS[sc]})
            and list(rmeta["scene_to_controller"]) == list(CAMPAIGN_SCENES),
    }
    say(f"phase 15e build_router: {len(policy.members)} members, "
        f"{policy.masks.shape[0]} controllers, {CAMPAIGN_EPISODES} episodes of "
        f"{CAMPAIGN_HORIZON} steps collected per scene, {CAMPAIGN_STEPS} router "
        f"steps, validation accuracy {rmeta['val_acc_per_class']}; K1 "
        f"launches {({KERNEL_NAMES[k]: v for k, v in counts.items()})}, "
        f"{seconds:.1f} s, routed action card vs CPU max |d| {err:.3e}, "
        f"checks {checks} | {card}")
    if not all(checks.values()):
        fail(f"phase 15e build_router checks failed: {checks}")
    return counts[CD.LANES]


def phase15(CD, root, dev, card, run_root):
    """Phase 15: the mesh (a-d) and the campaign tools (e)."""
    t0 = time.perf_counter()
    mark = lambda what: say(  # noqa: E731
        f"phase 15 {what} at {time.perf_counter() - t0:.1f} s")
    w1 = mesh_one_rank(CD, dev, card, run_root)
    mark("one rank on NCCL done")
    w2 = mesh_two_ranks(CD, card, run_root)
    mark("two ranks over gloo done")
    rec = mesh_smoke(card, run_root)
    mark("smoke tool done")
    tools = (drive_continue(CD, card, run_root),
               drive_distill_cli(CD, root, card, run_root),
               drive_build_router(CD, root, dev, card, run_root))
    say(f"phase 15 env-steps/s on one card: W=1 {w1[0]:.1f}, W=2 "
        f"{w2[0]:.1f}; collective_overhead_fraction over gloo "
        f"{rec['collective_overhead_fraction']:.4f} | {card}")
    say(f"phase 15 done in {time.perf_counter() - t0:.1f} s")
    return w1, w2, rec, tools


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", metavar="ROOT",
                    help="only build, time and profile the port of the "
                         "checkout at ROOT")
    ap.add_argument("--bootstrap", action="store_true",
                    help="only build and time tqc_ft2_tunnel's full prior "
                         "bootstrap (4 rollouts of 64 x 100 NEO steps)")
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
    if args.bootstrap:
        with tempfile.TemporaryDirectory() as run_root:
            run_bootstrap(ft2_config(100, 4, N_ENVS * 100 // 2), dev,
                          run_root, CD, card)
        print(card, flush=True)
        return 0
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
    for chain, name in ((1, "MyCobot (6 dofs)"), (2, "the 9-dof Panda")):
        occ = CD.occupancy(dev.index, CD.THREAD, chain)
        say(f"phase 2 occupancy, one-env-per-thread kernel of {name}: "
            f"{occ['regs']} registers/thread, {occ['local_bytes']} bytes "
            f"local memory/thread, {occ['blocks_per_sm']} blocks of "
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
        counts, e, _, _ = drive(make_core, _hi_prec, CD, B, n_steps, dev)
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

    # --------------------------------------------------------------- 10
    ctl = drive_control(make_core, _hi_prec, CD, dev, card)
    drive_neo(dev, card)
    po_launches, po_err, _ = drive_prior_obs(CD, dev, card)
    with tempfile.TemporaryDirectory() as run_root:
        trainer, boot_launches, boot_err, _ = drive_bootstrap(CD, dev, card,
                                                              run_root)
        pe_launches, pe_err, _ = drive_prior_eval(CD, trainer, dev, card)

    # --------------------------------------------------------------- 11
    ct_counts, ct_err = {}, {}
    for task, B, n_steps in CONTACT:
        ct_counts[task, B], ct_err[task, B], _ = drive_contact(
            make_core, _hi_prec, CD, task, B, n_steps, dev, card)
    if {CD.LANES if B <= CD.lanes_wave(dev.index) else CD.THREAD
            for _, B, _ in CONTACT} != {CD.LANES, CD.THREAD}:
        fail("phase 11: the contact batches did not run both K1 kernels")
    warm_launches, warm_err = drive_reach_ao_warm(CD, _hi_prec, dev, card)
    with tempfile.TemporaryDirectory() as run_root:
        push_train_launches = drive_push_training(CD, dev, card, run_root)
    sub_times, sub_ops = k1_substep_times(CD, model, rng, dev, card)

    # --------------------------------------------------------------- 12
    cob, grip, pnp_train_launches, chain_times = phase12(
        make_core, _hi_prec, CD, rng, dev, card)

    # --------------------------------------------------------------- 13
    # phases 13-15 keep their runs here: phase 15 continues phase 13's
    # population
    runs = tempfile.TemporaryDirectory()
    pop, pop_times, off, ppo, distill, reach_times = phase13(
        CD, root, rng, dev, card, runs.name)

    # --------------------------------------------------------------- 14
    grav_err, golden, adapters, vector, facade, b1 = phase14(
        CD, _hi_prec, model, rng, dev, card)

    # --------------------------------------------------------------- 15
    phase15(CD, root, dev, card, runs.name)
    runs.cleanup()

    def bound_by(ops, bytes_per_env=K1_BYTES):
        return ("operations" if float(ops) / PEAK_FP32_OPS
                > bytes_per_env / PEAK_BYTES else "bytes")

    def k1_row(name, launches, err, ms, p_ms, bound, ops,
               bytes_per_env=K1_BYTES):
        return {"name": name, "route": "cuda",
                "source": "panda_gym_tpu_torch/ops/csrc/motor_steps.cu",
                "replaces": "panda_gym_tpu/ops/pallas_dynamics.py:96",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by(ops, bytes_per_env), "library_ms": None}

    rows = []
    for lanes, tag in ((CD.LANES, "lanes"), (CD.THREAD, "thread")):
        B, n = launches[lanes]
        rows.append(k1_row(f"K1 motor_steps_{tag}_kernel (B={B})", n,
                           err[lanes], times[B, lanes], plain_ms[B],
                           k1_bound_ms(n_ops, B), n_ops))
    B_AO = REACH_AO[-1][1]
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the ReachAO collision step, "
        f"{KERNEL_NAMES[CD.THREAD]} (B={B_AO})", ao_launches[B_AO],
        ao_err[B_AO], *ao_times[B_AO], ao_ops))
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the training path (Trainer on "
        f"reachao1), {KERNEL_NAMES[CD.LANES]} (B={N_ENVS})", train_launches,
        train_err, *tr_times[N_ENVS], ao_ops))
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the evaluation path (the routed "
        f"generalist through perform_benchmark on "
        f"{' and '.join(EVAL_SCENES)}), {KERNEL_NAMES[CD.LANES]} "
        f"(B={EVAL_EPISODES})", eval_launches, eval_err,
        *tr_times[EVAL_EPISODES], ao_ops))
    for (control, B), (counts, e, _) in ctl.items():
        lanes = CD.LANES if counts[CD.LANES] else CD.THREAD
        rows.append(k1_row(
            f"K1 on Reach under {control} control, {KERNEL_NAMES[lanes]} "
            f"(B={B})", counts[lanes], e, times[B, lanes], plain_ms[B],
            k1_bound_ms(n_ops, B), n_ops))
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on ReachAO with the prior observation "
        f"(reachao1), {KERNEL_NAMES[CD.LANES]} (B={B_MAIN})", po_launches,
        po_err, *ao_times[B_MAIN], ao_ops))
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the prior bootstrap (Trainer under "
        f"tqc_ft2_tunnel's config), {KERNEL_NAMES[CD.LANES]} (B={N_ENVS})",
        boot_launches, boot_err, *tr_times[N_ENVS], ao_ops))
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the prior and bcf evaluation "
        f"({PRIOR_EVAL_SCENE}), {KERNEL_NAMES[CD.LANES]} "
        f"(B={EVAL_EPISODES})", pe_launches, pe_err,
        *tr_times[EVAL_EPISODES], ao_ops))
    for (task, B), counts in ct_counts.items():
        lanes = CD.LANES if counts[CD.LANES] else CD.THREAD
        rows.append(k1_row(
            f"K1 one warm substep with tau_ext on the {task} contact step "
            f"(a seed and 20 substeps per step), {KERNEL_NAMES[lanes]} "
            f"(B={B})", counts[lanes], ct_err[task, B], *sub_times[B],
            sub_ops, K1_SUBSTEP_BYTES))
    rows.append(k1_row(
        f"K1 one warm substep with tau_ext on the Push training path "
        f"(Trainer at n_envs {N_ENVS}), {KERNEL_NAMES[CD.LANES]} "
        f"(B={N_ENVS})", push_train_launches, ct_err["push", N_ENVS],
        *sub_times[N_ENVS], sub_ops, K1_SUBSTEP_BYTES))
    rows.append(k1_row(
        f"K1 one warm substep on ReachAO under PANDA_LCP_WARM=1 (reachao1; "
        f"timed with tau_ext), {KERNEL_NAMES[CD.LANES]} (B={B_MAIN})",
        warm_launches, warm_err,
        *sub_times[B_MAIN], sub_ops, K1_SUBSTEP_BYTES))
    c_times, c_ops, c_bytes = chain_times["mycobot"]
    for B, (n, e, _) in cob.items():
        ms, p_ms, bound = c_times[B]
        rows.append(k1_row(
            f"K1 motor_steps_thread_kernel<MyCobotChain>, 20 warm substeps "
            f"on MyCobotReach (robot-only, one launch per step) (B={B})", n,
            e, ms, p_ms, bound, c_ops, c_bytes))
    g_times, g_ops, g_bytes = chain_times["panda9"]
    for (task, B), (n, e, _) in grip.items():
        rows.append(k1_row(
            f"K1 motor_steps_thread_kernel<GripperPandaChain>, one warm "
            f"substep with tau_ext on the {task} contact step (a seed and 20 "
            f"substeps per step) (B={B})", n, e, *g_times[B], g_ops,
            g_bytes))
    rows.append(k1_row(
        f"K1 motor_steps_thread_kernel<GripperPandaChain>, one warm substep "
        f"with tau_ext on the PickAndPlace training path (Trainer at n_envs "
        f"{N_ENVS}) (B={N_ENVS})", pnp_train_launches,
        grip["pickandplace", N_ENVS][1], *g_times[N_ENVS], g_ops, g_bytes))
    B_POP = POP_MEMBERS * N_ENVS
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the population path "
        f"(PopulationTrainer, {POP_MEMBERS} TQC members x {N_ENVS} envs on "
        f"{POP_SCENE}), {KERNEL_NAMES[CD.LANES]} (B={B_POP})", pop[0],
        pop[1], *pop_times[B_POP], ao_ops))
    paths = [(f"the {algo} training path (Trainer on Reach)", off[algo],
              N_ENVS) for algo in off]
    paths.append(("the PPO path (train_ppo on Reach)", ppo, PPO_ENVS))
    for what, (n, e), B in paths:
        rows.append(k1_row(
            f"K1 motor_steps_lanes_kernel, 20 warm substeps on {what} "
            f"(B={B})", n, e, *reach_times[B], k1_bound_ms(n_ops, B), n_ops))
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the distillation path "
        f"(collect_labeled with the routed generalist on reachao1), "
        f"{KERNEL_NAMES[CD.LANES]} (B={EVAL_EPISODES})", distill[0],
        distill[1], *tr_times[EVAL_EPISODES], ao_ops))
    # phase 14: the per-env entry points (B = 1), the vector adapter, the
    # stateful Simulation
    def b1_row(what, kind, key, names, kernel):
        n = sum(adapters[c][0] for c in names)
        e = max(adapters[c][2] for c in names)
        ms, p_ms, bound, ops, nbytes = b1[kind, key]
        return k1_row(f"{kernel}, {what} (B=1)", n, e, ms, p_ms, bound, ops,
                      nbytes)

    rows.append(b1_row(
        "20 warm substeps on the single-env adapters of Reach and "
        "ReachChecker (one launch per step)", "warm20", "panda7",
        ("PandaReachEnv", "PandaReachCheckerEnv"),
        "K1 motor_steps_lanes_kernel"))
    rows.append(b1_row(
        "20 warm substeps on the single-env adapter of MyCobotReach",
        "warm20", "mycobot", ("MyCobotReachEnv",),
        "K1 motor_steps_thread_kernel<MyCobotChain>"))
    rows.append(b1_row(
        "one warm substep with tau_ext on the single-env adapters of Push "
        "and Slide (a seed and 20 substeps per step)", "warm1 tau", "panda7",
        ("PandaPushEnv", "PandaSlideEnv"), "K1 motor_steps_lanes_kernel"))
    rows.append(b1_row(
        "one warm substep with tau_ext on the single-env adapters of "
        "PickAndPlace, Stack and Flip (a seed and 20 substeps per step)",
        "warm1 tau", "panda9",
        ("PandaPickAndPlaceEnv", "PandaStackEnv", "PandaFlipEnv"),
        "K1 motor_steps_thread_kernel<GripperPandaChain>"))
    rows.append(b1_row(
        "n_substeps=1, cold, on the single-env adapter of ReachAO "
        "(reachao1)", "cold1", "panda7", ("PandaReachAOEnv",),
        "K1 motor_steps_lanes_kernel"))
    B_V, n_v, _, _, _ = vector["reach"]
    rows.append(k1_row(
        f"K1 motor_steps_thread_kernel, 20 warm substeps on the vector "
        f"adapter of Reach through an autoreset (B={B_V})", n_v, err[CD.THREAD],
        times[B_V, CD.THREAD], plain_ms[B_V], k1_bound_ms(n_ops, B_V),
        n_ops))
    B_V, n_v, _, _, _ = vector["reachao"]
    rows.append(k1_row(
        f"K1 at n_substeps=1, cold, on the vector adapter of ReachAO "
        f"(reachao1) through an autoreset, {KERNEL_NAMES[CD.LANES]} "
        f"(B={B_V})", n_v, ao_err[B_MAIN], *ao_times[B_V], ao_ops))
    ms, p_ms, bound, ops, nbytes = b1["warm20", "panda7"]
    rows.append(k1_row(
        "K1 motor_steps_lanes_kernel, 20 warm substeps with the force clamps "
        "of control_joints, on Simulation's Bullet golden step (B=1)",
        golden[0], golden[1], ms, p_ms, bound, ops, nbytes))
    ms, p_ms, bound, ops, nbytes = b1["warm20 gravity", "panda7"]
    n, _, e, _ = facade["gravity (0, 0, -1.62)"]
    rows.append(k1_row(
        "K1 motor_steps_lanes_kernel, 20 warm substeps with a gravity "
        "vector, on Simulation(gravity=(0, 0, -1.62)) (B=1; timed and held "
        f"at gravity {GRAVITY} too)", n, max(e, grav_err), ms, p_ms, bound,
        ops, nbytes))
    ms, p_ms, bound, ops, nbytes = b1["cold1 tau", "panda7"]
    n, _, e, _ = facade["body and moving obstacle"]
    rows.append(k1_row(
        "K1 motor_steps_lanes_kernel, one cold substep with tau_ext, on "
        "Simulation with a free body beside a moving obstacle (20 per step)"
        " (B=1)", n, e, ms, p_ms, bound, ops, nbytes))
    say(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel K1's CUDA source, compiled as host C++, against its plain version.

There is no CUDA compiler or card here, so ``motor_steps.cu`` is compiled
with the host C++ compiler: a stub header turns the CUDA qualifiers into
plain C++ and the launch into a loop over blocks that runs every thread of
a block at once as a std::thread, the 8 lanes of an env's group meeting at
a barrier for each ``__syncwarp()``.  This holds the kernel's arithmetic
(RNEA, CRBA, Cholesky, the active-set LCP, the warm start) and its lane
exchange (the scratch slots, the syncs, the masked groups of a ragged
last block) against
ops/scalarized.py on the CPU, at the tests/test_dynamics.py:295-296
tolerances, and the one-substep launches of the contact step (the seed,
the carried active set, the contact torque) against one 20-substep launch
and the plain substep.  It says nothing about how the card compiles or runs
it: that is chip_smoke.py's and tests/test_torch_cuda.py's work.
"""
import hashlib
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import _build
from panda_gym_tpu_torch.ops import cuda_dynamics as CD
from panda_gym_tpu_torch.ops import dynamics as D

ATOL_Q, ATOL_QD = 2e-5, 2e-3

STUB = """
#pragma once
#include <math.h>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
struct Dim3Stub { int x; };
static thread_local Dim3Stub blockIdx, blockDim, threadIdx;
static thread_local std::barrier<>* lane_group;
inline void __syncwarp(unsigned = 0xffffffffu) { lane_group->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
static const int cudaSuccess = 0;
static const int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
inline int cudaSetDevice(int) { return 0; }
struct cudaFuncAttributes { int numRegs; unsigned long localSizeBytes; };
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes*, F) { return 1; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, unsigned long) { return 1; }
// The blocks run one after another; every thread of a block runs at once
// as a std::thread, and the 8 lanes of a group meet at one barrier per
// __syncwarp(), so a lane that reads a slot before its owner has written it,
// or a group whose lanes reach different numbers of __syncwarp(), shows.
template <class F>
void host_launch(int blocks, int threads, F body) {
  for (int bb = 0; bb < blocks; ++bb) {
    std::vector<std::unique_ptr<std::barrier<>>> groups;
    for (int g = 0; g < threads / 8; ++g)
      groups.emplace_back(new std::barrier<>(8));
    std::vector<std::thread> lanes;
    for (int tt = 0; tt < threads; ++tt)
      lanes.emplace_back([&, tt] {
        blockIdx.x = bb, blockDim.x = threads, threadIdx.x = tt;
        lane_group = groups[tt / 8].get();
        body();
      });
    for (auto& t : lanes) t.join();
  }
}
"""
# the two launch statements, and what runs them on the host
LAUNCH = re.compile(r"(motor_steps_\w+_kernel(?:<\w+>)?)<<<(\w+), (\w+), 0, "
                    r"static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
                    re.DOTALL)
HOST_LAUNCH = r"host_launch(\2, \3, [&] { \1(\4); });"


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("k1_host")
    src = (_build.CSRC / "motor_steps.cu").read_text()
    host_src, n = LAUNCH.subn(HOST_LAUNCH, src)
    assert n == 2
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k1.cpp").write_text(host_src)
    lib = d / "libk1_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    "-shared", "-fPIC", "-I", str(d), "-o", str(lib),
                    str(d / "k1.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _inputs(model, B, mode, seed):
    rng = np.random.default_rng(seed)
    n = model.ndof
    q = rng.uniform(model.q_lo, model.q_hi, (B, n)).astype(np.float32)
    qd = rng.normal(0, 0.5, (B, n)).astype(np.float32)
    tgt = ((q + rng.normal(0, 0.05, (B, n))) if mode == 0
           else rng.normal(0, 1.0, (B, n))).astype(np.float32)
    return q, qd, tgt


def _ptr(a):
    return None if a is None else a.ctypes.data


def _run(host_k1, model, q, qd, tgt, *, mode, lanes, n_substeps, warm,
         tau=None, warm_in=None, want_set=False, seed=False):
    """One launch of the host build: (q, qd, sat, sign), each None where
    the launch writes no such output."""
    fn = CD._bind(host_k1)
    chain = CD.chain_id(model)
    assert host_k1.motor_steps_model_floats(chain) == CD.pack_model(model).size
    B = q.shape[0]
    q_out = None if seed else np.full_like(q, np.nan)
    qd_out = None if seed else np.full_like(q, np.nan)
    sat_out = sign_out = None
    if want_set or seed:
        sat_out = np.full(q.shape, 7, np.uint8)
        sign_out = np.full_like(q, np.nan)
    sat_in, sign_in = (None, None) if warm_in is None else (
        np.ascontiguousarray(warm_in[0], np.uint8),
        np.ascontiguousarray(warm_in[1], np.float32))
    table = CD.pack_model(model)
    err = fn(q.ctypes.data, qd.ctypes.data, tgt.ctypes.data,
             _ptr(q_out), _ptr(qd_out), B, table.ctypes.data,
             n_substeps, 1.0 / 500.0, mode, D.POSITION_GAIN, D.MOTOR_LCP_ITERS,
             D.MOTOR_LCP_WARM_ITERS, 0, None, lanes, int(warm), _ptr(tau),
             _ptr(sat_in), _ptr(sign_in), _ptr(sat_out), _ptr(sign_out),
             int(seed), chain)
    assert err == 0
    return q_out, qd_out, sat_out, sign_out


def _hold(host_k1, mode, B, lanes, n_substeps, base, warm=True):
    """Run the host build of K1 and the plain version on one seeded batch
    and hold the two within the tolerances."""
    model = make_panda_model(base_position=base)
    q, qd, tgt = _inputs(model, B, mode, 7 + mode)
    q_out, qd_out, _, _ = _run(host_k1, model, q, qd, tgt, mode=mode,
                               lanes=lanes, n_substeps=n_substeps, warm=warm)
    k1 = CD.make_cuda_motor_steps(model, n_substeps=n_substeps,
                                  dt=1.0 / 500.0, ctrl_mode=mode,
                                  warm_start=warm)
    pq, pqd = k1.plain(*map(torch.as_tensor, (q, qd, tgt)))
    np.testing.assert_allclose(q_out, pq.numpy(), atol=ATOL_Q)
    np.testing.assert_allclose(qd_out, pqd.numpy(), atol=ATOL_QD)


@pytest.mark.parametrize("lanes", [8, 1], ids=["lanes", "thread"])
@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
# 1: a lone env in a block of masked groups; 260: 17 blocks of 16 envs (3
# blocks of 128 for one env per thread), the last one ragged
@pytest.mark.parametrize("B", [1, 260])
def test_k1_source_matches_plain(host_k1, mode, B, lanes):
    _hold(host_k1, mode, B, lanes, 20, (-0.6, 0.0, 0.0))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("lanes", [8, 1], ids=["lanes", "thread"])
@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
@pytest.mark.parametrize("B", [1, 260])
def test_k1_one_substep_matches_plain(host_k1, mode, B, lanes, warm):
    """n_substeps=1, as the ReachAO collision step launches K1 once per
    substep (cold by default there), with ReachAO's base at the origin."""
    _hold(host_k1, mode, B, lanes, 1, (0.0, 0.0, 0.0), warm)


@pytest.mark.parametrize("lanes", [8, 1], ids=["lanes", "thread"])
def test_k1_cold_substeps_match_plain(host_k1, lanes):
    """Five cold substeps in one launch."""
    _hold(host_k1, 0, 260, lanes, 5, (0.0, 0.0, 0.0), warm=False)


def test_nvcc_runs_in_the_build_directory(tmp_path, monkeypatch):
    """A header in the caller's working directory must not shadow the
    toolkit's: nvcc runs with the build directory as its cwd."""
    caller = tmp_path / "caller"
    caller.mkdir()
    (caller / "cuda_runtime.h").write_text("#error shadowed\n")
    monkeypatch.chdir(caller)
    build = tmp_path / "build"
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    lib = _build.load(CD.KERNEL)
    (cmd, kw), = calls
    assert kw["cwd"] == build and build.is_dir()
    assert str(caller) not in " ".join(map(str, cmd))
    assert lib.startswith(str(build))


# ---------------------------------------------------------------------------
# one substep per launch: the seed, the carried active set, the contact torque

# sha256 (first 16 hex digits) of q_out + qd_out of the kernel before the
# contact torque and the carried set were added, built by this file's host
# recipe on x86-64 Linux, at B = 40 from _inputs(model, 40, mode, 11 + mode):
# (n_substeps, warm, mode) -> digest; both kernels gave the same bits
PARENT_DIGESTS = {(20, True, 0): "227f4215aa0b5f6e",
                  (20, True, 1): "ab500da824d3bcd8",
                  (1, False, 0): "3705cf8d4351297a",
                  (1, False, 1): "9a90f109d7fc40c8"}


@pytest.mark.parametrize("lanes", [8, 1], ids=["lanes", "thread"])
@pytest.mark.parametrize("key", sorted(PARENT_DIGESTS),
                         ids=lambda k: f"{k[0]}sub-{'warm' if k[1] else 'cold'}-m{k[2]}")
def test_k1_null_pointers_keep_their_bits(host_k1, key, lanes):
    """The Reach step's warm 20-substep launch and the cold collision
    step's one-substep launch, with null pointers for the contact torque
    and the set: the outputs of the kernel before these were added, bit
    for bit."""
    n_substeps, warm, mode = key
    base = (-0.6, 0.0, 0.0) if n_substeps == 20 else (0.0, 0.0, 0.0)
    model = make_panda_model(base_position=base)
    q, qd, tgt = _inputs(model, 40, mode, 11 + mode)
    q_out, qd_out, _, _ = _run(host_k1, model, q, qd, tgt, mode=mode,
                               lanes=lanes, n_substeps=n_substeps, warm=warm)
    digest = hashlib.sha256(q_out.tobytes() + qd_out.tobytes()).hexdigest()
    assert digest[:16] == PARENT_DIGESTS[key]


@pytest.mark.parametrize("lanes", [8, 1], ids=["lanes", "thread"])
@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
# 40: 3 blocks of 16 envs, the last ragged (1 block of 128 per thread)
@pytest.mark.parametrize("B", [1, 40])
def test_k1_chained_warm_substeps_equal_one_launch(host_k1, mode, B, lanes):
    """A seed launch and 20 warm one-substep launches, each carrying the set
    of the one before, with tau_ext = 0, equal one warm 20-substep launch
    bit for bit; the seed's set is the plain seed's."""
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    q, qd, tgt = _inputs(model, B, mode, 21 + mode)
    kw = dict(mode=mode, lanes=lanes)
    q20, qd20, _, _ = _run(host_k1, model, q, qd, tgt, n_substeps=20,
                           warm=True, **kw)
    _, _, sat, sign = _run(host_k1, model, q, qd, tgt, n_substeps=1,
                           warm=True, seed=True, **kw)
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=1.0 / 500.0,
                                  ctrl_mode=mode, warm_start=True)
    psat, psign = k1.plain_seed(*map(torch.as_tensor, (q, qd, tgt)))
    np.testing.assert_array_equal(sat.astype(bool), psat.numpy())
    np.testing.assert_array_equal(sign, psign.numpy())
    zero = np.zeros_like(q)
    qc, qdc = q, qd
    for _ in range(20):
        qc, qdc, sat, sign = _run(host_k1, model, qc, qdc, tgt, n_substeps=1,
                                  warm=True, tau=zero, warm_in=(sat, sign),
                                  want_set=True, **kw)
    np.testing.assert_array_equal(qc, q20)
    np.testing.assert_array_equal(qdc, qd20)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("lanes", [8, 1], ids=["lanes", "thread"])
@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
def test_k1_tau_ext_substep_matches_plain(host_k1, mode, lanes, warm):
    """One substep with a random contact torque, warm from a random set (or
    cold), against the plain motor_substep: q and qd within 2e-5 and 2e-3,
    the returned set equal."""
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    B = 40
    q, qd, tgt = _inputs(model, B, mode, 31 + mode)
    rng = np.random.default_rng(41 + mode)
    tau = rng.normal(0, 20.0, (B, 7)).astype(np.float32)
    warm_in = None
    if warm:
        warm_in = (rng.random((B, 7)) < 0.3,
                   np.where(rng.random((B, 7)) < 0.5, -1.0, 1.0)
                   .astype(np.float32))
    qk, qdk, sat, sign = _run(host_k1, model, q, qd, tgt, mode=mode,
                              lanes=lanes, n_substeps=1, warm=warm, tau=tau,
                              warm_in=warm_in, want_set=warm)
    k1 = CD.make_cuda_motor_steps(model, n_substeps=1, dt=1.0 / 500.0,
                                  ctrl_mode=mode, warm_start=False)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    pq, pqd, pwarm = k1.plain_substep(
        t(q), t(qd), t(tgt), t(tau),
        None if warm_in is None else tuple(map(t, warm_in)))
    np.testing.assert_allclose(qk, pq.numpy(), atol=ATOL_Q)
    np.testing.assert_allclose(qdk, pqd.numpy(), atol=ATOL_QD)
    # the torque moves the result: not the substep without it
    q0, qd0, _, _ = _run(host_k1, model, q, qd, tgt, mode=mode, lanes=lanes,
                         n_substeps=1, warm=warm, warm_in=warm_in)
    assert np.abs(qd0 - qdk).max() > 10 * ATOL_QD
    if warm:
        np.testing.assert_array_equal(sat.astype(bool), pwarm[0].numpy())
        np.testing.assert_array_equal(sign, pwarm[1].numpy())

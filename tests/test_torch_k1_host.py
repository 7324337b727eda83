"""Kernel K1's CUDA source, compiled as host C++, against its plain version.

There is no CUDA compiler or card here, so ``motor_steps.cu`` is compiled
with the host C++ compiler: a stub header turns the CUDA qualifiers into
plain C++ and the launch into a loop that runs the kernel body once per
(block, thread).  This holds the kernel's arithmetic (RNEA, CRBA, Cholesky,
the active-set LCP, the warm start, the ragged last block) against
ops/scalarized.py on the CPU, at the tests/test_dynamics.py:295-296
tolerances.  It says nothing about how the card compiles or runs it: that
is chip_smoke.py's and tests/test_torch_cuda.py's work.
"""
import ctypes
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
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct Dim3Stub { int x; };
static Dim3Stub blockIdx, blockDim, threadIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
static const int cudaSuccess = 0;
inline int cudaGetLastError() { return 0; }
inline int cudaSetDevice(int) { return 0; }
"""
LAUNCH = ("motor_steps_kernel<<<blocks, threads, 0, "
          "static_cast<cudaStream_t>(stream)>>>(")
HOST_LOOP = ("for (int bb = 0; bb < blocks; ++bb) "
             "for (int tt = 0; tt < threads; ++tt) "
             "blockIdx.x = bb, threadIdx.x = tt, blockDim.x = threads, "
             "motor_steps_kernel(")


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("k1_host")
    src = (_build.CSRC / "motor_steps.cu").read_text()
    assert src.count(LAUNCH) == 1
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k1.cpp").write_text(src.replace(LAUNCH, HOST_LOOP))
    lib = d / "libk1_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(d), "-o", str(lib), str(d / "k1.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
def test_k1_source_matches_plain(host_k1, mode):
    model = make_panda_model(base_position=(-0.6, 0.0, 0.0))
    fn = CD._bind(host_k1)
    assert host_k1.motor_steps_model_floats() == CD.pack_model(model).size
    B = 260  # three blocks, the last one ragged
    rng = np.random.default_rng(7 + mode)
    q = rng.uniform(model.q_lo, model.q_hi, (B, 7)).astype(np.float32)
    qd = rng.normal(0, 0.5, (B, 7)).astype(np.float32)
    tgt = ((q + rng.normal(0, 0.05, (B, 7))) if mode == 0
           else rng.normal(0, 1.0, (B, 7))).astype(np.float32)
    q_out = np.full_like(q, np.nan)
    qd_out = np.full_like(q, np.nan)
    table = CD.pack_model(model)
    err = fn(q.ctypes.data, qd.ctypes.data, tgt.ctypes.data,
             q_out.ctypes.data, qd_out.ctypes.data, B, table.ctypes.data,
             20, 1.0 / 500.0, mode, D.POSITION_GAIN, D.MOTOR_LCP_ITERS,
             D.MOTOR_LCP_WARM_ITERS, 0, None)
    assert err == 0
    k1 = CD.make_cuda_motor_steps(model, n_substeps=20, dt=1.0 / 500.0,
                                  ctrl_mode=mode)
    pq, pqd = k1.plain(*map(torch.as_tensor, (q, qd, tgt)))
    np.testing.assert_allclose(q_out, pq.numpy(), atol=ATOL_Q)
    np.testing.assert_allclose(qd_out, pqd.numpy(), atol=ATOL_QD)

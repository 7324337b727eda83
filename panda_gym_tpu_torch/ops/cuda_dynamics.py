"""Kernel K1: the batched substepped motor dynamics, hand-written in CUDA.

Replaces the TPU kernel ``panda_gym_tpu/ops/pallas_dynamics.py::
make_pallas_motor_steps`` (kernel ``:45-77``, ``pl.pallas_call`` ``:79-105``).
The kernel is ``csrc/motor_steps.cu``, built by ``ops/_build.py`` with nvcc
for sm_90a and bound with ctypes; its plain version is
``ops/scalarized.py::make_batched_motor_steps``.

What bounds it on the H100: per env it moves 140 bytes (q, qd, target read,
q, qd written) and does about 82k fp32 operations per policy step, so the
work is bound by operations (67 TFLOP/s fp32 outside the tensor cores), not
by bytes; and those operations are one long dependent chain per env.  The
design keeps the chain in registers: one env per thread, the cold pre-solve
and every substep run without touching device memory, the model tables sit
in the constant bank.  At B = 4096 that is 32 blocks of 128 threads on 132
SMs, so the card is underfilled; spreading one env over several threads is
work for a later change.

Same contract as make_batched_motor_steps: (B, ndof) in, (B, ndof) out.  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  Like the TPU kernel, K1 always warm-starts the motor LCP and
ignores PANDA_LCP_WARM, which the plain version honours.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from panda_gym_tpu_torch.models.chain import ChainModel, JOINT_REVOLUTE
from panda_gym_tpu_torch.ops import _build
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import scalarized as S

NDOF = 7
KERNEL = "motor_steps"


def pack_model(model: ChainModel) -> np.ndarray:
    """The model tables in the order of ``struct Model`` in motor_steps.cu."""
    parts = [model.X_R, model.X_p, model.axis, model.mass, model.com,
             model.inertia, model.q_lo, model.q_hi, model.effort,
             model.vel_limit]
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for a in parts]))


def _bind(lib: ctypes.CDLL):
    fn = lib.motor_steps_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.motor_steps_model_floats.restype = ctypes.c_int
    return fn


class CudaMotorSteps:
    """K1 wrapper: ``(q, qd, target) -> (q, qd)`` after ``n_substeps``.

    ``launches`` counts kernel launches, and nothing else."""

    def __init__(self, model: ChainModel, *, n_substeps: int, dt: float,
                 ctrl_mode: int):
        if (model.ndof != NDOF
                or model.parent_tuple != tuple(range(-1, NDOF - 1))
                or any(t != JOINT_REVOLUTE for t in model.jtype_tuple)):
            raise NotImplementedError(
                "K1 covers 7-dof serial revolute chains (the welded Panda); "
                "other models wait for their own kernel")
        self.n_substeps = int(n_substeps)
        self.dt = float(dt)
        self.ctrl_mode = int(ctrl_mode)
        self.plain = S.make_batched_motor_steps(
            model, n_substeps=n_substeps, dt=dt, ctrl_mode=ctrl_mode)
        self._table = pack_model(model)
        self._fn = None
        self.launches = 0

    def __call__(self, q, qd, target):
        if q.device.type == "cpu":
            return self.plain(q, qd, target)
        if q.device.type != "cuda":
            raise ValueError(f"K1 runs on cuda or cpu tensors, got {q.device}")
        for name, t in (("q", q), ("qd", qd), ("target", target)):
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on {q.device}")
            if t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {t.dtype}")
            if t.dim() != 2 or t.shape[1] != NDOF or t.shape != q.shape:
                raise ValueError(
                    f"{name} must be (B, {NDOF}) like q, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if self._fn is None:
            lib = _build.load(KERNEL)
            fn = _bind(lib)
            if lib.motor_steps_model_floats() != self._table.size:
                raise RuntimeError("model table does not match motor_steps.cu")
            self._fn = fn
        q_out = torch.empty_like(q)
        qd_out = torch.empty_like(qd)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = self._fn(
            q.data_ptr(), qd.data_ptr(), target.data_ptr(),
            q_out.data_ptr(), qd_out.data_ptr(), q.shape[0],
            self._table.ctypes.data, self.n_substeps, self.dt,
            self.ctrl_mode, D.POSITION_GAIN, D.MOTOR_LCP_ITERS,
            D.MOTOR_LCP_WARM_ITERS, q.device.index, stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {err}")
        self.launches += 1
        return q_out, qd_out


def make_cuda_motor_steps(model: ChainModel, *, n_substeps: int, dt: float,
                          ctrl_mode: int) -> CudaMotorSteps:
    """Same contract as scalarized.make_batched_motor_steps."""
    return CudaMotorSteps(model, n_substeps=n_substeps, dt=dt,
                          ctrl_mode=ctrl_mode)

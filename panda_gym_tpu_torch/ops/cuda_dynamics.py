"""Kernel K1: the batched substepped motor dynamics, hand-written in CUDA.

Replaces the TPU kernel ``panda_gym_tpu/ops/pallas_dynamics.py::
make_pallas_motor_steps`` (kernel ``:45-77``, ``pl.pallas_call`` ``:79-105``).
The kernel is ``csrc/motor_steps.cu``, built by ``ops/_build.py`` with nvcc
for sm_90a and bound with ctypes; its plain version is
``ops/scalarized.py::make_batched_motor_steps``.

It is built for three chains (``CHAINS``): the welded 7-dof Panda, MyCobot's
6 serial revolute dofs, and the 9-dof Panda whose prismatic fingers both
hang from link 6.  Any other chain raises NotImplementedError.

What bounds it on the H100: per env of the welded Panda it moves 140 bytes
(q, qd, target read, q, qd written) and does about 82k fp32 operations per
policy step, so the work is bound by operations (67 TFLOP/s fp32 outside
the tensor cores), not by bytes; and those operations form one long chain
per env.  Two kernels of one source do it for the welded Panda, and the
wrapper picks one from B and the card:

- up to one wave of its grid (every block resident at once: 132 SMs x 2
  blocks x 16 envs = 4,224 envs on the H100), the lane-group kernel, which
  spreads each env over a group of 8 lanes, so that the trainer's and the
  env step's batches fill the card (lane d owns dof d, lane 7 is spare; 16
  envs per 128-thread block, so B = 4096 is 256 blocks on the 132 SMs and
  the trainer's B = 512 is 32);
- past it, the one-env-per-thread kernel: the card is full there, time
  follows the instructions issued per env, and the lane groups issue about
  4x as many (bench.py's B = 65536: ~0.42 ms against ~2.2 ms on the H100).

MyCobot and the 9-dof Panda run the one-env-per-thread kernel at every B:
the lane groups own one dof per lane, 8 lanes, which cannot hold 9.

In the lane-group kernel the joint frames, the links' own RNEA
forces, the CRBA columns and the rows of the LCP's matrix-vector products
are split by dof; the RNEA motion sweep by vector and the CRBA
composite-inertia sweep by 3x3 row, interleaved; the two Cholesky
factorizations of a warm substep run side by side on lanes 0-3 and 4-7;
the RNEA force sweep, the substitutions and the active-set update run alike
on every lane.  Every scalar keeps the plain version's order of operations.
The lanes exchange through shared memory behind ``__syncwarp()``;
constants that differ by lane are picked into registers at kernel start,
and the lanes of a missing env in the ragged last block compute on a
clamped index with their stores masked.  The source note of
``csrc/motor_steps.cu`` has the details.  The choice is made from B and
what the card reports (its SM count and the occupancy query), never by an
option; ``launch`` runs a named kernel at any B, so that each can be held
against the plain version.

Same contract as make_batched_motor_steps: (B, ndof) in, (B, ndof) out,
and ``warm_start`` as there, but always given by the caller.  Warm (the TPU
kernel's only way; the Reach step) seeds the motor LCP's active set with
one cold solve and refines it warm in every substep; cold solves every
substep from scratch, as the reference's ReachAO collision step does (it
launches K1 once per substep).  A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version.

The steps that launch K1 once per substep carry the warm active set from
one launch to the next: ``seed`` runs the cold pre-solve alone and returns
the set, ``substep`` runs one substep, warm from a given set (which it
returns updated) or cold, with an optional contact torque ``tau_ext``
added to the free-velocity solve (the contact step's J^T f).  A set is
``(sat, sign)``, (B, ndof) bool and float32; its plain twins
(``plain_seed``, ``plain_substep``) run ``scalarized.motor_substep`` on
any device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from panda_gym_tpu_torch.models.chain import ChainModel
from panda_gym_tpu_torch.ops import _build
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import scalarized as S

KERNEL = "motor_steps"
# lanes per env of the two kernels: the lane-group kernel, one env per thread
LANES, THREAD = 8, 1
# the chains motor_steps.cu is built for, (ndof, parents, joint types) ->
# its chain id: the welded Panda, MyCobot, the Panda with prismatic fingers
CHAINS = {
    (7, (-1, 0, 1, 2, 3, 4, 5), (0,) * 7): 0,
    (6, (-1, 0, 1, 2, 3, 4), (0,) * 6): 1,
    (9, (-1, 0, 1, 2, 3, 4, 5, 6, 6), (0,) * 7 + (1, 1)): 2,
}
# the welded Panda's id, the one chain the lane-group kernel runs
PANDA = 0


def pack_model(model: ChainModel) -> np.ndarray:
    """The model tables in the order of ``struct Model`` in motor_steps.cu."""
    parts = [model.X_R, model.X_p, model.axis, model.mass, model.com,
             model.inertia, model.q_lo, model.q_hi, model.effort,
             model.vel_limit]
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for a in parts]))


def chain_id(model: ChainModel) -> int:
    """The chain id of ``model`` in motor_steps.cu; NotImplementedError
    for a chain K1 is not built for."""
    key = (model.ndof, tuple(model.parent_tuple), tuple(model.jtype_tuple))
    if key not in CHAINS:
        raise NotImplementedError(
            f"K1 is built for the welded 7-dof Panda, MyCobot's 6 dofs and the "
            f"9-dof Panda with prismatic fingers, not for the chain with "
            f"parents {key[1]} and joint types {key[2]}: a new chain waits for "
            f"its instantiation (ROADMAP queue 2)")
    return CHAINS[key]


def _bind(lib: ctypes.CDLL):
    fn = lib.motor_steps_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                  + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int])
    fn.restype = ctypes.c_int
    lib.motor_steps_model_floats.argtypes = [ctypes.c_int]
    lib.motor_steps_model_floats.restype = ctypes.c_int
    lib.motor_steps_occupancy.argtypes = ([ctypes.c_int] * 3
                                          + [ctypes.POINTER(ctypes.c_int)] * 4)
    lib.motor_steps_occupancy.restype = ctypes.c_int
    return fn


def occupancy(device_index: int = 0, lanes_per_env: int = LANES,
              chain: int = PANDA) -> dict:
    """What the card makes of one of K1's kernels (and chains): resident
    blocks per SM (the CUDA occupancy query), registers per thread, local
    memory per thread (spill and stack, bytes) and threads per block."""
    lib = _build.load(KERNEL)
    _bind(lib)
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.motor_steps_occupancy(device_index, lanes_per_env, chain,
                                    *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"K1 occupancy query failed: cudaError {err}")
    blocks, regs, local, threads = (v.value for v in vals)
    return {"blocks_per_sm": blocks, "regs": regs, "local_bytes": local,
            "threads_per_block": threads,
            "warps_per_sm": blocks * threads // 32}


_WAVE: dict = {}


def lanes_wave(device_index: int) -> int:
    """Envs that one wave of the lane-group kernel holds on the card: its
    resident blocks per SM times the SMs times 16 envs per block."""
    if device_index not in _WAVE:
        occ = occupancy(device_index, LANES)
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
        _WAVE[device_index] = (sms * occ["blocks_per_sm"]
                               * occ["threads_per_block"] // LANES)
    return _WAVE[device_index]


class CudaMotorSteps:
    """K1 wrapper: ``(q, qd, target) -> (q, qd)`` after ``n_substeps``.

    ``launches`` counts kernel launches, and nothing else;
    ``kernel_launches`` splits them by kernel (``LANES``, ``THREAD``).
    ``chain`` is the model's chain id (``CHAINS``)."""

    def __init__(self, model: ChainModel, *, n_substeps: int, dt: float,
                 ctrl_mode: int, warm_start: bool):
        self.chain = chain_id(model)
        self.ndof = model.ndof
        self.n_substeps = int(n_substeps)
        self.dt = float(dt)
        self.ctrl_mode = int(ctrl_mode)
        self.warm_start = bool(warm_start)
        self.plain = S.make_batched_motor_steps(
            model, n_substeps=n_substeps, dt=dt, ctrl_mode=ctrl_mode,
            warm_start=self.warm_start)
        self.mc = S.consts_from_model(model)
        self._table = pack_model(model)
        self._fn = None
        self.launches = 0
        self.kernel_launches = {LANES: 0, THREAD: 0}

    def pick(self, q) -> int:
        """The kernel the wrapper runs at q's batch: for the welded Panda
        ``LANES`` up to one wave of the lane-group kernel, ``THREAD`` past
        it; ``THREAD`` at every batch for the other chains."""
        if self.chain != PANDA:
            return THREAD
        past_wave = (q.device.type == "cuda"
                     and q.shape[0] > lanes_wave(q.device.index))
        return THREAD if past_wave else LANES

    def __call__(self, q, qd, target):
        return self.launch(q, qd, target, self.pick(q))

    # ------------------------------------------- one substep per launch
    def seed(self, q, qd, target, lanes_per_env=None):
        """The warm active set of the cold pre-solve on (q, qd, target):
        ``(sat, sign)``.  A CPU tensor takes ``plain_seed``."""
        if q.device.type == "cpu":
            return self.plain_seed(q, qd, target)
        sat = torch.empty(q.shape, dtype=torch.bool, device=q.device)
        sign = torch.empty_like(q)
        self._launch(q, qd, target, lanes_per_env or self.pick(q), 1, False,
                     warm_out=(sat, sign), seed=True)
        return sat, sign

    def substep(self, q, qd, target, tau_ext=None, warm=None,
                lanes_per_env=None):
        """One substep: warm from ``warm = (sat, sign)`` or cold when it is
        None, with the contact torque ``tau_ext`` (B, ndof) when given.
        Returns (q, qd, the set after it, or None when cold).  A CPU tensor
        takes ``plain_substep``."""
        if q.device.type == "cpu":
            return self.plain_substep(q, qd, target, tau_ext, warm)
        warm_out = None
        if warm is not None:
            warm_out = (torch.empty_like(warm[0]), torch.empty_like(warm[1]))
        q, qd = self._launch(q, qd, target, lanes_per_env or self.pick(q), 1,
                             warm is not None, tau_ext=tau_ext, warm_in=warm,
                             warm_out=warm_out)
        return q, qd, warm_out

    def _cols(self, *ts):
        return [[t[:, d] for d in range(self.ndof)] for t in ts]

    def plain_seed(self, q, qd, target):
        """``seed``'s plain version, on any device."""
        _, _, (sat, sign) = S.motor_substep(
            self.mc, *self._cols(q, qd, target), self.dt, self.ctrl_mode,
            return_warm=True)
        return torch.stack(sat, -1), torch.stack(sign, -1)

    def plain_substep(self, q, qd, target, tau_ext=None, warm=None):
        """``substep``'s plain version, on any device."""
        q_, qd_, tgt_ = self._cols(q, qd, target)
        tau = None if tau_ext is None else self._cols(tau_ext)[0]
        if warm is None:
            q2, qd2 = S.motor_substep(self.mc, q_, qd_, tgt_, self.dt,
                                      self.ctrl_mode, tau_ext=tau)
            return torch.stack(q2, -1), torch.stack(qd2, -1), None
        q2, qd2, (sat, sign) = S.motor_substep(
            self.mc, q_, qd_, tgt_, self.dt, self.ctrl_mode, tau_ext=tau,
            warm=tuple(self._cols(*warm)))
        return (torch.stack(q2, -1), torch.stack(qd2, -1),
                (torch.stack(sat, -1), torch.stack(sign, -1)))

    def launch(self, q, qd, target, lanes_per_env):
        """Run the kernel with ``lanes_per_env`` (``LANES`` or ``THREAD``)
        whatever B is; a CPU tensor takes the plain version."""
        if q.device.type == "cpu":
            if lanes_per_env not in (LANES, THREAD):
                raise ValueError(f"lanes_per_env is {LANES} or {THREAD}, "
                                 f"got {lanes_per_env}")
            return self.plain(q, qd, target)
        return self._launch(q, qd, target, lanes_per_env, self.n_substeps,
                            self.warm_start)

    def _launch(self, q, qd, target, lanes_per_env, n_substeps, warm,
                tau_ext=None, warm_in=None, warm_out=None, seed=False):
        if lanes_per_env not in (LANES, THREAD):
            raise ValueError(f"lanes_per_env is {LANES} or {THREAD}, "
                             f"got {lanes_per_env}")
        if lanes_per_env == LANES and self.chain != PANDA:
            raise ValueError("the lane-group kernel runs the welded Panda "
                             "only")
        if q.device.type != "cuda":
            raise ValueError(f"K1 runs on cuda or cpu tensors, got {q.device}")
        named = [("q", q, torch.float32), ("qd", qd, torch.float32),
                 ("target", target, torch.float32)]
        if tau_ext is not None:
            named.append(("tau_ext", tau_ext, torch.float32))
        for tag, pair in (("in", warm_in), ("out", warm_out)):
            if pair is not None:
                named += [(f"sat_{tag}", pair[0], torch.bool),
                          (f"sign_{tag}", pair[1], torch.float32)]
        for name, t, dtype in named:
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on {q.device}")
            if t.dtype != dtype:
                raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
            if t.dim() != 2 or t.shape[1] != self.ndof or t.shape != q.shape:
                raise ValueError(f"{name} must be (B, {self.ndof}) like q, "
                                 f"got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if self._fn is None:
            lib = _build.load(KERNEL)
            fn = _bind(lib)
            if lib.motor_steps_model_floats(self.chain) != self._table.size:
                raise RuntimeError("model table does not match motor_steps.cu")
            self._fn = fn
        q_out = None if seed else torch.empty_like(q)
        qd_out = None if seed else torch.empty_like(qd)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        w_in = warm_in or (None, None)
        w_out = warm_out or (None, None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = self._fn(
            q.data_ptr(), qd.data_ptr(), target.data_ptr(),
            ptr(q_out), ptr(qd_out), q.shape[0],
            self._table.ctypes.data, n_substeps, self.dt,
            self.ctrl_mode, D.POSITION_GAIN, D.MOTOR_LCP_ITERS,
            D.MOTOR_LCP_WARM_ITERS, q.device.index, stream, lanes_per_env,
            int(warm), ptr(tau_ext), ptr(w_in[0]), ptr(w_in[1]),
            ptr(w_out[0]), ptr(w_out[1]), int(seed), self.chain)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {err}")
        self.launches += 1
        self.kernel_launches[lanes_per_env] += 1
        return q_out, qd_out


def make_cuda_motor_steps(model: ChainModel, *, n_substeps: int, dt: float,
                          ctrl_mode: int, warm_start: bool
                          ) -> CudaMotorSteps:
    """Same contract as scalarized.make_batched_motor_steps."""
    return CudaMotorSteps(model, n_substeps=n_substeps, dt=dt,
                          ctrl_mode=ctrl_mode, warm_start=warm_start)

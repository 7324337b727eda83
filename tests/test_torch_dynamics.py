"""Port parity: the plain version of kernel K1 (ops/scalarized.py) against
panda_gym_tpu.ops.scalarized, and the K1 wrapper's CPU behaviour.

Inputs are drawn with numpy from a seed, as tests/test_dynamics.py draws
them for the Pallas kernel, and handed to both sides.  Tolerances are those
of tests/test_dynamics.py:295-296: q atol 2e-5, qd atol 2e-3.  The JAX
side runs eagerly (``jax.disable_jit``): a few seconds per case, where
compiling each configuration would take tens of seconds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.models.panda import make_panda_model as jax_make_panda
from panda_gym_tpu.ops import dynamics as JD
from panda_gym_tpu.ops import scalarized as JS

from panda_gym_tpu_torch.models.panda import make_panda_model as torch_make_panda
from panda_gym_tpu_torch.ops import _build
from panda_gym_tpu_torch.ops import cuda_dynamics as CD
from panda_gym_tpu_torch.ops import dynamics as TD
from panda_gym_tpu_torch.ops import scalarized as TS

DT = 1.0 / 500.0
B = 24            # not a multiple of the kernel's 128-thread block
N_SUB = 5
ATOL_Q, ATOL_QD = 2e-5, 2e-3
MODES = [TS.CTRL_POSITION, TS.CTRL_VELOCITY]


@pytest.fixture(scope="module")
def models():
    return jax_make_panda(), torch_make_panda()


@pytest.fixture(scope="module")
def inputs(models):
    jm, _ = models
    rng = np.random.default_rng(11)
    lo, hi = np.asarray(jm.q_lo), np.asarray(jm.q_hi)
    q = rng.uniform(lo, hi, (B, 7)).astype(np.float32)
    qd = rng.normal(0, 0.5, (B, 7)).astype(np.float32)
    tgt_pos = (q + rng.normal(0, 0.05, (B, 7))).astype(np.float32)
    tgt_vel = rng.normal(0, 1.0, (B, 7)).astype(np.float32)
    return q, qd, {TS.CTRL_POSITION: tgt_pos, TS.CTRL_VELOCITY: tgt_vel}


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _cols(x):
    return [x[:, d] for d in range(x.shape[1])]


def test_lcp_knobs_match_jax():
    assert TD.MOTOR_LCP_ITERS == JD.MOTOR_LCP_ITERS
    assert TD.MOTOR_LCP_WARM_ITERS == JD.MOTOR_LCP_WARM_ITERS
    assert TD.LCP_WARM_START == JD.LCP_WARM_START
    assert TD.lcp_warm_default(True) == JD.lcp_warm_default(True)
    assert (TD.CTRL_POSITION, TD.CTRL_VELOCITY) == (JD.CTRL_POSITION,
                                                    JD.CTRL_VELOCITY)
    assert TD.POSITION_GAIN == JD.POSITION_GAIN


def test_rnea_and_crba_match_jax(models, inputs):
    jm, tm = models
    q, qd, _ = inputs
    jmc, tmc = JS.consts_from_model(jm), TS.consts_from_model(tm)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    jb = JS.rnea(jmc, _cols(jq), _cols(jqd), [0.0] * 7)
    jM = JS.crba(jmc, _cols(jq))
    tq, tqd = _t(q, qd)
    tb = TS.rnea(tmc, _cols(tq), _cols(tqd), [0.0] * 7)
    tM = TS.crba(tmc, _cols(tq))
    for d in range(7):
        np.testing.assert_allclose(np.asarray(tb[d]), np.asarray(jb[d]),
                                   rtol=1e-5, atol=1e-4)
        for e in range(7):
            np.testing.assert_allclose(np.asarray(tM[d][e]) + 0 * q[:, 0],
                                       np.asarray(jM[d][e]) + 0 * q[:, 0],
                                       rtol=1e-5, atol=1e-6)


def test_cholesky_solve_matches_numpy():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(16, 7, 7))
    A = A @ A.transpose(0, 2, 1) + 7 * np.eye(7)
    b = rng.normal(size=(16, 7))
    M = [[torch.as_tensor(A[:, i, j], dtype=torch.float64) for j in range(7)]
         for i in range(7)]
    x = TS.cholesky_solve(M, [torch.as_tensor(b[:, i], dtype=torch.float64)
                              for i in range(7)])
    np.testing.assert_allclose(torch.stack(x, -1).numpy(),
                               np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-10)


@pytest.mark.parametrize("mode", MODES, ids=["position", "velocity"])
@pytest.mark.parametrize("cold", [True, False], ids=["cold", "warm"])
def test_motor_substep_matches_jax(models, inputs, mode, cold):
    jm, tm = models
    q, qd, tgts = inputs
    tgt = tgts[mode]
    jmc, tmc = JS.consts_from_model(jm), TS.consts_from_model(tm)
    rng = np.random.default_rng(2)
    sat = rng.uniform(size=(B, 7)) < 0.3
    sign = np.where(rng.uniform(size=(B, 7)) < 0.5, 1.0, -1.0).astype(np.float32)

    def jax_fn(q, qd, tgt, sat, sign):
        warm = None if cold else (tuple(_cols(sat)), tuple(_cols(sign)))
        return JS.motor_substep(jmc, _cols(q), _cols(qd), _cols(tgt), DT,
                                mode, warm=warm, return_warm=True)

    jq, jqd, (jsat, jsign) = jax_fn(*map(jnp.asarray, (q, qd, tgt, sat, sign)))
    tq, tqd, ttgt, tsat, tsign = _t(q, qd, tgt, sat, sign)
    warm = None if cold else (tuple(_cols(tsat)), tuple(_cols(tsign)))
    oq, oqd, (osat, osign) = TS.motor_substep(
        tmc, _cols(tq), _cols(tqd), _cols(ttgt), DT, mode, warm=warm,
        return_warm=True)
    np.testing.assert_allclose(torch.stack(oq, -1).numpy(),
                               np.stack(jq, -1), atol=ATOL_Q)
    np.testing.assert_allclose(torch.stack(oqd, -1).numpy(),
                               np.stack(jqd, -1), atol=ATOL_QD)
    np.testing.assert_array_equal(torch.stack(osat, -1).numpy(),
                                  np.stack(jsat, -1))
    np.testing.assert_array_equal(torch.stack(osign, -1).numpy(),
                                  np.stack(jsign, -1))


@pytest.mark.parametrize("mode", MODES, ids=["position", "velocity"])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_batched_motor_steps_match_jax(models, inputs, mode, warm):
    jm, tm = models
    q, qd, tgts = inputs
    tgt = tgts[mode]
    f_j = JS.make_batched_motor_steps(
        jm, n_substeps=N_SUB, dt=DT, ctrl_mode=mode, warm_start=warm)
    f_t = TS.make_batched_motor_steps(tm, n_substeps=N_SUB, dt=DT,
                                      ctrl_mode=mode, warm_start=warm)
    with jax.disable_jit():
        jq, jqd = f_j(*map(jnp.asarray, (q, qd, tgt)))
    tq, tqd = f_t(*_t(q, qd, tgt))
    assert tq.shape == (B, 7) and tq.dtype == torch.float32
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_Q)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=ATOL_QD)


@pytest.mark.parametrize("mode", MODES, ids=["position", "velocity"])
def test_k1_wrapper_on_cpu_takes_plain_path(models, inputs, mode):
    _, tm = models
    q, qd, tgts = inputs
    k1 = CD.make_cuda_motor_steps(tm, n_substeps=N_SUB, dt=DT, ctrl_mode=mode,
                                  warm_start=True)
    plain = TS.make_batched_motor_steps(tm, n_substeps=N_SUB, dt=DT,
                                        ctrl_mode=mode)
    args = _t(q, qd, tgts[mode])
    kq, kqd = k1(*args)
    pq, pqd = plain(*args)
    assert k1.launches == 0
    assert torch.equal(kq, pq) and torch.equal(kqd, pqd)


def test_k1_wrapper_rejects_what_it_cannot_launch(models):
    _, tm = models
    k1 = CD.make_cuda_motor_steps(tm, n_substeps=1, dt=DT,
                                  ctrl_mode=TS.CTRL_POSITION, warm_start=True)
    meta = torch.empty(4, 7, device="meta")
    with pytest.raises(ValueError):
        k1(meta, meta, meta)
    assert k1.launches == 0
    # a chain K1 is not built for: the 9-dof Panda with revolute fingers
    revolute_fingers = dataclasses.replace(
        torch_make_panda(gripper="prismatic"), jtype_tuple=(0,) * 9)
    with pytest.raises(NotImplementedError, match="queue 2"):
        CD.make_cuda_motor_steps(revolute_fingers, n_substeps=1, dt=DT,
                                 ctrl_mode=0, warm_start=True)


def test_pack_model_matches_kernel_layout(models):
    _, tm = models
    table = CD.pack_model(tm)
    assert table.dtype == np.float32 and table.size == 7 * 32
    np.testing.assert_array_equal(table[:63], tm.X_R.reshape(-1))
    np.testing.assert_array_equal(table[-7:], tm.vel_limit)
    # offset of effort: XR 63, Xp 21, axis 21, mass 7, com 21, inertia 63,
    # q_lo 7, q_hi 7
    np.testing.assert_array_equal(table[210:217], tm.effort)


def test_build_targets_hopper_and_needs_no_torch_headers():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-Xptxas -v" in flags
    src = (_build.CSRC / "motor_steps.cu").read_text()
    assert "torch/extension.h" not in src
    assert 'extern "C" int motor_steps_launch' in src


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


@pytest.mark.slow
def test_plain_matches_pallas_kernel_interpret(models, inputs):
    """The TPU kernel itself, in interpret mode on the CPU, against the
    port's plain version (as tests/test_dynamics.py:273 does for XLA)."""
    from panda_gym_tpu.ops.pallas_dynamics import make_pallas_motor_steps

    jm, tm = models
    q, qd, tgts = inputs
    f_p = make_pallas_motor_steps(jm, n_substeps=N_SUB, dt=DT,
                                  ctrl_mode=TS.CTRL_POSITION, interpret=True)
    f_t = TS.make_batched_motor_steps(tm, n_substeps=N_SUB, dt=DT,
                                      ctrl_mode=TS.CTRL_POSITION)
    jq, jqd = f_p(q, qd, tgts[TS.CTRL_POSITION])
    tq, tqd = f_t(*_t(q, qd, tgts[TS.CTRL_POSITION]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_Q)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=ATOL_QD)

"""Kernel K1 on the chains besides the welded Panda: MyCobot's 6 serial
revolute dofs and the 9-dof Panda whose prismatic fingers both hang from
link 6 (PickAndPlace, Stack, Flip).

The one-env-per-thread kernel of ``motor_steps.cu``, compiled as host C++
by test_torch_k1_host.py's recipe, is held against the port's plain version
(ops/scalarized.py) on seeded numpy inputs: 20 warm substeps, one cold
substep, and the contact step's launches, a seed and 20 chained one-substep
launches with a contact torque tau_ext, each carrying the active set of the
one before.  The port's plain batched motor steps are held against the JAX
package's batched twin (panda_gym_tpu/ops/scalarized.py, run eagerly) and
against its Pallas kernel in interpret mode.  Tolerances are
tests/test_dynamics.py:295-296's: q atol 2e-5, qd atol 2e-3.

MyCobot's efforts are the reference's zeros (mycobot.py:56): every impulse
cap is 0, every joint saturates, and the sign of the LCP residual, which
multiplies a cap of 0, is rounding noise; so its signs are compared only
where a cap is not 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_k1_host import _inputs, _run, host_k1  # noqa: F401

from panda_gym_tpu.models.mycobot import make_mycobot_model as jax_mycobot
from panda_gym_tpu.models.panda import make_panda_model as jax_panda
from panda_gym_tpu.ops import scalarized as JS

from panda_gym_tpu_torch.models.chain import build_chain
from panda_gym_tpu_torch.models.mycobot import make_mycobot_model
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import cuda_dynamics as CD
from panda_gym_tpu_torch.ops import scalarized as TS

ATOL_Q, ATOL_QD = 2e-5, 2e-3
DT = 1.0 / 500.0
BASE = (-0.6, 0.0, 0.0)
MODELS = {
    "mycobot": (lambda: make_mycobot_model(base_position=BASE),
                lambda: jax_mycobot(base_position=BASE)),
    "panda9": (lambda: make_panda_model(base_position=BASE,
                                        gripper="prismatic"),
               lambda: jax_panda(base_position=BASE, gripper="prismatic")),
}
CHAIN_IDS = {"mycobot": 1, "panda9": 2}


def _k1(model, n_substeps, mode, warm):
    return CD.make_cuda_motor_steps(model, n_substeps=n_substeps, dt=DT,
                                    ctrl_mode=mode, warm_start=warm)


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


def _signs_equal(model, sign, ref):
    """The LCP signs equal where the joint's impulse cap is not 0."""
    capped = np.asarray(model.effort) != 0
    np.testing.assert_array_equal(sign[:, capped], ref[:, capped])


def test_chain_ids_and_tables():
    for name, (make, _) in MODELS.items():
        model = make()
        k1 = _k1(model, 20, 0, True)
        assert k1.chain == CHAIN_IDS[name] == CD.chain_id(model)
        assert CD.pack_model(model).size == 32 * model.ndof
        # the lane groups hold 8 dofs of the welded Panda only
        assert k1.pick(torch.zeros(65536, model.ndof)) == CD.THREAD
        meta = torch.empty(4, model.ndof, device="meta")
        with pytest.raises(ValueError, match="lane-group"):
            k1.launch(meta, meta, meta, CD.LANES)
        assert k1.launches == 0


def test_other_chains_raise():
    """A chain K1 is not built for raises, naming ROADMAP queue 2: a 3-dof
    serial chain, and the 9-dof Panda with revolute fingers."""
    link = (1.0, (0.0, 0.0, 0.05), (0.01, 0.01, 0.01))
    joints = [(f"j{i}", "revolute", f"l{i}", f"l{i + 1}", (0.0, 0.0, 0.1),
               (0, 0, 0), (0, 0, 1), -2.0, 2.0, 10.0, 2.0) for i in range(3)]
    three = build_chain(joints, {f"l{i}": link for i in range(4)}, "l0")
    nine = make_panda_model(gripper="prismatic")
    revolute_fingers = dataclasses.replace(nine, jtype_tuple=(0,) * 9)
    for model in (three, revolute_fingers):
        with pytest.raises(NotImplementedError, match="queue 2"):
            _k1(model, 1, 0, True)


@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
# 130: two blocks of 128 threads, the last ragged
@pytest.mark.parametrize("B", [1, 130])
@pytest.mark.parametrize("chain", sorted(MODELS))
def test_k1_chain_matches_plain(host_k1, chain, B, mode):
    """20 warm substeps in one launch, as the MyCobotReach step runs K1."""
    model = MODELS[chain][0]()
    q, qd, tgt = _inputs(model, B, mode, 51 + mode)
    q_out, qd_out, _, _ = _run(host_k1, model, q, qd, tgt, mode=mode,
                               lanes=CD.THREAD, n_substeps=20, warm=True)
    pq, pqd = _k1(model, 20, mode, True).plain(*_t(q, qd, tgt))
    np.testing.assert_allclose(q_out, pq.numpy(), atol=ATOL_Q)
    np.testing.assert_allclose(qd_out, pqd.numpy(), atol=ATOL_QD)


@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
@pytest.mark.parametrize("chain", sorted(MODELS))
def test_k1_chain_one_cold_substep_matches_plain(host_k1, chain, mode):
    model = MODELS[chain][0]()
    q, qd, tgt = _inputs(model, 40, mode, 61 + mode)
    q_out, qd_out, _, _ = _run(host_k1, model, q, qd, tgt, mode=mode,
                               lanes=CD.THREAD, n_substeps=1, warm=False)
    pq, pqd = _k1(model, 1, mode, False).plain(*_t(q, qd, tgt))
    np.testing.assert_allclose(q_out, pq.numpy(), atol=ATOL_Q)
    np.testing.assert_allclose(qd_out, pqd.numpy(), atol=ATOL_QD)


@pytest.mark.parametrize("chain", sorted(MODELS))
def test_k1_chain_seed_and_tau_ext_substeps(host_k1, chain):
    """The contact step's launches: a seed, then 20 one-substep launches
    with a contact torque, each warm from the set of the one before.  The
    chain equals one 20-substep launch with that torque bit for bit; each
    substep's q and qd are within the tolerances of the plain chain's and
    its active set equals the plain chain's."""
    model = MODELS[chain][0]()
    B = 40
    q, qd, tgt = _inputs(model, B, 0, 71)
    tau = np.random.default_rng(72).normal(0, 5.0, q.shape).astype(np.float32)
    kw = dict(mode=0, lanes=CD.THREAD)
    q20, qd20, _, _ = _run(host_k1, model, q, qd, tgt, n_substeps=20,
                           warm=True, tau=tau, **kw)
    _, _, sat, sign = _run(host_k1, model, q, qd, tgt, n_substeps=1,
                           warm=True, seed=True, **kw)
    k1 = _k1(model, 1, 0, False)
    tq, tqd, ttgt, ttau = _t(q, qd, tgt, tau)
    psat, psign = k1.plain_seed(tq, tqd, ttgt)
    np.testing.assert_array_equal(sat.astype(bool), psat.numpy())
    _signs_equal(model, sign, psign.numpy())
    qc, qdc, pwarm = q, qd, (psat, psign)
    for i in range(20):
        qc, qdc, sat, sign = _run(host_k1, model, qc, qdc, tgt, n_substeps=1,
                                  warm=True, tau=tau, warm_in=(sat, sign),
                                  want_set=True, **kw)
        tq, tqd, pwarm = k1.plain_substep(tq, tqd, ttgt, ttau, pwarm)
        msg = f"{chain} substep {i}"
        np.testing.assert_allclose(qc, tq.numpy(), atol=ATOL_Q, err_msg=msg)
        np.testing.assert_allclose(qdc, tqd.numpy(), atol=ATOL_QD,
                                   err_msg=msg)
        np.testing.assert_array_equal(sat.astype(bool), pwarm[0].numpy(),
                                      err_msg=msg)
        _signs_equal(model, sign, pwarm[1].numpy())
    np.testing.assert_array_equal(qc, q20)
    np.testing.assert_array_equal(qdc, qd20)
    # the torque moves the result: not the chain without it
    q0, qd0, _, _ = _run(host_k1, model, q, qd, tgt, n_substeps=20,
                         warm=True, **kw)
    assert np.abs(qd0 - qd20).max() > 10 * ATOL_QD


def test_gripper_fingers_slide_and_branch():
    """The 9-dof Panda's plain dynamics: the two finger dofs are prismatic
    children of link 6, neither the other's ancestor, so their mass-matrix
    entry is an exact 0 (the float the fold keeps) and each finger's
    diagonal entry is the finger's mass."""
    model = make_panda_model(base_position=BASE, gripper="prismatic")
    mc = TS.consts_from_model(model)
    q, _, _ = _inputs(model, 4, 0, 81)
    M = TS.crba(mc, [torch.as_tensor(q[:, d]) for d in range(9)])
    assert M[7][8] == 0.0 and M[8][7] == 0.0
    for d in (7, 8):
        np.testing.assert_allclose(np.asarray(M[d][d]) + 0 * q[:, 0],
                                   float(model.mass[d]), rtol=1e-6)


@pytest.mark.parametrize("mode", [0, 1], ids=["position", "velocity"])
@pytest.mark.parametrize("chain", sorted(MODELS))
def test_plain_motor_steps_match_jax(chain, mode):
    """The port's plain batched motor steps against the JAX package's
    batched twin, run eagerly, 4 warm substeps."""
    make_t, make_j = MODELS[chain]
    tm, jm = make_t(), make_j()
    q, qd, tgt = _inputs(tm, 8, mode, 91 + mode)
    f_j = JS.make_batched_motor_steps(jm, n_substeps=4, dt=DT, ctrl_mode=mode,
                                      warm_start=True)
    with jax.disable_jit():
        jq, jqd = f_j(*map(jnp.asarray, (q, qd, tgt)))
    tq, tqd = TS.make_batched_motor_steps(tm, n_substeps=4, dt=DT,
                                          ctrl_mode=mode,
                                          warm_start=True)(*_t(q, qd, tgt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_Q)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=ATOL_QD)


def _pallas_case(chain):
    """The TPU kernel itself in interpret mode on the CPU, 2 substeps,
    against the port's plain version (as test_torch_dynamics.py does for
    the welded Panda)."""
    from panda_gym_tpu.ops.pallas_dynamics import make_pallas_motor_steps

    make_t, make_j = MODELS[chain]
    tm, jm = make_t(), make_j()
    q, qd, tgt = _inputs(tm, 8, 0, 101)
    f_p = make_pallas_motor_steps(jm, n_substeps=2, dt=DT, ctrl_mode=0,
                                  interpret=True)
    jq, jqd = f_p(q, qd, tgt)
    tq, tqd = TS.make_batched_motor_steps(tm, n_substeps=2, dt=DT,
                                          ctrl_mode=0,
                                          warm_start=True)(*_t(q, qd, tgt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_Q)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=ATOL_QD)


def test_plain_matches_pallas_kernel_interpret_mycobot():
    _pallas_case("mycobot")


# compiling the interpreted 9-dof kernel takes about 2 minutes on the CPU
@pytest.mark.slow
def test_plain_matches_pallas_kernel_interpret_panda9():
    _pallas_case("panda9")

"""Port parity: the per-env dynamics of panda_gym_tpu_torch/ops/dynamics.py
(batch leading, built on ops/scalarized.py) against panda_gym_tpu/ops/
dynamics.py under jax.vmap, on the three chains the tasks use: the welded
Panda, MyCobot and the 9-dof Panda with prismatic fingers.

Inputs come from numpy seeds.  Tolerances follow tests/test_dynamics.py:
q 2e-5 and qd 2e-3 for a motor substep (:295-296); RNEA torques and mass
matrix entries agree to float32 rounding of sums of ~50 N m terms (1e-4
and 1e-5 here).  JAX's LCP mode is switched by assigning
``dynamics.LCP_MODE`` and restoring it (its set_lcp_mode would drop every
compiled function of the worker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.models.mycobot import make_mycobot_model as jax_mycobot
from panda_gym_tpu.models.panda import make_panda_model as jax_panda
from panda_gym_tpu.ops import dynamics as JD

from panda_gym_tpu_torch.models.mycobot import make_mycobot_model
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import dynamics as TD

ATOL_Q, ATOL_QD = 2e-5, 2e-3
ATOL_TAU, ATOL_M = 1e-4, 1e-5
B = 6
DT = 1.0 / 500.0
GRAVITY = (0.3, -0.2, -9.0)

CHAINS = {
    "welded": (lambda: jax_panda(gripper="welded"),
               lambda: make_panda_model(gripper="welded")),
    "mycobot": (jax_mycobot, make_mycobot_model),
    "prismatic": (lambda: jax_panda(gripper="prismatic"),
                  lambda: make_panda_model(gripper="prismatic")),
}


@pytest.fixture(scope="module", params=sorted(CHAINS))
def chain(request):
    j, t = CHAINS[request.param]
    return request.param, j(), t()


@pytest.fixture
def lcp_mode():
    """Set both packages' LCP mode for one test and restore "exact"."""
    def set_mode(mode):
        JD.LCP_MODE = mode
        TD.set_lcp_mode(mode)
    yield set_mode
    JD.LCP_MODE = "exact"
    TD.set_lcp_mode("exact")


def _inputs(model, seed, mode=0):
    rng = np.random.default_rng(seed)
    n = model.ndof
    lo, hi = np.asarray(model.q_lo), np.asarray(model.q_hi)
    q = rng.uniform(lo, hi, (B, n)).astype(np.float32)
    qd = rng.normal(0, 0.5, (B, n)).astype(np.float32)
    tgt = ((q + rng.normal(0, 0.05, (B, n))) if mode == 0
           else rng.normal(0, 1.0, (B, n))).astype(np.float32)
    return q, qd, tgt, rng


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("gravity", [(0.0, 0.0, -9.81), GRAVITY],
                         ids=["default", "tilted"])
def test_rnea_bias_force_crba(chain, gravity):
    _, jm, tm = chain
    q, qd, _, rng = _inputs(jm, 1)
    qdd = rng.normal(0, 1.0, q.shape).astype(np.float32)
    j = jax.vmap(lambda a, b, c: JD.rnea(jm, a, b, c, gravity))(q, qd, qdd)
    t = TD.rnea(tm, *_t(q, qd, qdd), gravity=gravity)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_TAU)
    j = jax.vmap(lambda a, b: JD.bias_force(jm, a, b, gravity))(q, qd)
    t = TD.bias_force(tm, *_t(q, qd), gravity=gravity)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_TAU)
    j = jax.vmap(lambda a: JD.crba(jm, a))(q)
    t = TD.crba(tm, *_t(q))
    assert t.shape == (B, jm.ndof, jm.ndof)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_M)
    np.testing.assert_array_equal(t.numpy(), t.transpose(1, 2).numpy())


CASES = {
    "cold": dict(),
    "warm": dict(warm=True),
    "tau_ext": dict(tau=True),
    "effort": dict(effort=True),
    "gravity": dict(gravity=GRAVITY),
    "velocity": dict(mode=1),
    "all": dict(warm=True, tau=True, effort=True, gravity=GRAVITY),
}


def _substep_pair(jm, tm, case, seed):
    mode = case.get("mode", 0)
    q, qd, tgt, rng = _inputs(jm, seed, mode)
    n = jm.ndof
    kw_j, kw_t = {}, {}
    if "gravity" in case:
        kw_j["gravity"] = kw_t["gravity"] = case["gravity"]
    if case.get("tau"):
        tau = rng.normal(0, 10.0, (B, n)).astype(np.float32)
        kw_j["tau_ext"], kw_t["tau_ext"] = jnp.asarray(tau), _t(tau)[0]
    if case.get("effort"):
        eff = (np.asarray(jm.effort) * rng.uniform(0.2, 1.0, n)
               ).astype(np.float32)
        kw_j["effort"], kw_t["effort"] = jnp.asarray(eff), eff
    warm = None
    if case.get("warm"):
        sat = rng.random((B, n)) < 0.4
        sign = np.where(rng.random((B, n)) < 0.5, -1.0, 1.0).astype(
            np.float32)
        warm = (sat, sign)
    args = (q, qd, tgt)
    return args, warm, mode, kw_j, kw_t


def _run_both(jm, tm, case, seed):
    args, warm, mode, kw_j, kw_t = _substep_pair(jm, tm, case, seed)
    if warm is None:
        def jf(a, b, c, *rest):
            return JD.motor_substep(jm, a, b, c, DT, mode,
                                    **dict(zip(kw_j, rest)),
                                    return_warm=True)
        j = jax.vmap(jf, in_axes=(0, 0, 0) + tuple(
            0 if k == "tau_ext" else None for k in kw_j))(
            *args, *kw_j.values())
    else:
        def jf(a, b, c, s, g, *rest):
            return JD.motor_substep(jm, a, b, c, DT, mode,
                                    **dict(zip(kw_j, rest)), warm=(s, g))
        j = jax.vmap(jf, in_axes=(0,) * 5 + tuple(
            0 if k == "tau_ext" else None for k in kw_j))(
            *args, *warm, *kw_j.values())
    t = TD.motor_substep(tm, *_t(*args), DT, mode,
                         warm=None if warm is None else tuple(_t(*warm)),
                         return_warm=True, **kw_t)
    return j, t


@pytest.mark.parametrize("case", sorted(CASES))
def test_motor_substep_exact(chain, case):
    """The exact masked active-set solve: q, qd and the returned set."""
    _, jm, tm = chain
    (jq, jqd, (jsat, jsign)), (tq, tqd, (tsat, tsign)) = _run_both(
        jm, tm, CASES[case], 3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_Q)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=ATOL_QD)
    np.testing.assert_array_equal(tsat.numpy(), np.asarray(jsat))
    # MyCobot's motors exert no force (zero caps): the sign of its zero
    # impulse is the sign of a rounding residue, so only signs under a
    # non-zero cap are compared
    live = np.broadcast_to(np.asarray(jm.effort) > 0, tsign.shape)
    np.testing.assert_array_equal(tsign.numpy()[live],
                                  np.asarray(jsign)[live])


@pytest.mark.parametrize("case", ["cold", "effort", "all", "velocity"])
def test_motor_substep_pgs(chain, case, lcp_mode):
    """The "pgs" mode: 50 sweeps of sequential impulse."""
    _, jm, tm = chain
    lcp_mode("pgs")
    (jq, jqd, _), (tq, tqd, _) = _run_both(jm, tm, CASES[case], 5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_Q)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=ATOL_QD)


def test_motor_pgs_directly(chain):
    """_motor_pgs on one batch of (M, qd_free, v_des, cap) against JAX's
    under vmap, 10 and 50 sweeps."""
    _, jm, tm = chain
    q, qd, tgt, rng = _inputs(jm, 9)
    M = TD.crba(tm, *_t(q))
    qd_free = rng.normal(0, 1.0, q.shape).astype(np.float32)
    v_des = rng.normal(0, 2.0, q.shape).astype(np.float32)
    cap = (np.asarray(jm.effort) * DT).astype(np.float32)
    for iters in (10, 50):
        j = jax.vmap(lambda m, a, b: JD._motor_pgs(m, a, b, cap, iters))(
            jnp.asarray(M.numpy()), qd_free, v_des)
        t = TD._motor_pgs(M, *_t(qd_free, v_des), torch.as_tensor(cap),
                          iters)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_QD)


def test_set_lcp_mode(lcp_mode):
    TD.set_lcp_mode("pgs", pgs_iters=7)
    assert TD.LCP_MODE == "pgs" and TD.PGS_ITERS == 7
    with pytest.raises(ValueError):
        TD.set_lcp_mode("sor")
    TD.set_lcp_mode("exact", pgs_iters=50)
    assert TD.LCP_MODE == "exact" and TD.PGS_ITERS == 50

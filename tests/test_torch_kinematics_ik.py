"""Port parity: Jacobians, manipulability, the unrolled Cholesky solve and
the batched damped-least-squares IK of panda_gym_tpu_torch against
panda_gym_tpu's per-env functions under ``jax.vmap``, both on the CPU.

Inputs are drawn with numpy from a seed: q inside the joint limits,
reachable targets (the EE position of another random q) and unreachable
ones (1.2-1.6 m from the base, or below the floor), so that the IK's step
clip and joint-limit clamp engage.  Tolerances: Jacobian columns atol 1e-5,
manipulability rtol 1e-4 (JAX takes the determinant by LU, the port in
closed form), the solve 4 fp32 epsilons times each system's condition
number, relative to its solution's norm; the IK's final q atol 1e-4 rad and
its EE position atol 1e-4 m.

The IK runs 30 steps with a step clip and a joint-limit clamp, and JAX
solves each step by LU where the port uses the unrolled Cholesky.  So an
env may part by more than the tolerance, but only where the reference
itself does: its trajectory touched the clip or the clamp, and JAX's own
result moves by more than the tolerance when the target moves by 1e-6
(a perturbation test over 8 copies).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.models.panda import make_panda_model as jax_make_panda
from panda_gym_tpu.ops import kinematics as JK
from panda_gym_tpu.ops.linalg import cholesky_solve_unrolled as j_chol

from panda_gym_tpu_torch.models import panda_constants as pc
from panda_gym_tpu_torch.models.panda import EE_SITE
from panda_gym_tpu_torch.models.panda import make_panda_model as torch_make_panda
from panda_gym_tpu_torch.ops import kinematics as TK
from panda_gym_tpu_torch.ops.linalg import cholesky_solve_unrolled

B = 24
ATOL_J, RTOL_M, ATOL_Q, ATOL_X = 1e-5, 1e-4, 1e-4, 1e-4


@pytest.fixture(scope="module", params=["welded", "prismatic"])
def models(request):
    return (jax_make_panda(gripper=request.param),
            torch_make_panda(gripper=request.param))


def _q(model, rng, n=B):
    lo, hi = np.asarray(model.q_lo), np.asarray(model.q_hi)
    return rng.uniform(lo, hi, (n, model.ndof)).astype(np.float32)


def _jv(fn, *arrays):
    return [np.asarray(a) for a in
            jax.jit(jax.vmap(fn))(*[jnp.asarray(a) for a in arrays])]


@pytest.mark.parametrize("body", [EE_SITE, 3], ids=["ee", "link3"])
def test_point_jacobian_matches_jax(models, body):
    """The EE site's Jacobian, and one of a point on the 4th link (the
    columns of the dofs past it are zero)."""
    jm, tm = models
    rng = np.random.default_rng(0)
    q = _q(tm, rng)
    fk = TK.fk_world(tm, torch.as_tensor(q))
    if body == EE_SITE:
        x = TK.site_com_position(tm, fk, EE_SITE)
        dof = tm.site_body_tuple[EE_SITE]
    else:
        x = fk.p[:, body] + torch.as_tensor(rng.normal(0, 0.1, (B, 3)),
                                            dtype=torch.float32)
        dof = body
    J_v, J_w = TK.point_jacobian(tm, fk, x, dof)
    want_v, want_w = _jv(
        lambda qq, xx: JK.point_jacobian(jm, JK.fk_world(jm, qq), xx, dof),
        q, x.numpy())
    np.testing.assert_allclose(J_v.numpy(), want_v, atol=ATOL_J)
    np.testing.assert_allclose(J_w.numpy(), want_w, atol=ATOL_J)
    if body == 3:
        assert not J_v[..., 4:].any() and not J_w[..., 4:].any()
    ev, ew = TK.ee_jacobian(tm, EE_SITE, torch.as_tensor(q))
    if body == EE_SITE:
        np.testing.assert_array_equal(ev.numpy(), J_v.numpy())
        np.testing.assert_array_equal(ew.numpy(), J_w.numpy())


def test_manipulability_matches_jax(models):
    jm, tm = models
    q = _q(tm, np.random.default_rng(1), 64)
    q[0] = 0.0                              # the zero pose, near-singular
    got = TK.manipulability(tm, EE_SITE, torch.as_tensor(q)).numpy()
    (want,) = _jv(lambda qq: (JK.manipulability(jm, EE_SITE, qq),), q)
    np.testing.assert_allclose(got, want, rtol=RTOL_M, atol=1e-7)
    assert (got > 0).all() and got[0] < np.median(got)


@pytest.mark.parametrize("n", [3, 6])
def test_cholesky_solve_unrolled_matches_jax(n):
    rng = np.random.default_rng(n)
    A = rng.normal(0, 1, (B, n, 7)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 0.0025 * np.eye(n)).astype(np.float32)
    b = rng.normal(0, 1, (B, n)).astype(np.float32)
    got = cholesky_solve_unrolled(torch.as_tensor(M),
                                  torch.as_tensor(b)).numpy()
    (want,) = _jv(lambda m, v: (j_chol(m, v),), M, b)
    M64 = M.astype(np.float64)
    exact = np.linalg.solve(M64, b[..., None])[..., 0]
    tol = (4 * np.finfo(np.float32).eps * np.linalg.cond(M64)
           * np.linalg.norm(exact, axis=-1))
    for other in (want, exact):
        assert (np.linalg.norm(got - other, axis=-1) <= tol).all()


def _targets(tm, rng):
    """Half reachable (the EE of random poses), a quarter far out of reach,
    a quarter under the floor."""
    fk = TK.fk_world(tm, torch.as_tensor(_q(tm, rng)))
    pos = TK.site_com_position(tm, fk, EE_SITE).numpy()
    d = rng.normal(0, 1, (B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    far = d * rng.uniform(1.2, 1.6, (B, 1))
    pos[B // 2:3 * B // 4] = far[B // 2:3 * B // 4]
    pos[3 * B // 4:, 2] = -0.3
    quat = rng.normal(0, 1, (B, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return pos.astype(np.float32), quat.astype(np.float32)


def _boundary(tm, q_prev, q_next):
    """Per env, whether an IK step hit the step clip or the joint clamp."""
    dq = (q_next - q_prev)[:, :7].abs()
    lo, hi = torch.as_tensor(tm.q_lo[:7]), torch.as_tensor(tm.q_hi[:7])
    return ((dq == 0.5) | (q_next[:, :7] == lo)
            | (q_next[:, :7] == hi)).any(1)


@pytest.mark.parametrize("n_iters", [1, 30])
@pytest.mark.parametrize("with_quat", [False, True], ids=["pos", "pos+quat"])
def test_dls_ik_matches_jax(models, with_quat, n_iters):
    """The batched IK against jax.vmap(K.dls_ik) from the neutral pose, as
    ReachAO calls it (n_iters=30), and its first step alone."""
    jm, tm = models
    rng = np.random.default_rng(7)
    pos, quat = _targets(tm, rng)
    q0 = np.zeros(tm.ndof, np.float32)
    q0[:7] = pc.NEUTRAL_JOINT_VALUES[:7]
    quat_t = torch.as_tensor(quat) if with_quat else None
    ik = lambda p, q, n: TK.dls_ik(tm, EE_SITE, torch.as_tensor(p), quat_t,
                                   q0=q, n_iters=n)
    got = ik(pos, torch.as_tensor(q0), n_iters)
    assert got.shape == (B, tm.ndof)
    # the same steps one at a time: each is the loop's own step
    q = torch.as_tensor(q0).expand(B, -1)
    boundary = torch.zeros(B, dtype=torch.bool)
    for _ in range(n_iters):
        q_next = ik(pos, q, 1)
        boundary |= _boundary(tm, q, q_next)
        q = q_next
    assert torch.equal(q, got)

    jik = jax.jit(jax.vmap(lambda p, qt: JK.dls_ik(
        jm, EE_SITE, p, qt if with_quat else None, jnp.asarray(q0),
        n_iters=n_iters)))
    want = np.asarray(jik(pos, quat))
    x_got = TK.site_com_position(tm, TK.fk_world(tm, got), EE_SITE).numpy()
    (x_want,) = _jv(lambda qq: (JK.site_com_position(
        jm, JK.fk_world(jm, qq), EE_SITE),), want)
    parted = ((np.abs(got.numpy() - want) > ATOL_Q).any(1)
              | (np.abs(x_got - x_want) > ATOL_X).any(1))
    for b in np.flatnonzero(parted):
        spread = max(np.abs(np.asarray(jik(
            pos + np.random.default_rng(100 + k).normal(
                0, 1e-6, pos.shape).astype(np.float32), quat))[b]
            - want[b]).max() for k in range(8))
        assert boundary[b] and spread > ATOL_Q, (
            f"env {b} parts from JAX by "
            f"{np.abs(got.numpy() - want)[b].max():.2e} without a boundary "
            f"(clip or clamp touched: {bool(boundary[b])}, JAX spread under "
            f"a 1e-6 perturbation: {spread:.2e})")
    # the reachable targets of the position-only IK all agree
    if not with_quat:
        assert not parted[:B // 2].any()
    assert parted.sum() <= B // 4

    dq = got[:, :7] - torch.as_tensor(q0[:7])
    lo, hi = torch.as_tensor(tm.q_lo[:7]), torch.as_tensor(tm.q_hi[:7])
    if n_iters == 1:
        # the step clip engages on the unreachable targets
        assert (dq.abs().amax(1) == 0.5).any()
    else:
        # the clamp holds some unreachable targets at a joint limit, and the
        # reachable ones converge
        assert ((got[B // 2:, :7] == lo) | (got[B // 2:, :7] == hi)).any()
        if not with_quat:
            err = np.linalg.norm(x_got - pos, axis=-1)[:B // 2]
            assert np.median(err) < 1e-3
    assert ((got[:, :7] >= lo) & (got[:, :7] <= hi)).all()
    if tm.ndof > 7:
        np.testing.assert_array_equal(got[:, 7:].numpy(), 0.0)


def test_dls_ik_defaults_to_zero_start():
    tm = torch_make_panda()
    pos = torch.tensor([[0.5, 0.0, 0.4]])
    a = TK.dls_ik(tm, EE_SITE, pos, n_iters=3)
    b = TK.dls_ik(tm, EE_SITE, pos, q0=torch.zeros(tm.ndof), n_iters=3)
    assert torch.equal(a, b)

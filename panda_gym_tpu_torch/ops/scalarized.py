"""Batched motor dynamics in component form: the plain version of kernel K1
(port of panda_gym_tpu/ops/scalarized.py).

Every spatial quantity is a tuple of scalar components, each component a
(B,) tensor (or a Python float).  Model constants (joint frames, axes,
inertias, limits) enter as Python floats and take part in constant folding
while the trace runs: multiplications by 0 vanish, products of constants
are taken once in double precision.  That folding is what keeps the trace
short (about 82k elementwise operations per env per policy step, counted in
chip_smoke.py); the CUDA kernel in ``ops/csrc/motor_steps.cu`` computes the
same function and is held against this module.

Run eagerly on the card this is one kernel launch per operation, so it is a
reference, never a yardstick of speed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from panda_gym_tpu_torch.models.chain import ChainModel, JOINT_REVOLUTE
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops.dynamics import (CTRL_POSITION, CTRL_VELOCITY,
                                              POSITION_GAIN)

# ---------------------------------------------------------------------------
# scalar algebra with trace-time constant folding
# ---------------------------------------------------------------------------

def _is_c(x) -> bool:
    return isinstance(x, float)


def neg(a):
    return -a if _is_c(a) else -a


def add(a, b):
    if _is_c(a) and _is_c(b):
        return a + b
    if _is_c(a) and a == 0.0:
        return b
    if _is_c(b) and b == 0.0:
        return a
    return a + b


def sub(a, b):
    if _is_c(b) and b == 0.0:
        return a
    if _is_c(a) and a == 0.0:
        return neg(b)
    if _is_c(a) and _is_c(b):
        return a - b
    return a - b


def mul(a, b):
    if _is_c(a) and _is_c(b):
        return a * b
    if _is_c(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return -b
        return a * b
    if _is_c(b):
        return mul(b, a)
    return a * b


def fma(a, b, c):
    """a*b + c with folding."""
    return add(mul(a, b), c)


def div(a, b):
    if _is_c(b):
        return mul(a, 1.0 / b)
    if _is_c(a) and a == 0.0:
        return 0.0
    return a / b


# vec3 = (x, y, z) of scalars; mat3 = ((..),(..),(..)) rows of vec3
V0 = (0.0, 0.0, 0.0)
I3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def vadd(a, b):
    return tuple(add(x, y) for x, y in zip(a, b))


def vsub(a, b):
    return tuple(sub(x, y) for x, y in zip(a, b))


def vscale(s, a):
    return tuple(mul(s, x) for x in a)


def vdot(a, b):
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]))


def vcross(a, b):
    return (
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    )


def mv(M, v):
    return tuple(vdot(row, v) for row in M)


def mtv(M, v):
    """M^T v."""
    return tuple(
        add(add(mul(M[0][i], v[0]), mul(M[1][i], v[1])), mul(M[2][i], v[2]))
        for i in range(3)
    )


def mm(A, B):
    return tuple(
        tuple(
            add(add(mul(A[i][0], B[0][j]), mul(A[i][1], B[1][j])),
                mul(A[i][2], B[2][j]))
            for j in range(3))
        for i in range(3))


def mT(A):
    return tuple(tuple(A[j][i] for j in range(3)) for i in range(3))


def skew(v):
    return (
        (0.0, neg(v[2]), v[1]),
        (v[2], 0.0, neg(v[0])),
        (neg(v[1]), v[0], 0.0),
    )


def madd(A, B):
    return tuple(vadd(ra, rb) for ra, rb in zip(A, B))


def msub(A, B):
    return tuple(vsub(ra, rb) for ra, rb in zip(A, B))


def mscale(s, A):
    return tuple(vscale(s, row) for row in A)


def cmat(M) -> Tuple[Tuple[float, ...], ...]:
    """numpy (3,3) -> const mat3 of Python floats."""
    return tuple(tuple(float(x) for x in row) for row in np.asarray(M))


def cvec(v) -> Tuple[float, ...]:
    return tuple(float(x) for x in np.asarray(v))


def axis_angle(axis_c: Tuple[float, float, float], c, s):
    """Rodrigues rotation about a constant unit axis, cos/sin given.

    With a constant axis the 9 entries fold: for [0,0,1] this is the familiar
    2x2 rotation block (kinematics.py:_axis_angle_mat, constant-folded).
    """
    x, y, z = axis_c
    C1 = sub(1.0, c)  # array
    return (
        (add(c, mul(mul(x, x), C1)),
         sub(mul(mul(x, y), C1), mul(z, s)),
         add(mul(mul(x, z), C1), mul(y, s))),
        (add(mul(mul(y, x), C1), mul(z, s)),
         add(c, mul(mul(y, y), C1)),
         sub(mul(mul(y, z), C1), mul(x, s))),
        (sub(mul(mul(z, x), C1), mul(y, s)),
         add(mul(mul(z, y), C1), mul(x, s)),
         add(c, mul(mul(z, z), C1))),
    )


# ---------------------------------------------------------------------------
# static model constants
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConsts:
    ndof: int
    parent: Tuple[int, ...]
    revolute: Tuple[bool, ...]
    X_R: Tuple
    X_p: Tuple
    axis: Tuple
    mass: Tuple[float, ...]
    com: Tuple
    inertia: Tuple
    q_lo: Tuple[float, ...]
    q_hi: Tuple[float, ...]
    effort: Tuple[float, ...]
    vel_limit: Tuple[float, ...]
    # kinematics / collision tables (for scalarized FK & distance kernels)
    base_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cap_body: Tuple[int, ...] = ()
    cap_p0: Tuple = ()
    cap_p1: Tuple = ()
    cap_radius: Tuple[float, ...] = ()
    cap_group: Tuple[int, ...] = ()
    ngroup: int = 0
    site_body: Tuple[int, ...] = ()
    site_R: Tuple = ()
    site_p: Tuple = ()
    site_com: Tuple = ()


_MODEL_CONSTS_CACHE: dict = {}


def consts_from_model(model: ChainModel) -> ModelConsts:
    # memoized per model object; the cache also keeps the model alive, so
    # the id() key stays unambiguous
    ent = _MODEL_CONSTS_CACHE.get(id(model))
    if ent is not None and ent[0] is model:
        return ent[1]
    mc = _consts_from_model(model)
    _MODEL_CONSTS_CACHE[id(model)] = (model, mc)
    return mc


def _consts_from_model(model: ChainModel) -> ModelConsts:
    g = lambda a: np.asarray(a, dtype=np.float64)
    return ModelConsts(
        ndof=model.ndof,
        parent=model.parent_tuple,
        revolute=tuple(t == JOINT_REVOLUTE for t in model.jtype_tuple),
        X_R=tuple(cmat(m) for m in g(model.X_R)),
        X_p=tuple(cvec(v) for v in g(model.X_p)),
        axis=tuple(cvec(v) for v in g(model.axis)),
        mass=tuple(float(x) for x in g(model.mass)),
        com=tuple(cvec(v) for v in g(model.com)),
        inertia=tuple(cmat(m) for m in g(model.inertia)),
        q_lo=tuple(float(x) for x in g(model.q_lo)),
        q_hi=tuple(float(x) for x in g(model.q_hi)),
        effort=tuple(float(x) for x in g(model.effort)),
        vel_limit=tuple(float(x) for x in g(model.vel_limit)),
        base_pos=cvec(g(model.base_pos)),
        cap_body=model.cap_body_tuple,
        cap_p0=tuple(cvec(v) for v in g(model.cap_p0)),
        cap_p1=tuple(cvec(v) for v in g(model.cap_p1)),
        cap_radius=tuple(float(x) for x in g(model.cap_radius)),
        cap_group=model.cap_group_tuple,
        ngroup=model.ngroup,
        site_body=model.site_body_tuple,
        site_R=tuple(cmat(m) for m in g(model.site_R)),
        site_p=tuple(cvec(v) for v in g(model.site_p)),
        site_com=tuple(cvec(v) for v in g(model.site_com)),
    )




# tensor primitives that also take a folded Python float

def _sqrt_max(s, eps):
    if _is_c(s):
        return math.sqrt(max(s, eps))
    return torch.sqrt(torch.clamp_min(s, eps))


def _clip(x, lo, hi):
    if _is_c(x):
        return min(max(x, lo), hi)
    return torch.clamp(x, lo, hi)


def _abs(x):
    return abs(x) if _is_c(x) else torch.abs(x)


# ---------------------------------------------------------------------------
# Featherstone in component form (mirrors ops/dynamics.py exactly)
# ---------------------------------------------------------------------------

def _joint_X(mc: ModelConsts, d: int, q_d):
    """Child-body frame pose (R, p) in parent coords (dynamics.py:_joint_X)."""
    if mc.revolute[d]:
        c, s = torch.cos(q_d), torch.sin(q_d)
        R = mm(mc.X_R[d], axis_angle(mc.axis[d], c, s))
        p = mc.X_p[d]
    else:
        R = mc.X_R[d]
        p = vadd(mc.X_p[d], mv(R, vscale(q_d, mc.axis[d])))
    return R, p


def _motion_to_child(R, p, om, v):
    return mtv(R, om), mtv(R, vadd(v, vcross(om, p)))


def _force_to_parent(R, p, n, f):
    f_p = mv(R, f)
    n_p = vadd(mv(R, n), vcross(p, f_p))
    return n_p, f_p


def _inertia_mul(m, c, I_o, om, v):
    n = vadd(mv(I_o, om), vscale(m, vcross(c, v)))
    f = vscale(m, vadd(v, vcross(om, c)))
    return n, f


def rnea(mc: ModelConsts, q, qd, qdd, gravity=(0.0, 0.0, -9.81)):
    """Inverse dynamics (dynamics.py:rnea) over component lists.

    q/qd/qdd: sequences of ndof scalars (arrays or floats). Returns list of
    ndof joint torques (scalars).
    """
    g = (float(gravity[0]), float(gravity[1]), float(gravity[2]))
    ndof = mc.ndof
    Xs, v_om, v_v, a_om, a_v, f_n, f_f = [], [], [], [], [], [], []

    for d in range(ndof):
        R, p = _joint_X(mc, d, q[d])
        Xs.append((R, p))
        pd = mc.parent[d]
        if pd < 0:
            om_p, v_p = V0, V0
            aom_p, av_p = V0, (neg(g[0]), neg(g[1]), neg(g[2]))
        else:
            om_p, v_p = v_om[pd], v_v[pd]
            aom_p, av_p = a_om[pd], a_v[pd]

        om_i, v_i = _motion_to_child(R, p, om_p, v_p)
        aom_i, av_i = _motion_to_child(R, p, aom_p, av_p)

        ax = mc.axis[d]
        if mc.revolute[d]:
            s_om, s_v = ax, V0
        else:
            s_om, s_v = V0, ax

        vj_om, vj_v = vscale(qd[d], s_om), vscale(qd[d], s_v)
        om_i = vadd(om_i, vj_om)
        v_i = vadd(v_i, vj_v)
        aom_i = vadd(aom_i, vadd(vscale(qdd[d], s_om), vcross(om_i, vj_om)))
        av_i = vadd(av_i, vadd(vscale(qdd[d], s_v),
                               vadd(vcross(om_i, vj_v), vcross(v_i, vj_om))))

        m, c, I_o = mc.mass[d], mc.com[d], mc.inertia[d]
        hn, hf = _inertia_mul(m, c, I_o, om_i, v_i)
        fn_i, ff_i = _inertia_mul(m, c, I_o, aom_i, av_i)
        fn_i = vadd(fn_i, vadd(vcross(om_i, hn), vcross(v_i, hf)))
        ff_i = vadd(ff_i, vcross(om_i, hf))

        v_om.append(om_i); v_v.append(v_i)
        a_om.append(aom_i); a_v.append(av_i)
        f_n.append(fn_i); f_f.append(ff_i)

    tau = [None] * ndof
    for d in reversed(range(ndof)):
        ax = mc.axis[d]
        tau[d] = vdot(ax, f_n[d]) if mc.revolute[d] else vdot(ax, f_f[d])
        pd = mc.parent[d]
        if pd >= 0:
            R, p = Xs[d]
            n_p, f_p = _force_to_parent(R, p, f_n[d], f_f[d])
            f_n[pd] = vadd(f_n[pd], n_p)
            f_f[pd] = vadd(f_f[pd], f_p)
    return tau


def _inertia_to_parent(R, p, m, c, I_o):
    c_p = vadd(mv(R, c), p)
    sk_c = skew(c)
    I_com = msub(I_o, mscale(m, mm(sk_c, mT(sk_c))))
    I_com_p = mm(R, mm(I_com, mT(R)))
    sk_cp = skew(c_p)
    I_o_p = madd(I_com_p, mscale(m, mm(sk_cp, mT(sk_cp))))
    return m, c_p, I_o_p


def crba(mc: ModelConsts, q):
    """Mass matrix entries M[i][j] (scalars), mirroring dynamics.py:crba."""
    ndof = mc.ndof
    Xs = [_joint_X(mc, d, q[d]) for d in range(ndof)]

    Ic = [(mc.mass[d], mc.com[d], mc.inertia[d]) for d in range(ndof)]
    for d in reversed(range(ndof)):
        pd = mc.parent[d]
        if pd >= 0:
            R, p = Xs[d]
            m_c, c_c, I_c = _inertia_to_parent(R, p, *Ic[d])
            m_p, c_p, I_p = Ic[pd]
            m_t = m_p + m_c  # both floats by construction
            w = 1.0 / max(m_t, 1e-12)
            c_t = vscale(w, vadd(vscale(m_p, c_p), vscale(m_c, c_c)))
            Ic[pd] = (m_t, c_t, madd(I_p, I_c))

    M = [[0.0] * ndof for _ in range(ndof)]
    for d in range(ndof):
        ax = mc.axis[d]
        if mc.revolute[d]:
            s_om, s_v = ax, V0
        else:
            s_om, s_v = V0, ax
        Fn, Ff = _inertia_mul(*Ic[d], s_om, s_v)
        M[d][d] = add(vdot(s_om, Fn), vdot(s_v, Ff))
        j = d
        while mc.parent[j] >= 0:
            R, p = Xs[j]
            Fn, Ff = _force_to_parent(R, p, Fn, Ff)
            j = mc.parent[j]
            axj = mc.axis[j]
            Mdj = vdot(axj, Fn) if mc.revolute[j] else vdot(axj, Ff)
            M[d][j] = Mdj
            M[j][d] = Mdj
    return M


def cholesky_factor(M, eps: float = 1e-9):
    """Index-unrolled Cholesky over scalar entries; returns (L, inv_diag)."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = sub(s, mul(L[i][k], L[j][k]))
            if i == j:
                L[i][j] = _sqrt_max(s, eps)
                inv_diag[i] = 1.0 / L[i][j]
            else:
                L[i][j] = mul(s, inv_diag[j])
    return L, inv_diag


def cholesky_substitute(Lfac, b):
    """Forward+back substitution given cholesky_factor output."""
    L, inv_diag = Lfac
    n = len(b)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = sub(s, mul(L[i][k], y[k]))
        y[i] = mul(s, inv_diag[i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = sub(s, mul(L[k][i], x[k]))
        x[i] = mul(s, inv_diag[i])
    return x


def cholesky_solve(M, b, eps: float = 1e-9):
    """Index-unrolled SPD solve over scalar entries (linalg.py semantics)."""
    return cholesky_substitute(cholesky_factor(M, eps), b)


# ---------------------------------------------------------------------------
# motor substep (dynamics.py:motor_substep, component form)
# ---------------------------------------------------------------------------

def motor_substep(mc: ModelConsts, q, qd, target, dt: float, control_mode: int,
                  position_gain: float = POSITION_GAIN, tau_ext=None,
                  warm=None, return_warm: bool = False,
                  gravity=(0.0, 0.0, -9.81), effort=None):
    """One semi-implicit Euler substep with PyBullet motor semantics over
    component lists; numerically identical to dynamics.py:motor_substep
    and to panda_gym_tpu/ops/scalarized.py:motor_substep
    (coupled motor box-LCP solved exactly by a masked active-set method —
    see dynamics.py for the golden values that pin this down).

    ``warm=(sat, sign)`` — component lists carried from the previous
    substep — runs MOTOR_LCP_WARM_ITERS refinements from that active set
    (mirrors dynamics.py); with warm given (or return_warm) the return is
    (q, qd, (sat, sign)).  ``gravity`` (3 floats) enters the RNEA bias and
    ``effort`` (ndof floats, default the model's) sets the motor impulse
    caps effort * dt, as dynamics.py:motor_substep takes them; both fold as
    constants, and their defaults give the bits of the version without
    them."""
    ndof = mc.ndof
    inv_dt = 1.0 / dt
    if control_mode == CTRL_POSITION:
        v_des = [mul(position_gain * inv_dt, sub(target[d], q[d]))
                 for d in range(ndof)]
    else:
        v_des = list(target)
    # Bullet maxCoordinateVelocity clamp (mc.vel_limit = 100 rad/s default)
    v_des = [_clip(v_des[d], -mc.vel_limit[d], mc.vel_limit[d])
             for d in range(ndof)]

    bias = rnea(mc, q, qd, [0.0] * ndof, gravity)
    M = crba(mc, q)
    if tau_ext is None:
        tau_ext = [0.0] * ndof
    eff = mc.effort if effort is None else tuple(float(e) for e in effort)

    # free velocity: one substep under bias/external forces, motors off
    fv = cholesky_solve(M, [sub(tau_ext[i], bias[i]) for i in range(ndof)])
    qd_free = [add(qd[d], mul(dt, fv[d])) for d in range(ndof)]
    cap = [mul(dt, eff[d]) for d in range(ndof)]

    def matvec(vec):
        out = []
        for i in range(ndof):
            s = 0.0
            for j in range(ndof):
                s = add(s, mul(M[i][j], vec[j]))
            out.append(s)
        return out

    Mqf = matvec(qd_free)
    if warm is None:
        # unconstrained pass: impulse needed for every motor to hit v_des
        Mv = matvec(v_des)
        x = [sub(Mv[i], Mqf[i]) for i in range(ndof)]
        sat = [_abs(x[i]) > cap[i] for i in range(ndof)]
        c = [_clip(x[i], -cap[i], cap[i]) for i in range(ndof)]
        n_iters = D.MOTOR_LCP_ITERS
    else:
        sat, sign = warm
        sat = list(sat)
        c = [mul(cap[i], sign[i]) for i in range(ndof)]
        n_iters = D.MOTOR_LCP_WARM_ITERS
    u = list(v_des)
    x = None
    for _ in range(n_iters):
        # rows S (saturated): M_SS u_S = c_S + (M qd_free)_S - M_SF v_des_F
        # rows F (free):      u_F = v_des_F
        A = [[torch.where(sat[i] & sat[j], M[i][j],
                          1.0 if i == j else 0.0)
              for j in range(ndof)] for i in range(ndof)]
        mvf = matvec([torch.where(sat[j], 0.0, v_des[j])
                      for j in range(ndof)])
        rhs = [torch.where(sat[i], sub(add(c[i], Mqf[i]), mvf[i]), v_des[i])
               for i in range(ndof)]
        u = cholesky_solve(A, rhs)
        Mu = matvec(u)
        x = [sub(Mu[i], Mqf[i]) for i in range(ndof)]
        # saturated stays iff deficit still pushes into the cap; free joints
        # whose required impulse exceeds the cap saturate
        sat = [(sat[i] & (mul(sub(v_des[i], u[i]), c[i]) >= 0.0))
               | ((~sat[i]) & (_abs(x[i]) > cap[i]))
               for i in range(ndof)]
        c = [_clip(x[i], -cap[i], cap[i]) for i in range(ndof)]

    qd_new = list(u)
    q_new = [add(q[d], mul(dt, qd_new[d])) for d in range(ndof)]
    q_cl = [_clip(q_new[d], mc.q_lo[d], mc.q_hi[d]) for d in range(ndof)]
    qd_out = [torch.where(q_cl[d] != q_new[d], 0.0, qd_new[d])
              for d in range(ndof)]
    if warm is not None or return_warm:
        sign_out = [torch.where(x[i] >= 0.0, 1.0, -1.0) for i in range(ndof)]
        return q_cl, qd_out, (tuple(sat), tuple(sign_out))
    return q_cl, qd_out


def make_batched_motor_steps(model: ChainModel, *, n_substeps: int, dt: float,
                             ctrl_mode: int, warm_start=None,
                             gravity=None, effort=None):
    """Batched n-substep robot physics: (B, ndof) in/out.  ``gravity`` and
    ``effort`` as motor_substep takes them (None: the defaults).

    warm_start: carry the LCP active set across substeps (cold pre-solve +
    MOTOR_LCP_WARM_ITERS refinements each, the default) or run the cold
    MOTOR_LCP_ITERS solve every substep; PANDA_LCP_WARM=0/1 overrides, as
    in the JAX package (scalarized.py:672-723, the lax.scan a Python loop).
    """
    if warm_start is None:
        warm_start = D.lcp_warm_default(True)
    mc = consts_from_model(model)
    ndof = mc.ndof
    kw = {}
    if gravity is not None:
        kw["gravity"] = tuple(float(g) for g in gravity)
    if effort is not None:
        kw["effort"] = tuple(float(e) for e in effort)

    def step(q, qd, target):
        tgt = [target[:, d] for d in range(ndof)]
        qc = [q[:, d] for d in range(ndof)]
        qdc = [qd[:, d] for d in range(ndof)]
        if not warm_start:
            for _ in range(n_substeps):
                qc, qdc = motor_substep(mc, qc, qdc, tgt, dt, ctrl_mode, **kw)
            return torch.stack(qc, dim=-1), torch.stack(qdc, dim=-1)

        # cold pre-solve seeds the warm active set; every substep then runs
        # the warm refinement
        _, _, warm = motor_substep(mc, qc, qdc, tgt, dt, ctrl_mode,
                                   return_warm=True, **kw)
        for _ in range(n_substeps):
            qc, qdc, warm = motor_substep(mc, qc, qdc, tgt, dt, ctrl_mode,
                                          warm=warm, **kw)
        return torch.stack(qc, dim=-1), torch.stack(qdc, dim=-1)

    return step

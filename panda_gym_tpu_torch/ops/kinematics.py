"""Forward kinematics, link queries, Jacobians and damped-least-squares IK
for ChainModel, batch leading (port of panda_gym_tpu/ops/kinematics.py).

The JAX functions are single-env and batched with vmap; here every tensor
carries the env batch as its leading dimension, so one call covers the whole
batch.  Loops run over the (static, tiny) dof count.  The FK's (3, 3)
products are fp32 matrix products: callers run them with TF32 off
(envs/core.py ``_hi_prec``); the Jacobian products of the IK and the
manipulability are sums of elementwise products, exact fp32 on any device.
The IK solves its damped normal equations with the unrolled Cholesky of
ops/linalg.py, which never synchronizes with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from panda_gym_tpu_torch.math.transforms import axis_angle_mat, quat_to_mat
from panda_gym_tpu_torch.models.chain import ChainModel, JOINT_REVOLUTE
from panda_gym_tpu_torch.ops.linalg import cholesky_solve_unrolled


class FK(NamedTuple):
    """World-frame kinematics of each dof body, stacked over dofs."""

    R: torch.Tensor     # (B, ndof, 3, 3) body frame rotation
    p: torch.Tensor     # (B, ndof, 3) body frame origin (== joint anchor)
    a: torch.Tensor     # (B, ndof, 3) joint axis in world frame
    om: torch.Tensor    # (B, ndof, 3) body angular velocity (world coords)
    v: torch.Tensor     # (B, ndof, 3) velocity of the body-frame origin


def fk_world(model: ChainModel, q, qd=None) -> FK:
    """Forward position (and optional velocity) kinematics, world frame.
    q, qd: (B, ndof).  Without qd every body is at rest: the velocities
    are zeros and are not computed."""
    T = model.tensors(q.device)
    B = q.shape[0]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(B, 3, 3)
    zero = torch.zeros(B, 3, dtype=q.dtype, device=q.device)
    base = T["base_pos"].expand(B, 3)
    Rs, ps, as_, oms, vs = [], [], [], [], []
    for d in range(model.ndof):
        pd = model.parent_tuple[d]
        if pd < 0:
            R_par, p_par, om_par, v_par = eye, base, zero, zero
        else:
            R_par, p_par, om_par, v_par = Rs[pd], ps[pd], oms[pd], vs[pd]
        R_f = R_par @ T["X_R"][d]
        p_f = R_par @ T["X_p"][d] + p_par
        a_w = R_f @ T["axis"][d]
        revolute = model.jtype_tuple[d] == JOINT_REVOLUTE
        if revolute:
            R_b = R_f @ axis_angle_mat(model.axis[d], torch.cos(q[:, d]),
                                       torch.sin(q[:, d]))
            p_b = p_f
        else:
            R_b = R_f
            p_b = p_f + a_w * q[:, d:d + 1]
        if qd is None:
            om_b, v_b = zero, zero
        else:
            qd_d = qd[:, d:d + 1]
            om_b = om_par + a_w * qd_d if revolute else om_par
            v_b = v_par + torch.linalg.cross(om_par, p_b - p_par)
            if not revolute:
                v_b = v_b + a_w * qd_d
        Rs.append(R_b)
        ps.append(p_b)
        as_.append(a_w)
        oms.append(om_b)
        vs.append(v_b)
    return FK(torch.stack(Rs, 1), torch.stack(ps, 1), torch.stack(as_, 1),
              torch.stack(oms, 1), torch.stack(vs, 1))


def _site_base(model: ChainModel, fk: FK, s: int):
    b = model.site_body_tuple[s]
    if b < 0:
        B = fk.p.shape[0]
        T = model.tensors(fk.p.device)
        zero = torch.zeros_like(fk.p[:, 0])
        return (torch.eye(3, dtype=fk.p.dtype, device=fk.p.device)
                .expand(B, 3, 3), T["base_pos"].expand(B, 3), zero, zero)
    return fk.R[:, b], fk.p[:, b], fk.om[:, b], fk.v[:, b]


def site_frame(model: ChainModel, fk: FK, s: int):
    """World pose (R, p) of URDF link frame s (PyBullet link index)."""
    T = model.tensors(fk.p.device)
    R_b, p_b, _, _ = _site_base(model, fk, s)
    return R_b @ T["site_R"][s], R_b @ T["site_p"][s] + p_b


def site_com_position(model: ChainModel, fk: FK, s: int):
    """World CoM of link s — PyBullet getLinkState()[0] semantics."""
    T = model.tensors(fk.p.device)
    R_s, p_s = site_frame(model, fk, s)
    return R_s @ T["site_com"][s] + p_s


def site_com_velocity(model: ChainModel, fk: FK, s: int):
    """World CoM linear velocity of link s — getLinkState()[6] semantics."""
    _, p_b, om_b, v_b = _site_base(model, fk, s)
    x = site_com_position(model, fk, s)
    return v_b + torch.linalg.cross(om_b, x - p_b)


def capsule_endpoints_world(model: ChainModel, fk: FK):
    """World endpoints of every collision capsule: (B, ncap, 3) x2."""
    T = model.tensors(fk.p.device)
    # gather body frames; a capsule on no body sits on the base
    on_body = T["cap_on_body"]
    eye = torch.eye(3, dtype=fk.p.dtype, device=fk.p.device)
    R_b = torch.where(on_body[:, None, None], fk.R[:, T["cap_body_index"]],
                      eye)
    p_b = torch.where(on_body[:, None], fk.p[:, T["cap_body_index"]],
                      T["base_pos"])
    # R_b @ p as a sum of products: no matrix product, so no TF32
    p0 = (R_b * T["cap_p0"][:, None, :]).sum(-1) + p_b
    p1 = (R_b * T["cap_p1"][:, None, :]).sum(-1) + p_b
    return p0, p1


def point_jacobian(model: ChainModel, fk: FK, x, body: int):
    """Geometric Jacobian of world points x (B, 3) rigidly attached to dof
    body ``body``: (J_v, J_w), each (B, 3, ndof); the columns of dofs that
    do not carry the body are zero."""
    support = [False] * model.ndof
    b = body
    while b >= 0:
        support[b] = True
        b = model.parent_tuple[b]
    revolute = [model.jtype_tuple[d] == JOINT_REVOLUTE for d in range(model.ndof)]
    dev = x.device
    sup = torch.tensor(support, device=dev)[:, None]
    rev = torch.tensor(revolute, device=dev)[:, None]
    # (B, ndof, 3): a revolute dof moves x by a x (x - p), a prismatic by a
    lin = torch.where(rev, torch.linalg.cross(fk.a, x[:, None] - fk.p), fk.a)
    ang = torch.where(rev, fk.a, 0.0)
    J_v = torch.where(sup, lin, 0.0).transpose(1, 2)
    J_w = torch.where(sup, ang, 0.0).transpose(1, 2)
    return J_v, J_w


def ee_jacobian(model: ChainModel, ee_site: int, q):
    """(J_v, J_w) at the EE site CoM for q (B, ndof)."""
    fk = fk_world(model, q)
    x = site_com_position(model, fk, ee_site)
    return point_jacobian(model, fk, x, model.site_body_tuple[ee_site])


def _gram(J):
    """J @ J^T as a sum of elementwise products: (B, m, n) -> (B, m, m)."""
    return (J[:, :, None, :] * J[:, None, :, :]).sum(-1)


def manipulability(model: ChainModel, ee_site: int, q, n_arm: int = 7):
    """Yoshikawa translational manipulability sqrt(det(Jv Jv^T)), (B,),
    with the 3x3 determinant in closed form."""
    J_v, _ = ee_jacobian(model, ee_site, q)
    A = _gram(J_v[..., :n_arm])
    det = (A[:, 0, 0] * (A[:, 1, 1] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 1])
           - A[:, 0, 1] * (A[:, 1, 0] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 0])
           + A[:, 0, 2] * (A[:, 1, 0] * A[:, 2, 1] - A[:, 1, 1] * A[:, 2, 0]))
    return torch.sqrt(torch.clamp_min(det, 0.0))


def _quat_err_vec(R_cur, quat_target):
    """Rotation error as a 3-vector (axis*angle, small-angle form):
    0.5 * sum_i cur_i x target_i over the columns, (B, 3)."""
    R_t = quat_to_mat(quat_target)
    c = torch.linalg.cross(R_cur.transpose(1, 2), R_t.transpose(1, 2))
    return 0.5 * (c[:, 0] + c[:, 1] + c[:, 2])


def dls_ik(model: ChainModel, ee_site: int, target_pos, target_quat=None,
           q0=None, n_iters: int = 30, damping: float = 0.05,
           n_arm: int = 7, step_clip: float = 0.5):
    """Damped-least-squares IK to world positions target_pos (B, 3), and
    orientations target_quat (B, 4) xyzw when given, from q0 (B, ndof) or
    (ndof,) (zeros by default): a fixed n_iters steps, each clipped to
    step_clip per joint and clamped to the joint limits.  Only the first
    ``n_arm`` dofs move.  Returns q (B, ndof)."""
    B = target_pos.shape[0]
    dev = target_pos.device
    if q0 is None:
        q = torch.zeros(B, model.ndof, device=dev)
    else:
        q = torch.as_tensor(q0, dtype=torch.float32, device=dev).expand(
            B, model.ndof)
    T = model.tensors(dev)
    lo, hi = T["q_lo"][:n_arm], T["q_hi"][:n_arm]
    m = 3 if target_quat is None else 6
    lam2 = (damping * damping) * torch.eye(m, device=dev)
    body = model.site_body_tuple[ee_site]
    for _ in range(n_iters):
        fk = fk_world(model, q)
        x = site_com_position(model, fk, ee_site)
        J_v, J_w = point_jacobian(model, fk, x, body)
        e = target_pos - x
        if target_quat is None:
            J = J_v[..., :n_arm]
        else:
            R_s, _ = site_frame(model, fk, ee_site)
            J = torch.cat([J_v, J_w], 1)[..., :n_arm]
            e = torch.cat([e, _quat_err_vec(R_s, target_quat)], -1)
        y = cholesky_solve_unrolled(_gram(J) + lam2, e)
        dq = torch.clamp((J * y[:, :, None]).sum(1), -step_clip, step_clip)
        q = torch.cat([torch.clamp(q[:, :n_arm] + dq, lo, hi),
                       q[:, n_arm:]], -1)
    return q

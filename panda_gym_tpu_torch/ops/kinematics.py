"""Forward kinematics and link queries for ChainModel, batch leading
(port of fk_world and the site queries of panda_gym_tpu/ops/kinematics.py).

The JAX functions are single-env and batched with vmap; here every tensor
carries the env batch as its leading dimension, so one call covers the whole
batch.  Loops run over the (static, tiny) dof count.  The (3, 3) products
are fp32 matrix products: callers run them with TF32 off (envs/core.py
``_hi_prec``).  ``dls_ik`` and the Jacobians wait for the "ee" control
(ROADMAP item 15).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from panda_gym_tpu_torch.math.transforms import axis_angle_mat
from panda_gym_tpu_torch.models.chain import ChainModel, JOINT_REVOLUTE


class FK(NamedTuple):
    """World-frame kinematics of each dof body, stacked over dofs."""

    R: torch.Tensor     # (B, ndof, 3, 3) body frame rotation
    p: torch.Tensor     # (B, ndof, 3) body frame origin (== joint anchor)
    a: torch.Tensor     # (B, ndof, 3) joint axis in world frame
    om: torch.Tensor    # (B, ndof, 3) body angular velocity (world coords)
    v: torch.Tensor     # (B, ndof, 3) velocity of the body-frame origin


def fk_world(model: ChainModel, q, qd=None) -> FK:
    """Forward position (and optional velocity) kinematics, world frame.
    q, qd: (B, ndof)."""
    if qd is None:
        qd = torch.zeros_like(q)
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
        qd_d = qd[:, d:d + 1]
        if model.jtype_tuple[d] == JOINT_REVOLUTE:
            R_b = R_f @ axis_angle_mat(model.axis[d], torch.cos(q[:, d]),
                                       torch.sin(q[:, d]))
            p_b = p_f
            om_b = om_par + a_w * qd_d
            v_b = v_par + torch.linalg.cross(om_par, p_b - p_par)
        else:
            R_b = R_f
            p_b = p_f + a_w * q[:, d:d + 1]
            om_b = om_par
            v_b = v_par + torch.linalg.cross(om_par, p_b - p_par) + a_w * qd_d
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

"""NEO reactive QP controller, the analytic motion-planner prior, for a batch
of envs (port of panda_gym_tpu/ops/neo.py).

The QP of Haviland & Corke 2021 (reference panda.py:319-429) for every env
at once, the batch leading:

  * p_servo        -> desired EE twist from the pose error,
  * jacobe         -> geometric Jacobian rotated into the EE frame,
  * jacobm         -> gradient of the Yoshikawa index, by autograd on a
                      detached copy of q (works under ``no_grad``),
  * joint-limit and per-(capsule, obstacle) velocity dampers as inequality
    rows, the latter for all pairs in a few broadcast operations,
  * the solve      -> fixed-iteration ADMM (ops/qp.py).

Variables x = [qd(7); slack(6)]; the rows keep the JAX function's order
(equality, joint dampers, obstacle dampers capsule-major, bounds), so the
assembled QP compares row by row.  ``compute_action_neo`` runs with TF32
off.
"""
from __future__ import annotations

import torch

from panda_gym_tpu_torch.models import panda_constants as pc
from panda_gym_tpu_torch.models.chain import ChainModel
from panda_gym_tpu_torch.ops import contact as C
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.ops.linalg import _hi_prec
from panda_gym_tpu_torch.ops.qp import solve_qp_admm
from panda_gym_tpu_torch.sim.state import OBS_BOX

# the gains of the JAX function's DEFAULT_CONFIG (neo.py:31-40), which no
# caller overrides (its threshold_error is read nowhere)
VELOCITY_GAIN = 0.5
GAIN_CONTROL_MINIMIZATION = 0.01
MIN_ANGLE_JOINT = 0.05
MIN_ANGLE_JOINT_DAMP_ACTIVE = 0.9
MIN_DIST_OBSTACLE = 0.05
MIN_DIST_OBSTACLE_DAMP_ACTIVE = 0.3
DAMP_GAIN = 1.0

N_ARM = 7       # the arm's joints; the gripper's dofs take no command
_BIG = 1e6


def _rotvec(R):
    """Rotation matrices (B, 3, 3) -> axis*angle vectors (B, 3)."""
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    angle = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    axis = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                        R[:, 1, 0] - R[:, 0, 1]], -1)
    s = torch.clamp_min(2.0 * torch.sin(angle), 1e-8)
    return axis / s[:, None] * angle[:, None]


def p_servo(R_cur, p_cur, R_des, p_des, gain: float):
    """Position-based servoing twist in the current EE frame (rtb p_servo),
    (B, 6)."""
    Rt = R_cur.transpose(1, 2)
    e_t = (Rt @ (p_des - p_cur)[..., None])[..., 0]
    return gain * torch.cat([e_t, _rotvec(Rt @ R_des)], -1)


def _tables(model: ChainModel, device):
    """NEO's static tables, cached with the model's tensors: the damped
    capsules (on a body and in a collision group), each one's ancestor mask
    (``K.dof_support``), and the rtb joint and velocity limits that the
    dampers and bounds use (pc.JOINT_LIM_*, not the URDF limits of
    ``model.tensors``' q_lo/q_hi: joint 6's are shifted by ~0.6 rad)."""
    T = model.tensors(device)
    if "neo" not in T:
        caps = [i for i, (b, g) in enumerate(zip(model.cap_body_tuple,
                                                  model.cap_group_tuple))
                if b >= 0 and g >= 0]
        support = [K.dof_support(model, model.cap_body_tuple[i])
                   for i in caps]
        f = dict(dtype=torch.float32, device=device)
        T["neo"] = dict(
            caps=torch.as_tensor(caps, dtype=torch.int64, device=device),
            radius=T["cap_radius"][caps],
            support=torch.as_tensor(support, device=device).reshape(
                len(caps), model.ndof),
            q_lo=torch.as_tensor(pc.JOINT_LIM_MIN[:N_ARM], **f),
            q_hi=torch.as_tensor(pc.JOINT_LIM_MAX[:N_ARM], **f),
            qdlim=torch.as_tensor(pc.QDLIM[:N_ARM], **f))
    return T["neo"]


def jacobm(model: ChainModel, ee_site: int, q):
    """Gradient of sqrt(max(det(Jv Jv^T), 1e-12)) with respect to the arm's
    joints at q (B, ndof), (B, N_ARM): the JAX function's jax.grad, by
    autograd on a detached copy, so it also works where autograd is off."""
    with torch.enable_grad():
        qa = q[:, :N_ARM].detach().requires_grad_(True)
        fk = K.fk_world(model, torch.cat([qa, q[:, N_ARM:].detach()], -1))
        x = K.site_com_position(model, fk, ee_site)
        J_v, _ = K.point_jacobian(model, fk, x, model.site_body_tuple[ee_site])
        det = K.det3(K._gram(J_v[..., :N_ARM]))
        manip = torch.sqrt(torch.clamp_min(det, 1e-12))
        grad, = torch.autograd.grad(manip.sum(), qa)
    return grad


def obstacle_rows(model: ChainModel, fk, state):
    """One velocity-damper row per (damped capsule, obstacle) pair, capsule
    major: d_dot = n_hat . J_v(p) qd <= xi (d - ds) / (di - ds), zero rows
    with u = 1e6 where the pair is farther than di or the obstacle inactive.
    Returns (A_o (B, ncap * no, N_ARM), u_o (B, ncap * no))."""
    ds, di, xi = MIN_DIST_OBSTACLE, MIN_DIST_OBSTACLE_DAMP_ACTIVE, DAMP_GAIN
    tab = _tables(model, fk.p.device)
    caps = tab["caps"]
    cap_p0, cap_p1 = K.capsule_endpoints_world(model, fk)
    B, no = state.obstacle_pos.shape[:2]
    nc = caps.shape[0]
    shape = (B, nc, no)
    p0 = cap_p0[:, caps, None].expand(*shape, 3)
    p1 = cap_p1[:, caps, None].expand(*shape, 3)
    rc = tab["radius"][None, :, None].expand(shape)
    opos = state.obstacle_pos[:, None].expand(*shape, 3)
    osize = state.obstacle_size[:, None].expand(*shape, 3)
    d_s, pc_s, po_s = C.capsule_sphere_distance(p0, p1, rc, opos,
                                                osize[..., 0])
    eye = torch.eye(3, dtype=p0.dtype, device=p0.device).expand(*shape, 3, 3)
    d_b, pc_b, po_b, _ = C.capsule_box_distance(p0, p1, rc, opos, eye, osize)
    is_box = (state.obstacle_type == OBS_BOX)[:, None, :]
    dist = torch.where(is_box, d_b, d_s)
    pcap = torch.where(is_box[..., None], pc_b, pc_s)
    pobs = torch.where(is_box[..., None], po_b, po_s)
    dist = torch.where(state.obstacle_active[:, None, :], dist, _BIG)
    n_hat = pobs - pcap
    n_hat = n_hat / torch.clamp_min(
        torch.linalg.vector_norm(n_hat, dim=-1, keepdim=True), 1e-9)

    # n_hat . J_v at every closest point, each on its capsule's body
    J_v, _ = K.point_jacobian(model, fk, pcap, tab["support"][:, None])
    row = (n_hat[..., None] * J_v[..., :N_ARM]).sum(-2)   # (B, nc, no, n)
    active = dist <= di
    A_o = torch.where(active[..., None], row, 0.0).reshape(B, nc * no, N_ARM)
    u_o = torch.where(active, xi * (dist - ds) / (di - ds), _BIG).reshape(
        B, nc * no)
    return A_o, u_o


def assemble_qp(model: ChainModel, ee_site: int, state, fk, target):
    """NEO's QP for a batch of envs (panda.py:345-429): (Q (B, 13, 13),
    c (B, 13), A (B, m, 13), l (B, m), u (B, m)) with m = 6 + 2 N_ARM +
    (damped capsules x obstacles) + 13.  Callers run it with TF32 off, as
    ``compute_action_neo`` does."""
    ps, pi_ = MIN_ANGLE_JOINT, MIN_ANGLE_JOINT_DAMP_ACTIVE
    xi, gain, Y = DAMP_GAIN, VELOCITY_GAIN, GAIN_CONTROL_MINIMIZATION
    n = N_ARM
    nv = n + 6
    tab = _tables(model, target.device)
    q = state.q[:, :n]
    B = q.shape[0]
    f = dict(dtype=torch.float32, device=q.device)

    # EE pose; the desired pose keeps the current orientation (neo.py:80-84)
    R_e, _ = K.site_frame(model, fk, ee_site)
    x_ee = K.site_com_position(model, fk, ee_site)
    v = p_servo(R_e, x_ee, R_e, target, gain)
    # spatial error (panda.py:364): |t_err| + |rpy_err|, here |rotvec|
    e = torch.clamp_min(torch.abs(v / gain).sum(-1), 1e-4)

    # EE-frame Jacobian (jacobe)
    J_v, J_w = K.point_jacobian(model, fk, x_ee, model.site_body_tuple[ee_site])
    Rt = R_e.transpose(1, 2)
    Je = torch.cat([Rt @ J_v[..., :n], Rt @ J_w[..., :n]], 1)   # (B, 6, n)

    eye6 = torch.eye(6, **f)
    Q = torch.diag_embed(torch.cat([torch.full((B, n), Y, **f),
                                    (1.0 / e)[:, None].expand(B, 6)], -1))
    c = torch.cat([-jacobm(model, ee_site, state.q),
                   torch.zeros(B, 6, **f)], -1)

    # equality [Je I6] x = v
    A_eq = torch.cat([Je, eye6.expand(B, 6, 6)], -1)

    # joint-limit velocity dampers (rtb joint_velocity_damper)
    rho_lo = q - tab["q_lo"]
    rho_hi = tab["q_hi"] - q
    b_lo = torch.where(rho_lo <= pi_, xi * (rho_lo - ps) / (pi_ - ps), _BIG)
    b_hi = torch.where(rho_hi <= pi_, xi * (rho_hi - ps) / (pi_ - ps), _BIG)
    eye_n = torch.eye(n, **f)
    A_j = torch.cat([torch.cat([-eye_n, eye_n]),
                     torch.zeros(2 * n, 6, **f)], -1).expand(B, 2 * n, nv)

    # obstacle velocity dampers (link_collision_damper_pybullet)
    A_o, u_o = obstacle_rows(model, fk, state)
    A_o = torch.cat([A_o, A_o.new_zeros(B, A_o.shape[1], 6)], -1)

    # bounds as rows: lb <= x <= ub (panda.py:417-419)
    ten = torch.full((6,), 10.0, **f)
    A_b = torch.eye(nv, **f).expand(B, nv, nv)
    l_b = torch.cat([-tab["qdlim"], -ten]).expand(B, nv)
    u_b = torch.cat([tab["qdlim"], ten]).expand(B, nv)

    A = torch.cat([A_eq, A_j, A_o, A_b], 1)
    l = torch.cat([v, torch.full((B, 2 * n + A_o.shape[1]), -_BIG, **f), l_b],
                  -1)
    u = torch.cat([v, b_lo, b_hi, u_o, u_b], -1)
    return Q, c, A, l, u


@_hi_prec
def compute_action_neo(model: ChainModel, ee_site: int, state, fk, target):
    """Collision-avoiding joint-velocity command toward ``target`` (B, 3)
    for a batch of envs: states and FK batched, (B, N_ARM)."""
    x, _ = solve_qp_admm(*assemble_qp(model, ee_site, state, fk, target))
    return x[:, :N_ARM]

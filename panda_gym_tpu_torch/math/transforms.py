"""Rotation and rigid-transform helpers (port of
panda_gym_tpu/math/transforms.py).  Quaternions are (x, y, z, w), euler
angles extrinsic XYZ, rotation matrices world_R_body, as in the JAX module;
every function broadcasts over leading batch dimensions."""
import torch


def axis_angle_mat(axis, c, s):
    """Rodrigues rotation about a constant unit axis (3 floats), given the
    angle's cos ``c`` and sin ``s`` as (B,) tensors -> (B, 3, 3)."""
    x, y, z = (float(v) for v in axis)
    C = 1.0 - c
    return torch.stack([
        c + x * x * C, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, c + y * y * C, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, c + z * z * C,
    ], dim=-1).reshape(c.shape + (3, 3))


def quat_to_mat(q):
    """Quaternion (..., 4) xyzw -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product q1 (x) q2 in (x, y, z, w) layout, its terms grouped
    as the JAX package's batched form groups them
    (scalarized_contact.py:54-66)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        (w1 * x2 + x1 * w2) + (y1 * z2 - z1 * y2),
        (w1 * y2 - x1 * z2) + (y1 * w2 + z1 * x2),
        (w1 * z2 + x1 * y2) + (z1 * w2 - y1 * x2),
        (w1 * w2 - x1 * x2) - (y1 * y2 + z1 * z2),
    ], dim=-1)


def quat_to_euler(q):
    """Quaternion -> extrinsic XYZ euler (roll, pitch, yaw), as
    pybullet.getEulerFromQuaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_integrate(q, omega, dt):
    """q after dt of world-frame angular velocity omega:
    exp(0.5 omega dt) (x) q, normalized; in the order of operations of the
    JAX package's batched form (scalarized_contact.py:69-82)."""
    sq = omega * omega
    angle = torch.sqrt(torch.clamp_min((sq[..., 0] + sq[..., 1]) + sq[..., 2],
                                       0.0))
    axis = omega / torch.where(angle > 1e-9, angle, 1.0)[..., None]
    half = (0.5 * dt) * angle
    qn = quat_mul(torch.cat([axis * torch.sin(half)[..., None],
                             torch.cos(half)[..., None]], -1), q)
    sq = qn * qn
    inv_n = 1.0 / torch.sqrt(torch.clamp_min(
        (sq[..., 0] + sq[..., 1]) + (sq[..., 2] + sq[..., 3]), 1e-9))
    return inv_n[..., None] * qn


def quat_conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv.expand_as(v), v)
    return v + w * t + torch.linalg.cross(qv.expand_as(t), t)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, angle):
    """axis: (..., 3) unit vectors, angle: (...)."""
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], -1)


def mat_to_quat(m):
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) xyzw: of the
    four candidates, one per dominant component, the one whose component
    is largest (Shepperd's selection, branch-free), normalized."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw = torch.stack([m21 - m12, m02 - m20, m10 - m01,
                      1.0 + m00 + m11 + m22], -1)
    qx = torch.stack([1.0 + m00 - m11 - m22, m10 + m01, m02 + m20,
                      m21 - m12], -1)
    qy = torch.stack([m10 + m01, 1.0 - m00 + m11 - m22, m21 + m12,
                      m02 - m20], -1)
    qz = torch.stack([m02 + m20, m21 + m12, 1.0 - m00 - m11 + m22,
                      m10 - m01], -1)
    trace = m00 + m11 + m22
    best = torch.argmax(torch.stack([m00, m11, m22, trace], -1), -1)
    cands = torch.stack([qx, qy, qz, qw], -2)            # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def quat_from_euler(rpy):
    """Extrinsic XYZ euler (roll, pitch, yaw) -> quaternion (x, y, z, w), as
    pybullet.getQuaternionFromEuler."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], -1)


# rigid transforms as (R, p) pairs: R (..., 3, 3), p (..., 3)

def _mv(R, v):
    return (R * v[..., None, :]).sum(-1)


def rt_compose(Ra, pa, Rb, pb):
    """(Ra, pa) o (Rb, pb): first apply b in a's frame."""
    return Ra @ Rb, pa + _mv(Ra, pb)


def rt_apply(R, p, v):
    return _mv(R, v) + p


def rt_inv(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, p)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)

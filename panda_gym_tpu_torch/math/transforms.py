"""Rotation helpers (port of the part of panda_gym_tpu/math/transforms.py
that the Reach family and the free-body tasks call).  Quaternions are
(x, y, z, w), euler angles extrinsic XYZ, as in the JAX module."""
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

"""Rotation helpers (port of the part of panda_gym_tpu/math/transforms.py
that the Reach slice calls)."""
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

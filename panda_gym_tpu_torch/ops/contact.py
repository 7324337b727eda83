"""Analytic primitive geometry: distances and closest points (port of
panda_gym_tpu/ops/contact.py:21-147).

Capsule, sphere and box queries with leading batch dimensions that
broadcast, as in the JAX module:
  capsule  = (p0, p1, r)      segment + radius
  sphere   = (c, r)           degenerate capsule
  box      = (center, R, half) oriented box
Rotations are applied as sums of products, never as matrix products, so
TF32 cannot reach them.  ``penalty_force`` (:148) is the contact law of the
free-body step.
"""
from __future__ import annotations

import torch

EPS = 1e-9
# the penalty contact law's stiffness, damping and friction slip scale
KN, DN, V_EPS = 8000.0, 120.0, 2e-3


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _dot(a, b):
    return (a * b).sum(-1)


def _rot(R, x):
    """R @ x over the last axes: (..., 3, 3) with (..., 3)."""
    return (R * x[..., None, :]).sum(-1)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def closest_on_segment(p0, p1, x):
    """Closest point to x on segment [p0, p1] (leading batch dims ok)."""
    d = p1 - p0
    t = _dot(x - p0, d) / torch.clamp_min(_dot(d, d), EPS)
    t = torch.clamp(t, 0.0, 1.0)
    return p0 + t[..., None] * d


def segment_segment_closest(p0, p1, q0, q1):
    """Closest point pair between two segments (Ericson, real-time CD 5.1.9)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > EPS,
                    torch.clamp((b * f - c * e) / torch.clamp_min(denom, EPS),
                                0.0, 1.0), 0.0)
    t = (b * s + f) / torch.clamp_min(e, EPS)
    t_clamped = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_clamped - c) / torch.clamp_min(a, EPS), 0.0, 1.0)
    cp = p0 + s[..., None] * d1
    cq = q0 + t_clamped[..., None] * d2
    return cp, cq


def capsule_sphere_distance(p0, p1, rc, center, rs):
    """Surface distance + closest surface points (on capsule, on sphere)."""
    cp = closest_on_segment(p0, p1, center)
    delta = center - cp
    d = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp_min(d, EPS)[..., None]  # capsule -> sphere
    rc = _t(rc, d)
    rs = _t(rs, d)
    dist = d - rc - rs
    point_on_capsule = cp + n * rc[..., None]
    point_on_sphere = center - n * rs[..., None]
    return dist, point_on_capsule, point_on_sphere


def point_box_closest(x_local, half):
    """Closest point on an axis-aligned box (local frame) to x_local and the
    signed distance (negative inside)."""
    half = _t(half, x_local) * torch.ones_like(x_local)
    clamped = _clip(x_local, -half, half)
    outside = x_local - clamped
    d_out = torch.linalg.vector_norm(outside, dim=-1)
    # inside: distance to the nearest face (negative), closest point on it
    face_gap = half - torch.abs(x_local)
    k = torch.argmin(face_gap, dim=-1)               # first index on ties
    min_gap = torch.amin(face_gap, dim=-1)
    sign = torch.sign(torch.gather(x_local, -1, k[..., None]))[..., 0]
    sign = torch.where(sign == 0, 1.0, sign)
    # replace coordinate k by +-half_k
    onehot = torch.nn.functional.one_hot(k, 3).to(x_local.dtype)
    half_k = torch.gather(half, -1, k[..., None])[..., 0]
    inside_pt = x_local * (1 - onehot) + (sign * half_k)[..., None] * onehot
    is_inside = d_out <= EPS
    closest = torch.where(is_inside[..., None], inside_pt, clamped)
    dist = torch.where(is_inside, -min_gap, d_out)
    return closest, dist


def _inside_normal(x_local, half):
    """Outward normal of the nearest face for a point inside the box."""
    face_gap = _t(half, x_local) - torch.abs(x_local)
    k = torch.argmin(face_gap, dim=-1)
    sign = torch.sign(torch.gather(x_local, -1, k[..., None]))[..., 0]
    sign = torch.where(sign == 0, 1.0, sign)
    onehot = torch.nn.functional.one_hot(k, 3).to(x_local.dtype)
    return onehot * sign[..., None]


def capsule_box_distance(p0, p1, rc, center, Rb, half, n_iter: int = 4):
    """Surface distance + closest points between a capsule and an oriented
    box, and the normal from the box toward the capsule.

    Fixed-point iteration: alternate closest-point projections between the
    segment and the box surface (converges for convex pairs; n_iter static).
    """
    Rt = Rb.transpose(-1, -2)
    rc = _t(rc, p0)
    a, b = _rot(Rt, p0 - center), _rot(Rt, p1 - center)
    x = 0.5 * (a + b)
    for _ in range(n_iter):
        cb, _ = point_box_closest(x, half)
        x = closest_on_segment(a, b, cb)
    cb, sd = point_box_closest(x, half)
    delta = cb - x
    d = torch.linalg.vector_norm(delta, dim=-1)
    outside = sd > 0
    n_loc = torch.where(
        outside[..., None],
        -delta / torch.clamp_min(d, EPS)[..., None],   # box -> segment
        _inside_normal(x, half),
    )
    dist = sd - rc
    n_world = _rot(Rb, n_loc)
    p_on_capsule = (_rot(Rb, x) + center) - n_world * rc[..., None]
    p_on_box = _rot(Rb, cb) + center
    return dist, p_on_capsule, p_on_box, n_world


def sphere_box_distance(center_s, rs, center_b, Rb, half):
    """Surface distance, closest points and normal (box toward sphere)."""
    Rt = Rb.transpose(-1, -2)
    x = _rot(Rt, center_s - center_b)
    cb, sd = point_box_closest(x, half)
    n_loc = torch.where(
        (sd > 0)[..., None],
        (x - cb) / torch.clamp_min(torch.abs(sd), EPS)[..., None],
        _inside_normal(x, half),
    )
    rs = _t(rs, sd)
    n_world = _rot(Rb, n_loc)
    p_on_box = _rot(Rb, cb) + center_b
    p_on_sphere = center_s - n_world * rs[..., None]
    return sd - rs, p_on_sphere, p_on_box, n_world


# ---------------------------------------------------------------------------
# penalty contact force
# ---------------------------------------------------------------------------

def dot3(a, b):
    """a . b over the last axis, added as (x + y) + z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def penalty_force(depth, normal, v_rel, mu):
    """Spring-damper normal force and regularised Coulomb friction.

    depth > 0 is penetration; ``normal`` points from surface A into B (the
    force acts on B); ``v_rel`` is B's velocity relative to A at the contact
    point.  Returns the force on B (..., 3).  The order of operations is
    the JAX package's batched form (scalarized_contact.py:90-100), which
    its free-body step runs."""
    pen = torch.clamp_min(depth, 0.0)
    v_n = dot3(v_rel, normal)
    fn = torch.clamp_min(KN * pen - DN * v_n * (pen > 0), 0.0)
    v_t = v_rel - v_n[..., None] * normal
    vt_norm = torch.sqrt(torch.clamp_min(dot3(v_t, v_t), 0.0))
    # saturated viscous friction: |ft| <= mu fn, linear for small slip
    ft_mag = mu * fn * torch.clamp_max(vt_norm / V_EPS, 1.0)
    inv = 1.0 / torch.clamp_min(vt_norm, EPS)
    return fn[..., None] * normal + (-ft_mag[..., None] * v_t) * inv[..., None]

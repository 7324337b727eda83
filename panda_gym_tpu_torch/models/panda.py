"""Franka Panda ChainModel factories (port of panda_gym_tpu/models/panda.py).

Two gripper variants: ``welded`` (the reference's custom URDF, 7 dofs) and
``prismatic`` (finger joints promoted to prismatic, 9 dofs).  Motor force
clamps follow the reference robot (panda.py:63 joint_forces), not the URDF
efforts.
"""
from __future__ import annotations

import numpy as np

from panda_gym_tpu_torch.models import panda_constants as pc
from panda_gym_tpu_torch.models.chain import ChainModel, build_chain

# distance-observation groups: robot.link_names minus the excluded links
# (reach_ao.py:98-99) -> 9 groups, in link_names order.
COLLISION_GROUPS = tuple(
    n for n in pc.LINK_NAMES if n not in pc.COLLISION_EXCLUDE_LINKS
)

# reference joint_forces (panda.py:63) keyed by joint name
_EFFORTS = {
    "panda_joint1": 87.0, "panda_joint2": 87.0, "panda_joint3": 87.0,
    "panda_joint4": 87.0, "panda_joint5": 12.0, "panda_joint6": 120.0,
    "panda_joint7": 120.0,
    "panda_finger_joint1": 170.0, "panda_finger_joint2": 170.0,
}

# finger contact pads for the prismatic variant (capsule approximations of
# the stock Franka finger: ~16 mm wide pad, 50 mm long).
_FINGER_CAPSULES = [((0.0, 0.0, 0.015), (0.0, 0.0, 0.05), 0.012)]


def make_panda_model(
    base_position=(0.0, 0.0, 0.0), gripper: str = "welded",
    inertia: str = "custom",
) -> ChainModel:
    """inertia="custom": Bullet-equivalent inertias of the custom URDF's
    collision primitives (what the reference envs simulated); "stock": of
    the pybullet_data franka_panda mesh URDF (what the reference's golden
    tests load) — see panda_constants.LINKS."""
    links = pc.LINKS
    if inertia == "stock":
        def _stock(k, m, com, diag):
            diag = pc.BULLET_INERTIA_STOCK.get(k, diag)
            if k in pc.BULLET_STOCK_WRIST_LINKS:
                s = pc.BULLET_STOCK_WRIST_CALIBRATION
                m = m * s
                diag = tuple(x * s for x in diag)
            return (m, com, diag)
        links = {k: _stock(k, m, com, diag)
                 for k, (m, com, diag) in pc.LINKS.items()}
    elif inertia != "custom":
        raise ValueError(f"unknown inertia variant: {inertia}")
    collision = dict(pc.COLLISION_CAPSULES)
    overrides = {}
    if gripper == "prismatic":
        overrides = {
            "panda_finger_joint1": "prismatic",
            "panda_finger_joint2": "prismatic",
        }
        collision["panda_leftfinger"] = _FINGER_CAPSULES
        collision["panda_rightfinger"] = _FINGER_CAPSULES
    elif gripper != "welded":
        raise ValueError(f"unknown gripper variant: {gripper}")

    return build_chain(
        joints=pc.JOINTS,
        links=links,
        root_link="panda_link0",
        collision_capsules=collision,
        collision_groups=COLLISION_GROUPS,
        base_position=base_position,
        actuated_overrides=overrides,
        effort_overrides=_EFFORTS,
    )


EE_SITE = pc.EE_LINK  # 11: CoM of panda_rightfinger (panda.py:68)
NEUTRAL_ARM = np.asarray(pc.NEUTRAL_JOINT_VALUES[:7], dtype=np.float32)

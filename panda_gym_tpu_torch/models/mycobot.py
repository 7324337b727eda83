"""MyCobot 280 6-dof arm model (port of panda_gym_tpu/models/mycobot.py),
the reference's second robot (panda_gym/envs/robots/mycobot.py).

The reference loads "mycobot/mycobot.urdf" through PyBullet's search path
(mycobot.py:52) without shipping it, and passes zero joint forces
(mycobot.py:56), so its motors exert no torque.  The kinematic parameters
below approximate the Elephant Robotics myCobot 280 (about 280 mm reach,
joints yaw-pitch-pitch-pitch-yaw-roll).  Every effort in the table is 0 N m,
the reference's zero forces (the joints drift under gravity).  The tables
are the JAX package's, copied.
"""
import numpy as np

from panda_gym_tpu_torch.models.chain import ChainModel, build_chain

HALF_PI = np.pi / 2.0

# (name, type, parent, child, xyz, rpy, axis, lower, upper, effort, velocity)
JOINTS = [
    ("joint1", "revolute", "base", "link1",
     (0.0, 0.0, 0.13156), (0, 0, 0), (0, 0, 1), -2.88, 2.88, 0.0, 2.0),
    ("joint2", "revolute", "link1", "link2",
     (0.0, 0.0, 0.0), (HALF_PI, 0, 0), (0, 0, 1), -2.88, 2.88, 0.0, 2.0),
    ("joint3", "revolute", "link2", "link3",
     (0.0, -0.1104, 0.0), (0, 0, 0), (0, 0, 1), -2.88, 2.88, 0.0, 2.0),
    ("joint4", "revolute", "link3", "link4",
     (0.0, -0.096, 0.0), (0, 0, 0), (0, 0, 1), -2.88, 2.88, 0.0, 2.0),
    ("joint5", "revolute", "link4", "link5",
     (0.0, -0.07318, 0.0), (-HALF_PI, 0, 0), (0, 0, 1), -2.88, 2.88, 0.0, 2.0),
    ("joint6", "revolute", "link5", "link6",
     (0.0, 0.0456, 0.0), (HALF_PI, 0, 0), (0, 0, 1), -3.05, 3.05, 0.0, 2.0),
    ("ee_joint", "fixed", "link6", "ee",
     (0.0, 0.0, 0.034), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 0.0, 0.0),
]

# link name -> (mass, com, inertia diagonal)
LINKS = {
    "base": (0.3, (0.0, 0.0, 0.05), (0.01, 0.01, 0.01)),
    "link1": (0.25, (0.0, 0.0, -0.03), (0.01, 0.01, 0.01)),
    "link2": (0.2, (0.0, -0.05, 0.0), (0.01, 0.01, 0.01)),
    "link3": (0.15, (0.0, -0.05, 0.0), (0.01, 0.01, 0.01)),
    "link4": (0.1, (0.0, -0.03, 0.0), (0.01, 0.01, 0.01)),
    "link5": (0.1, (0.0, 0.02, 0.0), (0.01, 0.01, 0.01)),
    "link6": (0.05, (0.0, 0.0, 0.01), (0.005, 0.005, 0.005)),
    "ee": (0.0, (0.0, 0.0, 0.0), (0.001, 0.001, 0.001)),
}

COLLISION_CAPSULES = {
    "link1": [((0, 0, -0.10), (0, 0, 0.0), 0.035)],
    "link2": [((0, 0, 0), (0, -0.1104, 0), 0.03)],
    "link3": [((0, 0, 0), (0, -0.096, 0), 0.025)],
    "link4": [((0, 0, 0), (0, -0.0732, 0), 0.02)],
    "link5": [((0, 0, 0), (0, 0.0456, 0), 0.02)],
    "link6": [((0, 0, 0), (0, 0, 0.034), 0.015)],
}

EE_SITE = 6  # the "ee" link (joint order), mycobot.py:60 ee_link = 6
NEUTRAL = np.zeros(6, dtype=np.float32)  # mycobot.py:59


def make_mycobot_model(base_position=(0.0, 0.0, 0.0)) -> ChainModel:
    return build_chain(
        joints=JOINTS, links=LINKS, root_link="base",
        collision_capsules=COLLISION_CAPSULES,
        collision_groups=[f"link{i}" for i in range(1, 7)],
        base_position=base_position,
    )

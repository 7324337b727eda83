"""EnvState / SceneParams: the simulation state of a batch of envs
(port of panda_gym_tpu/sim/state.py:61-202).

The JAX package keeps one env's state in a flax struct and batches it with
vmap.  Here ``EnvState`` is a dataclass of tensors whose leading dimension
is the env batch, with a ``replace`` method in place of the struct's.  It
holds the fields that the Reach family reads and writes; the free-body
fields and the per-env PRNG key are not ported (randomness comes from an
explicit ``torch.Generator``).  ``SceneParams`` stays host-side numpy: it is
static per env class and only ever read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# body shapes
SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CYLINDER = 2


@dataclass(frozen=True)
class SceneParams:
    """Static scene description, shared across the batch (numpy arrays):
    a table box whose top is z=0, a ground plane at plane_z and a fixed
    roster of dynamic bodies (none for Reach)."""

    body_shape: np.ndarray      # (nb,) int32
    body_size: np.ndarray       # (nb, 3)
    body_mass: np.ndarray       # (nb,)
    body_mu: np.ndarray         # (nb,) lateral friction
    body_inertia: np.ndarray    # (nb, 3) diagonal inertia in body frame
    body_samples: np.ndarray    # (nb, K, 4) contact sample points: xyz + radius
    body_sample_mask: np.ndarray  # (nb, K) 1.0 active
    table_half: np.ndarray      # (3,)
    table_center: np.ndarray    # (3,)
    table_mu: np.float32        # lateral friction of the table
    plane_z: np.float32         # ground plane height
    nb: int = 0


@dataclass(frozen=True)
class EnvState:
    """Simulation + task state of B envs; every field has a leading B."""

    # robot
    q: torch.Tensor              # (B, ndof)
    qd: torch.Tensor             # (B, ndof)
    ctrl_target: torch.Tensor    # (B, ndof) motor target (position or velocity)
    # ReachAO obstacles (fixed capacity, active mask)
    obstacle_pos: torch.Tensor   # (B, no, 3)
    obstacle_vel: torch.Tensor   # (B, no, 3)
    obstacle_size: torch.Tensor  # (B, no, 3)
    obstacle_type: torch.Tensor  # (B, no) int32
    obstacle_active: torch.Tensor  # (B, no) bool
    # task
    goal: torch.Tensor           # (B, goal_dim)
    steps: torch.Tensor          # (B,) int32 episode step counter
    is_collided: torch.Tensor    # (B,) bool
    goal_reached: torch.Tensor   # (B,) bool
    # action bookkeeping (panda.py:87-95, 167-172)
    prev_action: torch.Tensor    # (B, na)
    recent_action: torch.Tensor  # (B, na)
    action_count: torch.Tensor   # (B,) int32
    cur_jvel: torch.Tensor       # (B, 7)
    prev_jvel: torch.Tensor      # (B, 7)
    cur_jacc: torch.Tensor       # (B, 7)
    prev_jacc: torch.Tensor      # (B, 7)
    cur_jerk: torch.Tensor       # (B, 7)
    link_obstacle_dist: torch.Tensor  # (B, ngroup)
    past_obs: torch.Tensor       # (B, 3, obs_vec_dim)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    @property
    def batch_size(self) -> int:
        return self.q.shape[0]


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))


# ---------------------------------------------------------------------------
# scene construction helpers (host-side, numpy)
# ---------------------------------------------------------------------------

def _shape_inertia(shape: int, size, mass: float):
    """Diagonal inertia PyBullet derives from the collision shape."""
    x, y, z = size
    if shape == SHAPE_BOX:
        return mass / 3.0 * np.array([y * y + z * z, x * x + z * z, x * x + y * y])
    if shape == SHAPE_SPHERE:
        r = x
        return np.full(3, 0.4 * mass * r * r)
    # cylinder, axis z: r = x, half height = y
    r, hh = x, y
    ixy = mass * (3 * r * r + (2 * hh) ** 2) / 12.0
    return np.array([ixy, ixy, 0.5 * mass * r * r])


def _shape_samples(shape: int, size, k: int = 12):
    """Contact sample points (local xyz + point radius), padded to k."""
    x, y, z = size
    pts = []
    if shape == SHAPE_BOX:
        eps = 0.002  # rounded corners for smooth penalty contact
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    pts.append((sx * (x - eps), sy * (y - eps), sz * (z - eps), eps))
    elif shape == SHAPE_SPHERE:
        pts.append((0.0, 0.0, 0.0, x))
    else:  # cylinder rim: 6 bottom + 6 top points
        r, hh = x, y
        for sz in (-1, 1):
            for i in range(6):
                a = 2 * np.pi * i / 6
                pts.append((r * np.cos(a), r * np.sin(a), sz * hh, 0.0))
    pts = pts[:k]
    mask = [1.0] * len(pts) + [0.0] * (k - len(pts))
    while len(pts) < k:
        pts.append((0.0, 0.0, 0.0, 0.0))
    return np.asarray(pts, dtype=np.float32), np.asarray(mask, dtype=np.float32)


def build_scene(
    bodies,
    table_length: float,
    table_width: float,
    table_height: float,
    table_x_offset: float = 0.0,
    table_mu: float = 0.5,
    plane_z: float = -0.4,
) -> SceneParams:
    """bodies: list of dicts(shape, size, mass, mu).

    Table geometry matches create_table (pybullet.py:780-817): top at z=0,
    centered in y, box center at (x_offset, 0, -height/2).
    """
    nb = len(bodies)
    if nb == 0:
        bodies = [dict(shape=SHAPE_SPHERE, size=(0.0, 0.0, 0.0), mass=1.0, mu=0.5)]
    shp = np.array([b["shape"] for b in bodies], dtype=np.int32)
    size = np.array([b["size"] for b in bodies], dtype=np.float32)
    mass = np.array([b["mass"] for b in bodies], dtype=np.float32)
    mu = np.array([b.get("mu", 0.5) for b in bodies], dtype=np.float32)
    inertia = np.stack([_shape_inertia(int(s), sz, m) for s, sz, m in zip(shp, size, mass)])
    samples, masks = zip(*[_shape_samples(int(s), sz) for s, sz in zip(shp, size)])
    return SceneParams(
        body_shape=np.asarray(shp),
        body_size=np.asarray(size, np.float32),
        body_mass=np.asarray(mass, np.float32),
        body_mu=np.asarray(mu, np.float32),
        body_inertia=np.asarray(inertia, dtype=np.float32),
        body_samples=np.stack(samples).astype(np.float32),
        body_sample_mask=np.stack(masks).astype(np.float32),
        table_half=np.array([table_length, table_width, table_height], np.float32) / 2,
        table_center=np.array([table_x_offset, 0.0, -table_height / 2], np.float32),
        table_mu=np.float32(table_mu),
        plane_z=np.float32(plane_z),
        nb=nb,
    )

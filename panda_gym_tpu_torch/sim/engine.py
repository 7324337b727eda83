"""Batched physics step and per-env-group distances (port of
panda_gym_tpu/sim/engine.py: the contact forces, :38-160, the group
distances, :163-259, make_physics_step, :262-438, and
make_batched_physics_step, :440-523, as one batched engine).

For configurations whose per-substep work is robot-only (no free bodies,
no contact, no per-substep collision check: Reach and friends) the motor
dynamics run through kernel K1 (``ops/cuda_dynamics.py``) on the card, or
its plain version for CPU tensors.  Moving obstacles advance by their
velocity over the policy step.  The ReachAO configuration (a collision
check after every substep) runs ``CollisionPhysics``: K1 once per substep
on the card, and the group distances below, which the observations use
too.  Free bodies (Push, Slide, PickAndPlace, Stack, Flip, and the
stateful Simulation's bodies, also beside obstacles) run
``ContactPhysics``: penalty contact against the ground, the robot's
capsules and the other bodies, the reaction J^T f on the arm, K1 once per
substep with that torque (ops/scalarized_contact.py:135-463 of the JAX
package, in tensor form), and the obstacles' advance and collision check
where there are obstacles.

The JAX package's per-env step (``make_physics_step``) and its batched one
are built to agree; here one engine serves both.  The per-env entry
points (``RobotTaskEnv.step``, the single-env adapters, ``Simulation``)
build their step with ``per_env=True`` and the per-env arguments
(``timestep``, ``gravity``, ``effort``): those steps honour the motor-LCP
mode of ``ops.dynamics.set_lcp_mode``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from panda_gym_tpu_torch.math.transforms import quat_integrate, quat_to_mat
from panda_gym_tpu_torch.models.chain import ChainModel
from panda_gym_tpu_torch.ops import contact as C
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.ops.cuda_dynamics import make_cuda_motor_steps
from panda_gym_tpu_torch.ops.linalg import _hi_prec
from panda_gym_tpu_torch.sim.state import (DEEP_PENETRATION_BLIND, OBS_BOX,
                                           SHAPE_BOX, SHAPE_SPHERE, EnvState,
                                           SceneParams)

TIMESTEP = 1.0 / 500.0  # pybullet.py:50
GRAVITY_Z = -9.81       # pybullet.py:54
# what a distance query reads where it sees no obstacle (the JAX
# package's default, sim/engine.py:163-259)
MAX_DISTANCE = 999.0


def capsule_obstacle_distances(model: ChainModel, cap_p0, cap_p1,
                               state: EnvState,
                               max_distance: float = MAX_DISTANCE):
    """Distance of every capsule to every obstacle, and the closest surface
    point pair: (B, ncap, no), (B, ncap, no, 3) x2.  Inactive obstacles, and
    box obstacles penetrated deeper than the blind margin, read
    ``max_distance``."""
    B, ncap = cap_p0.shape[:2]
    no = state.obstacle_pos.shape[1]
    dev = cap_p0.device
    shape = (B, ncap, no)
    p0 = cap_p0[:, :, None, :].expand(*shape, 3)
    p1 = cap_p1[:, :, None, :].expand(*shape, 3)
    rc = model.tensors(dev)["cap_radius"][None, :, None].expand(shape)
    opos = state.obstacle_pos[:, None].expand(*shape, 3)
    osize = state.obstacle_size[:, None].expand(*shape, 3)

    d_s, pc_s, po_s = C.capsule_sphere_distance(p0, p1, rc, opos,
                                                osize[..., 0])
    eye = torch.eye(3, dtype=p0.dtype, device=dev).expand(*shape, 3, 3)
    d_b, pc_b, po_b, _ = C.capsule_box_distance(p0, p1, rc, opos, eye, osize)

    is_box = (state.obstacle_type == OBS_BOX)[:, None, :]  # (B, 1, no)
    dist = torch.where(is_box, d_b, d_s)                  # (B, ncap, no)
    pc = torch.where(is_box[..., None], pc_b, pc_s)
    po = torch.where(is_box[..., None], po_b, po_s)
    # Bullet's convex-convex queries (box obstacles vs link hulls) return no
    # points for penetrations deeper than the collision margin, so the
    # reference sees max_distance for them, in observations and in
    # check_collided; sphere queries are analytic and always report
    dist = torch.where(is_box & (dist <= -DEEP_PENETRATION_BLIND),
                       max_distance, dist)
    dist = torch.where(state.obstacle_active[:, None, :], dist, max_distance)
    return dist, pc, po


def group_min(model: ChainModel, d, max_distance: float = MAX_DISTANCE):
    """Per-group minimum of per-capsule values, (B, ncap) -> (B, ngroup); a
    group without capsules reads ``max_distance``."""
    idx = model.tensors(d.device)["cap_group_index"].expand_as(d)
    out = d.new_full((d.shape[0], model.ngroup + 1), max_distance)
    return out.scatter_reduce(1, idx, d, "amin")[:, :model.ngroup]


def group_obstacle_distances(model: ChainModel, fk, state: EnvState,
                             max_distance: float = MAX_DISTANCE):
    """Min distance per collision-link group vs all active obstacles, plus
    the closest surface point pair per group, for a batch of envs:
    (B, ngroup), (B, ngroup, 3), (B, ngroup, 3).

    Stands in for pyb_utils' CollisionDetector.compute_distances_per_link
    (reach_ao.py:902-959); the groups are the 9 non-excluded links."""
    cap_p0, cap_p1 = K.capsule_endpoints_world(model, fk)    # (B, ncap, 3)
    dist, pc, po = capsule_obstacle_distances(model, cap_p0, cap_p1, state,
                                              max_distance)
    B, ncap, no = dist.shape
    dev = dist.device
    # each group's argmin over the flat (capsule, obstacle) list, first
    # index on ties; entries of other groups read strictly worse than
    # max_distance, so that the argmin lands on the group's own first
    # candidate even when every candidate is inactive
    group = model.tensors(dev)["cap_group_index"].repeat_interleave(no)
    mine = group[None, :] == torch.arange(model.ngroup, device=dev)[:, None]
    dg = torch.where(mine, dist.reshape(B, 1, ncap * no), max_distance + 1.0)
    i = torch.argmin(dg, dim=2)                                # (B, ngroup)
    pick = i[..., None].expand(B, model.ngroup, 3)
    return (torch.gather(dg, 2, i[..., None])[..., 0],
            torch.gather(pc.reshape(B, ncap * no, 3), 1, pick),
            torch.gather(po.reshape(B, ncap * no, 3), 1, pick))


def table_capsule_distances(model: ChainModel, cap_p0, cap_p1, center, half,
                            max_distance: float = MAX_DISTANCE):
    """Distance of every capsule to the table box (axis-aligned, ``center``
    and ``half`` tensors of 3), (B, ncap); penetrations deeper than the
    blind margin read ``max_distance``."""
    B, ncap = cap_p0.shape[:2]
    eye = torch.eye(3, dtype=cap_p0.dtype, device=cap_p0.device)
    d, _, _, _ = C.capsule_box_distance(
        cap_p0, cap_p1, model.tensors(cap_p0.device)["cap_radius"],
        center.expand(B, ncap, 3), eye.expand(B, ncap, 3, 3),
        half.expand(B, ncap, 3))
    # convex-convex deep-penetration blindness (capsule_obstacle_distances)
    return torch.where(d <= -DEEP_PENETRATION_BLIND, max_distance, d)


def _skip(gd, skip_groups, max_distance):
    for g in skip_groups:
        gd[:, g] = max_distance
    return gd


def group_table_distances(model: ChainModel, fk, scene: SceneParams,
                          skip_groups: Tuple[int, ...] = (0,),
                          max_distance: float = MAX_DISTANCE):
    """Distance of each collision group to the table box, (B, ngroup).

    The reference ignores panda_link0 and panda_link1 here (check_collided's
    ignore_link, reach_ao.py:898); the groups never contain link0, so only
    group 0 (panda_link1) is skipped."""
    cap_p0, cap_p1 = K.capsule_endpoints_world(model, fk)
    dev = cap_p0.device
    d = table_capsule_distances(
        model, cap_p0, cap_p1, torch.as_tensor(scene.table_center, device=dev),
        torch.as_tensor(scene.table_half, device=dev), max_distance)
    return _skip(group_min(model, d, max_distance), skip_groups, max_distance)


# ---------------------------------------------------------------------------
# free bodies: penalty contact forces (engine.py:38-124), batch leading

def _vec(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# The free-body step is stiff (kn = 8000 at dt = 1/500 s) and its friction
# law, explicit in time, amplifies a rounding difference about 1.45-fold per
# substep in a body at rest on the table.  So the sums below keep the
# reference's order of operations (its batched component form,
# ops/scalarized_contact.py), term by term, rather than leave it to a
# reduction kernel: 3-vectors sum as (x + y) + z, and the sums over contact
# samples and capsules run in index order.

def _mv(R, x):
    """R x over the last axes."""
    return torch.stack([C.dot3(R[..., i, :], x) for i in range(3)], -1)


def _mtv(R, x):
    """R^T x over the last axes."""
    return torch.stack([C.dot3(R[..., :, i], x) for i in range(3)], -1)


def _sum_in_order(x, dim: int):
    """The sum over ``dim``, its terms added in index order."""
    out = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        out = out + x.select(dim, k)
    return out


def ground_height(scene: SceneParams, x, y):
    """The table top (z = 0) inside the table's footprint, else the plane
    (engine.py:38-48)."""
    c, h = scene.table_center, scene.table_half
    on_table = ((torch.abs(x - float(c[0])) <= float(h[0]))
                & (torch.abs(y - float(c[1])) <= float(h[1])))
    return torch.where(on_table, 0.0, float(scene.plane_z))


def body_ground_forces(scene: SceneParams, b: int, pos, R, vel, ang):
    """Penalty forces of body b's contact samples against the ground
    (engine.py:51-65): pos, vel, ang (B, 3), R (B, 3, 3) -> force and
    torque about the body's centre, (B, 3) each."""
    samples = _vec(scene.body_samples[b], pos)          # (K, 4)
    mask = _vec(scene.body_sample_mask[b], pos)[:, None]
    p_w = _mv(R[:, None], samples[:, :3]) + pos[:, None]   # (B, K, 3)
    rel = p_w - pos[:, None]
    v_pt = vel[:, None] + C.cross3(ang[:, None].expand_as(rel), rel)
    gz = ground_height(scene, p_w[..., 0], p_w[..., 1])
    depth = gz - (p_w[..., 2] - samples[:, 3])
    n = _vec([0.0, 0.0, 1.0], pos).expand_as(p_w)
    mu = float(scene.body_mu[b]) * float(scene.table_mu)
    f = mask * C.penalty_force(depth, n, v_pt, mu)
    return _sum_in_order(f, 1), _sum_in_order(C.cross3(rel, f), 1)


def robot_body_contact(model: ChainModel, fk, cap_p0, cap_p1,
                       scene: SceneParams, b: int, pos, R, vel, ang):
    """The robot's collision capsules against body b (engine.py:68-124):
    (force on the body, torque on the body, tau_ext on the robot), (B, 3),
    (B, 3), (B, ndof).  The robot takes the reaction as the generalised
    torque sum_i J_i^T (-f_i) over the capsules on a dof body
    (point_jacobian with the capsules' ancestor support).  A cylinder meets
    the robot as its bounding box."""
    T = model.tensors(pos.device)
    rc = T["cap_radius"]
    ncap = rc.shape[0]
    shape = int(scene.body_shape[b])
    size = [float(v) for v in scene.body_size[b]]
    B = pos.shape[0]
    pos_c = pos[:, None].expand(B, ncap, 3)
    if shape == SHAPE_SPHERE:
        dist, pc, pb = C.capsule_sphere_distance(cap_p0, cap_p1, rc, pos_c,
                                                 size[0])
        # the capsule axis -> sphere centre direction: normalising pb - pc
        # would flip it under penetration, turning repulsion into suction
        n_hat = pos_c - C.closest_on_segment(cap_p0, cap_p1, pos_c)
        n_hat = n_hat / torch.clamp_min(
            torch.sqrt(C.dot3(n_hat, n_hat)), C.EPS)[..., None]
    else:
        half = size if shape == SHAPE_BOX else [size[0], size[0], size[1]]
        dist, pc, pb, n_b = C.capsule_box_distance(
            cap_p0, cap_p1, rc, pos_c, R[:, None].expand(B, ncap, 3, 3),
            _vec(half, pos))
        n_hat = -n_b                   # from the robot into the body
    p_contact = 0.5 * (pc + pb)
    on_body = T["cap_on_body"][:, None]
    idx = T["cap_body_index"]
    om_c = torch.where(on_body, fk.om[:, idx], 0.0)
    v_c = torch.where(on_body, fk.v[:, idx], 0.0)
    p_c = torch.where(on_body, fk.p[:, idx], 0.0)
    v_cap = v_c + C.cross3(om_c, p_contact - p_c)
    arm = p_contact - pos_c
    v_body = vel[:, None] + C.cross3(ang[:, None].expand_as(arm), arm)
    # robot links: friction 1.0 (panda.py:69-70)
    f = C.penalty_force(-dist, n_hat, v_body - v_cap,
                        float(scene.body_mu[b]))          # (B, ncap, 3)
    J_v, _ = K.point_jacobian(model, fk, p_contact,
                              _cap_support(model, pos.device))
    tau = (J_v[..., 0, :] * -f[..., 0:1] + J_v[..., 1, :] * -f[..., 1:2]) \
        + J_v[..., 2, :] * -f[..., 2:3]                   # (B, ncap, ndof)
    return (_sum_in_order(f, 1), _sum_in_order(C.cross3(arm, f), 1),
            _sum_in_order(tau, 1))


def body_body_forces(scene: SceneParams, a: int, b: int, pos_a, R_a, vel_a,
                     ang_a, pos_b, R_b, vel_b, ang_b):
    """Body a's contact samples against body b's volume, a sphere or
    else a box of half extents ``body_size[b]`` (engine.py:127-160, in the
    order of the batched form, scalarized_contact.py:290-339): the force and
    torque on a, then on b, (B, 3) each.  The pair's forces are equal and
    opposite; the normal points from b's surface toward a's sample."""
    samples = _vec(scene.body_samples[a], pos_a)          # (K, 4)
    mask = _vec(scene.body_sample_mask[a], pos_a)[:, None]
    rad = samples[:, 3]
    p_w = _mv(R_a[:, None], samples[:, :3]) + pos_a[:, None]   # (B, K, 3)
    size_b = [float(v) for v in scene.body_size[b]]
    if int(scene.body_shape[b]) == SHAPE_SPHERE:
        delta = p_w - pos_b[:, None]
        dn = torch.sqrt(torch.clamp_min(C.dot3(delta, delta), 0.0))
        n_ba = delta / torch.clamp_min(dn, C.EPS)[..., None]
        dist = (dn - size_b[0]) - rad
    else:
        x = _mtv(R_b[:, None], p_w - pos_b[:, None])
        cb, sd = C.point_box_closest(x, size_b)
        out_n = (x - cb) / torch.clamp_min(torch.abs(sd), C.EPS)[..., None]
        n_loc = torch.where((sd > 0)[..., None], out_n,
                            C._inside_normal(x, size_b))
        n_ba = _mv(R_b[:, None], n_loc)
        dist = sd - rad
    rel_a = p_w - pos_a[:, None]
    rel_b = p_w - pos_b[:, None]
    v_pt_a = vel_a[:, None] + C.cross3(ang_a[:, None].expand_as(rel_a), rel_a)
    v_pt_b = vel_b[:, None] + C.cross3(ang_b[:, None].expand_as(rel_b), rel_b)
    mu = float(scene.body_mu[a]) * float(scene.body_mu[b])
    f_a = mask * C.penalty_force(-dist, n_ba, v_pt_a - v_pt_b, mu)
    force_a = _sum_in_order(f_a, 1)
    return (force_a, _sum_in_order(C.cross3(rel_a, f_a), 1), -force_a,
            _sum_in_order(C.cross3(rel_b, -f_a), 1))


def _cap_support(model: ChainModel, device):
    """(ncap, ndof) bools: the dofs that carry each capsule's body; none for
    a capsule on the base (scalarized_contact.py:171-177)."""
    T = model.tensors(device)
    if "cap_support" not in T:
        T["cap_support"] = torch.tensor(
            [K.dof_support(model, b) if b >= 0 else [False] * model.ndof
             for b in model.cap_body_tuple], device=device)
    return T["cap_support"]


def _keep(frozen, old, new):
    """``old`` where the env is frozen ((B,) bools), else ``new``."""
    return torch.where(frozen.view((-1,) + (1,) * (new.dim() - 1)), old, new)


class _Physics:
    """What the three physics steps share: the motor substep's constants
    (``dt``, ``gravity``, ``effort``) and its route.

    ``gravity`` (3 floats, None for (0, 0, -9.81)) and ``effort`` (ndof
    floats, None for the model's motor force clamps) are those of the JAX
    package's per-env step (sim/engine.py:262-297), which the stateful
    ``Simulation`` sets.  ``per_env``: the step serves a per-env entry point
    (``RobotTaskEnv.step``, ``GymAdapter``, ``Simulation``), which honours
    ``dynamics.set_lcp_mode("pgs")`` as the JAX package's per-env path does:
    under "pgs" its motor substeps run the plain projected Gauss-Seidel
    solve (``dynamics.motor_substep``) on any device, since no TPU kernel
    computes PGS, and K1 stays the exact solve.  The batched training and
    evaluation steps (``per_env`` False) ignore the mode."""

    def __init__(self, model: ChainModel, *, n_substeps: int, ctrl_mode: int,
                 timestep: float, gravity, effort, per_env: bool):
        self.model = model
        self.n_substeps = n_substeps
        self.ctrl_mode = ctrl_mode
        self.dt = float(timestep)
        self.gravity = None if gravity is None else tuple(
            float(g) for g in np.asarray(gravity, np.float32))
        self.effort = None if effort is None else np.asarray(effort,
                                                             np.float32)
        self.per_env = bool(per_env)

    def _motor(self, n_substeps: int, warm_start: bool):
        return make_cuda_motor_steps(
            self.model, n_substeps=n_substeps, dt=self.dt,
            ctrl_mode=self.ctrl_mode, warm_start=warm_start,
            gravity=self.gravity, effort=self.effort)

    @property
    def pgs(self) -> bool:
        """Whether this step runs the PGS motor solve now."""
        return self.per_env and D.LCP_MODE == "pgs"

    @property
    def route(self) -> str:
        """"k1" (the exact solve: K1 on the card, its plain version on the
        CPU) or "pgs" (plain PyTorch on any device)."""
        return "pgs" if self.pgs else "k1"

    def pgs_substep(self, q, qd, tgt, tau_ext=None, warm=None):
        """One PGS motor substep, (q, qd, None): the substep signature of
        the K1 wrapper's, the carried set unused (PGS keeps none)."""
        kw = {} if self.gravity is None else {"gravity": self.gravity}
        q, qd = D.motor_substep(self.model, q, qd, tgt, self.dt,
                                self.ctrl_mode, tau_ext=tau_ext,
                                effort=self.effort, **kw)
        return q, qd, None

    def _gravity_vec(self, like):
        return _vec((0.0, 0.0, GRAVITY_Z) if self.gravity is None
                    else self.gravity, like)


class CollisionCheck:
    """The collision check after a substep (engine.py:367-398): the
    per-group distances to the obstacles and to the table at the moved
    pose, and whether any group but 0 (panda_link1) comes within
    ``safety_distance``."""

    def __init__(self, model: ChainModel, scene: SceneParams,
                 safety_distance: float = 0.0):
        self.model = model
        self.scene = scene
        self.safety_distance = safety_distance
        self._table = {}

    def distances(self, q, states: EnvState):
        """Per-group obstacle and table distances at pose q against the
        obstacles of ``states``: (B, ngroup) x2, the table's without group 0
        (panda_link1; group_table_distances)."""
        model, far = self.model, MAX_DISTANCE
        p0, p1 = K.capsule_endpoints_world(model, K.fk_world(model, q))
        d, _, _ = capsule_obstacle_distances(model, p0, p1, states, far)
        gd = group_min(model, torch.amin(d, dim=2), far)
        dev = str(q.device)
        if dev not in self._table:
            self._table[dev] = [torch.as_tensor(v, device=q.device) for v in
                                (self.scene.table_center,
                                 self.scene.table_half)]
        td = table_capsule_distances(model, p0, p1, *self._table[dev], far)
        td = _skip(group_min(model, td, far), (0,), far)
        return gd, td

    def __call__(self, q, states: EnvState):
        """(group obstacle distances (B, ngroup), hit (B,) bools)."""
        gd, td = self.distances(q, states)
        # skip group 0 (panda_link1); deep box penetrations already read as
        # far upstream (Bullet convex-margin blindness); link1 distances
        # stay in the per-link observation vector
        least = torch.minimum(torch.amin(gd[:, 1:], dim=1),
                              torch.amin(td, dim=1))
        return gd, least <= self.safety_distance


class ContactPhysics(_Physics):
    """``states -> states`` after one policy step of free-body physics
    (scalarized_contact.py:135-463, engine.py:294-365).  Per substep, in the
    reference's order: FK with velocities, the ground forces on every body,
    the robot's capsules against every body (forces, and the reaction
    tau_ext on the arm), the forces between the bodies of each pair in
    ``body_pairs`` (a's samples against b's volume), semi-implicit Euler of
    the bodies, the obstacles' advance by dt * velocity (``moving_obstacles``),
    then the motor substep with tau_ext, and with ``check_collision`` the
    collision check of the moved robot against the moved obstacles: the
    group distances, the sticky flag, and the freeze of envs that collided
    before the substep (``freeze_on_collision``), as engine.py:299-400 orders
    them.  No task combines free bodies with obstacles; the stateful
    ``Simulation`` does, with a box on the table beside an obstacle.

    The motor substep is K1 launched once per substep on a CUDA tensor (its
    wrapper ``motor``, whose ``launches`` count its runs), with tau_ext and,
    warm, the active set carried from launch to launch after one seed
    launch: 21 launches per step at 20 substeps; a CPU tensor runs the plain
    ``motor_substep``.  Nothing falls back from the one to the other.

    warm_start: warm without a collision check and cold with one (the
    defaults of engine.py:make_physics_step; PANDA_LCP_WARM=0/1 overrides),
    as dynamics.lcp_warm_default resolves it: the seed, a cold solve of the
    first substep's system, ignores tau_ext, so a set change that the
    contact causes lands one substep late, as in the reference."""

    def __init__(self, model: ChainModel, scene: SceneParams, *,
                 n_substeps: int, ctrl_mode: int, robot_contact: bool,
                 body_pairs: Sequence[Tuple[int, int]] = (),
                 warm_start: Optional[bool] = None,
                 check_collision: bool = False,
                 collision_safety_distance: float = 0.0,
                 freeze_on_collision: bool = True,
                 moving_obstacles: bool = False,
                 timestep: float = TIMESTEP, gravity=None, effort=None,
                 per_env: bool = False):
        super().__init__(model, n_substeps=n_substeps, ctrl_mode=ctrl_mode,
                         timestep=timestep, gravity=gravity, effort=effort,
                         per_env=per_env)
        self.body_pairs = tuple((int(a), int(b)) for a, b in body_pairs)
        self.scene = scene
        self.robot_contact = robot_contact
        self.moving_obstacles = moving_obstacles
        self.freeze_on_collision = freeze_on_collision
        self.check = (CollisionCheck(model, scene, collision_safety_distance)
                      if check_collision else None)
        self.warm_start = (D.lcp_warm_default(not check_collision)
                           if warm_start is None else bool(warm_start))
        self.motor = self._motor(1, False)

    def forces(self, q, qd, pos, quat, vel, ang):
        """Contact forces and torques on the bodies, (B, nb, 3) each,
        tau_ext on the robot, (B, ndof), and the bodies' rotations, at one
        substep's state."""
        R = quat_to_mat(quat)
        forces, torques = [], []
        tau_ext = torch.zeros_like(q)
        fk = caps = None
        if self.robot_contact:
            fk = K.fk_world(self.model, q, qd)
            caps = K.capsule_endpoints_world(self.model, fk)
        for b in range(self.scene.nb):
            args = (pos[:, b], R[:, b], vel[:, b], ang[:, b])
            f, t = body_ground_forces(self.scene, b, *args)
            if self.robot_contact:
                fr, tr, te = robot_body_contact(self.model, fk, *caps,
                                                self.scene, b, *args)
                f, t, tau_ext = f + fr, t + tr, tau_ext + te
            forces.append(f)
            torques.append(t)
        for a, b in self.body_pairs:
            fa, ta, fb, tb = body_body_forces(
                self.scene, a, b, pos[:, a], R[:, a], vel[:, a], ang[:, a],
                pos[:, b], R[:, b], vel[:, b], ang[:, b])
            forces[a], torques[a] = forces[a] + fa, torques[a] + ta
            forces[b], torques[b] = forces[b] + fb, torques[b] + tb
        return torch.stack(forces, 1), torch.stack(torques, 1), tau_ext, R

    def integrate(self, pos, quat, vel, ang, force, torque, R):
        """Semi-implicit Euler of the free bodies (engine.py:330-346); the
        world inertia is inverted as R diag(1/I) R^T, never by cofactors
        (scalarized_contact.py:388-402)."""
        dt, nb = self.dt, self.scene.nb
        inv_m = _vec([1.0 / float(m) for m in self.scene.body_mass[:nb]],
                     pos)[:, None]
        inertia = _vec(self.scene.body_inertia[:nb], pos)     # (nb, 3)
        inv_i = _vec(1.0 / np.maximum(np.asarray(
            self.scene.body_inertia[:nb], np.float64), 1e-12), pos)
        v = vel + dt * (force * inv_m + self._gravity_vec(pos))
        p = pos + dt * v
        # I_w = (R diag(I)) R^T, then I_w om
        RI = R * inertia[:, None, :]
        I_w = torch.stack([torch.stack([C.dot3(RI[..., i, :], R[..., k, :])
                                        for k in range(3)], -1)
                           for i in range(3)], -2)
        rhs = torque - C.cross3(ang, _mv(I_w, ang))
        om = ang + dt * _mv(R, _mtv(R, rhs) * inv_i)
        return p, quat_integrate(quat, om, dt), v, om

    @_hi_prec
    def __call__(self, states: EnvState, plain: bool = False) -> EnvState:
        """``states -> states`` after one policy step.  ``plain`` runs the
        motor's plain seed and substep on any device (the card checks hold
        K1 against it)."""
        motor = self.motor
        if self.pgs:
            seed, substep = None, self.pgs_substep
        else:
            seed = motor.plain_seed if plain else motor.seed
            substep = motor.plain_substep if plain else motor.substep
        q = states.q.contiguous()
        qd = states.qd.contiguous()
        tgt = states.ctrl_target.contiguous()
        pos, quat = states.body_pos, states.body_quat
        vel, ang = states.body_vel, states.body_ang
        step_vel = self.dt * states.obstacle_vel
        s = states
        warm = seed(q, qd, tgt) if self.warm_start and seed else None
        for _ in range(self.n_substeps):
            force, torque, tau_ext, R = self.forces(q, qd, pos, quat, vel,
                                                    ang)
            new = self.integrate(pos, quat, vel, ang, force, torque, R)
            opos = (s.obstacle_pos + step_vel if self.moving_obstacles
                    else s.obstacle_pos)
            q_n, qd_n, warm = substep(q, qd, tgt, tau_ext.contiguous(), warm)
            new = (q_n, qd_n) + new
            if self.check is not None:
                gd, hit = self.check(q_n, s.replace(obstacle_pos=opos))
                collided = s.is_collided | hit
                if self.freeze_on_collision:
                    # once collided, the state stops evolving and the link
                    # distances keep the colliding substep's values
                    frz = s.is_collided
                    new = tuple(_keep(frz, o, n) for o, n in
                                zip((q, qd, pos, quat, vel, ang), new))
                    opos = _keep(frz, s.obstacle_pos, opos)
                    gd = _keep(frz, s.link_obstacle_dist, gd)
                s = s.replace(is_collided=collided, link_obstacle_dist=gd)
            q, qd, pos, quat, vel, ang = new
            s = s.replace(obstacle_pos=opos)
        return s.replace(q=q, qd=qd, body_pos=pos, body_quat=quat,
                         body_vel=vel, body_ang=ang)


class RobotOnlyPhysics(_Physics):
    """``states -> states`` after one policy step of robot-only physics.
    ``motor`` is the K1 wrapper, warm-started as the TPU kernel always is
    (unless ``warm_start`` says otherwise); its ``launches`` count the
    kernel's runs."""

    def __init__(self, model: ChainModel, *, n_substeps: int, ctrl_mode: int,
                 moving_obstacles: bool, timestep: float = TIMESTEP,
                 gravity=None, effort=None, warm_start: Optional[bool] = None,
                 per_env: bool = False):
        super().__init__(model, n_substeps=n_substeps, ctrl_mode=ctrl_mode,
                         timestep=timestep, gravity=gravity, effort=effort,
                         per_env=per_env)
        self.moving_obstacles = moving_obstacles
        self.motor = self._motor(n_substeps, True if warm_start is None
                                 else bool(warm_start))

    def __call__(self, states: EnvState, plain: bool = False) -> EnvState:
        """``states -> states`` after one policy step.  ``plain`` runs the
        motor's plain version on any device (the card checks hold K1
        against it)."""
        q, qd = states.q.contiguous(), states.qd.contiguous()
        tgt = states.ctrl_target.contiguous()
        if self.pgs:
            for _ in range(self.n_substeps):
                q, qd, _ = self.pgs_substep(q, qd, tgt)
        else:
            q, qd = (self.motor.plain if plain else self.motor)(q, qd, tgt)
        upd = dict(q=q, qd=qd)
        if self.moving_obstacles:
            upd["obstacle_pos"] = (
                states.obstacle_pos
                + (self.n_substeps * self.dt) * states.obstacle_vel)
        return states.replace(**upd)


class CollisionPhysics(_Physics):
    """``states -> states`` after one policy step of ReachAO physics:
    ``n_substeps`` substeps, each the motor substep, the obstacle advance,
    the collision check of the moved robot against the moved obstacles and
    the table, and the freeze of envs that collided before it (the
    check_collision branch of engine.py:make_physics_step, batched; the JAX
    package's batched twin is ops/scalarized_collision.py:266-406).

    The motor substep is the one part whose route depends on the device
    (``motor_substep_step``): ``motor``, kernel K1 at ``n_substeps=1``,
    launched once per substep on a CUDA tensor, whose ``launches`` count its
    runs; the plain ``motor_substep`` on a CPU tensor.  Nothing falls back
    from the one to the other.

    warm_start: cold solve in every substep (the default on this path, as
    in the JAX package; PANDA_LCP_WARM=0/1 overrides), or warm from an
    active set that one cold solve seeds (K1's seed launch on the card) and
    the substeps carry from launch to launch."""

    def __init__(self, model: ChainModel, scene: SceneParams, *,
                 n_substeps: int, ctrl_mode: int,
                 collision_safety_distance: float = 0.0,
                 freeze_on_collision: bool = True,
                 moving_obstacles: bool = False,
                 warm_start: Optional[bool] = None,
                 timestep: float = TIMESTEP, gravity=None, effort=None,
                 per_env: bool = False):
        super().__init__(model, n_substeps=n_substeps, ctrl_mode=ctrl_mode,
                         timestep=timestep, gravity=gravity, effort=effort,
                         per_env=per_env)
        self.collision_safety_distance = collision_safety_distance
        self.freeze_on_collision = freeze_on_collision
        self.moving_obstacles = moving_obstacles
        self.warm_start = (D.lcp_warm_default(False) if warm_start is None
                           else bool(warm_start))
        self.scene = scene
        self.check = CollisionCheck(model, scene, collision_safety_distance)
        self.motor = self._motor(1, False)

    # ------------------------------------------------------------ motor
    def motor_substep_step(self, q, qd, tgt, warm=None):
        """One motor substep of (B, ndof) tensors -> (q, qd, warm): cold
        when ``warm`` is None, else from the carried active set, which it
        returns updated.  A CUDA tensor launches K1 once (it raises if the
        kernel does not build or launch); a CPU tensor runs the plain
        substep (``plain_substep_step``)."""
        return self.motor.substep(q, qd, tgt, None, warm)

    def plain_substep_step(self, q, qd, tgt, warm=None):
        """The plain ``motor_substep`` on any device, as
        ``motor_substep_step``."""
        return self.motor.plain_substep(q, qd, tgt, None, warm)

    # ------------------------------------------------------------ check
    def substep_distances(self, q, states: EnvState):
        """Per-group obstacle and table distances at pose q
        (``CollisionCheck.distances``)."""
        return self.check.distances(q, states)

    def __call__(self, states: EnvState, plain: bool = False) -> EnvState:
        """``states -> states`` after one policy step.  ``plain`` runs the
        motor's plain seed and substep on any device (the card checks hold
        K1 against it)."""
        if self.pgs:
            seed = None
            substep = lambda q, qd, tgt, warm: self.pgs_substep(  # noqa: E731
                q, qd, tgt)
        else:
            substep = (self.plain_substep_step if plain
                       else self.motor_substep_step)
            seed = self.motor.plain_seed if plain else self.motor.seed
        q = states.q.contiguous()
        qd = states.qd.contiguous()
        tgt = states.ctrl_target.contiguous()
        step_vel = self.dt * states.obstacle_vel
        warm = seed(q, qd, tgt) if self.warm_start and seed else None
        s = states
        for _ in range(self.n_substeps):
            # robot substep (motor semantics), then the kinematic obstacle
            # advance, as engine.substep orders them
            q_new, qd_new, warm = substep(q, qd, tgt, warm)
            opos_new = (s.obstacle_pos + step_vel if self.moving_obstacles
                        else s.obstacle_pos)
            # collision check on the moved robot + moved obstacles
            gd, hit = self.check(q_new, s.replace(obstacle_pos=opos_new))
            collided = s.is_collided | hit
            if self.freeze_on_collision:
                # once collided, q/qd/obstacles stop evolving and link
                # distances keep the colliding substep's values
                # (reach_ao.py:182-188 early break)
                frz = s.is_collided[:, None]
                q = torch.where(frz, q, q_new)
                qd = torch.where(frz, qd, qd_new)
                if self.moving_obstacles:
                    opos_new = torch.where(frz[:, :, None], s.obstacle_pos,
                                           opos_new)
                gd = torch.where(frz, s.link_obstacle_dist, gd)
            else:
                q, qd = q_new, qd_new
            s = s.replace(obstacle_pos=opos_new, is_collided=collided,
                          link_obstacle_dist=gd)
        return s.replace(q=q, qd=qd)


def make_batched_physics_step(
    model: ChainModel,
    scene: SceneParams,
    *,
    n_substeps: int = 20,
    ctrl_mode: int = D.CTRL_POSITION,
    robot_contact: bool = False,
    body_pairs: Sequence[Tuple[int, int]] = (),
    check_collision: bool = False,
    collision_safety_distance: float = 0.0,
    freeze_on_collision: bool = True,
    has_bodies: bool = True,
    moving_obstacles: bool = False,
    timestep: float = TIMESTEP,
    gravity=None,
    effort=None,
    warm_start: Optional[bool] = None,
    per_env: bool = False,
):
    """Batch-native physics step over a batched EnvState: n_substeps of
    ``timestep`` (pybullet dt semantics; defaults 20 x 1/500 s).

    The arguments of the JAX package's per-env ``make_physics_step``
    (engine.py:262-297): ``gravity`` (3 floats; None for (0, 0, -9.81),
    which keeps K1's constants), ``effort`` (the per-joint motor force
    clamps; None for the model's URDF efforts) and ``warm_start`` (None for
    each path's default, dynamics.lcp_warm_default).  ``per_env`` builds
    the step of a per-env entry point, which honours
    ``dynamics.set_lcp_mode`` (``_Physics``)."""
    kw = dict(n_substeps=n_substeps, ctrl_mode=ctrl_mode, timestep=timestep,
              gravity=gravity, effort=effort, warm_start=warm_start,
              per_env=per_env)
    if has_bodies and scene.nb > 0:
        return ContactPhysics(
            model, scene, robot_contact=robot_contact, body_pairs=body_pairs,
            check_collision=check_collision,
            collision_safety_distance=collision_safety_distance,
            freeze_on_collision=freeze_on_collision,
            moving_obstacles=moving_obstacles, **kw)
    if check_collision:
        return CollisionPhysics(
            model, scene, collision_safety_distance=collision_safety_distance,
            freeze_on_collision=freeze_on_collision,
            moving_obstacles=moving_obstacles, **kw)
    return RobotOnlyPhysics(model, moving_obstacles=moving_obstacles, **kw)

"""Batched physics step and per-env-group distances (port of
panda_gym_tpu/sim/engine.py:163-259, of the robot-only branch of
make_batched_physics_step, :440-523, and of the check_collision branch of
make_physics_step, :260-438, batched).

For configurations whose per-substep work is robot-only (no free bodies, no
contact, no per-substep collision check: Reach and friends) the motor
dynamics run through kernel K1 (``ops/cuda_dynamics.py``) on the card, or
its plain version for CPU tensors.  Moving obstacles advance by their
velocity over the policy step.  The ReachAO configuration (a collision
check after every substep) runs ``CollisionPhysics``: K1 once per substep
on the card, and the group distances below, which the observations use
too.  The free-body branch is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from panda_gym_tpu_torch.models.chain import ChainModel
from panda_gym_tpu_torch.ops import contact as C
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.ops import scalarized as S
from panda_gym_tpu_torch.ops.cuda_dynamics import make_cuda_motor_steps
from panda_gym_tpu_torch.sim.state import (DEEP_PENETRATION_BLIND, OBS_BOX,
                                           EnvState, SceneParams)

TIMESTEP = 1.0 / 500.0  # pybullet.py:50
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


class RobotOnlyPhysics:
    """``states -> states`` after one policy step of robot-only physics.
    ``motor`` is the K1 wrapper, warm-started as the TPU kernel always is;
    its ``launches`` count the kernel's runs."""

    def __init__(self, model: ChainModel, *, n_substeps: int, ctrl_mode: int,
                 moving_obstacles: bool):
        self.n_substeps = n_substeps
        self.moving_obstacles = moving_obstacles
        self.motor = make_cuda_motor_steps(
            model, n_substeps=n_substeps, dt=TIMESTEP, ctrl_mode=ctrl_mode,
            warm_start=True)

    def __call__(self, states: EnvState) -> EnvState:
        q, qd = self.motor(states.q.contiguous(), states.qd.contiguous(),
                           states.ctrl_target.contiguous())
        upd = dict(q=q, qd=qd)
        if self.moving_obstacles:
            upd["obstacle_pos"] = (
                states.obstacle_pos
                + (self.n_substeps * TIMESTEP) * states.obstacle_vel)
        return states.replace(**upd)


class CollisionPhysics:
    """``states -> states`` after one policy step of ReachAO physics:
    ``n_substeps`` substeps, each the motor substep, the obstacle advance,
    the collision check of the moved robot against the moved obstacles and
    the table, and the freeze of envs that collided before it (the
    check_collision branch of engine.py:make_physics_step, batched; the JAX
    package's batched twin is ops/scalarized_collision.py:266-406).

    The motor substep is the one part whose route depends on the device
    (``motor_substep_step``): ``motor``, kernel K1 at ``n_substeps=1`` and
    cold, launched once per substep on a CUDA tensor, whose ``launches``
    count its runs; the plain ``motor_substep`` on a CPU tensor.  Nothing
    falls back from the one to the other.

    warm_start: cold solve in every substep (the default on this path, as
    in the JAX package; PANDA_LCP_WARM=0/1 overrides), or warm from an
    active set that one cold solve seeds and the substeps carry.  Only the
    plain route runs warm: K1 cannot carry the set from one launch to the
    next, so on a CUDA tensor warm raises NotImplementedError."""

    def __init__(self, model: ChainModel, scene: SceneParams, *,
                 n_substeps: int, ctrl_mode: int,
                 collision_safety_distance: float = 0.0,
                 freeze_on_collision: bool = True,
                 moving_obstacles: bool = False,
                 warm_start: Optional[bool] = None):
        self.model = model
        self.mc = S.consts_from_model(model)
        self.n_substeps = n_substeps
        self.dt = TIMESTEP
        self.ctrl_mode = ctrl_mode
        self.collision_safety_distance = collision_safety_distance
        self.freeze_on_collision = freeze_on_collision
        self.moving_obstacles = moving_obstacles
        self.warm_start = (D.lcp_warm_default(False) if warm_start is None
                           else bool(warm_start))
        self.scene = scene
        self._table = {}
        self.motor = make_cuda_motor_steps(
            model, n_substeps=1, dt=TIMESTEP, ctrl_mode=ctrl_mode,
            warm_start=False)

    # ------------------------------------------------------------ motor
    def motor_substep_step(self, q, qd, tgt, warm=None):
        """One motor substep of (B, ndof) tensors -> (q, qd, warm).

        A CUDA tensor launches K1 once (it raises if the kernel does not
        build or launch) and carries no active set; a CPU tensor runs the
        plain substep (``plain_substep_step``)."""
        if q.device.type == "cuda":
            if self.warm_start:
                raise NotImplementedError(
                    "the warm motor LCP on the collision step needs K1 to "
                    "carry the active set from one launch to the next; run "
                    "it cold (PANDA_LCP_WARM unset or 0)")
            q, qd = self.motor(q, qd, tgt)
            return q, qd, None
        return self.plain_substep_step(q, qd, tgt, warm)

    def plain_substep_step(self, q, qd, tgt, warm=None):
        """The plain ``motor_substep`` on any device: cold when ``warm`` is
        None, else warm from the carried active set, which it returns."""
        n = self.mc.ndof
        args = ([q[:, d] for d in range(n)], [qd[:, d] for d in range(n)],
                [tgt[:, d] for d in range(n)], self.dt, self.ctrl_mode)
        if warm is None:
            q2, qd2 = S.motor_substep(self.mc, *args)
        else:
            q2, qd2, warm = S.motor_substep(self.mc, *args, warm=warm)
        return torch.stack(q2, -1), torch.stack(qd2, -1), warm

    def warm_seed(self, q, qd, tgt):
        """The warm route's first active set: a cold solve of the first
        substep's system, its state discarded (engine.py:415-427); None in
        cold mode."""
        if not self.warm_start:
            return None
        n = self.mc.ndof
        _, _, warm = S.motor_substep(
            self.mc, [q[:, d] for d in range(n)],
            [qd[:, d] for d in range(n)], [tgt[:, d] for d in range(n)],
            self.dt, self.ctrl_mode, return_warm=True)
        return warm

    # ------------------------------------------------------------ check
    def substep_distances(self, q, states: EnvState):
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

    def __call__(self, states: EnvState, substep=None) -> EnvState:
        """``states -> states`` after one policy step.  ``substep`` is the
        motor substep route, ``motor_substep_step`` unless given (the card
        checks hold K1 against ``plain_substep_step`` through it)."""
        substep = substep or self.motor_substep_step
        q = states.q.contiguous()
        qd = states.qd.contiguous()
        tgt = states.ctrl_target.contiguous()
        step_vel = self.dt * states.obstacle_vel
        warm = self.warm_seed(q, qd, tgt)
        s = states
        for _ in range(self.n_substeps):
            # robot substep (motor semantics), then the kinematic obstacle
            # advance, as engine.substep orders them
            q_new, qd_new, warm = substep(q, qd, tgt, warm)
            opos_new = (s.obstacle_pos + step_vel if self.moving_obstacles
                        else s.obstacle_pos)
            # collision check on the moved robot + moved obstacles
            gd, td = self.substep_distances(
                q_new, s.replace(obstacle_pos=opos_new))
            # skip group 0 (panda_link1); deep box penetrations already
            # read as far upstream (Bullet convex-margin blindness); link1
            # distances stay in the per-link observation vector
            least = torch.minimum(torch.amin(gd[:, 1:], dim=1),
                                  torch.amin(td, dim=1))
            collided = s.is_collided | (least
                                        <= self.collision_safety_distance)
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
):
    """Batch-native physics step over a batched EnvState."""
    if has_bodies and scene.nb > 0:
        raise NotImplementedError(
            "free-body contact physics is not ported yet (ROADMAP item 13)")
    if check_collision:
        return CollisionPhysics(
            model, scene, n_substeps=n_substeps, ctrl_mode=ctrl_mode,
            collision_safety_distance=collision_safety_distance,
            freeze_on_collision=freeze_on_collision,
            moving_obstacles=moving_obstacles)
    return RobotOnlyPhysics(model, n_substeps=n_substeps, ctrl_mode=ctrl_mode,
                            moving_obstacles=moving_obstacles)

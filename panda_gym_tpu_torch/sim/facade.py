"""Stateful simulation facade: the reference `PyBullet` class surface (port
of panda_gym_tpu/sim/facade.py).

The port's native API is the batched core (`envs/core.py`).  This module
offers the other entry point a reference user expects: a mutable,
name-addressed simulation object with the method surface of the reference's
`panda_gym/pybullet.py::PyBullet` wrapper: body registry, substepped
stepping, geometry factory, joint get/set/control, IK, save/restore,
scenario loading, friction setters, debug items, software render.

Design: the facade keeps a host-side scene description (Python lists) and a
current `EnvState`, a batch of one on the facade's device; every scene
mutation drops the physics step, which is rebuilt on the next `step()`
(scene edits happen at env-construction time in the reference too: bodies
are created once, then stepped).  The step is the port's engine
(`sim/engine.py::make_batched_physics_step`) with the facade's `timestep`,
`gravity` and motor force clamps, the collision check of the obstacles
without the freeze, and the motor-LCP mode of `ops.dynamics.set_lcp_mode`
honoured: on the card in the default "exact" mode its motor substeps are
kernel K1.  Every getter reads the device (a host copy per call).

Method citations refer to the reference file `panda_gym/pybullet.py`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import resolve_device
from panda_gym_tpu_torch.math.transforms import (mat_to_quat, quat_from_euler,
                                                 quat_to_euler)
from panda_gym_tpu_torch.models.chain import ChainModel, pybullet_dof_index
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.sim import engine
from panda_gym_tpu_torch.sim.state import (EnvState, OBS_BOX, OBS_SPHERE,
                                           SHAPE_BOX, SHAPE_CYLINDER,
                                           SHAPE_SPHERE, build_scene)


def _host(x) -> np.ndarray:
    """Env 0 of a batched tensor as a writable numpy array."""
    return np.array(x[0].detach().cpu().numpy())


class Simulation:
    """Equivalent of `PyBullet.__init__` (pybullet.py:25-61).

    Args mirror the reference: render toggles nothing here (rendering is
    always available, software-side); n_substeps and timestep define the
    control dt exactly as pybullet.py:50,63-66.  ``device`` is the card
    unless the caller passes "cpu"."""

    def __init__(self, render: bool = False, n_substeps: int = 20,
                 timestep: float = 1.0 / 500.0,
                 gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81),
                 device="cuda"):
        self.device = resolve_device(device)
        self.render_enabled = render
        self.n_substeps = n_substeps
        self.timestep = timestep
        self.gravity = tuple(float(g) for g in gravity)

        # body registries: name -> record
        self._bodies_idx: Dict[str, dict] = {}   # mirrors pybullet.py:55
        self._robot_model: Optional[ChainModel] = None
        self._robot_name: Optional[str] = None
        self._ctrl_mode = D.CTRL_POSITION

        # world params (table/plane appear when created)
        self._table = None            # (length, width, height, x_offset, mu)
        self._plane_z = -10.0         # far below until create_plane

        # live state
        self._q = np.zeros(0)
        self._qd = np.zeros(0)
        self._ctrl_target = np.zeros(0)
        self._ctrl_force = np.zeros(0)   # per-joint motor force clamps
        self._saved: Dict[int, EnvState] = {}
        self._next_state_id = 0
        self._debug_texts: Dict[str, dict] = {}
        self._debug_lines: List[dict] = []

        self._state: Optional[EnvState] = None
        self._physics = None          # the step; None = needs rebuild

    # ------------------------------------------------------------- timing
    @property
    def dt(self) -> float:
        """Policy-step duration: timestep * n_substeps (pybullet.py:63-66)."""
        return self.timestep * self.n_substeps

    # ------------------------------------------------------------- robots
    def load_robot(self, base_position=(0.0, 0.0, 0.0),
                   body_name: str = "robot", gripper: str = "welded",
                   control_mode: str = "position",
                   inertia: str = "custom") -> str:
        """Load the Panda chain (replaces loadURDF of the robot URDF,
        pybullet.py:518-525 + core.py:54-68 _load_robot): gripper "welded"
        (7 dofs) or "prismatic" (9); control_mode "position" or
        "velocity".  inertia="stock" loads the pybullet_data mesh-URDF mass
        distribution (what the reference's golden tests simulate,
        test/pybullet_test.py:100-266)."""
        model = make_panda_model(base_position=base_position, gripper=gripper,
                                 inertia=inertia)
        self._robot_model = model
        self._robot_inertia = inertia
        self._robot_name = body_name
        self._ctrl_mode = (D.CTRL_VELOCITY if control_mode == "velocity"
                           else D.CTRL_POSITION)
        self._q = np.zeros(model.ndof)
        self._qd = np.zeros(model.ndof)
        self._ctrl_target = np.zeros(model.ndof)
        self._ctrl_force = np.array(model.effort, dtype=np.float32)
        self._bodies_idx[body_name] = dict(kind="robot")
        self._invalidate()
        return body_name

    # ------------------------------------------------------- scene factory
    def create_box(self, body_name: str, half_extents, mass: float,
                   position, rgba_color=None, specular_color=None,
                   ghost: bool = False, lateral_friction: Optional[float] = None,
                   spinning_friction: Optional[float] = None,
                   texture: Optional[str] = None) -> str:
        """pybullet.py:534-593."""
        return self._create_geometry(
            body_name, SHAPE_BOX, np.asarray(half_extents, float), mass,
            position, ghost, lateral_friction, rgba_color)

    def create_cylinder(self, body_name: str, radius: float, height: float,
                        mass: float, position, rgba_color=None,
                        ghost: bool = False,
                        lateral_friction: Optional[float] = None,
                        spinning_friction: Optional[float] = None) -> str:
        """pybullet.py:595-650."""
        return self._create_geometry(
            body_name, SHAPE_CYLINDER, np.array([radius, height / 2, 0.0]),
            mass, position, ghost, lateral_friction, rgba_color)

    def create_sphere(self, body_name: str, radius: float, mass: float,
                      position, rgba_color=None, ghost: bool = False,
                      lateral_friction: Optional[float] = None,
                      spinning_friction: Optional[float] = None) -> str:
        """pybullet.py:652-702."""
        return self._create_geometry(
            body_name, SHAPE_SPHERE, np.array([radius, 0.0, 0.0]), mass,
            position, ghost, lateral_friction, rgba_color)

    def _create_geometry(self, name, shape, size, mass, position, ghost,
                         lateral_friction, rgba_color):
        """pybullet.py:704-778 _create_geometry.

        mass > 0  -> dynamic body (simulated rigid body)
        mass == 0 -> static obstacle (collision/distance queries only)
        ghost     -> no collision response (reference ghost semantics)
        """
        if name in self._bodies_idx:
            raise ValueError(f"body name {name!r} already exists")
        kind = "ghost" if ghost else ("body" if mass > 0 else "obstacle")
        rec = dict(kind=kind,
                   shape=int(shape), size=np.asarray(size, float),
                   mass=float(mass),
                   mu=1.0 if lateral_friction is None else float(lateral_friction),
                   ghost=bool(ghost),
                   position=np.asarray(position, float),
                   quat=np.array([0.0, 0.0, 0.0, 1.0]),
                   velocity=np.zeros(3), ang=np.zeros(3),
                   rgba=rgba_color)
        self._bodies_idx[name] = rec
        self._invalidate()
        return name

    def create_plane(self, z_offset: float, **kw) -> str:
        """pybullet.py:780-797: ground plane at z_offset."""
        self._plane_z = float(z_offset)
        self._bodies_idx["plane"] = dict(kind="plane")
        self._invalidate()
        return "plane"

    def create_table(self, length: float, width: float, height: float,
                     x_offset: float = 0.0,
                     lateral_friction: Optional[float] = None,
                     spinning_friction: Optional[float] = None, **kw) -> str:
        """pybullet.py:799-817: table box whose top is z=0."""
        self._table = (length, width, height, x_offset,
                       0.5 if lateral_friction is None else float(lateral_friction))
        self._bodies_idx["table"] = dict(kind="table")
        self._invalidate()
        return "table"

    def loadURDF(self, body_name: str, fileName: str, basePosition=(0, 0, 0),
                 useFixedBase: bool = True, globalScaling: float = 1.0,
                 **kw) -> str:
        """Scenario URDF -> static obstacle boxes (pybullet.py:518-525),
        compiled by the native assetc (or its Python fallback)."""
        from panda_gym_tpu_torch.native import compile_urdf_boxes
        boxes = compile_urdf_boxes(fileName, tuple(basePosition),
                                   global_scaling=globalScaling)
        for i, b in enumerate(np.asarray(boxes)):
            self._create_geometry(f"{body_name}_box{i}", SHAPE_BOX,
                                  b[3:6], 0.0, b[0:3], False, None, None)
        self._bodies_idx[body_name] = dict(
            kind="urdf", parts=[f"{body_name}_box{i}"
                                for i in range(len(boxes))])
        return body_name

    def load_scenario(self, scenario_dir: str) -> None:
        """pybullet.py:527-532: manifest JSON -> loadURDF per body."""
        import json
        import os
        name = os.path.basename(os.path.normpath(scenario_dir))
        with open(os.path.join(scenario_dir, f"{name}.json")) as f:
            bodies = json.load(f)
        for body_name, spec in bodies.items():
            self.loadURDF(
                body_name,
                os.path.join(scenario_dir, "urdf", spec["fileName"]),
                basePosition=spec.get("basePosition", (0, 0, 0)),
                useFixedBase=spec.get("useFixedBase", True),
                globalScaling=spec.get("globalScaling", 1.0))

    def remove_body(self, body_name: str) -> None:
        """pybullet.py:104-115."""
        rec = self._bodies_idx.pop(body_name)
        for part in rec.get("parts", ()):
            self._bodies_idx.pop(part, None)
        self._invalidate()

    # ----------------------------------------------------------- stepping
    def step(self) -> None:
        """n_substeps of the engine (pybullet.py:68-71 stepSimulation loop)."""
        state = self._ensure_state()
        self._state = self._physics(state)
        self._pull_robot()

    def _invalidate(self):
        self._physics = None
        self._state = None

    def _dynamic_bodies(self):
        return [(n, r) for n, r in self._bodies_idx.items()
                if r.get("kind") == "body"]

    def _obstacles(self):
        return [(n, r) for n, r in self._bodies_idx.items()
                if r.get("kind") == "obstacle"]

    def _ensure_state(self) -> EnvState:
        if self._physics is not None and self._state is not None:
            return self._state
        if self._robot_model is None:
            # headless scene without a robot: attach the default one
            self.load_robot()
        model = self._robot_model
        dyn = self._dynamic_bodies()
        obs = self._obstacles()
        table = self._table or (1e-6, 1e-6, 1e-6, 0.0, 0.5)
        scene = build_scene(
            [dict(shape=r["shape"], size=tuple(r["size"]), mass=r["mass"],
                  mu=r["mu"]) for _, r in dyn],
            table_length=table[0], table_width=table[1],
            table_height=table[2], table_x_offset=table[3],
            table_mu=table[4], plane_z=self._plane_z)
        self._scene = scene
        self._physics = engine.make_batched_physics_step(
            model, scene,
            n_substeps=self.n_substeps,
            ctrl_mode=self._ctrl_mode,
            robot_contact=len(dyn) > 0,
            check_collision=len(obs) > 0,
            # obstacles advance by their base velocity (resetBaseVelocity on
            # the reference's kinematic obstacles, reach_ao.py:1091-1099);
            # zero velocity keeps them static, so static scenes are unchanged
            moving_obstacles=len(obs) > 0,
            # stepping never halts in the reference facade; is_collided is a
            # sticky query flag here, cleared with reset_collision_flag()
            freeze_on_collision=False,
            has_bodies=len(dyn) > 0,
            timestep=self.timestep,
            # the default gravity keeps K1's constants (a null pointer)
            gravity=None if self.gravity == D.GRAVITY else self.gravity,
            effort=self._ctrl_force if self._ctrl_force.size else None,
            per_env=True,
        )
        no = len(obs)
        nb = scene.nb
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=dev)[None]

        def rows(recs, key, empty, fn=lambda v: v):
            return (np.stack([fn(r[key]) for _, r in recs]) if recs
                    else empty)

        state = EnvState(
            q=t(self._q), qd=t(self._qd), ctrl_target=t(self._ctrl_target),
            body_pos=t(rows(dyn, "position", np.zeros((nb, 3)))),
            body_quat=t(rows(dyn, "quat", np.tile([0.0, 0, 0, 1], (nb, 1)))),
            body_vel=t(rows(dyn, "velocity", np.zeros((nb, 3)))),
            body_ang=t(rows(dyn, "ang", np.zeros((nb, 3)))),
            obstacle_pos=t(rows(obs, "position", np.zeros((0, 3)))),
            obstacle_vel=t(np.stack([r.get("velocity", np.zeros(3))
                                     for _, r in obs])
                           if obs else np.zeros((0, 3))),
            # spheres stay spheres; boxes stay boxes; a static cylinder is
            # approximated by its bounding box (axis z): half (r, r, h/2)
            obstacle_size=t(np.stack(
                [np.array([r["size"][0], r["size"][0], r["size"][1]])
                 if r["shape"] == SHAPE_CYLINDER else r["size"]
                 for _, r in obs]) if obs else np.zeros((0, 3))),
            obstacle_type=t([OBS_SPHERE if r["shape"] == SHAPE_SPHERE
                             else OBS_BOX for _, r in obs], torch.int32),
            obstacle_active=torch.ones(1, no, dtype=torch.bool, device=dev),
            goal=torch.full((1, 3), 1e6, device=dev),
            steps=torch.zeros(1, dtype=torch.int32, device=dev),
            is_collided=torch.zeros(1, dtype=torch.bool, device=dev),
            goal_reached=torch.zeros(1, dtype=torch.bool, device=dev),
            prev_action=torch.zeros(1, 1, device=dev),
            recent_action=torch.zeros(1, 1, device=dev),
            action_count=torch.zeros(1, dtype=torch.int32, device=dev),
            cur_jvel=torch.zeros(1, 7, device=dev),
            prev_jvel=torch.zeros(1, 7, device=dev),
            cur_jacc=torch.zeros(1, 7, device=dev),
            prev_jacc=torch.zeros(1, 7, device=dev),
            cur_jerk=torch.zeros(1, 7, device=dev),
            link_obstacle_dist=torch.full((1, max(model.ngroup, 1)), 999.0,
                                          device=dev),
            past_obs=torch.zeros(1, 3, 1, device=dev),
        )
        self._state = state
        return state

    @property
    def physics(self):
        """The current physics step (``sim/engine.py``): its ``route`` is
        "k1" or "pgs", and on the card its ``motor.launches`` count K1's
        launches."""
        self._ensure_state()
        return self._physics

    def _pull_robot(self):
        """Sync host-side mirrors from the stepped EnvState: robot q/qd,
        ctrl targets, and every dynamic-body/obstacle record, so that scene
        edits that rebuild the state keep the poses reached by stepping."""
        s = self._state
        self._q = _host(s.q)
        self._qd = _host(s.qd)
        self._ctrl_target = _host(s.ctrl_target)
        pos, quat = _host(s.body_pos), _host(s.body_quat)
        vel, ang = _host(s.body_vel), _host(s.body_ang)
        for i, (_n, rec) in enumerate(self._dynamic_bodies()):
            rec["position"], rec["quat"] = pos[i], quat[i]
            rec["velocity"], rec["ang"] = vel[i], ang[i]
        opos = _host(s.obstacle_pos)
        for i, (_n, rec) in enumerate(self._obstacles()):
            rec["position"] = opos[i]

    def _body_index(self, body_name: str) -> Tuple[str, int]:
        rec = self._bodies_idx[body_name]
        kind = rec.get("kind")
        if kind == "ghost":
            return "ghost", -1
        if kind == "body":
            return "body", [n for n, _ in self._dynamic_bodies()].index(body_name)
        if kind == "obstacle":
            return "obstacle", [n for n, _ in self._obstacles()].index(body_name)
        return kind, -1

    # ------------------------------------------------------------ getters
    def get_base_position(self, body_name: str) -> np.ndarray:
        """pybullet.py:182-192."""
        kind, i = self._body_index(body_name)
        state = self._ensure_state()
        if kind == "body":
            return _host(state.body_pos)[i]
        if kind == "obstacle":
            return _host(state.obstacle_pos)[i]
        if kind == "ghost":
            return np.asarray(self._bodies_idx[body_name]["position"])
        if kind == "robot":
            return np.asarray(self._robot_model.base_pos)
        raise ValueError(f"{body_name} has no base position")

    def get_base_orientation(self, body_name: str) -> np.ndarray:
        """pybullet.py:194-204 (xyzw quaternion)."""
        kind, i = self._body_index(body_name)
        if kind == "body":
            return _host(self._ensure_state().body_quat)[i]
        # obstacles are physically axis-aligned (their collision volume has
        # no orientation state), but the getter reports what was set, like
        # getBasePositionAndOrientation does for a fixed body
        rec = self._bodies_idx.get(body_name, {})
        return np.asarray(rec.get("quat", np.array([0.0, 0.0, 0.0, 1.0])))

    def get_base_rotation(self, body_name: str, type: str = "euler"):
        """pybullet.py:206-221."""
        q = self.get_base_orientation(body_name)
        if type == "quaternion":
            return q
        return quat_to_euler(torch.as_tensor(q, dtype=torch.float32)).numpy()

    def get_base_velocity(self, body_name: str) -> np.ndarray:
        """pybullet.py:223-233."""
        kind, i = self._body_index(body_name)
        state = self._ensure_state()
        if kind == "body":
            return _host(state.body_vel)[i]
        if kind == "obstacle":
            return _host(state.obstacle_vel)[i]
        if kind == "ghost":
            return np.asarray(self._bodies_idx[body_name]["velocity"])
        return np.zeros(3)

    def get_base_angular_velocity(self, body_name: str) -> np.ndarray:
        """pybullet.py:235-245."""
        kind, i = self._body_index(body_name)
        if kind == "body":
            return _host(self._ensure_state().body_ang)[i]
        return np.zeros(3)

    def _fk(self):
        state = self._ensure_state()
        return K.fk_world(self._robot_model, state.q, state.qd)

    def get_link_position(self, body_name: str, link: int) -> np.ndarray:
        """pybullet.py:249-260 (CoM frame, getLinkState conventions)."""
        return _host(K.site_com_position(self._robot_model, self._fk(), link))

    def get_link_orientation(self, body_name: str, link: int) -> np.ndarray:
        """pybullet.py:262-273: getLinkState linkWorldOrientation, i.e. the
        CoM/inertial frame (xyzw).  For stock-inertia robots the fitted
        per-link inertial-frame z-rotation is applied on the local side
        (panda_constants.BULLET_STOCK_LINK_FRAME_ROT_Z)."""
        R, _p = K.site_frame(self._robot_model, self._fk(), link)
        if getattr(self, "_robot_inertia", "custom") == "stock":
            from panda_gym_tpu_torch.models.panda_constants import (
                BULLET_STOCK_LINK_FRAME_ROT_Z)
            ang = BULLET_STOCK_LINK_FRAME_ROT_Z.get(link)
            if ang is not None:
                c, s = np.cos(ang), np.sin(ang)
                Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0],
                                   [0.0, 0.0, 1.0]], dtype=R.dtype,
                                  device=R.device)
                R = R @ Rz
        return _host(mat_to_quat(R))

    def get_link_velocity(self, body_name: str, link: int) -> np.ndarray:
        """pybullet.py:275-286."""
        return _host(K.site_com_velocity(self._robot_model, self._fk(), link))

    def get_link_angular_velocity(self, body_name: str,
                                  link: int) -> np.ndarray:
        """pybullet.py:288-299."""
        body = self._robot_model.site_body_tuple[link]
        return _host(self._fk().om[:, body])

    def _joint_read(self, vec: np.ndarray, joint: int) -> float:
        """Read one joint in the reference's PyBullet joint numbering
        (fingers at 9/10, fixed joints at 7/8 read 0.0; panda.py:62)."""
        i = pybullet_dof_index(vec.shape[0], joint)
        return 0.0 if i < 0 else float(vec[i])

    def get_joint_angle(self, body_name: str, joint: int) -> float:
        """pybullet.py:301-312."""
        return self._joint_read(_host(self._ensure_state().q), joint)

    def get_joint_angles(self, body_name: str, joints) -> np.ndarray:
        """pybullet.py:314-325."""
        q = _host(self._ensure_state().q)
        return np.asarray([self._joint_read(q, j) for j in joints])

    def get_joint_velocity(self, body_name: str, joint: int) -> float:
        """pybullet.py:327-338."""
        return self._joint_read(_host(self._ensure_state().qd), joint)

    def get_joint_velocities(self, body_name: str, joints) -> np.ndarray:
        """pybullet.py:340-348."""
        qd = _host(self._ensure_state().qd)
        return np.asarray([self._joint_read(qd, j) for j in joints])

    # ------------------------------------------------------------ setters
    def set_base_pose(self, body_name: str, position, orientation) -> None:
        """pybullet.py:350-366 (an euler 3-vector orientation converts as
        getQuaternionFromEuler, :362)."""
        rec = self._bodies_idx[body_name]
        rec["position"] = np.asarray(position, float)
        orientation = np.asarray(orientation, float)
        if len(orientation) == 3:
            orientation = quat_from_euler(torch.as_tensor(
                orientation, dtype=torch.float32)).double().numpy()
        rec["quat"] = orientation
        self._sync_record_to_state(body_name)

    def set_base_velocity(self, body_name: str, velocity) -> None:
        rec = self._bodies_idx[body_name]
        rec["velocity"] = np.asarray(velocity, float)
        self._sync_record_to_state(body_name)

    def set_base_pose_dummy(self, body_id, position, orientation,
                            physics_client=None) -> None:
        """pybullet.py:383-399: the raw-id variant (accepts a name here;
        the raw-handle/secondary-client distinction has no referent without
        a separate C++ client)."""
        self.set_base_pose(body_id, position, orientation)

    def set_base_velocity_dummy(self, body_id, velocity,
                                physics_client=None) -> None:
        """pybullet.py:401-414: the raw-id variant of set_base_velocity."""
        self.set_base_velocity(body_id, velocity)

    def _set_row(self, x, i, value):
        """x (1, n, ...) with row i of env 0 set to value (a new tensor)."""
        x = x.clone()
        x[0, i] = torch.as_tensor(np.asarray(value), dtype=x.dtype,
                                  device=x.device)
        return x

    def _sync_record_to_state(self, body_name: str) -> None:
        if self._state is None:
            return
        kind, i = self._body_index(body_name)
        rec = self._bodies_idx[body_name]
        s = self._state
        if kind == "body":
            self._state = s.replace(
                body_pos=self._set_row(s.body_pos, i, rec["position"]),
                body_quat=self._set_row(s.body_quat, i, rec["quat"]),
                body_vel=self._set_row(s.body_vel, i, rec["velocity"]),
                body_ang=self._set_row(s.body_ang, i, rec["ang"]))
        elif kind == "obstacle":
            self._state = s.replace(
                obstacle_pos=self._set_row(s.obstacle_pos, i,
                                           rec["position"]),
                obstacle_vel=self._set_row(s.obstacle_vel, i, rec.get(
                    "velocity", np.zeros(3))))

    def set_joint_angle(self, body_name: str, joint: int, angle: float) -> None:
        """pybullet.py:400-414 resetJointState.  Accepts PyBullet joint
        numbering (fingers at 9/10); writes to fixed joints are no-ops."""
        joint = pybullet_dof_index(len(self._q), joint)
        if joint < 0:
            return
        self._q[joint] = angle
        self._qd[joint] = 0.0
        self._ctrl_target[joint] = angle
        if self._state is not None:
            s = self._state
            self._state = s.replace(
                q=self._set_row(s.q, joint, angle),
                qd=self._set_row(s.qd, joint, 0.0),
                ctrl_target=self._set_row(s.ctrl_target, joint, angle))

    def set_joint_angles(self, body_name: str, joints, angles) -> None:
        """pybullet.py:416-425."""
        for j, a in zip(np.asarray(joints), np.asarray(angles)):
            self.set_joint_angle(body_name, int(j), float(a))

    def control_joints(self, body_name: str, joints, target_angles,
                       forces=None, control_mode: Optional[str] = None) -> None:
        """pybullet.py:437-463 setJointMotorControlArray: POSITION targets or
        VELOCITY targets per the facade's control mode.  `forces` are the
        per-joint motor force clamps (default: the model's URDF efforts);
        changing a clamp rebuilds the step (the clamps are in K1's model
        table), keeping the live poses through _pull_robot."""
        if forces is not None:
            changed = False
            for j, fc in zip(np.asarray(joints), np.asarray(forces)):
                i = pybullet_dof_index(len(self._ctrl_target), int(j))
                if i >= 0 and self._ctrl_force[i] != np.float32(fc):
                    self._ctrl_force[i] = fc
                    changed = True
            if changed and self._state is not None:
                self._pull_robot()
                self._invalidate()
        for j, t in zip(np.asarray(joints), np.asarray(target_angles)):
            i = pybullet_dof_index(len(self._ctrl_target), int(j))
            if i >= 0:
                self._ctrl_target[i] = float(t)
        if self._state is not None:
            self._state = self._state.replace(
                ctrl_target=torch.as_tensor(
                    self._ctrl_target, dtype=torch.float32,
                    device=self.device)[None])

    def inverse_kinematics(self, body_name: str, link: int, position,
                           orientation=None) -> np.ndarray:
        """pybullet.py:465-493 calculateInverseKinematics -> DLS IK (the
        batched dls_ik at B = 1)."""
        dev = self.device

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=dev).reshape(1, -1)

        q = K.dls_ik(self._robot_model, link, t(position),
                     None if orientation is None else t(orientation),
                     q0=t(self._q))
        return _host(q)

    def reset_collision_flag(self) -> None:
        """Clear the sticky is_collided flag (the engine latches it; the
        reference has no facade-level flag at all: tasks own it)."""
        if self._state is not None:
            self._state = self._state.replace(
                is_collided=torch.zeros_like(self._state.is_collided))

    @property
    def is_collided(self) -> bool:
        """The sticky collision flag of the obstacles' check."""
        return bool(self._ensure_state().is_collided[0])

    # ------------------------------------------------------ state snapshots
    def save_state(self) -> int:
        """pybullet.py:79-85 saveState."""
        sid = self._next_state_id
        self._next_state_id += 1
        self._saved[sid] = self._ensure_state()
        return sid

    def restore_state(self, state_id: int) -> None:
        """pybullet.py:87-94."""
        self._state = self._saved[state_id]
        self._pull_robot()

    def remove_state(self, state_id: int) -> None:
        """pybullet.py:96-102."""
        del self._saved[state_id]

    # ------------------------------------------------------------ friction
    def set_lateral_friction(self, body: str, link: int,
                             lateral_friction: float) -> None:
        """pybullet.py:880-893 changeDynamics lateralFriction."""
        rec = self._bodies_idx.get(body)
        if rec is not None and "mu" in rec:
            rec["mu"] = float(lateral_friction)
            self._invalidate()

    def set_spinning_friction(self, body: str, link: int,
                              spinning_friction: float) -> None:
        """pybullet.py:895-906 (spinning friction is folded into the
        regularized Coulomb model; recorded for parity)."""
        rec = self._bodies_idx.get(body)
        if rec is not None:
            rec["spinning_mu"] = float(spinning_friction)

    # ------------------------------------------------------------- debug UI
    def create_debug_text(self, text_name: str, text: str, **kw) -> None:
        """pybullet.py:819-856 (HUD labels; stored for host-side HUD/export)."""
        self._debug_texts[text_name] = dict(text=text, **kw)

    def remove_debug_text(self, text_name: str) -> None:
        self._debug_texts.pop(text_name, None)

    def remove_all_debug_text(self) -> None:
        """pybullet.py:867-869 removeAllUserDebugItems."""
        self._debug_texts.clear()

    def set_debug_object_color(self, body_name: str,
                               color=(0.0, 1.0, 0.0)) -> None:
        """pybullet.py:871-878 setDebugObjectColor (recorded; picked up by
        the software renderer's per-body color)."""
        rec = self._bodies_idx.get(body_name)
        if rec is not None:
            rec["debug_color"] = np.asarray(color, float)

    def create_debug_line(self, start, end, color=(0, 1, 0), width=1.0,
                          lifetime: float = 0.0) -> int:
        """pybullet.py:858-878 addUserDebugLine (drawn by render())."""
        self._debug_lines.append(dict(start=np.asarray(start, float),
                                      end=np.asarray(end, float),
                                      color=np.asarray(color, float)))
        return len(self._debug_lines) - 1

    # ------------------------------------------------------------- viewing
    def place_visualizer(self, target_position, distance, yaw, pitch) -> None:
        """pybullet.py:495-509 (camera defaults for render())."""
        self._camera = dict(target_position=np.asarray(target_position),
                            distance=distance, yaw=yaw, pitch=pitch)

    @contextlib.contextmanager
    def no_rendering(self):
        """pybullet.py:511-516 (no-op: nothing renders during stepping)."""
        yield

    def render(self, width: int = 720, height: int = 480,
               target_position=None, distance: float = 1.4, yaw: float = 45,
               pitch: float = -30, roll: float = 0, mode: str = "rgb_array"):
        """pybullet.py:117-180 -> software rasterizer + debug-line overlay."""
        from panda_gym_tpu_torch.eval.trajectory import _draw_segment
        from panda_gym_tpu_torch.render import _camera, render_state

        self._ensure_state()
        core = _FacadeCoreView(self)
        cam = getattr(self, "_camera", {})
        target = (target_position if target_position is not None
                  else cam.get("target_position", np.zeros(3)))
        img = render_state(core, self._ensure_state(), width=width,
                           height=height, target_position=target,
                           distance=cam.get("distance", distance),
                           yaw=cam.get("yaw", yaw),
                           pitch=cam.get("pitch", pitch))
        if self._debug_lines:
            project, _ = _camera(target, cam.get("distance", distance),
                                 cam.get("yaw", yaw), cam.get("pitch", pitch),
                                 roll, width, height)
            for line in self._debug_lines:
                pts = np.stack([line["start"], line["end"]])
                u, v, z = project(pts)
                if (z > 1e-3).all():
                    _draw_segment(img, u[0], v[0], u[1], v[1],
                                  (np.clip(line["color"], 0, 1) * 255
                                   ).astype(np.uint8))
        return img

    def close(self) -> None:
        """pybullet.py disconnect equivalent — nothing to tear down."""


class _FacadeCoreView:
    """Adapter giving render_state the (model, task.scene) attributes."""

    def __init__(self, sim: Simulation):
        self.model = sim._robot_model
        self.task = type("T", (), {"scene": sim._scene})()

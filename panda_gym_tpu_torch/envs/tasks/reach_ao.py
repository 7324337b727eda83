"""ReachAO, reach among obstacles (port of
panda_gym_tpu/envs/tasks/reach_ao.py).

The scenario table, obstacle randomization, the collision-free rejection
sampling of goal and obstacles, the per-substep collision check with
episode truncation (sim/engine.py::CollisionPhysics), five
obstacle-observation modes and six reward functions.  Every method works on
a batch of envs, the batch leading.  Rejection sampling draws a fixed
budget of candidates per env and takes the first valid one, with the same
fallbacks as the JAX package; each draw is kept apart from its selection,
so that the validity masks can be held against JAX on the same candidates.
Randomness comes from an explicit ``torch.Generator``.

The pose randomizers (``random_base``, and ``torus``, ``ik_goal``,
``ik_sphere`` and ``ik_range``, which IK every target of a reset in one
batched ``dls_ik`` call) and the multi-scene mixture core are ported.  Not
ported yet, each raising NotImplementedError when asked for: the ``prior``
observation (ROADMAP item 12) and the gym class (item 14).  Like the JAX
package, ``make_core`` does not build ReachAO: ``make_reach_ao_core``
does.
"""
from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from panda_gym_tpu_torch.envs.core import RobotTaskEnv, Task
from panda_gym_tpu_torch.envs.robot import PandaConfig, PandaRobot
from panda_gym_tpu_torch.models import panda_constants as pc
from panda_gym_tpu_torch.ops import contact as C
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.rl.config import TrainConfig
from panda_gym_tpu_torch.sim.engine import (group_obstacle_distances,
                                            group_table_distances)
from panda_gym_tpu_torch.sim.state import OBS_BOX, OBS_SPHERE, build_scene
from panda_gym_tpu_torch.utils import distance, unit_vector

# the port's own copy of panda_gym_tpu/assets/scenarios_compiled.json
ASSET_PATH = (Path(__file__).resolve().parents[2] / "assets"
              / "scenarios_compiled.json")

# goal-space defaults (reach_ao.py:74-82)
_GOAL_RANGE = 0.3
_X_OFFSET = 0.6
DEFAULT_GOAL_LOW = (-_GOAL_RANGE / 2.5 + _X_OFFSET, -_GOAL_RANGE / 1.5, 0.0)
DEFAULT_GOAL_HIGH = (_GOAL_RANGE / 2.5 + _X_OFFSET, _GOAL_RANGE / 1.5,
                     _GOAL_RANGE)

# cube sizes (reach_ao.py:66-69)
CUBE_LARGE = (0.05, 0.05, 0.05)
CUBE_MEDIUM = (0.03, 0.03, 0.03)
CUBE_SMALL = (0.02, 0.02, 0.02)
CUBE_MINI = (0.01, 0.01, 0.01)

NEUTRAL = tuple(pc.NEUTRAL_JOINT_VALUES[:7])


@dataclass(frozen=True)
class ScenarioSpec:
    """Declarative scenario description (replaces create_scenario_* methods)."""

    goal_sampler: Tuple = ("range",)          # ('range',) | ('hollow', rmin, rmax, upper, front, three_quarter)
    obstacle_sampler: Tuple = ("range",)      # ('range',) | ('wang',) | ('experimental',) | ('wang_paper',) | ('goal_hollow', rmin, rmax)
    pose_randomizer: Optional[Tuple] = None   # ('torus', front_only) | ('ik_goal',) | ('ik_sphere', rmin, rmax) | ('random_base',) | ('ik_range', low, high)
    randomize_robot_pose: bool = False
    pose_randomize_prob: float = 1.0          # fraction of episodes with a randomized start pose (rest start neutral)
    neutral_joints: Tuple[float, ...] = NEUTRAL
    goal_low: Tuple[float, float, float] = DEFAULT_GOAL_LOW
    goal_high: Tuple[float, float, float] = DEFAULT_GOAL_HIGH
    spheres: Tuple[float, ...] = ()           # dynamic sphere radii
    cuboids: Tuple[Tuple[float, float, float], ...] = ()  # half extents
    obstacle_init: Tuple[float, float, float] = (0.1, 0.0, 0.1)  # reach_ao.py:819, 841
    cuboid_positions: Tuple = ()              # fixed cuboid positions (wall)
    static_scenario: Optional[str] = None     # compiled-asset key
    randomize_obstacle_position: bool = False
    random_num_obs: bool = False
    sample_size_obs: Tuple[int, int] = (0, 0)
    allow_overlapping_obstacles: bool = False
    random_size_cuboids: bool = False


def _reach1():
    # reach_ao.py:518-522
    return ScenarioSpec(
        goal_low=(-0.2 + 0.6, -0.2, 0.0), goal_high=(0.2 + 0.6, 0.2, 0.4),
        pose_randomizer=("torus", True))


def _reach2():
    # :524-531
    return ScenarioSpec(goal_sampler=("hollow", 0.5, 0.85, True, False, True),
                        pose_randomizer=("torus", True))


def _reach3():
    # :533-539
    return ScenarioSpec(goal_sampler=("hollow", 0.5, 0.85, True, False, True),
                        pose_randomizer=("torus", False))


def _reachao1():
    # :541-545
    return replace(_reach1(), randomize_obstacle_position=True, spheres=(0.04,))


def _reachao2():
    # :547-564
    return ScenarioSpec(
        goal_sampler=("hollow", 0.5, 0.8, True, True, False),
        obstacle_sampler=("wang",),
        spheres=(0.05, 0.05),
        randomize_obstacle_position=True,
        pose_randomizer=("ik_goal",))


def _reachao3():
    # :573-585
    return ScenarioSpec(
        goal_sampler=("hollow", 0.5, 0.8, True, False, False),
        obstacle_sampler=("wang",),
        spheres=(0.05, 0.05, 0.05),
        randomize_obstacle_position=True,
        pose_randomizer=("ik_goal",))


def _reachao_rand():
    # :587-599
    return replace(
        _reachao3(),
        obstacle_sampler=("experimental",),
        cuboids=(CUBE_LARGE, CUBE_LARGE, CUBE_LARGE),
        random_num_obs=True, allow_overlapping_obstacles=True,
        sample_size_obs=(4, 6))


def _reachao_rand_start():
    # :601-604
    return replace(_reachao_rand(), randomize_robot_pose=True,
                   pose_randomizer=("ik_sphere", 0.45, 0.7))


def _reachao_rand_shape():
    # :606-608
    return replace(_reachao_rand(), random_size_cuboids=True)


def _wang(n: int):
    # :646-699
    return ScenarioSpec(
        goal_sampler=("hollow", 0.4, 0.95, True, False, False),
        obstacle_sampler=("wang_paper",),
        spheres=(0.05,) * n,
        randomize_obstacle_position=True,
        pose_randomizer=("torus", False))


def _wangexp(n: int):
    # :701-722
    return ScenarioSpec(
        goal_sampler=("hollow", 0.5, 0.8, True, False, False),
        obstacle_sampler=("wang",),
        spheres=(0.05,) * n,
        randomize_obstacle_position=True,
        sample_size_obs=(n, n),
        pose_randomizer=("random_base",))


def _wall():
    # :457-468
    return ScenarioSpec(
        goal_low=(0.45, -0.6, 0.1), goal_high=(0.7, -0.1, 0.3),
        neutral_joints=(0.94551719, 0.65262327, 0.12742699, -1.74347465,
                        -0.16996126, 1.97424632, 0.88058222),
        cuboids=((0.2, 0.05, 0.3),),
        cuboid_positions=((0.0, 0.0, 0.1),))


def _wall_h(half_height: float):
    """Training-only wall with a reduced height: the stages wall_h1 ->
    wall_h2 -> wall raise the obstacle while the goal region and the start
    pose stay canonical (reach_ao.py:457-468)."""
    return replace(_wall(), cuboids=((0.2, 0.05, half_height),))


def _showcase():
    # :724-767, three spheres in a shell, a visual scenario
    return ScenarioSpec(spheres=(0.05, 0.05, 0.05),
                        obstacle_sampler=("goal_hollow", 0.4, 0.95))


_TUNNEL_NEUTRAL = (-1.0, -0.3, 0.0, -2.2, 0.0, 2.0, np.pi / 4)
_BENCH_GOAL = dict(goal_low=(0.5, -0.3, 0.0), goal_high=(0.85, 0.3, 0.3))


def _benchmark_scenarios():
    # create_scenario_* for asset-backed scenes (reach_ao.py:308-516)
    s = {}
    s["narrow_tunnel"] = ScenarioSpec(
        neutral_joints=_TUNNEL_NEUTRAL,
        goal_low=(0.55, 0.2, 0.2), goal_high=(0.75, 0.4, 0.75),
        static_scenario="narrow_tunnel", randomize_robot_pose=True,
        pose_randomizer=("ik_range", (0.0, -0.6, 0.2), (0.5, -0.5, 0.7)))
    s["tunnel"] = ScenarioSpec(
        neutral_joints=_TUNNEL_NEUTRAL,
        goal_low=(0.55, 0.2, 0.2), goal_high=(0.75, 0.4, 0.75),
        static_scenario="tunnel")
    s["workshop"] = ScenarioSpec(
        neutral_joints=(0.00887326, -0.05377409, -0.03621967, -1.9094068,
                        0.08791409, 2.00265486, 0.76681184),
        goal_low=(-0.7, -0.7, 0.4), goal_high=(0.1, -0.4, 0.7),
        static_scenario="workshop")
    s["workshop2"] = replace(
        s["workshop"], randomize_robot_pose=True,
        pose_randomizer=("ik_range", (-0.5, -0.6, 0.6), (0.2, -0.3, 0.7)),
        goal_low=(0.5, -0.15, 0.4), goal_high=(0.6, 0.15, 0.5))
    s["workshop3"] = s["workshop"]
    s["industrial"] = ScenarioSpec(
        goal_low=(0.5, -0.1, 0.55), goal_high=(0.6, 0.1, 0.75),
        static_scenario="industrial", randomize_robot_pose=True,
        pose_randomizer=("ik_range", (-0.5, -0.8, 0.4), (0.2, -0.4, 0.7)))
    s["kasys"] = ScenarioSpec(
        goal_low=(1.4, -0.15, 0.45), goal_high=(1.7, 0.12, 0.6),
        static_scenario="kasys")
    s["library"] = ScenarioSpec(
        neutral_joints=(0.0, 0.12001979, 0.0, -1.64029458, 0.02081271, 3.1,
                        0.77979846),
        goal_low=(0.2, -0.3, 0.0), goal_high=(0.7, 0.3, 0.6),
        static_scenario="library")
    s["library1"] = replace(
        s["library"],
        neutral_joints=(-2.961, -0.031, -0.212, -1.603, 0.008, 3.087, 0.775),
        goal_low=(0.5, -0.3, 0.0), goal_high=(0.85, 0.3, 0.3))
    s["library2"] = replace(
        s["library"], goal_low=(-0.7, -0.4, 0.4), goal_high=(-0.55, 0.4, 0.85))
    s["bookshelves"] = ScenarioSpec(
        goal_low=(0.6, -0.35, 0.2), goal_high=(0.7, 0.35, 0.8),
        static_scenario="bookshelves")
    # warehouse loads the tabletop2 assets, a reference quirk
    # (reach_ao.py:470-476)
    s["warehouse"] = ScenarioSpec(static_scenario="tabletop2", **_BENCH_GOAL)
    s["countertop"] = ScenarioSpec(static_scenario="countertop", **_BENCH_GOAL)
    s["kitchen"] = ScenarioSpec(static_scenario="kitchen", **_BENCH_GOAL)
    s["raised_shelves"] = ScenarioSpec(static_scenario="raised_shelves",
                                       **_BENCH_GOAL)
    s["tabletop"] = ScenarioSpec(static_scenario="tabletop", **_BENCH_GOAL)
    s["tabletop2"] = ScenarioSpec(static_scenario="tabletop2", **_BENCH_GOAL)
    return s


def get_scenario(name: str) -> ScenarioSpec:
    """Scenario registry (reach_ao.py:229-266), with 'name-N' variants.

    ``<scene>_rs`` is a random-start variant of any scene (its start pose
    IK'd to a point of the scene's goal distribution); ``<scene>_pNN``
    randomizes the start pose in NN% of episodes only."""
    if name.endswith("_rs"):
        spec = get_scenario(name[:-3])
        return replace(spec, randomize_robot_pose=True,
                       pose_randomizer=("ik_goal",))
    m = re.fullmatch(r"(.+)_p(\d{1,2})", name)
    if m:
        spec = get_scenario(m.group(1))
        return replace(spec, pose_randomize_prob=int(m.group(2)) / 100.0)
    parts = name.split("-")
    base = parts[0]
    n = int(parts[1]) if len(parts) > 1 else 3
    if base == "wangexp_3":  # reference default string; equals wangexp-3
        base, n = "wangexp", 3
    simple = {
        "reach1": _reach1, "reach2": _reach2, "reach3": _reach3,
        "reachao1": _reachao1, "reachao2": _reachao2, "reachao3": _reachao3,
        "reachao_rand": _reachao_rand,
        "reachao_rand_start": _reachao_rand_start,
        "reachao_rand_shape": _reachao_rand_shape,
        "wall": _wall, "showcase": _showcase,
        "wall_h1": lambda: _wall_h(0.1), "wall_h15": lambda: _wall_h(0.15),
        "wall_h22": lambda: _wall_h(0.22), "wall_h2": lambda: _wall_h(0.2),
    }
    if base in simple:
        return simple[base]()
    if base == "wang":
        return _wang(n)
    if base == "wangexp":
        return _wangexp(n)
    bench = _benchmark_scenarios()
    if base in bench:
        return bench[base]
    raise ValueError(f"Scenario {name} not found!")  # reach_ao.py:262-264


def load_static_boxes(name: Optional[str]) -> np.ndarray:
    """A static scene's boxes, (n, 6) rows of center and half extents."""
    if name is None:
        return np.zeros((0, 6), np.float32)
    with open(ASSET_PATH) as f:
        data = json.load(f)["scenarios"]
    if name not in data:
        return np.zeros((0, 6), np.float32)
    return np.asarray(data[name]["boxes"], np.float32).reshape(-1, 6)


# ---------------------------------------------------------------------------
# samplers: batched, drawing from an explicit generator
# ---------------------------------------------------------------------------

def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def sample_hollow_sphere(generator, shape, rmin, rmax, upper=False,
                         front=False, three_quarter=False):
    """Uniform points in a spherical shell (reach_ao.py:1188-1211),
    (*shape, 3)."""
    if front:
        phi = _uniform(generator, shape, -0.5 * math.pi, 0.5 * math.pi)
    elif three_quarter:
        phi = _uniform(generator, shape, -0.75 * math.pi, 0.75 * math.pi)
    else:
        phi = _uniform(generator, shape, 0.0, 2 * math.pi)
    theta = _uniform(generator, shape, 0.0,
                     (0.5 if upper else 1.0) * math.pi)
    r = _uniform(generator, shape, rmin ** 3, rmax ** 3) ** (1.0 / 3.0)
    return torch.stack([r * torch.sin(theta) * torch.cos(phi),
                        r * torch.sin(theta) * torch.sin(phi),
                        r * torch.cos(theta)], -1)


def sample_inside_torus(generator, shape, R=0.5, r=0.05,
                        front_half_only=False):
    """Uniform points inside a torus about the z axis, lifted by 0.5
    (reach_ao.py:1213-1236), (*shape, 3)."""
    if front_half_only:
        theta = _uniform(generator, shape, -0.5 * math.pi, 0.5 * math.pi)
    else:
        theta = _uniform(generator, shape, 0.0, 2 * math.pi)
    phi = _uniform(generator, shape, 0.0, 2 * math.pi)
    rad = r * torch.sqrt(_uniform(generator, shape, 0.0, 1.0))
    x = (R + rad * torch.cos(phi)) * torch.cos(theta)
    y = (R + rad * torch.cos(phi)) * torch.sin(theta)
    z = rad * torch.sin(phi)
    return torch.stack([x, y, z + 0.5], -1)


def sample_cuboid_sizes(generator, shape):
    """Half extents 0.2 * Dirichlet(1, 1, 1) (reach_ao.py:968-979), drawn as
    normalised exponentials, (*shape, 3)."""
    e = -torch.log(_uniform(generator, (*shape, 3), 1.0, 0.0))  # U in (0, 1]
    return 0.2 * e / e.sum(-1, keepdim=True)


def select_first_valid(cands, mask, fallback):
    """Per env the first candidate whose mask is set, else ``fallback``:
    cands (B, N, k), mask (B, N), fallback (B, k)."""
    idx = torch.argmax(mask.to(torch.int32), dim=1)
    pick = cands[torch.arange(cands.shape[0], device=cands.device), idx]
    return torch.where(mask.any(1)[:, None], pick, fallback)


# ---------------------------------------------------------------------------
# the task
# ---------------------------------------------------------------------------

class ReachAO(Task):
    check_collision = True
    terminate_on_success = True
    N_CANDIDATES = 32      # fixed rejection-sampling budget per draw
    POSE_CANDIDATES = 8

    def __init__(self, robot: PandaRobot, scenario: str = "wangexp_3",
                 config: Optional[TrainConfig] = None,
                 ee_error_threshold: float = 0.05,
                 speed_threshold: float = 0.5,
                 capacity: Optional[int] = None):
        self.config = config or TrainConfig()
        self.spec = get_scenario(scenario)
        self.scenario_name = scenario
        self.robot = robot
        self.ee_error_threshold = float(ee_error_threshold)
        self.ee_speed_threshold = float(speed_threshold)
        self.randomize_robot_pose = (self.spec.randomize_robot_pose
                                     or self.config.randomize_robot_pose)
        self.truncate_on_collision = self.config.truncate_on_collision
        self.terminate_on_success = self.config.terminate_on_success
        # moving obstacles: reset draws velocities and the physics advances
        # them every substep (reach_ao.py:104, 997-1001, 1091-1095)
        self.moving_obstacles = bool(
            getattr(self.config, "randomize_obstacle_velocity", False))
        self.obstacle_obs = self.config.task_observations.get(
            "obstacles", "vectors+closest_per_link")
        self.prior = self.config.task_observations.get("prior")
        # cap on the observation's per-link distances only (rewards keep
        # the raw values); the default keeps the reference's raw 999.0
        self.obs_max_distance = float(
            self.config.task_observations.get("max_distance", 999.0))
        if self.prior is not None:
            raise NotImplementedError(
                "the 'prior' observation needs ops/neo.py, not ported yet "
                "(ROADMAP item 12)")

        # scene: plane + big table (reach_ao.py:268-290)
        self.scene = build_scene([], 2.0, 1.3, 0.4, 0.0)

        # obstacle roster: dynamic spheres + cuboids, then static boxes
        spec = self.spec
        self.n_spheres = len(spec.spheres)
        self.n_cuboids = len(spec.cuboids)
        self.static_boxes = load_static_boxes(spec.static_scenario)
        self.n_dynamic = self.n_spheres + self.n_cuboids
        # capacity pads the obstacle arrays past the scenario's own roster
        # (extra slots stay inactive at 99.9)
        self.n_obstacles = max(self.n_dynamic + len(self.static_boxes), 1,
                               capacity or 0)

        ngroup = robot.model.ngroup
        self.obs_vec_dim = 3 * ngroup  # 27 for the 9 collision links
        self.past_obs_dim = self.obs_vec_dim

        # neutral override (scenarios set robot.neutral_joint_values)
        robot.neutral[:7] = np.asarray(spec.neutral_joints, np.float32)
        self._obstacles0 = self._initial_obstacles()

    # -------------------------------------------------- initial obstacle state
    def _initial_obstacles(self):
        spec = self.spec
        no = self.n_obstacles
        pos = np.full((no, 3), 99.9, np.float32)
        size = np.full((no, 3), 1e-3, np.float32)
        typ = np.zeros(no, np.int32)
        active = np.zeros(no, bool)
        i = 0
        for r in spec.spheres:
            pos[i] = spec.obstacle_init
            size[i] = (r, r, r)
            typ[i] = OBS_SPHERE
            active[i] = True
            i += 1
        for j, h in enumerate(spec.cuboids):
            pos[i] = (spec.cuboid_positions[j]
                      if j < len(spec.cuboid_positions)
                      else spec.obstacle_init)
            size[i] = h
            typ[i] = OBS_BOX
            active[i] = True
            i += 1
        for b in self.static_boxes:
            pos[i] = b[:3]
            size[i] = b[3:]
            typ[i] = OBS_BOX
            active[i] = True
            i += 1
        return pos, size, typ, active

    def _init_obstacles(self, state):
        B, dev = state.batch_size, state.q.device
        pos, size, typ, active = (torch.as_tensor(a, device=dev)
                                  for a in self._obstacles0)
        return state.replace(
            obstacle_pos=pos.expand(B, -1, -1).clone(),
            obstacle_size=size.expand(B, -1, -1).clone(),
            obstacle_type=typ.expand(B, -1).clone(),
            obstacle_active=active.expand(B, -1).clone(),
            obstacle_vel=torch.zeros_like(state.obstacle_vel))

    # ------------------------------------------------------------- distances
    # p is (B, N, 3): N probe positions per env
    def _table(self, like):
        return (torch.as_tensor(self.scene.table_center, device=like.device),
                torch.eye(3, dtype=like.dtype, device=like.device),
                torch.as_tensor(self.scene.table_half, device=like.device))

    def _point_obstacle_dist(self, state, p, radius):
        """Distance of probe spheres to every obstacle, (B, N, no); radius
        a float or (B, N)."""
        no = state.obstacle_pos.shape[1]
        shape = p.shape[:2] + (no,)
        radius = torch.as_tensor(radius, dtype=p.dtype, device=p.device)
        if radius.dim():
            radius = radius[..., None].expand(shape)
        opos = state.obstacle_pos[:, None].expand(*shape, 3)
        osize = state.obstacle_size[:, None].expand(*shape, 3)
        pp = p[:, :, None].expand(*shape, 3)
        d_s = (torch.linalg.vector_norm(opos - pp, dim=-1) - osize[..., 0]
               - radius)
        eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*shape, 3, 3)
        d_b, _, _, _ = C.sphere_box_distance(pp, radius, opos, eye, osize)
        d = torch.where((state.obstacle_type == OBS_BOX)[:, None], d_b, d_s)
        return torch.where(state.obstacle_active[:, None], d, 999.0)

    def _probe_vs_robot(self, fk, p, radius):
        """Least distance of probe spheres to the robot's capsules, (B, N)."""
        model = self.robot.model
        cap_p0, cap_p1 = K.capsule_endpoints_world(model, fk)
        shape = p.shape[:2] + (cap_p0.shape[1],)
        d, _, _ = C.capsule_sphere_distance(
            cap_p0[:, None].expand(*shape, 3), cap_p1[:, None].expand(*shape, 3),
            model.tensors(p.device)["cap_radius"],
            p[:, :, None].expand(*shape, 3), radius)
        return torch.amin(d, dim=-1)

    def _probe_vs_table(self, p, radius):
        center, eye, half = self._table(p)
        d, _, _, _ = C.sphere_box_distance(p, radius, center, eye, half)
        return d

    def _obstacle_vs_robot(self, fk, pos, size, typ):
        """Least distance of candidate obstacles pos (B, N, 3) of size (B, 3)
        and type (B,) to the robot's capsules, (B, N)."""
        model = self.robot.model
        cap_p0, cap_p1 = K.capsule_endpoints_world(model, fk)
        shape = pos.shape[:2] + (cap_p0.shape[1],)
        P0 = cap_p0[:, None].expand(*shape, 3)
        P1 = cap_p1[:, None].expand(*shape, 3)
        rc = model.tensors(pos.device)["cap_radius"]
        posx = pos[:, :, None].expand(*shape, 3)
        d_s, _, _ = C.capsule_sphere_distance(P0, P1, rc, posx,
                                              size[:, 0, None, None])
        eye = torch.eye(3, dtype=pos.dtype,
                        device=pos.device).expand(*shape, 3, 3)
        d_b, _, _, _ = C.capsule_box_distance(
            P0, P1, rc, posx, eye, size[:, None, None].expand(*shape, 3))
        d = torch.where((typ == OBS_BOX)[:, None, None], d_b, d_s)
        return torch.amin(d, dim=-1)

    @staticmethod
    def _bounding_radius(size, typ):
        """Sphere radius, or a box's bounding radius, (B,)."""
        return torch.where(typ == OBS_BOX,
                           torch.linalg.vector_norm(size, dim=-1), size[:, 0])

    def _obstacle_vs_table(self, pos, size, typ):
        # boxes approximated by their bounding sphere for the placement
        # margin test (cheap, conservative within ~|size|)
        center, eye, half = self._table(pos)
        r = self._bounding_radius(size, typ)[:, None]
        d, _, _, _ = C.sphere_box_distance(pos, r, center, eye, half)
        return d

    def _obstacle_vs_obstacles(self, state, idx, pos, size, typ):
        """Distance of candidate obstacles to all *other* obstacles,
        (B, N, no)."""
        r_self = self._bounding_radius(size, typ)[:, None]
        d = self._point_obstacle_dist(state, pos, r_self.expand(pos.shape[:2]))
        other = torch.arange(d.shape[-1], device=d.device) != idx
        return torch.where(other, d, 999.0)

    # ------------------------------------------------------------- samplers
    def draw_goals(self, generator, B: int, n: int):
        """n goal candidates per env, (B, n, 3)."""
        kind = self.spec.goal_sampler
        if kind[0] == "hollow":
            _, rmin, rmax, upper, front, tq = kind
            return sample_hollow_sphere(generator, (B, n), rmin, rmax, upper,
                                        front, tq)
        lo = torch.as_tensor(self.spec.goal_low, device=generator.device)
        hi = torch.as_tensor(self.spec.goal_high, device=generator.device)
        return _uniform(generator, (B, n, 3), lo, hi)

    def draw_obstacles(self, generator, state, fk, n: int):
        """n obstacle-position candidates per env (reach_ao.py:610-644
        mixtures), (B, n, 3)."""
        kind = self.spec.obstacle_sampler
        B = state.batch_size
        goal = state.goal[:, None]
        ee = self.robot.ee_position(fk)[:, None]
        hs = lambda *a, **k: sample_hollow_sphere(generator, (B, n), *a, **k)
        if kind[0] == "wang":
            # sample_obstacle_wang (reach_ao.py:620-633)
            rand = _uniform(generator, (B, n, 1), 0.0, 1.0)
            near_goal = goal + hs(0.1, 0.5)
            near_ee = ee + hs(0.1, 0.4)
            # "near base" anchors at link 0's position (reach_ao.py:633)
            base = K.site_com_position(self.robot.model, fk, 0)[:, None]
            near_base = base + hs(0.3, 0.6, True)
            return torch.where(rand > 0.3, near_goal,
                               torch.where(rand > 0.1, near_ee, near_base))
        if kind[0] == "experimental":
            # sample_obstacle_experimental (reach_ao.py:635-644)
            rand = _uniform(generator, (B, n, 1), 0.0, 1.0)
            s = hs(0.1, 0.5)
            return torch.where(rand > 0.5, goal + s, ee + s)
        if kind[0] == "wang_paper":
            # create_scenario_wang's sampler (reach_ao.py:650-658)
            rand = _uniform(generator, (B, n, 1), 0.0, 1.0)
            near_goal = goal + hs(0.2, 0.6)
            near_ee = ee + hs(0.2, 0.4)
            return torch.where(rand > 0.3, near_goal, near_ee)
        if kind[0] == "goal_hollow":
            return hs(kind[1], kind[2])
        # default: goal-range uniform (reach_ao.py:78, 1183-1186)
        lo = torch.as_tensor(self.spec.goal_low, device=generator.device)
        hi = torch.as_tensor(self.spec.goal_high, device=generator.device)
        return _uniform(generator, (B, n, 3), lo, hi)

    # ------------------------------------------------------ validity masks
    def goal_mask(self, state, fk, cands, margin, include_obstacles):
        """Which goal candidates (B, N, 3) clear robot, table and (with
        include_obstacles) the obstacles by ``margin``, with the dummy probe
        sphere r = 0.05 (reach_ao.py:284-290, 1101-1129); (B, N)."""
        ok = self._probe_vs_robot(fk, cands, 0.05) > margin
        ok &= self._probe_vs_table(cands, 0.05) > margin
        if include_obstacles:
            ok &= torch.amin(self._point_obstacle_dist(state, cands, 0.05),
                             dim=-1) > margin
        return ok

    def obstacle_mask(self, state, fk, i, cands, margin):
        """Which candidates (B, N, 3) for obstacle i are valid
        (reach_ao.py:1131-1167); (B, N)."""
        size = state.obstacle_size[:, i]
        typ = state.obstacle_type[:, i]
        safety = self.config.safety_distance
        ok = self._obstacle_vs_robot(fk, cands, size, typ) > margin + safety
        ok &= self._obstacle_vs_table(cands, size, typ) > margin
        r_probe = self._bounding_radius(size, typ)[:, None]
        ok &= (torch.linalg.vector_norm(state.goal[:, None] - cands, dim=-1)
               - 0.05 - r_probe) > margin
        if not self.spec.allow_overlapping_obstacles:
            ok &= torch.amin(self._obstacle_vs_obstacles(
                state, i, cands, size, typ), dim=-1) > 0.0
            # boundary: within ~1 m of the origin probe (:1158-1161)
            ok &= (torch.linalg.vector_norm(cands, dim=-1) - 0.05
                   - r_probe) <= 1.0
        return ok

    # --------------------------------------------------------- robot posing
    # set_robot_random_pose (reach_ao.py:806-817): a torus draw IKs this many
    # targets and keeps the first whose EE height is in [0.4, 0.6]
    TORUS_CANDIDATES = 8

    def draw_pose_targets(self, generator, B: int, n: int):
        """IK targets of n pose draws per env (reach_ao.py:568-611): (B, n,
        3), or (B, n, TORUS_CANDIDATES, 3) for ``torus``."""
        kind = self.spec.pose_randomizer
        if kind[0] == "torus":
            return sample_inside_torus(
                generator, (B, n, self.TORUS_CANDIDATES),
                front_half_only=kind[1])
        if kind[0] == "ik_goal":
            return self.draw_goals(generator, B, n)
        if kind[0] == "ik_sphere":
            return sample_hollow_sphere(generator, (B, n), kind[1], kind[2],
                                        upper=True)
        # "ik_range"
        lo = torch.as_tensor(kind[1], device=generator.device)
        hi = torch.as_tensor(kind[2], device=generator.device)
        return _uniform(generator, (B, n, 3), lo, hi)

    def ik_poses(self, env, targets):
        """Every target (..., 3) IK'd from the neutral pose in one batched
        dls_ik call (n_iters=30, reach_ao.py:581): (..., ndof)."""
        flat = targets.reshape(-1, 3)
        q0 = torch.as_tensor(env.robot.neutral, device=flat.device)
        q = K.dls_ik(env.robot.model, env.robot.ee_site, flat, q0=q0,
                     n_iters=30)
        return q.reshape(targets.shape[:-1] + (q.shape[-1],))

    def torus_mask(self, env, qs):
        """Which IK'd torus poses (..., ndof) put the EE at a height in
        [0.4, 0.6] (reach_ao.py:806-817)."""
        flat = qs.reshape(-1, qs.shape[-1])
        z = env.robot.ee_position(K.fk_world(env.robot.model, flat))[:, 2]
        return ((z >= 0.4) & (z <= 0.6)).reshape(qs.shape[:-1])

    def _random_poses(self, env, state, generator, n: int):
        """n random start poses per env, (B, n, ndof): set_random_robot_base
        (reach_ao.py:1238-1241), or the IK'd pose of a drawn target."""
        B = state.batch_size
        kind = self.spec.pose_randomizer[0]
        neutral = torch.as_tensor(env.robot.neutral, device=env.device)
        if kind == "random_base":
            q = neutral.expand(B, n, -1).clone()
            q[..., 0] = _uniform(generator, (B, n),
                                 float(pc.JOINT_LIM_MIN[0]),
                                 float(pc.JOINT_LIM_MAX[0]))
            return q
        qs = self.ik_poses(env, self.draw_pose_targets(generator, B, n))
        if kind != "torus":
            return qs
        P = self.TORUS_CANDIDATES
        flat = qs.reshape(B * n, P, -1)
        return select_first_valid(
            flat, self.torus_mask(env, flat),
            neutral.expand(B * n, -1)).reshape(B, n, -1)

    def reset_robot(self, env, state, generator):
        state = super().reset_robot(env, state, generator)
        if not self.randomize_robot_pose or self.spec.pose_randomizer is None:
            return state
        q_new = self._random_poses(env, state, generator, 1)[:, 0]
        prob = self.spec.pose_randomize_prob
        if prob < 1.0:
            # start-pose curriculum: randomize a fraction of episodes only
            take = _uniform(generator, (state.batch_size, 1), 0.0, 1.0) < prob
            q_new = torch.where(take, q_new, state.q)
        return state.replace(q=q_new, ctrl_target=q_new.clone())

    def robot_pose_mask(self, env, state, qs):
        """Which candidate poses qs (B, P, ndof) clear the obstacles by 0.05
        and the table by 0 (reach_ao.py:1035-1060), (B, P)."""
        margin = 0.05
        B, P = qs.shape[:2]
        model = env.robot.model
        fk = K.fk_world(model, qs.reshape(B * P, -1))
        rep = state.replace(**{
            k: getattr(state, k).repeat_interleave(P, 0)
            for k in ("obstacle_pos", "obstacle_size", "obstacle_type",
                      "obstacle_active")})
        gd, _, _ = group_obstacle_distances(model, fk, rep)
        # the reference rejects with check_collided(), which tests the table
        # too (reach_ao.py:896-900)
        td = group_table_distances(model, fk, self.scene)
        return ((torch.amin(gd, -1) > margin)
                & (torch.amin(td, -1) > 0.0)).reshape(B, P)

    def _set_coll_free_robot(self, env, state, generator):
        """The current pose, or else the first of POSE_CANDIDATES - 1 fresh
        draws, that clears obstacles and table; fallback neutral
        (reach_ao.py:1035-1060)."""
        qs = torch.cat([state.q[:, None], self._random_poses(
            env, state, generator, self.POSE_CANDIDATES - 1)], 1)
        neutral = torch.as_tensor(env.robot.neutral, device=env.device)
        q = select_first_valid(qs, self.robot_pose_mask(env, state, qs),
                               neutral.expand(state.batch_size, -1))
        return state.replace(q=q, qd=torch.zeros_like(state.qd),
                             ctrl_target=q.clone())

    # ----------------------------------------------------------------- reset
    def reset(self, env, state, generator):
        spec = self.spec
        B = state.batch_size
        state = self._init_obstacles(state)
        model = env.robot.model

        if spec.random_size_cuboids and self.n_cuboids:
            # random-size cuboids (reach_ao.py:968-979, 1084-1089)
            osize = state.obstacle_size.clone()
            lo = self.n_spheres
            osize[:, lo:lo + self.n_cuboids] = sample_cuboid_sizes(
                generator, (B, self.n_cuboids))
            state = state.replace(obstacle_size=osize)

        fk = K.fk_world(model, state.q)

        # goal pass 1: vs table+robot, margin 0.1 (reach_ao.py:981-982,
        # 1101-1129)
        if self.config.fixed_target is None:
            state = self._set_coll_free_goal(state, fk, generator, 0.1,
                                             include_obstacles=False)
        else:
            goal = torch.as_tensor(self.config.fixed_target,
                                   dtype=torch.float32, device=env.device)
            state = state.replace(goal=goal.expand(B, 3).clone())

        if spec.randomize_obstacle_position:
            state = self._set_coll_free_obs(state, fk, generator, 0.03)
        elif self.config.fixed_target is None:
            # static obstacles: re-draw the goal vs everything, margin 0.03
            # (:986-989)
            state = self._set_coll_free_goal(state, fk, generator, 0.03,
                                             include_obstacles=True)

        # collision-free robot pose fix-up (:991-992, 1035-1060)
        if self.randomize_robot_pose and spec.pose_randomizer is not None:
            fixed = self._set_coll_free_robot(env, state, generator)
            if spec.pose_randomize_prob < 1.0:
                # episodes gated to a neutral start stay neutral
                neutral = torch.as_tensor(env.robot.neutral, device=env.device)
                was_rand = (torch.abs(state.q - neutral) > 1e-7).any(
                    -1, keepdim=True)
                fixed = fixed.replace(**{
                    k: torch.where(was_rand, getattr(fixed, k),
                                   getattr(state, k))
                    for k in ("q", "qd", "ctrl_target")})
            state = fixed

        if self.moving_obstacles:
            vel = _uniform(generator, state.obstacle_vel.shape, -0.2, 0.2)
            state = state.replace(obstacle_vel=torch.where(
                state.obstacle_active[..., None], vel, 0.0))

        if spec.random_num_obs:
            state = self._set_random_num_obs(state, generator)

        # prime link distances + past-observation stack (:1028-1033)
        fk = K.fk_world(model, state.q)
        gd, gpc, gpo = group_obstacle_distances(model, fk, state)
        vec = self._vector_obs(gpc, gpo)
        return state.replace(
            link_obstacle_dist=gd,
            past_obs=vec[:, None].expand(B, 3, -1).contiguous())

    def _set_coll_free_goal(self, state, fk, generator, margin,
                            include_obstacles):
        """Masked rejection sampling of the goal; fallback: the EE
        position."""
        cands = self.draw_goals(generator, state.batch_size,
                                self.N_CANDIDATES)
        mask = self.goal_mask(state, fk, cands, margin, include_obstacles)
        goal = select_first_valid(cands, mask, self.robot.ee_position(fk))
        return state.replace(goal=goal)

    def _set_coll_free_obs(self, state, fk, generator, margin):
        """Sequential per-obstacle masked rejection sampling; fallback: the
        first candidate (reach_ao.py:1131-1167)."""
        for i in range(self.n_dynamic):
            cands = self.draw_obstacles(generator, state, fk,
                                        self.N_CANDIDATES)
            mask = self.obstacle_mask(state, fk, i, cands, margin)
            pos = select_first_valid(cands, mask, cands[:, 0])
            opos = state.obstacle_pos.clone()
            opos[:, i] = pos
            state = state.replace(obstacle_pos=opos)
        return state

    def _set_random_num_obs(self, state, generator):
        """Teleport a random subset of the dynamic obstacles far away
        (reach_ao.py:1062-1082)."""
        lo, hi = self.spec.sample_size_obs
        B, n = state.batch_size, self.n_dynamic
        dev = state.q.device
        n_keep = torch.randint(lo, max(hi, lo + 1), (B,), generator=generator,
                               device=dev)
        # each obstacle's rank in a uniformly random order
        rank = torch.rand(B, n, generator=generator, device=dev).argsort(
            1).argsort(1)
        move = rank < torch.clamp(n - n_keep, 0, n)[:, None]
        far = torch.tensor([99.9, 99.9, -99.9], device=dev)
        pos = state.obstacle_pos.clone()
        pos[:, :n] = torch.where(move[..., None], far, pos[:, :n])
        return state.replace(obstacle_pos=pos)

    # ------------------------------------------------------------------ obs
    @staticmethod
    def _vector_obs(gpc, gpo):
        """Unit vectors link -> closest obstacle per group, (B, 3 * ngroup)
        (reach_ao.py:943-959)."""
        v = unit_vector(gpc, gpo)
        return v.reshape(v.shape[0], -1)

    def pre_obs(self, env, state, fk):
        """Refresh the per-link distances and the past-vector stack before
        the observation is assembled (reach_ao.py:902-928)."""
        gd, gpc, gpo = group_obstacle_distances(env.robot.model, fk, state)
        state = state.replace(link_obstacle_dist=gd)
        if self.obstacle_obs in ("vectors", "vectors+past"):
            vec = self._vector_obs(gpc, gpo)
            state = state.replace(past_obs=torch.cat(
                [state.past_obs[:, 1:], vec[:, None]], 1))
        return state

    def task_obs(self, env, state, fk):
        """The obstacle observation in this task's mode (reach_ao.py:
        902-941)."""
        gd, gpc, gpo = group_obstacle_distances(env.robot.model, fk, state)
        mode = self.obstacle_obs
        gd_o = torch.clamp_max(gd, self.obs_max_distance)
        if mode == "closest_per_link":
            return gd_o
        if mode == "closest":
            return torch.amin(gd_o, dim=-1, keepdim=True)
        if mode == "vectors":
            return state.past_obs[:, -1]
        if mode == "vectors+past":
            return state.past_obs.reshape(state.batch_size, -1)
        # "vectors+closest_per_link"
        return torch.cat([gd_o, self._vector_obs(gpc, gpo)], -1)

    def achieved_goal(self, env, state, fk):
        return env.robot.ee_position(fk)

    # ------------------------------------------------------- success/reward
    def is_success(self, env, achieved, desired, state):
        d = distance(achieved, desired)
        if self.config.goal_condition == "halt":
            # latch once error and speed are below their thresholds
            # (reach_ao.py:1253-1257)
            fk = K.fk_world(env.robot.model, state.q, state.qd)
            speed = torch.linalg.vector_norm(env.robot.ee_velocity(fk), dim=-1)
            reached = ((d < self.ee_error_threshold)
                       & (speed < self.ee_speed_threshold))
            new = state.goal_reached | reached
            return new, state.replace(goal_reached=new)
        return d < self.ee_error_threshold

    def is_truncated(self, env, state):
        if not self.truncate_on_collision:
            return torch.zeros_like(state.is_collided)  # reach_ao.py:84-86
        return state.is_collided  # :1263-1264

    def _aux_terms(self, state, ee_vel):
        return dict(ee_speed=torch.linalg.vector_norm(ee_vel, dim=-1),
                    effort=torch.linalg.vector_norm(state.cur_jacc, dim=-1),
                    jerk=torch.linalg.vector_norm(state.cur_jerk, dim=-1),
                    obst_pen=torch.sum(torch.clamp_min(
                        1.0 - state.link_obstacle_dist / 0.05, 0.0), -1))

    def reward_aux(self, env, state):
        """State-dependent reward terms, stored per transition so that HER
        can relabel every reward type exactly: (B, 5) of [collided,
        ee_speed, effort, jerk, obstacle_penalty] (reach_ao.py:1308-1383)."""
        fk = K.fk_world(env.robot.model, state.q, state.qd)
        t = self._aux_terms(state, env.robot.ee_velocity(fk))
        return torch.stack([state.is_collided.float(), t["ee_speed"],
                            t["effort"], t["jerk"], t["obst_pen"]], -1)

    def reward_from_aux(self, env, achieved, desired, aux):
        return self._reward(achieved, desired, collided=aux[..., 0],
                            ee_speed=aux[..., 1], effort=aux[..., 2],
                            jerk=aux[..., 3], obst_pen=aux[..., 4])

    def compute_reward(self, env, achieved, desired, state, fk):
        """The 6 reward functions (reach_ao.py:1308-1383)."""
        if fk is None:  # HER relabel path
            return self.reward_from_aux(env, achieved, desired,
                                        self.reward_aux(env, state))
        return self._reward(achieved, desired,
                            collided=state.is_collided.float(),
                            **self._aux_terms(state,
                                              env.robot.ee_velocity(fk)))

    def _reward(self, achieved, desired, *, collided, ee_speed, effort, jerk,
                obst_pen):
        cfg = self.config
        ee_error = distance(achieved, desired)
        thr, sthr = self.ee_error_threshold, self.ee_speed_threshold
        rt = cfg.reward_type
        if rt == "sparse":
            if cfg.goal_condition == "reach":
                e = ee_error + collided  # no reward if collided (:1319)
                reward = -1.0 + (e < thr).float()
            else:
                reward = 1.0 - ((ee_error < thr) & (ee_speed < sthr)).float()
        elif rt == "wang":
            distance_reward = (10e-3 * ee_error ** 2
                               + torch.log(ee_error ** 2 + 10e-4))
            reward = -(distance_reward + 0.1 * obst_pen)
        elif rt == "kumar_her":
            if cfg.goal_condition == "reach":
                reward = -((ee_error > thr).float() * jerk)
            else:
                reward = ((ee_error < thr) & (ee_speed < sthr)).float() - jerk
        elif rt == "kumar_optim":
            reward = -(ee_error > thr).float() - effort
        elif rt == "kumar":
            distance_reward = torch.exp(-20.0 * ee_error ** 2)
            reward = distance_reward - 0.005 * effort - 0.1 * obst_pen
        else:
            # the reference's dense fallback references undefined factors
            # (reach_ao.py:1363-1371); unit factors here, as in the JAX
            # package
            reward = -(effort + ee_error + 100.0 * collided)

        if self.truncate_on_collision and rt in ("sparse", "kumar_her",
                                                 "kumar_optim"):
            reward = reward + collided * cfg.collision_reward  # :1376-1377
        return reward.float()


# ---------------------------------------------------------------------------
# env factory (panda_tasks.py:132-159)
# ---------------------------------------------------------------------------

def make_reach_ao_core(scenario: str = "reachao1",
                       config: Optional[TrainConfig] = None,
                       ee_error_threshold: float = 0.05,
                       speed_threshold: float = 0.1,
                       capacity: Optional[int] = None,
                       device="cuda") -> RobotTaskEnv:
    config = config or TrainConfig()
    if "+" in scenario:
        return make_reach_ao_mixture_core(
            scenario.split("+"), config=config,
            ee_error_threshold=ee_error_threshold,
            speed_threshold=speed_threshold, device=device)
    robot = PandaRobot(PandaConfig(
        block_gripper=True, control_type=config.control_type,
        obs_type=tuple(config.obs_type), action_limiter=config.action_limiter,
        base_position=(0.0, 0.0, 0.0)))
    task = ReachAO(robot, scenario=scenario, config=config,
                   ee_error_threshold=ee_error_threshold,
                   speed_threshold=speed_threshold, capacity=capacity)
    return RobotTaskEnv(robot, task,
                        terminate_on_success=config.terminate_on_success,
                        n_substeps=config.n_substeps, device=device)


class _MixtureReachAOEnv(RobotTaskEnv):
    """Multi-scene ReachAO: each env draws a scenario at reset
    (reach_ao.py:931-957).

    Every scenario's obstacle arrays are padded to one shared capacity, so
    one batched step covers all scenes and a rollout of N envs trains on
    all of them at once.  Physics, observations and reward are the first
    core's (the machinery is the same for every scenario under one config);
    only the reset differs: one scene id per env from the generator, then
    each scene's envs reset by that scene's task.
    """

    def __init__(self, cores):
        self._cores = cores
        base = cores[0]
        super().__init__(base.robot, base.task,
                         terminate_on_success=base.terminate_on_success,
                         n_substeps=base.n_substeps, device=base.device)

    def batched_reset(self, batch: int, generator=None):
        generator = self._generator(generator)
        sid = torch.randint(0, len(self._cores), (batch,),
                            generator=generator, device=self.device)
        state = self.init_state(batch)
        fields = {k: getattr(state, k) for k in state.__dataclass_fields__}
        obs = None
        # the sub-batch sizes decide the shapes: one read of the ids
        for i, n in enumerate(torch.bincount(
                sid, minlength=len(self._cores)).tolist()):
            if n == 0:
                continue
            idx = (sid == i).nonzero().flatten()
            s_i, o_i = self._cores[i].batched_reset(n, generator)
            for k, v in fields.items():
                v[idx] = getattr(s_i, k)
            if obs is None:
                obs = {k: v.new_zeros((batch,) + v.shape[1:])
                       for k, v in o_i.items()}
            for k, v in o_i.items():
                obs[k][idx] = v
        return state.replace(**fields), obs


def make_reach_ao_mixture_core(scenarios, config: Optional[TrainConfig] = None,
                               ee_error_threshold: float = 0.05,
                               speed_threshold: float = 0.1,
                               device="cuda") -> RobotTaskEnv:
    """Uniform mixture over `scenarios` (oversample a scene by repeating its
    name), reach_ao.py:960-976.  make_reach_ao_core builds it from
    '+'-joined scenario names, e.g. "reachao1+wall+tunnel"."""
    config = config or TrainConfig()

    def natural_capacity(name: str) -> int:
        spec = get_scenario(name)
        return max(len(spec.spheres) + len(spec.cuboids)
                   + len(load_static_boxes(spec.static_scenario)), 1)

    capacity = max(natural_capacity(s) for s in scenarios)
    return _MixtureReachAOEnv([
        make_reach_ao_core(s, config=config,
                           ee_error_threshold=ee_error_threshold,
                           speed_threshold=speed_threshold,
                           capacity=capacity, device=device)
        for s in scenarios])


class PandaReachAOEnv:
    """The gymnasium class (reach_ao.py:979-990) waits for the gym surface."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PandaReachAOEnv waits for the gym surface (ROADMAP item 14); "
            "make_reach_ao_core builds the batched env")

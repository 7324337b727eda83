"""Port parity: the capsule kinematics, the collision sweep and the ReachAO
physics step of panda_gym_tpu_torch against panda_gym_tpu, both on the CPU.

Both sides get the same seeded numpy inputs.  The port has one collision
geometry, the batched tensor form of sim/engine.py; it is held against the
JAX package's per-env engine functions (vmapped) and against its batched
component-form twin, ops/scalarized_collision.py, whose physics step the
JAX ReachAO env runs.  The JAX physics step is run op by op with its
``lax.scan`` as a Python loop (what ``jax.disable_jit`` does to a scan), so
that the 20-substep body is not compiled: that compile takes about a minute
on the CPU.  Tolerances: kinematics and distances atol 1e-6, closest points
1e-5; the physics step q 2e-5 and qd 2e-3 (tests/test_dynamics.py:
295-296), link distances 1e-5, the collided flags equal.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.models.panda import make_panda_model as jax_panda
from panda_gym_tpu.ops import kinematics as JK
from panda_gym_tpu.ops import scalarized as JS
from panda_gym_tpu.ops import scalarized_collision as JSC
from panda_gym_tpu.sim import engine as JE
from panda_gym_tpu.sim.state import build_scene as jax_scene

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.models.panda import make_panda_model
from panda_gym_tpu_torch.ops import kinematics as TK
from panda_gym_tpu_torch.ops import contact as TC
from panda_gym_tpu_torch.ops import dynamics as TD
from panda_gym_tpu_torch.sim import engine as TE
from panda_gym_tpu_torch.sim.state import OBS_BOX, OBS_SPHERE, build_scene

B = 8
ATOL = 1e-6
ATOL_Q, ATOL_QD, ATOL_LINK = 2e-5, 2e-3, 1e-5
DT = 1.0 / 500.0


def _scan_loop(f, init, xs=None, length=None, **kw):
    assert xs is None and not kw
    carry = init
    for _ in range(length):
        carry, _ = f(carry, None)
    return carry, None


@pytest.fixture
def eager_scan(monkeypatch):
    monkeypatch.setattr(jax.lax, "scan", _scan_loop)


@pytest.fixture(scope="module")
def models():
    jm, tm = jax_panda(), make_panda_model()
    return jm, tm, JS.consts_from_model(jm)


def _random_q(seed, n=B):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(make_panda_model().q_lo), np.asarray(make_panda_model().q_hi)
    return (rng.uniform(lo, hi, (n, 7)).astype(np.float32),
            rng.normal(0, 0.5, (n, 7)).astype(np.float32))


def _cols(a, lib):
    if lib is torch:
        return [torch.as_tensor(np.ascontiguousarray(a[:, d]))
                for d in range(a.shape[1])]
    return [jnp.asarray(a[:, d]) for d in range(a.shape[1])]


def _close(t, j, atol=ATOL):
    """Nested component structures: tensors against arrays, folded floats
    against folded floats."""
    if isinstance(t, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close(a, b, atol)
    elif isinstance(t, float):
        assert isinstance(j, float) and abs(t - j) <= atol
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


# ------------------------------------------------------------- kinematics

def test_fk_world_without_qd_is_at_rest(models):
    """Without qd the collision check's FK skips the velocity terms: the
    same frames as with qd = 0, and zero velocities."""
    _, tm, _ = models
    q = torch.as_tensor(_random_q(9)[0])
    rest, zero = TK.fk_world(tm, q), TK.fk_world(tm, q, torch.zeros_like(q))
    for a, b in zip(rest, zero):
        assert torch.equal(a, b)
    assert not rest.om.any() and not rest.v.any()


def test_capsule_endpoints_world(models):
    jm, tm, _ = models
    q, qd = _random_q(3)
    t = TK.capsule_endpoints_world(tm, TK.fk_world(tm, torch.as_tensor(q),
                                                   torch.as_tensor(qd)))
    j = jax.vmap(lambda a: JK.capsule_endpoints_world(jm, JK.fk_world(jm, a)))(
        jnp.asarray(q))
    _close(t, j)


# ----------------------------------------------- sweep and group reductions

class Obstacles(NamedTuple):
    obstacle_pos: object
    obstacle_size: object
    obstacle_type: object
    obstacle_active: object


def _obstacles(seed, caps=None):
    """3 obstacles per env: mixed spheres and boxes; env 0 has none active
    (every candidate reads max_distance: an exact argmin tie); env 1's box
    swallows a capsule deeper than the blind margin; env 2's sphere
    overlaps one."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([0.1, -0.4, 0.0], [0.7, 0.4, 0.7], (B, 3, 3))
    size = rng.uniform(0.02, 0.08, (B, 3, 3))
    typ = rng.integers(0, 2, (B, 3))
    active = rng.uniform(size=(B, 3)) > 0.2
    active[0] = False
    active[1:] |= np.arange(3) == 0
    if caps is not None:
        typ[1, 0], pos[1, 0], size[1, 0] = OBS_BOX, caps[1], 0.3
        typ[2, 0], pos[2, 0], size[2, 0] = OBS_SPHERE, caps[2], 0.05
    return Obstacles(pos.astype(np.float32), size.astype(np.float32),
                     typ.astype(np.int32), active)


def _as(obs, lib):
    conv = torch.as_tensor if lib is torch else jnp.asarray
    return Obstacles(*(conv(a) for a in obs))


def _components(x):
    """(B, ncap, no[, 3]) -> the component form's (no, ncap, B) [vec3]."""
    if x.dim() == 4:
        return tuple(x[..., k].permute(2, 1, 0) for k in range(3))
    return x.permute(2, 1, 0)


@pytest.fixture(scope="module")
def swept(models):
    """Random poses and obstacles; the port's capsules and capsule x
    obstacle distances, and the JAX package's component-form sweep."""
    jm, tm, jmc = models
    q, _ = _random_q(4)
    fk = TK.fk_world(tm, torch.as_tensor(q))
    P0, P1 = TK.capsule_endpoints_world(tm, fk)
    obs = _obstacles(5, caps=P0[:, 5].numpy())
    t = dict(fk=fk, P0=P0, P1=P1, obs=_as(obs, torch))
    t["D"], t["PC"], t["PO"] = TE.capsule_obstacle_distances(
        tm, P0, P1, t["obs"], 999.0)
    # env 2's sphere is centred on capsule 5's axis, where the closest
    # points have no direction: the two forms pick theirs by rounding, so
    # that pair is held by its distance alone
    opos = t["obs"].obstacle_pos[:, None]
    t["on_axis"] = (torch.linalg.vector_norm(
        TC.closest_on_segment(P0[:, :, None], P1[:, :, None], opos) - opos,
        dim=-1) < 1e-6) & (t["obs"].obstacle_type[:, None] == OBS_SPHERE)
    Rs, ps = JS.fk_positions(jmc, _cols(q, jnp))
    p0s, p1s = JS.capsule_endpoints(jmc, Rs, ps)
    j = dict(mc=jmc, P0=JSC.stack_caps(p0s), P1=JSC.stack_caps(p1s),
             RC=JSC._cap_radius_col(jmc))
    j["D"], j["PC"], j["PO"] = JSC.obstacle_distance_sweep(
        jmc, j["P0"], j["P1"], j["RC"], *JSC._obstacle_comps(_as(obs, jnp), 3),
        3, 999.0, with_points=True)
    return t, j


def test_obstacle_distance_sweep(swept):
    t, j = swept
    _close(_components(t["D"]), j["D"])
    on_axis = t["on_axis"]
    assert on_axis.nonzero().tolist() == [[2, 5, 0]]
    for k in ("PC", "PO"):
        pts = np.stack([np.asarray(c) for c in j[k]], -1)
        np.testing.assert_allclose(
            t[k][~on_axis].numpy(),
            pts.transpose(2, 1, 0, 3)[~on_axis.numpy()], atol=1e-5)
    D = t["D"].numpy()
    assert (D[0] == 999.0).all()            # env 0: nothing active
    assert D[1, 5, 0] == 999.0              # env 1: deep in a box, blind
    assert D[2, 5, 0] < 0                   # env 2: inside a sphere


def test_group_min_distances(swept, models):
    t, j = swept
    _close(TE.group_min(models[1], torch.amin(t["D"], dim=2), 999.0).T,
           JSC.group_min_distances(j["mc"], j["D"], 999.0))


def test_group_min_empty_and_ungrouped(models):
    """A group without capsules reads max_distance, and capsules of no
    group reach no group."""
    _, tm, _ = models
    import dataclasses
    groups = np.asarray(tm.cap_group).copy()
    lost = groups == 3
    groups[lost] = -1
    m = dataclasses.replace(tm, cap_group=groups)
    d = torch.arange(2 * len(groups), dtype=torch.float32).reshape(2, -1)
    out = TE.group_min(m, d, 999.0)
    assert (out[:, 3] == 999.0).all()
    for g in range(tm.ngroup):
        if g != 3:
            np.testing.assert_array_equal(out[:, g].numpy(),
                                          d[:, groups == g].amin(1).numpy())


def test_group_obstacle_closest(swept, models):
    t, j = swept
    gd, gpc, gpo = TE.group_obstacle_distances(models[1], t["fk"], t["obs"])
    best = JSC.group_obstacle_closest(j["mc"], j["D"], j["PC"], j["PO"], 999.0)
    _close(tuple(gd.T), [b[0] for b in best])
    # the groups whose closest pair is the on-axis one, held by distance
    off = np.ones(gd.shape, bool)
    for b, c, _ in t["on_axis"].nonzero().tolist():
        off[b, models[1].cap_group[c]] = False
    for i, pts in ((1, gpc), (2, gpo)):
        want = np.stack([np.stack([np.asarray(x) for x in bg[i]], -1)
                         for bg in best], 1)                  # (B, G, 3)
        np.testing.assert_allclose(pts.numpy()[off], want[off], atol=1e-5)


def test_table_group_distances(swept, models):
    t, j = swept
    scene = build_scene([], 2.0, 1.3, 0.4, 0.0)
    center, half = (tuple(float(x) for x in v)
                    for v in (scene.table_center, scene.table_half))
    _close(tuple(TE.group_table_distances(models[1], t["fk"], scene).T),
           JSC.table_group_distances(j["mc"], j["P0"], j["P1"], j["RC"],
                                     center, half, (0,), 999.0))


def test_engine_group_distances(models):
    """The per-env group reductions of sim/engine.py, batched in the port,
    vmapped on the JAX side."""
    jm, tm, _ = models
    q, qd = _random_q(6)
    caps, _ = TK.capsule_endpoints_world(tm, TK.fk_world(tm, torch.as_tensor(q)))
    obs = _obstacles(7, caps=caps[:, 4].numpy())
    fk_t = TK.fk_world(tm, torch.as_tensor(q), torch.as_tensor(qd))
    t = TE.group_obstacle_distances(tm, fk_t, _as(obs, torch))
    j = jax.vmap(lambda a, o: JE.group_obstacle_distances(
        jm, JK.fk_world(jm, a), o))(jnp.asarray(q), _as(obs, jnp))
    _close(t, j, 1e-5)
    assert (t[0][0] == 999.0).all()
    for table in ((2.0, 1.3, 0.4, 0.0), (1.1, 0.7, 0.4, -0.3)):
        jscene = jax_scene([], *table)
        _close(TE.group_table_distances(tm, fk_t, build_scene([], *table)),
               jax.vmap(lambda a: JE.group_table_distances(
                   jm, JK.fk_world(jm, a), jscene))(jnp.asarray(q)))


# ------------------------------------------------------------ physics step

def _physics_states(n_substeps, tm):
    """B = 8 ReachAO states with 2 obstacles and moving obstacles: envs 0
    and 1 have a sphere, env 2 a box, driven at a link so that they collide
    mid-step; env 3 starts frozen; env 7's second obstacle is inactive."""
    rng = np.random.default_rng(10 + n_substeps)
    neutral = np.asarray(jrao.NEUTRAL, np.float32)
    q = np.clip(neutral + rng.normal(0, 0.2, (B, 7)), tm.q_lo, tm.q_hi)
    q = q.astype(np.float32)
    qd = rng.normal(0, 0.3, (B, 7)).astype(np.float32)
    tgt = (q + rng.normal(0, 0.05, (B, 7))).astype(np.float32)
    fk = TK.fk_world(tm, torch.as_tensor(q))
    link = TK.site_com_position(tm, fk, 4).numpy()            # panda_link4
    pos = rng.uniform([0.4, -0.3, 0.1], [0.8, 0.3, 0.5], (B, 2, 3))
    vel = rng.uniform(-0.2, 0.2, (B, 2, 3))
    size = np.full((B, 2, 3), 0.05)
    typ = np.full((B, 2), OBS_SPHERE)
    typ[2, 0], size[2, 0] = OBS_BOX, (0.05, 0.04, 0.06)
    typ[4:, 1] = OBS_BOX
    # from the side (-y), across the link within the policy step
    start, travel = 0.3, 0.35
    for b in (0, 1, 2):
        pos[b, 0] = link[b] + (0.0, -start, 0.0)
        vel[b, 0] = (0.0, travel / (n_substeps * DT), 0.0)
    active = np.ones((B, 2), bool)
    active[7, 1] = False
    collided = np.zeros(B, bool)
    collided[3] = True
    return dict(q=q, qd=qd, ctrl_target=tgt,
                obstacle_pos=pos.astype(np.float32),
                obstacle_vel=vel.astype(np.float32),
                obstacle_size=size.astype(np.float32),
                obstacle_type=typ.astype(np.int32), obstacle_active=active,
                is_collided=collided,
                link_obstacle_dist=np.full((B, 9), 0.123, np.float32))


@pytest.fixture(scope="module")
def jax_core():
    return jrao.make_reach_ao_core("reachao2")


SCENE = (2.0, 1.3, 0.4, 0.0)


def _run_both(jax_core, models, n_substeps, **kw):
    """One policy step of the JAX package's batched collision physics and
    of the port's on the same states; returns the input fields, both
    outputs and the port's physics."""
    jm, tm, _ = models
    fields = _physics_states(n_substeps, tm)
    jstates = jax.vmap(jax_core.init_state)(
        jax.random.split(jax.random.PRNGKey(0), B))
    jstates = jstates.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tstates = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    kw = dict(dict(n_substeps=n_substeps, ctrl_mode=0, moving_obstacles=True),
              **kw)
    jout = JSC.make_batched_collision_physics(
        jm, jax_core.task.scene, n_obstacles=2, dt=DT, **kw)(jstates)
    phys = TE.CollisionPhysics(tm, build_scene([], *SCENE), **kw)
    return fields, tstates, jout, phys(tstates), phys


def _hold(tout, jout):
    np.testing.assert_allclose(tout.q.numpy(), np.asarray(jout.q), atol=ATOL_Q)
    np.testing.assert_allclose(tout.qd.numpy(), np.asarray(jout.qd),
                               atol=ATOL_QD)
    np.testing.assert_allclose(tout.link_obstacle_dist.numpy(),
                               np.asarray(jout.link_obstacle_dist),
                               atol=ATOL_LINK)
    np.testing.assert_allclose(tout.obstacle_pos.numpy(),
                               np.asarray(jout.obstacle_pos), atol=ATOL)
    np.testing.assert_array_equal(tout.is_collided.numpy(),
                                  np.asarray(jout.is_collided))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("n_substeps", [4, 20])
def test_collision_physics_matches_jax(eager_scan, jax_core, models, n_substeps,
                                       warm):
    fields, tstates, jout, tout, phys = _run_both(
        jax_core, models, n_substeps, warm_start=warm)
    _hold(tout, jout)
    # the driven envs collide mid-step: clear after the first substep,
    # collided at the end; the frozen env keeps its state
    phys.n_substeps = 1
    first = phys(tstates)
    assert not first.is_collided[:3].any()
    assert tout.is_collided[:4].all()
    np.testing.assert_array_equal(tout.q[3].numpy(), fields["q"][3])
    np.testing.assert_array_equal(tout.obstacle_pos[3].numpy(),
                                  fields["obstacle_pos"][3])
    assert (tout.link_obstacle_dist[3] == 0.123).all()
    assert phys.motor.launches == 0        # CPU tensors: the plain route


@pytest.mark.parametrize("kw", [dict(freeze_on_collision=False),
                                dict(moving_obstacles=False)],
                         ids=["no_freeze", "static_obstacles"])
def test_collision_physics_options_match_jax(eager_scan, jax_core, models,
                                             kw):
    """The branches the ReachAO defaults leave out: no freeze (the collided
    envs move on), and obstacles that stay where they are."""
    fields, _, jout, tout, _ = _run_both(jax_core, models, 4,
                                         warm_start=False, **kw)
    _hold(tout, jout)
    if "freeze_on_collision" in kw:
        assert not np.array_equal(tout.q[3].numpy(), fields["q"][3])
    else:
        np.testing.assert_array_equal(tout.obstacle_pos.numpy(),
                                      fields["obstacle_pos"])


def test_collision_physics_routes_by_device(models):
    """CPU tensors take the plain substep: no K1 launch, and the result is
    plain_substep_step's.  The engine builds one physics for every obstacle
    count, with K1 at one substep and cold, and no safety distance."""
    _, tm, _ = models
    scene = build_scene([], *SCENE)
    phys = TE.make_batched_physics_step(tm, scene, check_collision=True,
                                        has_bodies=False)
    assert isinstance(phys, TE.CollisionPhysics)
    assert phys.motor.n_substeps == 1 and not phys.motor.warm_start
    assert phys.collision_safety_distance == 0.0
    q, qd = _random_q(8)
    args = [torch.as_tensor(a) for a in (q, qd, q)]
    a = phys.motor_substep_step(*args)
    b = phys.plain_substep_step(*args)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    assert a[2] is None and phys.motor.launches == 0


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_lcp_warm_setting_reaches_only_the_collision_step(models,
                                                          monkeypatch, env):
    """PANDA_LCP_WARM decides the collision step's warm start, in one
    place; K1 on that step is always cold, and the Reach step's K1 always
    warm, as the TPU kernel is."""
    _, tm, _ = models
    if env is None:
        monkeypatch.delenv("PANDA_LCP_WARM", raising=False)
    else:
        monkeypatch.setenv("PANDA_LCP_WARM", env)
        monkeypatch.setattr(TD, "LCP_WARM_START", env != "0")
    scene = build_scene([], *SCENE)
    phys = TE.make_batched_physics_step(tm, scene, check_collision=True,
                                        has_bodies=False)
    assert phys.warm_start == (env == "1")
    assert not phys.motor.warm_start
    reach = TE.make_batched_physics_step(tm, scene, has_bodies=False)
    assert reach.motor.warm_start

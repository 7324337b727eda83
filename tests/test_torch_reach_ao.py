"""Port parity: the ReachAO task of panda_gym_tpu_torch against
panda_gym_tpu's, both on the CPU.

The configuration, the scenario table and its static boxes, the rewards,
the success rules and the reset's validity masks are held against JAX on
identical inputs (B = 8; the reset's candidates are drawn once with numpy
and handed to both sides).  The port's own draws are held to the reset's
invariants and the samplers to their ranges, since the two sides draw from
different random streams.  The end-to-end step is in
test_torch_reach_ao_step.py.
"""
import dataclasses
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.ops import kinematics as JK
from panda_gym_tpu.rl import config as jcfg
from panda_gym_tpu.sim.engine import (
    group_obstacle_distances as jgroup_obstacle_distances,
    group_table_distances as jgroup_table_distances)

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.ops import kinematics as TK
from panda_gym_tpu_torch.rl import config as tcfg
from panda_gym_tpu_torch.sim.state import OBS_BOX

B = 8
ATOL = 1e-6

SCENARIOS = [
    "reach1", "reach2", "reach3", "reachao1", "reachao2", "reachao3",
    "reachao_rand", "reachao_rand_start", "reachao_rand_shape",
    "wall", "wall_h1", "wall_h15", "wall_h2", "wall_h22", "showcase",
    "wang-3", "wang-5", "wangexp-3", "wangexp_3", "wangexp-2",
    "narrow_tunnel", "tunnel", "library", "library1", "library2",
    "workshop", "workshop2", "workshop3", "industrial", "kasys",
    "warehouse", "countertop", "kitchen", "raised_shelves",
    "tabletop", "tabletop2", "bookshelves", "tunnel_rs",
    "reachao_rand_start_p25", "wall_p50",
]


# ---------------------------------------------------------------- config

def test_train_config_defaults_match_jax():
    t, j = tcfg.TrainConfig(), jcfg.TrainConfig()
    names = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == names
    for name in names:
        if name == "hyperparams":
            assert t.hyperparams.as_dict() == j.hyperparams.as_dict()
        else:
            assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("algorithm",
                         ["TQC", "TQC_v2", "SAC", "TD3", "DDPG", "PPO"])
def test_hyperparameters_match_jax(algorithm):
    assert (tcfg.Hyperparameters(algorithm).as_dict()
            == jcfg.Hyperparameters(algorithm).as_dict())


# -------------------------------------------------------------- scenarios

@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jax(name):
    t, j = trao.get_scenario(name), jrao.get_scenario(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    np.testing.assert_array_equal(trao.load_static_boxes(t.static_scenario),
                                  jrao._load_static_boxes(j.static_scenario))


def test_unknown_scenario_raises():
    with pytest.raises(ValueError):
        trao.get_scenario("nope")


def test_asset_copy_is_byte_equal():
    import panda_gym_tpu
    from pathlib import Path
    ref = (Path(panda_gym_tpu.__file__).parent / "assets"
           / "scenarios_compiled.json")
    assert filecmp.cmp(trao.ASSET_PATH, ref, shallow=False)
    assert "panda_gym_tpu_torch" in str(trao.ASSET_PATH)


def test_wangexp3_equals_reachao3_under_default_config():
    """The reference's wangexp-3 (reach_ao.py:701-722) differs from reachao3
    (:573-585) only in knobs that are inert under the default config: the
    pose randomizer and sample_size_obs (tests/test_reach_ao.py pins the
    same equality for the JAX package)."""
    a = trao.get_scenario("reachao3")
    b = trao.get_scenario("wangexp-3")
    assert a.goal_sampler == b.goal_sampler
    assert a.obstacle_sampler == b.obstacle_sampler
    assert a.spheres == b.spheres
    assert a.randomize_obstacle_position == b.randomize_obstacle_position
    assert a.random_num_obs is b.random_num_obs is False
    assert a.pose_randomizer != b.pose_randomizer
    assert b.sample_size_obs == (3, 3)


# -------------------------------------------------------- rewards, success

@pytest.fixture(scope="module")
def reward_inputs():
    rng = np.random.default_rng(3)
    n = 64
    achieved = rng.uniform(-0.5, 0.5, (n, 3))
    desired = achieved + rng.normal(0, 0.05, (n, 3))
    return {k: v.astype(np.float32) for k, v in dict(
        achieved=achieved, desired=desired,
        collided=(rng.uniform(size=n) < 0.3).astype(np.float32),
        ee_speed=rng.uniform(0, 1.0, n), effort=rng.uniform(0, 2.0, n),
        jerk=rng.uniform(0, 2.0, n), obst_pen=rng.uniform(0, 3.0, n)).items()}


def _tasks(**cfg):
    t = trao.make_reach_ao_core("reachao1", tcfg.TrainConfig(**cfg),
                                device="cpu")
    j = jrao.make_reach_ao_core("reachao1", jcfg.TrainConfig(**cfg))
    return t, j


@pytest.mark.parametrize("goal_condition", ["reach", "halt"])
@pytest.mark.parametrize("reward_type", ["sparse", "wang", "kumar_her",
                                         "kumar_optim", "kumar", "dense"])
def test_rewards_match_jax(reward_inputs, reward_type, goal_condition):
    t, j = _tasks(reward_type=reward_type, goal_condition=goal_condition)
    x = reward_inputs
    tr = t.task._reward(torch.as_tensor(x["achieved"]),
                        torch.as_tensor(x["desired"]),
                        **{k: torch.as_tensor(x[k]) for k in
                           ("collided", "ee_speed", "effort", "jerk",
                            "obst_pen")})
    jr = j.task._reward(jnp.asarray(x["achieved"]), jnp.asarray(x["desired"]),
                        **{k: jnp.asarray(x[k]) for k in
                           ("collided", "ee_speed", "effort", "jerk",
                            "obst_pen")})
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    aux = np.stack([x[k] for k in ("collided", "ee_speed", "effort", "jerk",
                                   "obst_pen")], -1)
    np.testing.assert_array_equal(
        t.task.reward_from_aux(t, torch.as_tensor(x["achieved"]),
                               torch.as_tensor(x["desired"]),
                               torch.as_tensor(aux)).numpy(), tr.numpy())


def _jax_states(core, fields):
    """A batched JAX EnvState with the given numpy fields."""
    s = jax.vmap(core.init_state)(jax.random.split(jax.random.PRNGKey(0),
                                                   len(fields["q"])))
    return s.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("goal_condition", ["reach", "halt"])
def test_success_and_reward_terms_match_jax(goal_condition):
    """is_success (the halt latch included), is_truncated, reward_aux and
    compute_reward on one batch of states, the JAX side vmapped."""
    t, j = _tasks(goal_condition=goal_condition)
    rng = np.random.default_rng(4)
    q = (np.asarray(jrao.NEUTRAL) + rng.normal(0, 0.1, (B, 7)))
    qd = rng.normal(0, 0.3, (B, 7))
    qd[:4] *= 0.01                              # slow envs, for the halt
    fields = dict(q=q.astype(np.float32), qd=qd.astype(np.float32),
                  cur_jacc=rng.normal(0, 1, (B, 7)).astype(np.float32),
                  cur_jerk=rng.normal(0, 1, (B, 7)).astype(np.float32),
                  link_obstacle_dist=rng.uniform(-0.02, 0.3, (B, 9)).astype(
                      np.float32),
                  is_collided=rng.uniform(size=B) < 0.3,
                  goal_reached=np.arange(B) == 5)
    js = _jax_states(j, fields)
    ts = convert.env_state(
        {k: np.asarray(getattr(js, k)) for k in convert.FIELDS}, "cpu")
    fk = TK.fk_world(t.model, ts.q, ts.qd)
    ee = t.robot.ee_position(fk).numpy()
    desired = ee + rng.normal(0, 0.04, (B, 3)).astype(np.float32)
    tsucc = t.task.is_success(t, torch.as_tensor(ee), torch.as_tensor(desired),
                              ts)
    jsucc = jax.vmap(lambda a, d, s: j.task.is_success(j, a, d, s))(
        jnp.asarray(ee), jnp.asarray(desired), js)
    if goal_condition == "halt":
        (tsucc, ts2), (jsucc, js2) = tsucc, jsucc
        np.testing.assert_array_equal(ts2.goal_reached.numpy(),
                                      np.asarray(js2.goal_reached))
    np.testing.assert_array_equal(tsucc.numpy(), np.asarray(jsucc))
    np.testing.assert_array_equal(
        t.task.is_truncated(t, ts).numpy(),
        np.asarray(jax.vmap(lambda s: j.task.is_truncated(j, s))(js)))
    np.testing.assert_allclose(
        t.task.reward_aux(t, ts).numpy(),
        np.asarray(jax.vmap(lambda s: j.task.reward_aux(j, s))(js)), atol=1e-5)
    jfk = jax.vmap(lambda a, b: JK.fk_world(j.model, a, b))(js.q, js.qd)
    for with_fk in (True, False):
        tr = t.task.compute_reward(t, torch.as_tensor(ee),
                                   torch.as_tensor(desired), ts,
                                   fk if with_fk else None)
        jr = jax.vmap(lambda a, d, s, f: j.task.compute_reward(
            j, a, d, s, f if with_fk else None))(
            jnp.asarray(ee), jnp.asarray(desired), js, jfk)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


@pytest.mark.parametrize("mode,dim", [
    ("closest_per_link", 29), ("closest", 21), ("vectors", 47),
    ("vectors+past", 101), ("vectors+closest_per_link", 56)])
def test_obs_mode_dims(mode, dim):
    cfg = tcfg.TrainConfig()
    cfg.task_observations = {"obstacles": mode, "prior": None}
    env = trao.make_reach_ao_core("reachao1", cfg, device="cpu")
    states, obs = env.batched_reset(2, torch.Generator().manual_seed(1))
    assert obs["observation"].shape == (2, dim)
    _, obs2, *_ = env.batched_step(states, torch.zeros(2, 7))
    assert obs2["observation"].shape == (2, dim)


# --------------------------------------------------------- reset masks

@pytest.fixture(scope="module", params=["reachao1", "reachao2"])
def mask_setup(request):
    """A port reset of B envs (one obstacle made a box), the same state on
    the JAX side, and 16 candidates per env drawn with numpy around the
    robot, some of them under the table top."""
    name = request.param
    t = trao.make_reach_ao_core(name, device="cpu")
    j = jrao.make_reach_ao_core(name)
    ts, _ = t.batched_reset(B, torch.Generator().manual_seed(2))
    typ = ts.obstacle_type.clone()
    typ[::2, 0] = OBS_BOX
    ts = ts.replace(obstacle_type=typ)
    js = _jax_states(j, convert.env_state_to_numpy(ts))
    rng = np.random.default_rng(5)
    cands = rng.uniform([-0.2, -0.6, -0.1], [0.9, 0.6, 0.9],
                        (B, 16, 3)).astype(np.float32)
    tfk = TK.fk_world(t.model, ts.q)
    jfk = jax.vmap(lambda q: JK.fk_world(j.model, q))(js.q)
    return t, j, ts, js, tfk, jfk, cands


def _jv(fn, *args):
    """fn vmapped over envs, then over each env's candidates (the last
    argument)."""
    return np.asarray(jax.vmap(lambda *a: jax.vmap(
        lambda p: fn(*a[:-1], p))(a[-1]))(*args))


def test_goal_probes_and_mask_match_jax(mask_setup):
    t, j, ts, js, tfk, jfk, cands = mask_setup
    c = torch.as_tensor(cands)
    jc = jnp.asarray(cands)
    robot = _jv(lambda f, p: j.task._probe_vs_robot(f, p, 0.05), jfk, jc)
    table = _jv(lambda p: j.task._probe_vs_table(p, 0.05), jc)
    obst = _jv(lambda s, p: j.task._point_obstacle_dist(s, p, 0.05), js, jc)
    np.testing.assert_allclose(t.task._probe_vs_robot(tfk, c, 0.05).numpy(),
                               robot, atol=ATOL)
    np.testing.assert_allclose(t.task._probe_vs_table(c, 0.05).numpy(),
                               table, atol=ATOL)
    np.testing.assert_allclose(
        t.task._point_obstacle_dist(ts, c, 0.05).numpy(), obst, atol=ATOL)
    for margin, with_obs in ((0.1, False), (0.03, True)):
        want = (robot > margin) & (table > margin)
        if with_obs:
            want &= obst.min(-1) > margin
        got = t.task.goal_mask(ts, tfk, c, margin, with_obs).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("overlap", [False, True])
def test_obstacle_probes_and_mask_match_jax(mask_setup, overlap):
    t, j, ts, js, tfk, jfk, cands = mask_setup
    t.task.spec = dataclasses.replace(t.task.spec,
                                      allow_overlapping_obstacles=overlap)
    c = torch.as_tensor(cands)
    jc = jnp.asarray(cands)
    for i in range(t.task.n_dynamic):
        size, typ = js.obstacle_size[:, i], js.obstacle_type[:, i]
        robot = _jv(lambda f, s, y, p: j.task._obstacle_vs_robot(f, p, s, y),
                    jfk, size, typ, jc)
        table = _jv(lambda s, y, p: j.task._obstacle_vs_table(p, s, y),
                    size, typ, jc)
        others = _jv(lambda st, s, y, p: j.task._obstacle_vs_obstacles(
            st, i, p, s, y), js, size, typ, jc)
        tsize, ttyp = ts.obstacle_size[:, i], ts.obstacle_type[:, i]
        np.testing.assert_allclose(
            t.task._obstacle_vs_robot(tfk, c, tsize, ttyp).numpy(), robot,
            atol=ATOL)
        np.testing.assert_allclose(
            t.task._obstacle_vs_table(c, tsize, ttyp).numpy(), table,
            atol=ATOL)
        np.testing.assert_allclose(
            t.task._obstacle_vs_obstacles(ts, i, c, tsize, ttyp).numpy(),
            others, atol=ATOL)
        r = np.where(np.asarray(typ) == OBS_BOX,
                     np.linalg.norm(np.asarray(size), axis=-1),
                     np.asarray(size)[:, 0])[:, None]
        want = (robot > 0.03) & (table > 0.03)
        want &= (np.linalg.norm(np.asarray(js.goal)[:, None] - cands, axis=-1)
                 - 0.05 - r) > 0.03
        if not overlap:
            want &= others.min(-1) > 0.0
            want &= (np.linalg.norm(cands, axis=-1) - 0.05 - r) <= 1.0
        got = t.task.obstacle_mask(ts, tfk, i, c, 0.03).numpy()
        np.testing.assert_array_equal(got, want)
    t.task.spec = trao.get_scenario(t.task.scenario_name)


# ------------------------------------------------ reset on the port's draws

@pytest.mark.parametrize("name", ["reachao1", "reachao2"])
def test_reset_invariants(name):
    """Goals clear robot and table by 0.1 (or sit on the EE, the fallback);
    obstacles clear robot, table and goal by 0.03 and each other, or sit on
    their first candidate; the start pose is neutral."""
    env = trao.make_reach_ao_core(name, device="cpu")
    n = 64
    states, obs = env.batched_reset(n, torch.Generator().manual_seed(7))
    task = env.task
    fk = TK.fk_world(env.model, states.q)
    ee = env.robot.ee_position(fk)
    goal = states.goal[:, None]
    clear = ((task._probe_vs_robot(fk, goal, 0.05)[:, 0] > 0.1)
             & (task._probe_vs_table(goal, 0.05)[:, 0] > 0.1))
    assert (clear | (states.goal == ee).all(-1)).all()
    assert clear.float().mean() > 0.9
    for i in range(task.n_dynamic):
        pos = states.obstacle_pos[:, i:i + 1]
        size, typ = states.obstacle_size[:, i], states.obstacle_type[:, i]
        ok = task._obstacle_vs_robot(fk, pos, size, typ)[:, 0] > 0.03
        ok &= task._obstacle_vs_table(pos, size, typ)[:, 0] > 0.03
        ok &= task._obstacle_vs_obstacles(states, i, pos, size,
                                          typ)[:, 0].amin(-1) > 0.0
        assert ok.float().mean() > 0.8
    assert torch.equal(states.q, torch.as_tensor(
        env.robot.neutral).expand(n, 7))
    assert obs["observation"].shape == (n, 56)
    assert (states.past_obs[:, 0] == states.past_obs[:, 2]).all()
    gd = states.link_obstacle_dist
    np.testing.assert_array_equal(
        obs["observation"][:, 20:29].numpy(), gd.numpy())


def test_reset_fallbacks(monkeypatch):
    """With no valid candidate the goal falls back to the EE position and
    each obstacle to its first candidate."""
    env = trao.make_reach_ao_core("reachao2", device="cpu")
    task = env.task
    drawn = []

    def draw(generator, state, fk, n):
        c = torch.rand(state.batch_size, n, 3, generator=generator)
        drawn.append(c)
        return c

    monkeypatch.setattr(task, "goal_mask",
                        lambda s, f, c, *a: torch.zeros(c.shape[:2], dtype=bool))
    monkeypatch.setattr(task, "obstacle_mask",
                        lambda s, f, i, c, m: torch.zeros(c.shape[:2],
                                                          dtype=bool))
    monkeypatch.setattr(task, "draw_obstacles", draw)
    states, obs = env.batched_reset(4, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(states.goal.numpy(),
                                  obs["achieved_goal"].numpy())
    for i in range(task.n_dynamic):
        assert torch.equal(states.obstacle_pos[:, i], drawn[i][:, 0])


def test_select_first_valid():
    cands = torch.arange(4 * 3 * 1, dtype=torch.float32).reshape(4, 3, 1)
    mask = torch.tensor([[0, 1, 1], [1, 0, 0], [0, 0, 0], [0, 0, 1]],
                        dtype=torch.bool)
    out = trao.select_first_valid(cands, mask, torch.full((4, 1), -1.0))
    assert out[:, 0].tolist() == [1.0, 3.0, -1.0, 11.0]


def test_samplers_stay_in_range():
    g = torch.Generator().manual_seed(0)
    n = (4096,)
    for kw in (dict(), dict(upper=True), dict(front=True),
               dict(three_quarter=True), dict(upper=True, front=True)):
        p = trao.sample_hollow_sphere(g, n, 0.5, 0.8, **kw)
        r = torch.linalg.vector_norm(p, dim=-1)
        assert r.min() >= 0.5 - 1e-6 and r.max() <= 0.8 + 1e-6
        if kw.get("upper"):
            assert (p[:, 2] >= 0).all()
        phi = torch.atan2(p[:, 1], p[:, 0])
        if kw.get("front"):
            assert (p[:, 0] >= -1e-7).all()
        elif kw.get("three_quarter"):
            assert phi.abs().max() <= 0.75 * np.pi + 1e-5
        else:
            assert phi.min() < -2.5 and phi.max() > 2.5
    for front in (False, True):
        p = trao.sample_inside_torus(g, n, front_half_only=front)
        ring = torch.linalg.vector_norm(p[:, :2], dim=-1) - 0.5
        assert torch.sqrt(ring ** 2 + (p[:, 2] - 0.5) ** 2).max() <= 0.05 + 1e-6
        if front:
            assert (p[:, 0] > 0).all()
    s = trao.sample_cuboid_sizes(g, (1000, 3))
    assert (s > 0).all() and torch.allclose(s.sum(-1), torch.tensor(0.2))
    assert abs(s.mean().item() - 0.2 / 3) < 0.005


def test_random_obstacle_count_and_shapes():
    """reachao_rand: 4 or 5 of its 6 dynamic obstacles stay near
    (sample_size_obs (4, 6), high exclusive), the rest are teleported
    far; reachao_rand_shape draws cuboid half extents summing to 0.2."""
    env = trao.make_reach_ao_core("reachao_rand", device="cpu")
    states, _ = env.batched_reset(32, torch.Generator().manual_seed(3))
    near = (torch.linalg.vector_norm(states.obstacle_pos[:, :6], dim=-1)
            < 5).sum(-1)
    assert set(near.tolist()) <= {4, 5} and len(set(near.tolist())) == 2
    env = trao.make_reach_ao_core("reachao_rand_shape", device="cpu")
    states, _ = env.batched_reset(8, torch.Generator().manual_seed(3))
    s = states.obstacle_size[:, 3:6]
    assert torch.allclose(s.sum(-1), torch.tensor(0.2))


def test_random_base_pose_and_moving_obstacles():
    """random_base (the one pose randomizer without IK) turns joint 1 only
    and starts clear; moving obstacles get velocities in +-0.2."""
    cfg = tcfg.TrainConfig(randomize_robot_pose=True,
                           randomize_obstacle_velocity=True)
    env = trao.make_reach_ao_core("wangexp-3", cfg, device="cpu")
    assert env.task.moving_obstacles
    states, _ = env.batched_reset(16, torch.Generator().manual_seed(4))
    neutral = torch.as_tensor(env.robot.neutral)
    assert torch.equal(states.q[:, 1:], neutral[1:].expand(16, 6))
    assert states.q[:, 0].std() > 0.3
    assert torch.equal(states.ctrl_target, states.q)
    v = states.obstacle_vel
    assert v.abs().max() <= 0.2 and v.abs().min() > 0


def test_unported_options_raise():
    # the prior observation is ported (test_prior_observation_matches_jax)
    # the IK pose randomizers are ported (test_ik_start_scenes_reset)
    for name in ("reachao_rand_start", "narrow_tunnel", "tunnel_rs"):
        trao.make_reach_ao_core(name, device="cpu")
    trao.make_reach_ao_core(
        "reachao1", tcfg.TrainConfig(randomize_robot_pose=True),
        device="cpu")
    # the mixture core is ported (tests/test_torch_train.py holds it)
    assert isinstance(trao.make_reach_ao_core("reachao1+wall", device="cpu"),
                      trao._MixtureReachAOEnv)
    # the gym class is ported (tests/test_torch_gym.py holds it)
    env = trao.PandaReachAOEnv(scenario="reachao1", device="cpu")
    assert env.observation_shapes["observation"] == (56,)
    # the static scenes and reachao1-3 run under the default config
    for name in ("reachao3", "wall", "tunnel", "wangexp-3"):
        trao.make_reach_ao_core(name, device="cpu")


# ------------------------------------------------------ IK pose randomizers
# one scene per IK randomizer, with the robot pose randomized
POSE_SCENES = {"torus": ("reach1", True), "torus_full": ("wang-3", True),
               "ik_goal": ("reachao2", True),
               "ik_sphere": ("reachao_rand_start", False),
               "ik_range": ("narrow_tunnel", False)}
N_POSES = 7           # POSE_CANDIDATES - 1 fresh draws per env
ATOL_IK = 1e-4        # tests/test_torch_kinematics_ik.py


@pytest.fixture(scope="module", params=list(POSE_SCENES))
def pose_setup(request):
    """Both cores of one scene, a port reset of B envs and the same state
    on the JAX side, and N_POSES pose targets per env drawn once (by the
    port's sampler) and handed to both sides."""
    name, by_config = POSE_SCENES[request.param]
    cfg = dict(randomize_robot_pose=True) if by_config else {}
    t = trao.make_reach_ao_core(name, tcfg.TrainConfig(**cfg), device="cpu")
    j = jrao.make_reach_ao_core(name, jcfg.TrainConfig(**cfg))
    ts, _ = t.batched_reset(B, torch.Generator().manual_seed(11))
    js = _jax_states(j, convert.env_state_to_numpy(ts))
    targets = t.task.draw_pose_targets(torch.Generator().manual_seed(12), B,
                                       N_POSES).numpy()
    if targets.ndim == 4:
        # every torus target reaches an EE height in [0.4, 0.6]: lower some
        # to 0.25 and 0.35, so that the height rule rejects them
        targets[:, :, ::3, 2] = 0.25
        targets[:4, :, :, 2] = 0.35
    return t, j, ts, js, targets


def _jax_ik(j, targets):
    """JAX's IK of every target from the neutral pose, as _randomize_pose
    calls it (reach_ao.py:580-581)."""
    q0 = jnp.asarray(j.robot.neutral)
    flat = jnp.asarray(targets.reshape(-1, 3))
    q = jax.jit(jax.vmap(lambda p: JK.dls_ik(
        j.robot.model, j.robot.ee_site, p, q0=q0, n_iters=30)))(flat)
    return np.asarray(q).reshape(targets.shape[:-1] + (-1,))


def test_pose_targets_follow_the_randomizer(pose_setup):
    t, j, ts, js, targets = pose_setup
    kind = t.task.spec.pose_randomizer
    if kind[0] == "torus":
        targets = t.task.draw_pose_targets(torch.Generator().manual_seed(12),
                                           B, N_POSES).numpy()
        assert targets.shape == (B, N_POSES, t.task.TORUS_CANDIDATES, 3)
        ring = np.linalg.norm(targets[..., :2], axis=-1) - 0.5
        assert (np.hypot(ring, targets[..., 2] - 0.5) <= 0.05 + 1e-6).all()
        if kind[1]:
            assert (targets[..., 0] > 0).all()
        return
    assert targets.shape == (B, N_POSES, 3)
    if kind[0] == "ik_sphere":
        r = np.linalg.norm(targets, axis=-1)
        assert r.min() >= kind[1] - 1e-6 and r.max() <= kind[2] + 1e-6
        assert (targets[..., 2] >= 0).all()
    elif kind[0] == "ik_range":
        assert (targets >= np.asarray(kind[1]) - 1e-7).all()
        assert (targets <= np.asarray(kind[2]) + 1e-7).all()


def test_ik_pose_candidates_match_jax(pose_setup):
    """The IK'd candidates of both sides from the same targets."""
    t, j, ts, js, targets = pose_setup
    got = t.task.ik_poses(t, torch.as_tensor(targets)).numpy()
    want = _jax_ik(j, targets)
    assert got.shape == want.shape == targets.shape[:-1] + (7,)
    np.testing.assert_allclose(got, want, atol=ATOL_IK)


def test_pose_masks_match_jax(pose_setup):
    """The torus height rule and the clearance rule of _set_coll_free_robot
    (reach_ao.py:728-750), evaluated by the port on JAX's own IK'd
    candidates, against the JAX package's distance functions on them; then
    the selection with JAX's fallbacks."""
    t, j, ts, js, targets = pose_setup
    model = j.robot.model
    qs = _jax_ik(j, targets)
    neutral = np.asarray(j.robot.neutral)
    if qs.ndim == 4:
        zs = _jv(lambda _, q: JK.site_com_position(
            model, JK.fk_world(model, q), j.robot.ee_site)[2],
            jnp.zeros(B), jnp.asarray(qs.reshape(B, -1, 7)))
        want = ((zs >= 0.4) & (zs <= 0.6)).reshape(qs.shape[:-1])
        got = t.task.torus_mask(t, torch.as_tensor(qs)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size and not want[:4].any()
        # the first valid of each draw, else neutral
        idx = want.argmax(-1)
        pick = np.take_along_axis(qs, idx[..., None, None], -2)[..., 0, :]
        qs = np.where(want.any(-1)[..., None], pick, neutral)
    qs = np.concatenate([np.asarray(js.q)[:, None], qs], 1)    # (B, P, 7)

    def clear(s, q):
        fk = JK.fk_world(model, q)
        gd, _, _ = jgroup_obstacle_distances(model, fk, s)
        td = jgroup_table_distances(model, fk, j.task.scene)
        return (jnp.min(gd) > 0.05) & (jnp.min(td) > 0.0)

    want = np.array(_jv(clear, js, jnp.asarray(qs)))
    got = t.task.robot_pose_mask(t, ts, torch.as_tensor(qs)).numpy()
    np.testing.assert_array_equal(got, want)
    q = trao.select_first_valid(torch.as_tensor(qs), torch.as_tensor(want),
                                torch.as_tensor(neutral).expand(B, 7))
    idx = want.argmax(1)
    np.testing.assert_array_equal(
        q.numpy(), np.where(want.any(1)[:, None], qs[np.arange(B), idx],
                            neutral))


@pytest.mark.parametrize("name", ["reachao_rand_start", "narrow_tunnel",
                                  "industrial"])
def test_ik_start_scenes_reset(name):
    """The three benchmark scenes that start from an IK'd pose build and
    reset: every start lies in the joint limits and either clears the
    obstacles by 0.05 and the table by 0 or is the neutral fallback."""
    env = trao.make_reach_ao_core(name, device="cpu")
    states, obs = env.batched_reset(B, torch.Generator().manual_seed(3))
    q = states.q
    lo, hi = torch.as_tensor(env.model.q_lo), torch.as_tensor(env.model.q_hi)
    assert ((q >= lo) & (q <= hi)).all()
    neutral = torch.as_tensor(env.robot.neutral)
    clear = env.task.robot_pose_mask(env, states, q[:, None])[:, 0]
    assert (clear | (q == neutral).all(1)).all()
    assert clear.float().mean() >= 0.5
    assert not (q == neutral).all(1).all()
    assert torch.equal(states.ctrl_target, q) and not states.qd.any()
    assert torch.isfinite(obs["observation"]).all()


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trao.make_reach_ao_core("reachao1")
    with pytest.raises(RuntimeError, match="cuda"):
        trao.make_reach_ao_core("reachao2", device="cuda")


# ------------------------------------------------------ prior observation

PRIOR_OBS = {"obstacles": "vectors+closest_per_link", "prior": "rrmc_neo"}


@pytest.mark.parametrize("name", ["reachao1", "tunnel"])
def test_prior_observation_matches_jax(name):
    """With a ``prior``, the task observation ends in NEO's command toward
    the goal (reach_ao.py:803-810): held against JAX's task_obs on the same
    states (B = 4, env 0 with an obstacle ~0.1 m from its end effector) at
    the NEO tolerance, atol and rtol 1e-4; the rest of the observation at
    1e-6."""
    jc = jcfg.TrainConfig(task_observations=dict(PRIOR_OBS))
    tc = tcfg.TrainConfig(task_observations=dict(PRIOR_OBS))
    jcore = jrao.make_reach_ao_core(name, config=jc)
    tcore = trao.make_reach_ao_core(name, config=tc, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    jstates, jobs = jax.jit(jax.vmap(jcore.reset))(keys)
    opos = np.asarray(jstates.obstacle_pos).copy()
    opos[0, 0] = np.asarray(jobs["achieved_goal"])[0] + [0.0, 0.1, 0.1]
    jstates = jstates.replace(obstacle_pos=jnp.asarray(opos, jnp.float32))

    def obs(s):
        return jcore.task.task_obs(jcore, s, JK.fk_world(jcore.model, s.q,
                                                         s.qd))

    want = np.asarray(jax.jit(jax.vmap(obs))(jstates))
    ts = convert.env_state(
        {k: np.asarray(getattr(jstates, k)) for k in convert.FIELDS}, "cpu")
    got = tcore.task.task_obs(tcore, ts, TK.fk_world(tcore.model, ts.q, ts.qd))
    assert got.shape == want.shape == (4, 36 + 7)
    np.testing.assert_allclose(got[:, :-7].numpy(), want[:, :-7], atol=ATOL)
    np.testing.assert_allclose(got[:, -7:].numpy(), want[:, -7:], atol=1e-4,
                               rtol=1e-4)
    assert got[:, -7:].abs().max() > 1e-3


def test_prior_observation_grows_the_obs_and_the_mixture_carries_it():
    """The observation grows by 7, on a scene and on a mixture core."""
    tc = tcfg.TrainConfig(task_observations=dict(PRIOR_OBS))
    for name in ("reachao1", "reachao1+tunnel"):
        plain = trao.make_reach_ao_core(name, device="cpu")
        core = trao.make_reach_ao_core(name, config=tc, device="cpu")
        _, o0 = plain.batched_reset(2, torch.Generator().manual_seed(0))
        states, o1 = core.batched_reset(2, torch.Generator().manual_seed(0))
        assert o1["observation"].shape[-1] == o0["observation"].shape[-1] + 7
        a = torch.zeros(2, 7)
        _, o2, *_ = core.batched_step(states, a)
        assert o2["observation"].shape == o1["observation"].shape
        assert torch.isfinite(o2["observation"]).all()

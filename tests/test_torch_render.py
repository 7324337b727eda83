"""The port's software renderer and the tools on it
(panda_gym_tpu_torch/render.py, eval/trajectory.py, eval/interact.py,
eval/goal_maker.py) on the CPU.

``render_state`` is held against the JAX package's on one ReachAO state
(the JAX reset carried across): the two rasterize the same triangles from
FK that agree to float32 rounding, so a pixel may differ only where a
triangle edge or a depth tie falls between the two; at most 0.5% of the
pixels may differ (measured: none of the 76,800).
"""
import json

import jax
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.render import render_state as jax_render_state

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.panda_tasks import make_core
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.eval import goal_maker, interact, trajectory
from panda_gym_tpu_torch.render import render_state, save_video

MAX_DIFF_SHARE = 0.005


def test_render_state_matches_jax():
    core = jrao.make_reach_ao_core("reachao1")
    jstate, _ = jax.jit(core.reset)(jax.random.PRNGKey(4))
    tcore = trao.make_reach_ao_core("reachao1", device="cpu")
    tstate = convert.env_state(
        {k: np.asarray(getattr(jstate, k))[None] for k in convert.FIELDS},
        "cpu")
    kw = dict(width=320, height=240, target_position=np.array([0.3, 0, 0.2]),
              distance=1.2, yaw=50, pitch=-25)
    ref = np.asarray(jax_render_state(core, jstate, **kw))
    img = render_state(tcore, tstate, **kw)
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    differ = (np.abs(img.astype(int) - ref.astype(int)).max(-1) > 0).mean()
    assert differ <= MAX_DIFF_SHARE, differ
    # the scene is drawn: robot, obstacles and goal leave the background
    assert (img != 230).any(-1).mean() > 0.01


def test_render_env_through_the_adapter_and_index():
    from panda_gym_tpu_torch.envs.panda_tasks import PandaPushEnv
    env = PandaPushEnv(device="cpu")
    env.reset(seed=1)
    img = env.render(width=120, height=90)
    assert img.shape == (90, 120, 3)
    core = make_core("reach", device="cpu")
    states, _ = core.batched_reset(3, torch.Generator().manual_seed(0))
    a = render_state(core, states, width=80, height=60, index=0)
    b = render_state(core, states, width=80, height=60, index=2)
    assert not np.array_equal(a, b)   # the goals differ


def test_trace_round_trip_and_draw(tmp_path):
    core = make_core("reach", device="cpu")
    gen = torch.Generator().manual_seed(3)

    def policy(obs, generator):
        return torch.rand(1, core.robot.action_dim,
                          generator=generator) * 2 - 1

    state, trace = trajectory.trace_episode(core, policy, gen, n_steps=6)
    assert trace["ee"].shape == (7, 3) and trace["speed"].shape == (7,)
    assert trace["reward"].shape == (6,) and trace["success"].dtype == bool
    assert (trace["speed"][1:] > 0).any()
    # the same generator seed gives the same trace
    _, again = trajectory.trace_episode(core, policy,
                                        torch.Generator().manual_seed(3),
                                        n_steps=6)
    np.testing.assert_array_equal(trace["ee"], again["ee"])
    path = str(tmp_path / "traces.npz")
    trajectory.save_traces(path, [trace, again])
    loaded = trajectory.load_traces(path)
    assert len(loaded) == 2
    for k, v in trace.items():
        np.testing.assert_array_equal(loaded[0][k], v)
    plain = render_state(core, state, width=160, height=120)
    img = trajectory.draw_traces(core, state, loaded, width=160, height=120)
    assert img.shape == plain.shape and (img != plain).any()
    gif = save_video([plain, img], str(tmp_path / "clip.gif"))
    assert gif.endswith(".gif")


@pytest.mark.parametrize("policy", ["zero", "random"])
def test_interact(policy, tmp_path, capsys):
    rows = interact.interact("reachao1", n_steps=3, policy=policy, seed=2,
                             save_frames=str(tmp_path / "f"), device="cpu")
    assert len(rows) == 3
    assert set(rows[0]) == {"t", "ee_error", "min_obstacle_dist", "reward",
                            "collided", "success"}
    assert all(np.isfinite(r["ee_error"]) for r in rows)
    assert "ee_error=" in capsys.readouterr().out
    assert len(list((tmp_path / "f").iterdir())) == 3
    if policy == "zero":
        again = interact.interact("reachao1", n_steps=3, policy=policy,
                                  seed=2, verbose=False, device="cpu")
        assert again == rows


def test_interact_callable_and_neo():
    rows = interact.interact(
        "reachao1", n_steps=2, verbose=False, device="cpu",
        policy=lambda state, obs: torch.full((1, 7), 0.5))
    assert len(rows) == 2
    rows = interact.interact("reachao1", n_steps=2, policy="neo",
                             verbose=False, device="cpu")
    assert len(rows) == 2
    with pytest.raises(ValueError):
        interact.interact("reachao1", n_steps=1, policy="bogus",
                          verbose=False, device="cpu")


def test_goal_maker_format_and_range(tmp_path):
    goals = goal_maker.make_scenario_goals(("reachao1", "wall"), n_goals=16,
                                           seed=0, device="cpu")
    assert set(goals) == {"reachao1", "wall"}
    for name, gs in goals.items():
        spec = trao.get_scenario(name)
        g = np.asarray(gs)
        assert g.shape == (16, 3) and isinstance(gs[0], tuple)
        assert (g >= np.asarray(spec.goal_low) - 1e-6).all()
        assert (g <= np.asarray(spec.goal_high) + 1e-6).all()
        assert len({tuple(x) for x in gs}) > 1
    again = goal_maker.make_scenario_goals(("reachao1",), n_goals=16, seed=0,
                                           device="cpu")
    assert again["reachao1"] == goals["reachao1"]
    path = str(tmp_path / "goals.json")
    written = goal_maker.main(path, n_goals=2, seed=1, device="cpu")
    assert set(written) == set(goal_maker.DEFAULT_SCENARIOS)
    on_disk = json.load(open(path))
    assert on_disk.keys() == written.keys()
    assert all(np.asarray(v).shape == (2, 3) for v in on_disk.values())

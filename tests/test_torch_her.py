"""Port parity: the HER replay buffer of panda_gym_tpu_torch/rl/her.py
against panda_gym_tpu/rl/her.py, on the CPU.

Episodes from numpy seeds go into both rings across the wrap-around; then
both sample from the same draws (JAX's own: the key split in four as
her.py:80-100 does, handed to the port's gather), with the rewards
recomputed by each package's ReachAO reward_from_aux (sparse, collision
penalty).  Everything is held exactly: indices, goals and rewards, and the
floats that are gathered.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.rl import her as JH

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.rl import her as TH

CAP, T, OBS, GOAL, ACT, AUX = 5, 4, 6, 3, 7, 5
BATCH = 64


def _episodes(seed, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    aux = np.abs(f(n, T, AUX))
    aux[..., 0] = rng.uniform(size=(n, T)) < 0.2        # collided flags
    ach = f(n, T + 1, GOAL)
    desired = ach[:, -1] + f(n, GOAL) * 0.1             # some successes
    return dict(obs=f(n, T + 1, OBS), achieved=ach, desired=desired,
                action=f(n, T, ACT), aux=aux,
                ep_len=rng.integers(1, T + 1, n).astype(np.int32),
                terminated=rng.uniform(size=(n, T)) < 0.3)


def _fill():
    jb = JH.create(CAP, T, OBS, GOAL, ACT, AUX)
    tb = TH.create(CAP, T, OBS, GOAL, ACT, AUX, device="cpu")
    for seed, n in ((0, 3), (1, 3), (2, 4)):   # wraps twice
        ep = _episodes(seed, n)
        jb = JH.add_episodes(jb, **{k: jnp.asarray(v) for k, v in ep.items()})
        tb = TH.add_episodes(tb, **{k: torch.as_tensor(v)
                                    for k, v in ep.items()})
    return jb, tb


def test_add_episodes_wraps_like_jax():
    jb, tb = _fill()
    assert (tb.write_idx, tb.n_stored) == (int(jb.write_idx),
                                           int(jb.n_stored)) == (0, CAP)
    for k in TH.TENSORS:
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    assert tb.ep_len.dtype == torch.int32 and tb.terminated.dtype == torch.bool
    # and carried across whole
    cb = convert.her_buffer({k: np.asarray(getattr(jb, k))
                             for k in convert.BUFFER_FIELDS}, "cpu")
    for k in TH.TENSORS:
        assert torch.equal(getattr(cb, k), getattr(tb, k)), k
    assert (cb.write_idx, cb.n_stored) == (tb.write_idx, tb.n_stored)


@pytest.mark.parametrize("n_batches", [1, 2])
def test_sample_matches_jax_on_the_same_draws(n_batches):
    jb = JH.create(CAP, T, OBS, GOAL, ACT, AUX)
    tb = TH.create(CAP, T, OBS, GOAL, ACT, AUX, device="cpu")
    for seed in range(n_batches):            # a partly filled ring too
        ep = _episodes(10 + seed, 3)
        jb = JH.add_episodes(jb, **{k: jnp.asarray(v) for k, v in ep.items()})
        tb = TH.add_episodes(tb, **{k: torch.as_tensor(v)
                                    for k, v in ep.items()})
    jcore = jrao.make_reach_ao_core("reachao1")
    tcore = trao.make_reach_ao_core("reachao1", device="cpu")
    jfn = lambda a, g, x: jax.vmap(
        lambda a_, g_, x_: jcore.task.reward_from_aux(jcore, a_, g_, x_))(
        a, g, x)
    tfn = lambda a, g, x: tcore.task.reward_from_aux(tcore, a, g, x)

    key = jax.random.PRNGKey(3)
    j = JH.sample(jb, key, BATCH, jfn)
    # her.py:80-100's draws
    k_ep, k_t, k_f, k_h = jax.random.split(key, 4)
    draws = dict(
        ep=jax.random.randint(k_ep, (BATCH,), 0, max(int(jb.n_stored), 1)),
        u_t=jax.random.uniform(k_t, (BATCH,)),
        u_f=jax.random.uniform(k_f, (BATCH,)),
        use_her=jax.random.uniform(k_h, (BATCH,)) < 0.8)
    t = TH.gather(tb, {k: torch.tensor(np.asarray(v))
                       for k, v in draws.items()}, tfn)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    # the relabelled goals and both reward branches are exercised
    her = np.asarray(draws["use_her"])
    assert her.any() and (~her).any()
    r = t["reward"].numpy()
    assert (r == 0).any() and (r <= -100).any()


def test_sample_draws_from_generator():
    _, tb = _fill()
    g = torch.Generator().manual_seed(5)
    d = TH.draw(tb, g, 1000)
    assert d["ep"].min() >= 0 and d["ep"].max() < CAP
    assert 0.7 < d["use_her"].float().mean() < 0.9
    again = TH.draw(tb, torch.Generator().manual_seed(5), 1000)
    for k in d:
        assert torch.equal(d[k], again[k])
    b = TH.sample(tb, torch.Generator().manual_seed(5), 1000,
                  lambda a, g_, x: torch.zeros(a.shape[0]))
    assert b["obs"].shape == (1000, OBS) and b["goal"].shape == (1000, GOAL)


def test_state_round_trip():
    _, tb = _fill()
    st = TH.save_state(tb)
    fresh = TH.create(CAP, T, OBS, GOAL, ACT, AUX, device="cpu")
    back = TH.load_state(fresh, st)
    for k in TH.TENSORS:
        assert torch.equal(getattr(back, k), getattr(tb, k)), k
    assert (back.write_idx, back.n_stored) == (tb.write_idx, tb.n_stored)
    small = TH.create(CAP - 1, T, OBS, GOAL, ACT, AUX, device="cpu")
    with pytest.raises(ValueError, match="resume buffer: leaf obs"):
        TH.load_state(small, st)

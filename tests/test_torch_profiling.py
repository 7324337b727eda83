"""The port's profiling hooks (panda_gym_tpu_torch/utils/profiling.py)
against panda_gym_tpu/utils/profiling.py, on CPU tensors: ``sync`` fetches
the same sum, ``StepTimer`` gives the same stats from the same samples and
keeps the same window, ``trace`` writes a Chrome trace, and
``device_memory_stats`` reports no card where there is none."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.utils import profiling as JP

from panda_gym_tpu_torch.utils import profiling as TP


def test_sync_fetches_the_sum():
    x = np.random.default_rng(0).normal(0, 1, (64, 7)).astype(np.float32)
    got = TP.sync(torch.as_tensor(x))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, JP.sync(jnp.asarray(x)), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 250], ids=["one", "few", "past-window"])
def test_step_timer_stats_match_jax(monkeypatch, n):
    """The same clock readings through both timers: the same samples, the
    same window and the same p50, p95 and units/s."""
    ticks = np.cumsum(np.random.default_rng(n).uniform(1e-3, 5e-3, 2 * n))
    timers = {}
    for mod in (TP, JP):
        clock = iter(ticks.tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(window=200)
        for _ in range(n):
            with timer:
                pass
        timers[mod] = timer
    assert timers[TP].samples == timers[JP].samples
    assert len(timers[TP].samples) == min(n, 200)
    t, j = timers[TP].stats(4096), timers[JP].stats(4096)
    assert t.keys() == j.keys() == {"p50_ms", "p95_ms", "units_per_sec"}
    for k in t:
        assert t[k] == pytest.approx(j[k], rel=1e-12), k
    assert TP.StepTimer().stats() == JP.StepTimer().stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path)) as prof:
        TP.sync(torch.ones(8, 8) @ torch.ones(8, 8))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_device_memory_stats_without_a_card():
    stats = TP.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    else:
        assert set(stats) == {f"cuda:{i}"
                              for i in range(torch.cuda.device_count())}

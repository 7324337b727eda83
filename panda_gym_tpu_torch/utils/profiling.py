"""Profiling hooks (port of panda_gym_tpu/utils/profiling.py):
torch.profiler traces and simple step timers.

    with profiling.trace("/tmp/trace") as prof:
        states, *_ = core.batched_step(states, actions)
        profiling.sync(states.q)
    # /tmp/trace/trace.json opens in Perfetto or chrome://tracing
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def sync(x: torch.Tensor) -> float:
    """Wait for everything queued on x's card, then fetch the scalar
    x.sum() to the host.  A wall-clock measurement of card work ends in
    this: PyTorch returns before the card finishes.  The fetched sum
    doubles as a cheap checksum."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.sum())


@contextlib.contextmanager
def trace(logdir: str = "panda_gym_tpu_torch_trace"):
    """torch.profiler over the block (the card's activity too where there
    is one), its Chrome trace written to <logdir>/trace.json on exit.
    Yields the profiler (``key_averages()`` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling wall-clock stats for the train loop (steps/s, p50/p95).
    A timed block that queues card work ends in ``sync``."""

    def __init__(self, window: int = 200):
        self.window = window
        self.samples = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    def stats(self, units_per_step: float = 1.0) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "p50_ms": 1e3 * s[n // 2],
            "p95_ms": 1e3 * s[min(int(n * 0.95), n - 1)],
            "units_per_sec": units_per_step / (sum(s) / n),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per visible card, the memory PyTorch's allocator holds in MiB: in
    use now and at its peak (torch.cuda.memory_stats).  Empty without a
    card, as the JAX package's is on a backend that reports none."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mib": ms.get("allocated_bytes.all.current", 0)
            / 2**20,
            "peak_bytes_mib": ms.get("allocated_bytes.all.peak", 0) / 2**20,
        }
    return out

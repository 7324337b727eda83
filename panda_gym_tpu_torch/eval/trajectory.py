"""Trajectory traces: record, export and draw end-effector paths (port of
panda_gym_tpu/eval/trajectory.py).

Replaces the reference's GUI debug-line trajectory visualization
(evaluation/evaluate.py:43-86 ``visualize_trajectory``: an addUserDebugLine
polyline through the recorded ee positions, colour-graded by speed) with an
offline equivalent: a rollout records the ee path on the device, traces are
exported as .npz, and a host-side viewer overlays the speed-graded polyline
on the software-rendered scene (render.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.render import _camera, render_state


def trace_episode(core, action_fn: Callable, generator: torch.Generator,
                  n_steps: int = 50):
    """Roll one episode of ``core`` (a batch of one env, reset from
    ``generator``) under ``action_fn(obs, generator) -> action`` (tensors of
    a batch of one on the core's device) through the per-env entry point
    ``core.step``; record the ee path.

    Returns (final_state, trace), trace a dict of ``ee`` (n_steps+1, 3),
    ``speed`` (n_steps+1,), ``reward`` (n_steps,) and ``success``
    (n_steps,): the data ``visualize_trajectory`` consumed (evaluate.py:43-66
    records the ee position per step).  The loop stays on the device; the
    trace comes to the host once, at the end."""
    state, obs = core.reset(generator)

    def ee_of(state):
        fk = K.fk_world(core.model, state.q, state.qd)
        vel = core.robot.ee_velocity(fk)
        return core.robot.ee_position(fk)[0], torch.linalg.vector_norm(vel[0])

    ee, speed, reward, success = [], [], [], []
    p, s = ee_of(state)
    ee.append(p)
    speed.append(s)
    for _ in range(n_steps):
        action = action_fn(obs, generator)
        state, obs, r, _, _, info = core.step(state, action)
        p, s = ee_of(state)
        ee.append(p)
        speed.append(s)
        reward.append(r[0])
        success.append(info["is_success"][0])
    trace = {
        "ee": torch.stack(ee).cpu().numpy(),
        "speed": torch.stack(speed).cpu().numpy(),
        "reward": (torch.stack(reward).cpu().numpy() if reward
                   else np.zeros(0, np.float32)),
        "success": (torch.stack(success).cpu().numpy() if success
                    else np.zeros(0, bool)),
    }
    return state, trace


def save_traces(path: str, traces: Sequence[Dict[str, np.ndarray]]) -> None:
    """Export traces to one .npz (arrays namespaced ``<i>/<field>``)."""
    flat = {}
    for i, t in enumerate(traces):
        for k, v in t.items():
            flat[f"{i}/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_traces(path: str) -> List[Dict[str, np.ndarray]]:
    data = np.load(path)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for k in data.files:
        i, field = k.split("/", 1)
        out.setdefault(int(i), {})[field] = data[k]
    return [out[i] for i in sorted(out)]


def _speed_color(speed: float, vmax: float) -> np.ndarray:
    """Green (slow) to red (fast), the reference's speed grading."""
    t = 0.0 if vmax <= 0 else min(float(speed) / vmax, 1.0)
    return np.array([255 * t, 255 * (1 - t), 40], np.uint8)


def _draw_segment(img: np.ndarray, u0, v0, u1, v1, color) -> None:
    h, w = img.shape[:2]
    n = int(max(abs(u1 - u0), abs(v1 - v0), 1)) + 1
    us = np.linspace(u0, u1, n).round().astype(int)
    vs = np.linspace(v0, v1, n).round().astype(int)
    ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
    img[vs[ok], us[ok]] = color
    # 1-px thickening for visibility
    ok2 = ok & (vs + 1 < h)
    img[vs[ok2] + 1, us[ok2]] = color


def draw_traces(core, state, traces: Sequence[Dict[str, np.ndarray]],
                width: int = 720, height: int = 480,
                target_position: Optional[np.ndarray] = None,
                distance: float = 1.4, yaw: float = 45, pitch: float = -30):
    """Render the scene (env 0 of ``state``) and overlay each trace as a
    speed-graded polyline."""
    img = render_state(core, state, width=width, height=height,
                       target_position=target_position, distance=distance,
                       yaw=yaw, pitch=pitch)
    target = target_position if target_position is not None else np.zeros(3)
    project, _ = _camera(target, distance, yaw, pitch, 0, width, height)
    for t in traces:
        ee = np.asarray(t["ee"], np.float64)
        speed = np.asarray(t.get("speed", np.zeros(len(ee))))
        vmax = max(float(speed.max()), 1e-6)
        u, v, z = project(ee)
        for i in range(len(ee) - 1):
            if z[i] <= 1e-3 or z[i + 1] <= 1e-3:
                continue
            _draw_segment(img, u[i], v[i], u[i + 1], v[i + 1],
                          _speed_color(speed[i + 1], vmax))
    return img

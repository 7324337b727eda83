"""Interactive env probe (port of panda_gym_tpu/eval/interact.py; reference
evaluation/panda_interact.py:20-59).

The reference opens a PyBullet GUI and steps the env by hand; headless,
this rolls a chosen policy through a scenario, prints per-step diagnostics
(the debug-HUD quantities: ee error, min obstacle distance, reward,
collision flag; reach_ao.py:1266-1289) and optionally saves
software-rendered frames.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch


def interact(scenario: str = "wangexp_3", n_steps: int = 60,
             policy: Union[str, Callable] = "zero", seed: int = 0,
             save_frames: Optional[str] = None, verbose: bool = True,
             device="cuda"):
    """Roll ``policy`` through one episode of one env and report the HUD
    quantities, one dict per step.

    policy: "zero" | "random" | "neo" (the QP prior) | a callable
    (state, obs) -> action (tensors of a batch of one).  The episode and the
    random actions draw from one torch.Generator seeded with ``seed``."""
    from panda_gym_tpu_torch.envs.tasks.reach_ao import make_reach_ao_core
    from panda_gym_tpu_torch.ops import kinematics as K

    core = make_reach_ao_core(scenario, device=device)
    dev = core.device
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    state, obs = core.reset(generator)
    na = core.robot.action_dim
    rows = []
    if save_frames:
        import os
        os.makedirs(save_frames, exist_ok=True)

    for t in range(n_steps):
        if callable(policy):
            action = torch.as_tensor(policy(state, obs), dtype=torch.float32,
                                     device=dev).reshape(1, na)
        elif policy == "zero":
            action = torch.zeros(1, na, device=dev)
        elif policy == "random":
            action = torch.rand(1, na, generator=generator,
                                device=dev) * 2.0 - 1.0
        elif policy == "neo":
            from panda_gym_tpu_torch.ops.neo import compute_action_neo
            fk = K.fk_world(core.model, state.q, state.qd)
            action = compute_action_neo(core.model, core.robot.ee_site,
                                        state, fk, state.goal)
        else:
            raise ValueError(f"unknown policy {policy!r}")

        state, obs, reward, term, trunc, info = core.step(state, action)
        # the HUD quantities in one read from the device
        hud = torch.stack([
            torch.linalg.vector_norm(obs["achieved_goal"][0]
                                     - obs["desired_goal"][0]),
            torch.amin(state.link_obstacle_dist[0]), reward[0].float(),
            state.is_collided[0].float(), info["is_success"][0].float(),
            term[0].float(), trunc[0].float()]).cpu().numpy()
        row = dict(t=t, ee_error=float(hud[0]),
                   min_obstacle_dist=float(hud[1]), reward=float(hud[2]),
                   collided=bool(hud[3]), success=bool(hud[4]))
        rows.append(row)
        if verbose:
            print("  ".join(f"{k}={v:.4f}" if isinstance(v, float)
                            else f"{k}={v}" for k, v in row.items()))
        if save_frames:
            from panda_gym_tpu_torch.render import render_state
            _save_png(f"{save_frames}/frame_{t:04d}.png",
                      render_state(core, state))
        if hud[5] or hud[6]:
            break
    return rows


def _save_png(path: str, rgb: np.ndarray):
    try:
        from PIL import Image
        Image.fromarray(np.asarray(rgb, np.uint8)).save(path)
    except ImportError:  # minimal PPM fallback, no deps
        ppm = path.rsplit(".", 1)[0] + ".ppm"
        h, w = rgb.shape[:2]
        with open(ppm, "wb") as f:
            f.write(f"P6 {w} {h} 255\n".encode())
            f.write(np.asarray(rgb, np.uint8).tobytes())


if __name__ == "__main__":
    import sys
    interact(*(sys.argv[1:2] or ["wangexp_3"]))

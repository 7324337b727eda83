"""Panda robot layer: action pipeline, robot observations, reset
(port of panda_gym_tpu/envs/robot.py:27-217).

Every method takes and returns batched tensors (the env batch leading), so
there is no vmap.  Control modes "ee" (end-effector displacement, resolved
for the whole batch by one ops/kinematics.py::dls_ik call), "js" (joint
position deltas), "jsd" (joint velocity) and "pcc" (teleport);
"clip"/"scale" action limiters; obs modes "ee"/"js";
velocity/acceleration/jerk bookkeeping (panda.py:120-175, 264-288).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from panda_gym_tpu_torch.models import panda_constants as pc
from panda_gym_tpu_torch.models.panda import EE_SITE, make_panda_model
from panda_gym_tpu_torch.ops import dynamics as D
from panda_gym_tpu_torch.ops import kinematics as K
from panda_gym_tpu_torch.sim.state import EnvState

# IK orientation target for "ee" control: (1,0,0,0) xyzw = gripper pointing
# down (panda.py:242-244).
EE_DOWN_QUAT = np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)


@dataclass
class PandaConfig:
    block_gripper: bool = False
    control_type: str = "js"           # panda.py:36 default
    obs_type: Tuple[str, ...] = ("ee",)
    action_limiter: str = "clip"       # panda.py:39
    base_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gripper: str = "auto"              # auto: welded if blocked else prismatic
    max_change_position: float = 0.05  # panda.py:74
    finger_change: float = 0.2         # panda.py:151
    neutral: Tuple[float, ...] = tuple(pc.NEUTRAL_JOINT_VALUES[:7])


class PandaRobot:
    """Owns the ChainModel + static config; all methods are pure."""

    def __init__(self, config: PandaConfig):
        self.config = config
        gripper = config.gripper
        if gripper == "auto":
            gripper = "welded" if config.block_gripper else "prismatic"
        self.gripper = gripper
        self.model = make_panda_model(base_position=config.base_position,
                                      gripper=gripper)
        self.ndof = self.model.ndof
        self.n_arm = 7
        self.ee_site = EE_SITE
        # action dim: 3 (ee) or n_arm (joints) + 1 finger channel if not
        # blocked (panda.py:47-48)
        n = 3 if config.control_type == "ee" else self.n_arm
        self.action_dim = n + (0 if config.block_gripper else 1)
        self.ctrl_mode = (D.CTRL_VELOCITY if config.control_type == "jsd"
                          else D.CTRL_POSITION)
        self.neutral = np.zeros(self.ndof, dtype=np.float32)
        self.neutral[:self.n_arm] = np.asarray(config.neutral, np.float32)

    # ------------------------------------------------------------------ obs
    def ee_position(self, fk):
        return K.site_com_position(self.model, fk, self.ee_site)

    def ee_velocity(self, fk):
        return K.site_com_velocity(self.model, fk, self.ee_site)

    def fingers_width(self, state: EnvState):
        """finger1 + finger2 joint positions (panda.py:300-304); identically
        0 for the welded gripper."""
        if self.ndof > 7:
            return state.q[:, 7] + state.q[:, 8]
        return torch.zeros_like(state.q[:, 0])

    def robot_obs(self, state: EnvState, fk):
        """panda.py:264-288 get_obs, (B, obs_dim)."""
        parts = []
        if "ee" in self.config.obs_type:
            parts += [self.ee_position(fk), self.ee_velocity(fk)]
        if "js" in self.config.obs_type:
            parts += [state.q[:, :self.n_arm], state.qd[:, :self.n_arm]]
        if not self.config.block_gripper:
            parts.append(self.fingers_width(state)[:, None])
        return torch.cat(parts, dim=-1)

    # --------------------------------------------------------------- action
    def _limit_action(self, action):
        if self.config.action_limiter == "scale":
            # scale down if any |a| > 1 (panda.py:129-133)
            mx = torch.amax(torch.abs(action), dim=-1, keepdim=True)
            return torch.where(mx > 1.0, action / mx, action)
        return torch.clamp(action, -1.0, 1.0)  # panda.py:134-135

    def set_action(self, state: EnvState, action) -> EnvState:
        """Motor targets + bookkeeping for (B, action_dim) actions
        (panda.py:120-175); runs before the physics step."""
        cfg = self.config
        action = self._limit_action(action)
        n = self.n_arm
        if cfg.control_type == "ee":
            # the EE displaced by action * 0.05, z kept above 0
            # (panda.py:235-240), resolved by 10 IK steps from q
            target = (self.ee_position(K.fk_world(self.model, state.q))
                      + action[:, :3] * cfg.max_change_position)
            target = torch.cat([target[:, :2],
                                torch.clamp_min(target[:, 2:], 0.0)], -1)
            quat = torch.as_tensor(EE_DOWN_QUAT, device=target.device)
            q_arm = K.dls_ik(self.model, self.ee_site, target,
                             target_quat=quat.expand(target.shape[0], 4),
                             q0=state.q, n_iters=10, n_arm=n)[:, :n]
        else:
            q_arm = state.q[:, :n] + action[:, :n] * cfg.max_change_position
        return self._finish_set_action(state, action, q_arm)

    def _finish_set_action(self, state: EnvState, action, q_arm) -> EnvState:
        """Everything after target-arm-angle resolution: gripper targets,
        control-mode dispatch, vel/acc/jerk bookkeeping (panda.py:137-175)."""
        cfg = self.config
        B = state.q.shape[0]
        if self.ndof > 7:
            if cfg.block_gripper:
                finger_t = torch.zeros(B, 2, dtype=q_arm.dtype,
                                       device=q_arm.device)
            else:
                width = self.fingers_width(state)
                target_w = width + action[:, -1] * cfg.finger_change  # :151-153
                finger_t = (target_w / 2.0)[:, None].expand(B, 2)     # :164
            target = torch.cat([q_arm, finger_t], dim=-1)
        else:
            target = q_arm

        q, qd = state.q, state.qd
        if cfg.control_type == "jsd":
            # velocity control: targets are the action itself (panda.py:155-158)
            ctrl_target = action[:, :self.n_arm]
            if self.ndof > 7:
                ctrl_target = torch.cat(
                    [ctrl_target, torch.zeros_like(ctrl_target[:, :2])], -1)
        elif cfg.control_type == "pcc":
            # teleport (panda.py:159-162): resetJointState zeroes velocity
            T = self.model.tensors(target.device)
            q = torch.clamp(target, T["q_lo"], T["q_hi"])
            qd = torch.zeros_like(state.qd)
            ctrl_target = q
        else:
            ctrl_target = target

        # velocity/acceleration/jerk bookkeeping, recorded pre-step with the
        # reference's exact (sign-flipped) finite differences (panda.py:167-172)
        prev_jvel = state.cur_jvel
        prev_jacc = state.cur_jacc
        cur_jvel = torch.zeros_like(state.cur_jvel)
        k = min(self.n_arm, 7)
        cur_jvel[:, :k] = state.qd[:, :k]
        cur_jacc = prev_jvel - cur_jvel
        cur_jerk = torch.abs(prev_jacc - cur_jacc)

        na = self.action_dim
        return state.replace(
            q=q, qd=qd, ctrl_target=ctrl_target.contiguous(),
            prev_action=state.recent_action,
            recent_action=action[:, :na],
            action_count=state.action_count + 1,
            prev_jvel=prev_jvel, cur_jvel=cur_jvel,
            prev_jacc=prev_jacc, cur_jacc=cur_jacc, cur_jerk=cur_jerk,
        )

    # ---------------------------------------------------------------- reset
    def reset_q(self, batch: int, device):
        """Neutral pose and zero velocity, (B, ndof) each (panda.py:290-298)."""
        q = torch.as_tensor(self.neutral, device=device).expand(
            batch, self.ndof).clone()
        return q, torch.zeros_like(q)

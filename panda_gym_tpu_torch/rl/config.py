"""Training configuration (port of panda_gym_tpu/rl/config.py, which imports
no JAX; copied whole so that the port reads nothing of the JAX package).

TrainConfig is the single flat experiment config (train_config.py:6-68 of
the reference); ReachAO is built from it.  Hyperparameters provides the
per-algorithm presets (hyperparameters.py:7-71: TQC / TQC_v2 / TD3 / PPO /
DDPG), which rl/learners.py and rl/train.py read (TQC, TQC_v2 and SAC
are ported).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Hyperparameters:
    """Per-algorithm presets (hyperparameters.py:7-71)."""

    def __init__(self, algorithm: str = "TQC"):
        self.algorithm = algorithm
        if algorithm == "TQC":
            self.learning_rate = 0.0007
            self.gamma = 0.98
            self.tau = 0.02
            self.buffer_size = 300_000
            self.batch_size = 256
            self.gradient_steps = 8
            self.train_freq = 8
            self.ent_coef = "auto"
            self.use_sde = True
            self.policy_kwargs = dict(log_std_init=-3, net_arch=[256, 256])
            self.n_quantiles = 25
            self.n_critics = 2
            self.top_quantiles_to_drop_per_net = 2
        elif algorithm == "TQC_v2":
            self.learning_rate = 7.3e-4
            self.buffer_size = 1_000_000
            self.batch_size = 256
            self.top_quantiles_to_drop_per_net = 5
            self.use_sde = True
            self.policy_kwargs = dict(log_std_init=-3, net_arch=[400, 300])
            self.gamma = 0.98
            self.tau = 0.02
            self.gradient_steps = 8
            self.train_freq = 8
            self.ent_coef = "auto"
            self.n_quantiles = 25
            self.n_critics = 2
        elif algorithm == "SAC":
            self.learning_rate = 7.3e-4
            self.gamma = 0.98
            self.tau = 0.02
            self.buffer_size = 300_000
            self.batch_size = 256
            self.gradient_steps = 8
            self.train_freq = 8
            self.ent_coef = "auto"
            self.policy_kwargs = dict(log_std_init=-3, net_arch=[256, 256])
        elif algorithm == "TD3":
            self.learning_rate = 1e-3
            self.gamma = 0.98
            self.buffer_size = 200_000
            self.gradient_steps = 8      # reference uses (1,"episode"); we
            self.train_freq = 8          # use step-based scheduling on-device
            self.batch_size = 256
            self.tau = 0.005
            self.policy_kwargs = dict(net_arch=[256, 256])
        elif algorithm == "DDPG":
            self.learning_rate = 1e-3
            self.gamma = 0.98
            self.buffer_size = 200_000
            self.gradient_steps = 1
            self.train_freq = 1
            self.batch_size = 256
            self.tau = 0.005
            self.noise_std = 0.1
            self.policy_kwargs = dict(net_arch=[256, 256])
        elif algorithm == "PPO":
            self.normalize = True
            self.n_envs = 16
            self.batch_size = 128
            self.n_steps = 512
            self.gamma = 0.99
            self.gae_lambda = 0.9
            self.n_epochs = 20
            self.ent_coef = 0.0
            self.max_grad_norm = 0.5
            self.vf_coef = 0.5
            self.learning_rate = 3e-5
            self.clip_range = 0.4
            self.policy_kwargs = dict(log_std_init=-2, net_arch=[256, 256])
        else:
            raise ValueError("Invalid algorithm")

    def as_dict(self) -> Dict:
        return dict(self.__dict__)


@dataclass
class TrainConfig:
    """Flat experiment config (train_config.py:6-68), same field names."""

    # wandb settings
    name: str = "default"
    job_type: str = "train"
    group: str = "default"

    # learning settings
    algorithm: str = "TQC"
    replay_buffer_class: str = "her"   # "her" | "uniform" (train_config.py:15)
    policy_type: str = "MultiInputPolicy"
    learning_starts: int = 10_000
    prior_steps: int = 0
    seed: int = 0

    # performance settings
    n_envs: int = 8
    # interleaved collect/update (rl/train.py): one gradient burst after
    # every vector env step instead of one big burst per episode batch —
    # keeps large n_envs sample-efficient.  utd overrides the SB3-derived
    # updates-per-transition ratio (TQC preset: 0.125); update_batch_size
    # overrides the algorithm preset's batch_size (fewer, larger updates
    # trade gradient count for TPU throughput).
    interleave_updates: bool = True
    # interleaved bursts only fire once the replay buffer holds this many
    # transitions (None -> max(2*learning_starts, 20k)); guards resumed
    # policies against high-UTD updates on a near-empty fresh buffer
    interleave_min_buffer: Optional[int] = None
    utd: Optional[float] = None
    update_batch_size: Optional[int] = None
    # full-training-state checkpoint cadence in env steps (0 = off): learner
    # + replay buffer + PRNG key + stage/step counters via orbax, written to
    # <run_dir>/full_state/ — kill-and-resume reproduces the uninterrupted
    # run exactly (SURVEY §5.3; the reference has no analogue, its resume is
    # manual best_model.zip reloading, setup_training.py:383-422).
    full_ckpt_freq: int = 0

    # environment settings
    env_name: str = "PandaReachAO-v3"
    randomize_robot_pose: bool = False
    # moving obstacles: sample a random obstacle velocity at reset and let
    # the engine integrate it each substep (reference reach_ao.py:104 sets
    # velocities, PyBullet integrates them, :997-1001, 1091-1095)
    randomize_obstacle_velocity: bool = False
    truncate_on_collision: bool = True
    terminate_on_success: bool = True
    fixed_target: Optional[List[float]] = None

    # rewards settings
    reward_type: str = "sparse"
    collision_reward: int = -100

    # goal condition settings
    goal_condition: str = "reach"
    ee_error_thresholds: List[float] = field(default_factory=lambda: [0.05, 0.05, 0.05])
    speed_thresholds: List[float] = field(default_factory=lambda: [0.5, 0.1, 0.01])
    safety_distance: float = 0.0

    # temporal settings
    max_timesteps: int = 600_000
    max_ep_steps: List[int] = field(default_factory=lambda: [50, 75, 100])
    n_substeps: int = 20

    # curriculum setup
    stages: List[str] = field(default_factory=lambda: ["reachao1", "reachao2", "reachao3"])
    success_thresholds: List[float] = field(default_factory=lambda: [0.9, 0.9, 1.0])

    # evaluation settings
    eval_freq: int = 10_000
    n_eval_episodes: int = 100
    # benchmark scenes evaluated during the FINAL curriculum stage, with a
    # best-model snapshot per scene (setup_training.py:255-290
    # eval_benchmark_scenes + get_eval_success_callbacks); [] disables
    benchmark_eval_scenes: List[str] = field(default_factory=lambda: [
        "library1", "library2", "narrow_tunnel", "workshop", "workshop2"])

    # observations and actions
    obs_type: Tuple[str, ...] = ("ee", "js")
    control_type: str = "js"
    action_limiter: str = "clip"
    limiter: str = "sim"
    task_observations: Dict = field(
        default_factory=lambda: {"obstacles": "vectors+closest_per_link", "prior": None})

    # visualization
    render: bool = False
    show_goal_space: bool = False
    show_debug_labels: bool = False
    debug_collision: bool = False

    # hyperparams
    hyperparams: Hyperparameters = field(default_factory=lambda: Hyperparameters("TQC"))

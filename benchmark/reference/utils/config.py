"""Typed configuration tree for environments and training.

Pure-Python copy of ``unitree_rl_gym_tpu/utils/config.py`` (the port imports
nothing of the JAX package).

Replaces the reference's nested-class config kernel
(``base_config.py:8-25`` + ``legged_robot_config.py``) with plain Python
dataclasses. Field names, defaults, and semantics are kept 1:1 with
``LeggedRobotCfg`` / ``LeggedRobotCfgPPO`` (legged_robot_config.py:51-286)
so that per-robot configs read like the reference's and CLI overrides
(--num_envs/--seed/--max_iterations/...) keep their meaning
(helpers.py:97-120). Reward scales and command ranges are dicts (the
reference converts its class blobs to dicts before use anyway,
legged_robot.py:58-60).

Configs are *static*: they are consumed at trace time to build jitted
closures. Mutate them freely while building a task; never inside jit.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def _d(**kw):
    return field(default_factory=lambda: dict(kw))


def _l(*args):
    return field(default_factory=lambda: list(args))


@dataclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 48
    num_privileged_obs: Optional[int] = None
    num_actions: int = 12
    env_spacing: float = 3.0
    send_timeouts: bool = True
    episode_length_s: float = 20.0
    test: bool = False


@dataclass
class TerrainCfg:
    mesh_type: str = "plane"        # none | plane | heightfield | trimesh
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 25.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    measure_heights: bool = True
    measured_points_x: List[float] = _l(
        -0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1,
        0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
    )
    measured_points_y: List[float] = _l(
        -0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5
    )
    selected: bool = False
    terrain_kwargs: Optional[dict] = None
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_proportions: List[float] = _l(0.1, 0.1, 0.35, 0.25, 0.2)
    slope_treshold: float = 0.75
    # Per-env resident heightfield windows (the JAX package's formulation,
    # kept by the port): per-step height lookups read a [W, W] window
    # carried in EnvState via a tent-weight contraction instead of
    # gathering from the global heightfield (the JAX package chose this
    # because gathers inside its rollout scan serialise, doc/profile_r3.md).
    # The contraction is O(W^2) per contact point, so W is kept as small as
    # the refresh cadence allows: PPO re-centers windows every
    # `window_refresh_steps` control steps via the block-major fetch
    # (TerrainGrid.window_at; W must be a multiple of 8). Safety margin at the defaults: the block-aligned fetch
    # guarantees >= 8 cells (0.8 m) from the robot to the window edge vs
    # worst-case contact-point reach from base xy (~0.5 m) plus drift
    # over 12 steps at the 1.5 m/s push-cap velocity (~0.36 m, partially
    # concurrent); out-of-window lookups clamp to the window edge
    # (TerrainGrid.height_in_window).
    window_size: int = 24
    window_refresh_steps: int = 12


@dataclass
class CommandsCfg:
    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4           # lin_vel_x, lin_vel_y, ang_vel_yaw, heading
    resampling_time: float = 10.0
    heading_command: bool = True
    ranges: Dict[str, Tuple[float, float]] = _d(
        lin_vel_x=(-1.0, 1.0),
        lin_vel_y=(-1.0, 1.0),
        ang_vel_yaw=(-1.0, 1.0),
        heading=(-3.14, 3.14),
    )


@dataclass
class InitStateCfg:
    pos: List[float] = _l(0.0, 0.0, 1.0)
    rot: List[float] = _l(0.0, 0.0, 0.0, 1.0)     # xyzw
    lin_vel: List[float] = _l(0.0, 0.0, 0.0)
    ang_vel: List[float] = _l(0.0, 0.0, 0.0)
    default_joint_angles: Dict[str, float] = _d()


@dataclass
class ControlCfg:
    control_type: str = "P"         # P | V | T
    stiffness: Dict[str, float] = _d()
    damping: Dict[str, float] = _d()
    action_scale: float = 0.5
    decimation: int = 4


@dataclass
class AssetCfg:
    file: str = ""
    name: str = "legged_robot"
    foot_name: str = "None"
    penalize_contacts_on: List[str] = _l()
    terminate_after_contacts_on: List[str] = _l()
    disable_gravity: bool = False
    collapse_fixed_joints: bool = True
    fix_base_link: bool = False
    self_collisions: int = 0
    replace_cylinder_with_capsule: bool = True
    flip_visual_attachments: bool = True
    density: float = 0.001
    angular_damping: float = 0.0
    linear_damping: float = 0.0
    max_angular_velocity: float = 1000.0
    max_linear_velocity: float = 1000.0
    armature: float = 0.0
    thickness: float = 0.01
    # Restrict contact-point emission to the bodies whose contact forces
    # the env actually reads (feet + penalize_contacts_on +
    # terminate_after_contacts_on). Mirrors the reference's trimming of
    # training collision geometry (envs/h1_2/README.md:3-13) and bounds
    # the contact solver / Pallas VMEM footprint. False keeps every
    # collision geom in the URDF.
    prune_contact_bodies: bool = True


@dataclass
class DomainRandCfg:
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.5, 1.25)
    randomize_base_mass: bool = False
    added_mass_range: Tuple[float, float] = (-1.0, 1.0)
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    # Contact-stiffness DR (no reference analog — PhysX's solver is not
    # randomizable; ours is): per-env scale on the contact solver's
    # de-penetration bias (Baumgarte gain AND velocity cap together, see
    # physics/contact.py). Fixed per env at creation like the friction
    # buckets. Policies trained with this cannot tune themselves to one
    # exact contact response. (Note: the r3 theory that the handstand
    # transfer failure was contact softness turned out wrong — the r3
    # "hold" did not exist in any engine, doc/handstand_r4_notes.md —
    # but the knob remains useful for cross-engine robustness.)
    randomize_contact_stiffness: bool = False
    contact_stiffness_range: Tuple[float, float] = (0.5, 3.0)
    # Actuation-loop DR (no reference analog; r5 transfer work). The
    # handstand hold transfers 0/8 to MuJoCo under contact/friction/push
    # DR alone — over-rotation is a feedback-loop symptom (loop gain /
    # phase mismatch between engines), so randomize the loop itself:
    # * per-env proportional-gain scale, applied as a target transform
    #   q + g*(target - q) in the env step (exactly g*kp*(target-q) on
    #   the first substep; plant-side DR needs no backend change)
    # * per-env 1-control-step actuation delay (the classic sim2real
    #   phase-margin lever): delayed envs actuate the PREVIOUS step's
    #   policy action; observations still report the commanded one.
    # Both fixed per env at creation, like the friction buckets; None/off
    # keeps the exact step program (compile cache + golden traces).
    randomize_pd_gain: bool = False
    pd_gain_range: Tuple[float, float] = (0.8, 1.2)
    action_delay_prob: float = 0.0


def base_reward_scales() -> Dict[str, float]:
    """Default reward scales (legged_robot_config.py:160-175). Zero-scale
    terms are pruned at env build, like _prepare_reward_function
    (legged_robot.py:822-827)."""
    return dict(
        termination=-0.0,
        tracking_lin_vel=1.0,
        tracking_ang_vel=0.5,
        lin_vel_z=-2.0,
        ang_vel_xy=-0.05,
        orientation=-0.0,
        torques=-0.00001,
        dof_vel=-0.0,
        dof_acc=-2.5e-7,
        base_height=-0.0,
        feet_air_time=1.0,
        collision=-1.0,
        feet_stumble=-0.0,
        action_rate=-0.01,
        stand_still=-0.0,
    )


@dataclass
class RewardsCfg:
    scales: Dict[str, float] = field(default_factory=base_reward_scales)
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 1.0
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 1.0
    max_contact_force: float = 100.0


@dataclass
class NormalizationCfg:
    obs_scales: Dict[str, float] = _d(
        lin_vel=2.0,
        ang_vel=0.25,
        dof_pos=1.0,
        dof_vel=0.05,
        height_measurements=5.0,
    )
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: Dict[str, float] = _d(
        dof_pos=0.01,
        dof_vel=1.5,
        lin_vel=0.1,
        ang_vel=0.2,
        gravity=0.05,
        height_measurements=0.1,
    )


@dataclass
class ViewerCfg:
    ref_env: int = 0
    pos: List[float] = _l(10.0, 0.0, 6.0)
    lookat: List[float] = _l(11.0, 5.0, 3.0)


@dataclass
class SimCfg:
    dt: float = 0.005
    substeps: int = 1
    gravity: List[float] = _l(0.0, 0.0, -9.81)
    up_axis: int = 1
    # impulse-PGS contact solver knobs (physics/contact.py ContactParams;
    # the TPU-native replacement for the reference's PhysX block,
    # legged_robot_config.py:231-242). `contact_iterations` doubles
    # PhysX's num_position_iterations=4 by default;
    # `max_depenetration_velocity` is the knob PhysX exposes and the
    # reference sets to 1.0 (legged_robot_config.py:239).
    contact_iterations: int = 8
    contact_baumgarte: float = 0.2
    max_depenetration_velocity: float = 1.0


@dataclass
class LeggedRobotCfg:
    env: EnvCfg = field(default_factory=EnvCfg)
    terrain: TerrainCfg = field(default_factory=TerrainCfg)
    commands: CommandsCfg = field(default_factory=CommandsCfg)
    init_state: InitStateCfg = field(default_factory=InitStateCfg)
    control: ControlCfg = field(default_factory=ControlCfg)
    asset: AssetCfg = field(default_factory=AssetCfg)
    domain_rand: DomainRandCfg = field(default_factory=DomainRandCfg)
    rewards: RewardsCfg = field(default_factory=RewardsCfg)
    normalization: NormalizationCfg = field(default_factory=NormalizationCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    viewer: ViewerCfg = field(default_factory=ViewerCfg)
    sim: SimCfg = field(default_factory=SimCfg)
    seed: int = 1

    def copy(self) -> "LeggedRobotCfg":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Training (PPO) config — mirrors LeggedRobotCfgPPO
# ---------------------------------------------------------------------------


@dataclass
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: List[int] = _l(512, 256, 128)
    critic_hidden_dims: List[int] = _l(512, 256, 128)
    activation: str = "elu"
    # matmul compute dtype (params + losses stay fp32). bfloat16 is the
    # training default; set "float32" for exact-reproducibility studies.
    dtype: str = "bfloat16"
    # only for ActorCriticRecurrent:
    rnn_type: str = "lstm"
    rnn_hidden_size: int = 64
    rnn_num_layers: int = 1


@dataclass
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1.0e-3
    schedule: str = "adaptive"      # adaptive | fixed
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    # --- skill-preserving fine-tune knobs (no rsl_rl analog; both off by
    # default so the base algorithm stays exactly v1.0.2). Used by the
    # handstand kick-up recipe: upright-idle episodes are ~5x longer than
    # failed kick-up attempts, so once upright starts are mixed in their
    # samples dominate the PPO batch and erode the hold faster than the
    # kick-up is acquired (doc/handstand_r4_notes.md).
    # anchor_kl_coef: weight of a KL(anchor || pi) penalty applied on
    # task-critical states (env.ppo_state_class_fn == 1) toward a FROZEN
    # anchor policy (runner.set_anchor) — pins the already-learned skill
    # in its state region while the rest of state space trains freely.
    anchor_kl_coef: float = 0.0
    # class_target_frac: minimum effective share of task-critical-state
    # samples in every minibatch loss; when their empirical fraction
    # falls below this, per-sample importance weights rebalance the
    # surrogate/value/entropy means (one-sided — never downweights).
    class_target_frac: float = 0.0
    # class_weight_cap: upper bound on the class-1 importance weight
    # tau/frac. Without it, a minibatch whose task-critical fraction
    # collapses (e.g. every env fallen under a long termination grace)
    # gets weights of 100-1000x on a handful of samples — measured to
    # explode the surrogate variance and NaN a fine-tune (E7,
    # doc/handstand_r5_notes.md).
    class_weight_cap: float = 20.0
    # nan_guard: skip any minibatch update whose loss or gradients are
    # non-finite (params/optimizer state/LR keep their previous values
    # for that step). One critic-explosion minibatch otherwise NaNs every
    # parameter through the global-norm clip. No rsl_rl analog; semantics
    # identical on any run that never produces a non-finite step. The
    # per-minibatch finiteness checks cost time on the recurrent path, so
    # it is OFF by default and enabled by the fine-tune scripts whose
    # staged-termination regimes actually produce the explosions
    # (scripts/handstand_*_r5.py; doc/handstand_r5_notes.md finding 3).
    nan_guard: bool = False


@dataclass
class RunnerCfg:
    policy_class_name: str = "ActorCritic"
    algorithm_class_name: str = "PPO"
    num_steps_per_env: int = 24
    max_iterations: int = 1500
    save_interval: int = 50
    experiment_name: str = "test"
    run_name: str = ""
    resume: bool = False
    load_run: str | int = -1
    checkpoint: int = -1
    resume_path: Optional[str] = None


@dataclass
class TrainCfg:
    seed: int = 1
    runner_class_name: str = "OnPolicyRunner"
    policy: PolicyCfg = field(default_factory=PolicyCfg)
    algorithm: AlgorithmCfg = field(default_factory=AlgorithmCfg)
    runner: RunnerCfg = field(default_factory=RunnerCfg)

    def copy(self) -> "TrainCfg":
        return copy.deepcopy(self)


def class_to_dict(obj) -> dict:
    """Recursive dataclass -> dict (reference helpers.py:11-26 analogue,
    used for checkpoint metadata / logging)."""
    if dataclasses.is_dataclass(obj):
        return {
            f.name: class_to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: class_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(class_to_dict(v) for v in obj)
    return obj


def update_class_from_dict(obj, d: dict):
    """Apply a nested dict of overrides (reference helpers.py:28-35)."""
    for k, v in d.items():
        attr = getattr(obj, k, None)
        if dataclasses.is_dataclass(attr) and isinstance(v, dict):
            update_class_from_dict(attr, v)
        elif isinstance(attr, dict) and isinstance(v, dict):
            attr.update(v)
        else:
            setattr(obj, k, v)
    return obj

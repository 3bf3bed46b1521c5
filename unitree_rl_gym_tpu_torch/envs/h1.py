"""H1 humanoid task config (counterpart of
``unitree_rl_gym_tpu/envs/h1.py``; reference: h1_config.py)."""

from __future__ import annotations

from unitree_rl_gym_tpu_torch.utils.config import LeggedRobotCfg, TrainCfg


def h1_rough_cfg() -> LeggedRobotCfg:
    cfg = LeggedRobotCfg()
    # init_state (h1_config.py:4-26). The 12dof-style URDF used here keeps
    # arms/torso fixed, so only the 10 actuated joints carry defaults.
    cfg.init_state.pos = [0.0, 0.0, 1.0]
    cfg.init_state.default_joint_angles = {
        "left_hip_yaw_joint": 0.0, "left_hip_roll_joint": 0.0,
        "left_hip_pitch_joint": -0.1, "left_knee_joint": 0.3,
        "left_ankle_joint": -0.2,
        "right_hip_yaw_joint": 0.0, "right_hip_roll_joint": 0.0,
        "right_hip_pitch_joint": -0.1, "right_knee_joint": 0.3,
        "right_ankle_joint": -0.2,
    }
    # env (h1_config.py:28-32): 3+3+3+10+10+10+2 = 41
    cfg.env.num_observations = 41
    cfg.env.num_privileged_obs = 44
    cfg.env.num_actions = 10
    # domain_rand (h1_config.py:35-42)
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = (0.1, 1.25)
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = (-1.0, 3.0)
    cfg.domain_rand.push_robots = True
    cfg.domain_rand.push_interval_s = 5
    cfg.domain_rand.max_push_vel_xy = 1.5
    # control (h1_config.py:44-69)
    cfg.control.control_type = "P"
    cfg.control.stiffness = {
        "hip_yaw": 150, "hip_roll": 150, "hip_pitch": 150, "knee": 200,
        "ankle": 40, "torso": 300, "shoulder": 150, "elbow": 100,
    }
    cfg.control.damping = {
        "hip_yaw": 2, "hip_roll": 2, "hip_pitch": 2, "knee": 4,
        "ankle": 2, "torso": 6, "shoulder": 2, "elbow": 2,
    }
    cfg.control.action_scale = 0.25
    cfg.control.decimation = 4
    # asset (h1_config.py:71-78)
    cfg.asset.file = "resources/robots/h1/urdf/h1.urdf"
    cfg.asset.name = "h1"
    cfg.asset.foot_name = "ankle"
    cfg.asset.penalize_contacts_on = ["hip", "knee"]
    cfg.asset.terminate_after_contacts_on = ["pelvis"]
    cfg.asset.self_collisions = 0
    cfg.asset.flip_visual_attachments = False
    # rewards (h1_config.py:80-100)
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 1.05
    cfg.rewards.scales.update(
        tracking_lin_vel=1.0, tracking_ang_vel=0.5,
        lin_vel_z=-2.0, ang_vel_xy=-0.05, orientation=-1.0,
        base_height=-10.0, dof_acc=-2.5e-7, feet_air_time=0.0,
        collision=-1.0, action_rate=-0.01, torques=0.0,
        dof_pos_limits=-5.0, alive=0.15, hip_pos=-1.0,
        contact_no_vel=-0.2, feet_swing_height=-20.0, contact=0.18,
    )
    return cfg


def h1_rough_train_cfg() -> TrainCfg:
    t = TrainCfg()
    # policy (h1_config.py:103-111)
    t.policy.init_noise_std = 0.8
    t.policy.actor_hidden_dims = [32]
    t.policy.critic_hidden_dims = [32]
    t.policy.rnn_type = "lstm"
    t.policy.rnn_hidden_size = 64
    t.policy.rnn_num_layers = 1
    # runner (h1_config.py:114-118)
    t.runner.policy_class_name = "ActorCriticRecurrent"
    t.runner.max_iterations = 10000
    t.runner.experiment_name = "h1"
    return t

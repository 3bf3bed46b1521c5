"""G1 humanoid task config (counterpart of
``unitree_rl_gym_tpu/envs/g1.py``; reference: g1_config.py)."""

from __future__ import annotations

from reference.utils.config import LeggedRobotCfg, TrainCfg


def g1_rough_cfg() -> LeggedRobotCfg:
    cfg = LeggedRobotCfg()
    # init_state (g1_config.py:4-20)
    cfg.init_state.pos = [0.0, 0.0, 0.8]
    cfg.init_state.default_joint_angles = {
        "left_hip_yaw_joint": 0.0, "left_hip_roll_joint": 0.0,
        "left_hip_pitch_joint": -0.1, "left_knee_joint": 0.3,
        "left_ankle_pitch_joint": -0.2, "left_ankle_roll_joint": 0.0,
        "right_hip_yaw_joint": 0.0, "right_hip_roll_joint": 0.0,
        "right_hip_pitch_joint": -0.1, "right_knee_joint": 0.3,
        "right_ankle_pitch_joint": -0.2, "right_ankle_roll_joint": 0.0,
        "torso_joint": 0.0,
    }
    # env (g1_config.py:22-26)
    cfg.env.num_observations = 47
    cfg.env.num_privileged_obs = 50
    cfg.env.num_actions = 12
    # domain_rand (g1_config.py:28-35)
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = (0.1, 1.25)
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = (-1.0, 3.0)
    cfg.domain_rand.push_robots = True
    cfg.domain_rand.push_interval_s = 5
    cfg.domain_rand.max_push_vel_xy = 1.5
    # control (g1_config.py:38-57)
    cfg.control.control_type = "P"
    cfg.control.stiffness = {
        "hip_yaw": 100, "hip_roll": 100, "hip_pitch": 100,
        "knee": 150, "ankle": 40,
    }
    cfg.control.damping = {
        "hip_yaw": 2, "hip_roll": 2, "hip_pitch": 2, "knee": 4, "ankle": 2,
    }
    cfg.control.action_scale = 0.25
    cfg.control.decimation = 4
    # asset (g1_config.py:59-66)
    cfg.asset.file = "resources/robots/g1_description/g1_12dof.urdf"
    cfg.asset.name = "g1"
    cfg.asset.foot_name = "ankle_roll"
    cfg.asset.penalize_contacts_on = ["hip", "knee"]
    cfg.asset.terminate_after_contacts_on = ["pelvis"]
    cfg.asset.self_collisions = 0
    cfg.asset.flip_visual_attachments = False
    # rewards (g1_config.py:68-89)
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.78
    cfg.rewards.scales.update(
        tracking_lin_vel=1.0, tracking_ang_vel=0.5,
        lin_vel_z=-2.0, ang_vel_xy=-0.05, orientation=-1.0,
        base_height=-10.0, dof_acc=-2.5e-7, dof_vel=-1e-3,
        feet_air_time=0.0, collision=0.0, action_rate=-0.01,
        dof_pos_limits=-5.0, alive=0.15, hip_pos=-1.0,
        contact_no_vel=-0.2, feet_swing_height=-20.0, contact=0.18,
    )
    return cfg


def g1_rough_train_cfg() -> TrainCfg:
    t = TrainCfg()
    # policy (g1_config.py:92-100)
    t.policy.init_noise_std = 0.8
    t.policy.actor_hidden_dims = [32]
    t.policy.critic_hidden_dims = [32]
    t.policy.activation = "elu"
    t.policy.rnn_type = "lstm"
    t.policy.rnn_hidden_size = 64
    t.policy.rnn_num_layers = 1
    # runner (g1_config.py:104-108)
    t.runner.policy_class_name = "ActorCriticRecurrent"
    t.runner.max_iterations = 10000
    t.runner.experiment_name = "g1"
    return t

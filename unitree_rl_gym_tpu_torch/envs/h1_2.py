"""H1_2 humanoid task config (counterpart of
``unitree_rl_gym_tpu/envs/h1_2.py``; reference: h1_2_config.py).

Runs at 400 Hz physics (dt 0.0025) with decimation 8 => same 50 Hz policy
(h1_2_config.py:66-69); armature 1e-3 (h1_2_config.py:88). Uses the
simplified 12-DoF URDF (fixed wrists/hands, collision kept only on
foot-roll/knee/base — envs/h1_2/README.md:3-13)."""

from __future__ import annotations

from unitree_rl_gym_tpu_torch.utils.config import LeggedRobotCfg, TrainCfg


def h1_2_rough_cfg() -> LeggedRobotCfg:
    cfg = LeggedRobotCfg()
    # init_state (h1_2_config.py:6-34); fixed arm joints omitted (the URDF
    # holds them rigid, so they carry no dofs in this build)
    cfg.init_state.pos = [0.0, 0.0, 1.05]
    cfg.init_state.default_joint_angles = {
        "left_hip_yaw_joint": 0.0, "left_hip_roll_joint": 0.0,
        "left_hip_pitch_joint": -0.16, "left_knee_joint": 0.36,
        "left_ankle_pitch_joint": -0.2, "left_ankle_roll_joint": 0.0,
        "right_hip_yaw_joint": 0.0, "right_hip_roll_joint": 0.0,
        "right_hip_pitch_joint": -0.16, "right_knee_joint": 0.36,
        "right_ankle_pitch_joint": -0.2, "right_ankle_roll_joint": 0.0,
    }
    # env (h1_2_config.py:36-40): 3+3+3+12+12+12+2 = 47
    cfg.env.num_observations = 47
    cfg.env.num_privileged_obs = 50
    cfg.env.num_actions = 12
    # control (h1_2_config.py:43-66)
    cfg.control.control_type = "P"
    cfg.control.stiffness = {
        "hip_yaw_joint": 200.0, "hip_roll_joint": 200.0,
        "hip_pitch_joint": 200.0, "knee_joint": 300.0,
        "ankle_pitch_joint": 40.0, "ankle_roll_joint": 40.0,
    }
    cfg.control.damping = {
        "hip_yaw_joint": 2.5, "hip_roll_joint": 2.5,
        "hip_pitch_joint": 2.5, "knee_joint": 4,
        "ankle_pitch_joint": 2.0, "ankle_roll_joint": 2.0,
    }
    cfg.control.action_scale = 0.25
    cfg.control.decimation = 8
    # sim (h1_2_config.py:68-69)
    cfg.sim.dt = 0.0025
    # domain_rand (h1_2_config.py:71-78)
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = (0.1, 1.25)
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = (-1.0, 3.0)
    cfg.domain_rand.push_robots = True
    cfg.domain_rand.push_interval_s = 5
    cfg.domain_rand.max_push_vel_xy = 1.5
    # asset (h1_2_config.py:80-88)
    cfg.asset.file = "resources/robots/h1_2/h1_2_12dof.urdf"
    cfg.asset.name = "h1_2"
    cfg.asset.foot_name = "ankle_roll"
    cfg.asset.penalize_contacts_on = ["hip", "knee"]
    cfg.asset.terminate_after_contacts_on = ["pelvis"]
    cfg.asset.self_collisions = 0
    cfg.asset.flip_visual_attachments = False
    cfg.asset.armature = 1e-3
    # rewards (h1_2_config.py:90-111)
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 1.0
    cfg.rewards.scales.update(
        tracking_lin_vel=1.0, tracking_ang_vel=0.5,
        lin_vel_z=-2.0, ang_vel_xy=-0.05, orientation=-1.0,
        base_height=-10.0, dof_acc=-2.5e-7, dof_vel=-1e-3,
        feet_air_time=0.0, collision=0.0, action_rate=-0.01,
        dof_pos_limits=-5.0, alive=0.15, hip_pos=-1.0,
        contact_no_vel=-0.2, feet_swing_height=-20.0, contact=0.18,
    )
    return cfg


def h1_2_rough_train_cfg() -> TrainCfg:
    t = TrainCfg()
    # policy (h1_2_config.py:115-123)
    t.policy.init_noise_std = 0.8
    t.policy.actor_hidden_dims = [32]
    t.policy.critic_hidden_dims = [32]
    t.policy.rnn_type = "lstm"
    t.policy.rnn_hidden_size = 64
    t.policy.rnn_num_layers = 1
    # runner (h1_2_config.py:126-130)
    t.runner.policy_class_name = "ActorCriticRecurrent"
    t.runner.max_iterations = 10000
    t.runner.experiment_name = "h1_2"
    return t

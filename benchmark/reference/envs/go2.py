"""Go2 velocity-tracking task config (counterpart of
``unitree_rl_gym_tpu/envs/go2.py``; reference: go2_config.py). Uses the base
:class:`LeggedEnv` directly."""

from __future__ import annotations

from reference.utils.config import LeggedRobotCfg, TrainCfg


def go2_rough_cfg() -> LeggedRobotCfg:
    cfg = LeggedRobotCfg()
    cfg.init_state.pos = [0.0, 0.0, 0.42]
    cfg.init_state.default_joint_angles = {
        "FL_hip_joint": 0.1, "RL_hip_joint": 0.1,
        "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
        "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
        "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
        "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
        "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
    }
    cfg.control.control_type = "P"
    cfg.control.stiffness = {"joint": 20.0}
    cfg.control.damping = {"joint": 0.5}
    cfg.control.action_scale = 0.25
    cfg.control.decimation = 4
    cfg.asset.file = "resources/robots/go2/urdf/go2.urdf"
    cfg.asset.name = "go2"
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.asset.self_collisions = 1
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.25
    cfg.rewards.scales["torques"] = -0.0002
    cfg.rewards.scales["dof_pos_limits"] = -10.0
    return cfg


def go2_rough_train_cfg() -> TrainCfg:
    t = TrainCfg()
    t.algorithm.entropy_coef = 0.01
    t.runner.run_name = ""
    t.runner.experiment_name = "rough_go2"
    return t

"""Deploy config loader (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/config.py``; ``yaml`` is imported
where a file is read; reference: deploy_real/config.py — same YAML
schema: control_dt, msg_type hg|go, imu_type, topics, policy path,
joint->motor index maps, PD gains, arm/waist holding targets, obs/cmd
scales)."""

from __future__ import annotations

import numpy as np

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR


class Config:
    def __init__(self, file_path: str) -> None:
        import yaml

        with open(file_path, "r") as f:
            config = yaml.safe_load(f)

        self.control_dt = config["control_dt"]
        self.msg_type = config["msg_type"]
        self.imu_type = config["imu_type"]
        self.weak_motor = config.get("weak_motor", [])

        self.lowcmd_topic = config["lowcmd_topic"]
        self.lowstate_topic = config["lowstate_topic"]

        self.policy_path = (
            config["policy_path"]
            .replace("{UNITREE_RL_GYM_TPU_ROOT_DIR}", UNITREE_RL_GYM_TPU_ROOT_DIR)
            .replace("{LEGGED_GYM_ROOT_DIR}", UNITREE_RL_GYM_TPU_ROOT_DIR)
        )

        self.leg_joint2motor_idx = config["leg_joint2motor_idx"]
        self.kps = config["kps"]
        self.kds = config["kds"]
        self.default_angles = np.array(config["default_angles"], dtype=np.float32)

        self.arm_waist_joint2motor_idx = config["arm_waist_joint2motor_idx"]
        self.arm_waist_kps = config["arm_waist_kps"]
        self.arm_waist_kds = config["arm_waist_kds"]
        self.arm_waist_target = np.array(
            config["arm_waist_target"], dtype=np.float32
        )

        self.ang_vel_scale = config["ang_vel_scale"]
        self.dof_pos_scale = config["dof_pos_scale"]
        self.dof_vel_scale = config["dof_vel_scale"]
        self.action_scale = config["action_scale"]
        self.cmd_scale = np.array(config["cmd_scale"], dtype=np.float32)
        self.max_cmd = np.array(config["max_cmd"], dtype=np.float32)

        self.num_actions = config["num_actions"]
        self.num_obs = config["num_obs"]

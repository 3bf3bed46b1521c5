"""Real-robot controller (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/deploy_real.py``, the same code;
reference: deploy_real/deploy_real.py).

State machine preserved exactly (deploy_real.py:93-265):
  zero-torque (wait start) -> move-to-default (2 s lerp) ->
  default-pos-hold (wait A) -> run @ control_dt 50 Hz -> damping on exit
with the same obs assembly (IMU + encoders + remote sticks; torso->pelvis
IMU transform for torso-IMU robots), joint<->motor index maps, arm/waist
holding targets, and CRC-stamped commands.

Differences by design: the DDS transport is injected (see transport.py), so
the whole controller runs against the mock transport in CI; the policy may
be a TorchScript file or a flat numpy export."""

from __future__ import annotations

import time

import numpy as np

from unitree_rl_gym_tpu_torch.deploy.deploy_real.common.command_helper import (
    MotorMode,
    create_damping_cmd,
    create_zero_cmd,
    init_cmd_go,
    init_cmd_hg,
)
from unitree_rl_gym_tpu_torch.deploy.deploy_real.common.remote_controller import (
    KeyMap,
    RemoteController,
)
from unitree_rl_gym_tpu_torch.deploy.deploy_real.common.rotation_helper import (
    get_gravity_orientation,
    transform_imu_data,
)
from unitree_rl_gym_tpu_torch.deploy import obs_layout
from unitree_rl_gym_tpu_torch.deploy.deploy_real.config import Config


def load_policy(path: str):
    from unitree_rl_gym_tpu_torch.deploy.deploy_mujoco.deploy_mujoco import (
        load_policy as _lp,
    )

    return _lp(path)


class Controller:
    def __init__(self, config: Config, transport, policy=None,
                 sleep=time.sleep) -> None:
        self.config = config
        self.transport = transport
        self.sleep = sleep
        self.remote_controller = RemoteController()
        self.policy = policy or load_policy(config.policy_path)

        self.qj = np.zeros(config.num_actions, dtype=np.float32)
        self.dqj = np.zeros(config.num_actions, dtype=np.float32)
        self.action = np.zeros(config.num_actions, dtype=np.float32)
        self.target_dof_pos = config.default_angles.copy()
        self.obs = np.zeros(config.num_obs, dtype=np.float32)
        self.obs_segments = obs_layout.layout_for(
            config.num_obs, config.num_actions
        )
        self.cmd = np.array([0.0, 0.0, 0.0])
        self.counter = 0

        self.low_cmd = transport.new_cmd()
        self.wait_for_low_state()
        if config.msg_type == "hg":
            init_cmd_hg(self.low_cmd, transport.mode_machine, MotorMode.PR)
        elif config.msg_type == "go":
            init_cmd_go(self.low_cmd, weak_motor=self.config.weak_motor)

    # ------------------------------------------------------------------

    @property
    def low_state(self):
        return self.transport.low_state

    def send_cmd(self, cmd):
        self.transport.send(cmd)

    def wait_for_low_state(self):
        while self.low_state.tick == 0:
            self.sleep(self.config.control_dt)
        print("Successfully connected to the robot.")

    def _poll_remote(self):
        self.remote_controller.set(self.low_state.wireless_remote)

    # ------------------------------------------------------------------
    # state machine (deploy_real.py:93-151)
    # ------------------------------------------------------------------

    def zero_torque_state(self):
        print("Enter zero torque state.")
        print("Waiting for the start signal...")
        self._poll_remote()
        while self.remote_controller.button[KeyMap.start] != 1:
            create_zero_cmd(self.low_cmd)
            self.send_cmd(self.low_cmd)
            self.sleep(self.config.control_dt)
            self._poll_remote()

    def move_to_default_pos(self):
        print("Moving to default pos.")
        total_time = 2.0
        num_step = int(total_time / self.config.control_dt)
        dof_idx = (
            self.config.leg_joint2motor_idx
            + self.config.arm_waist_joint2motor_idx
        )
        kps = self.config.kps + self.config.arm_waist_kps
        kds = self.config.kds + self.config.arm_waist_kds
        default_pos = np.concatenate(
            (self.config.default_angles, self.config.arm_waist_target)
        )
        init_dof_pos = np.array(
            [self.low_state.motor_state[i].q for i in dof_idx],
            dtype=np.float32,
        )
        for i in range(num_step):
            alpha = i / num_step
            for j, motor_idx in enumerate(dof_idx):
                mc = self.low_cmd.motor_cmd[motor_idx]
                mc.q = init_dof_pos[j] * (1 - alpha) + default_pos[j] * alpha
                mc.qd = 0
                mc.kp = kps[j]
                mc.kd = kds[j]
                mc.tau = 0
            self.send_cmd(self.low_cmd)
            self.sleep(self.config.control_dt)

    def default_pos_state(self):
        print("Enter default pos state.")
        print("Waiting for the Button A signal...")
        self._poll_remote()
        while self.remote_controller.button[KeyMap.A] != 1:
            self._hold_default()
            self.send_cmd(self.low_cmd)
            self.sleep(self.config.control_dt)
            self._poll_remote()

    def _hold_default(self):
        for i, motor_idx in enumerate(self.config.leg_joint2motor_idx):
            mc = self.low_cmd.motor_cmd[motor_idx]
            mc.q = self.config.default_angles[i]
            mc.qd = 0
            mc.kp = self.config.kps[i]
            mc.kd = self.config.kds[i]
            mc.tau = 0
        self._hold_arm_waist()

    def _hold_arm_waist(self):
        for i, motor_idx in enumerate(self.config.arm_waist_joint2motor_idx):
            mc = self.low_cmd.motor_cmd[motor_idx]
            mc.q = self.config.arm_waist_target[i]
            mc.qd = 0
            mc.kp = self.config.arm_waist_kps[i]
            mc.kd = self.config.arm_waist_kds[i]
            mc.tau = 0

    # ------------------------------------------------------------------
    # 50 Hz control tick (deploy_real.py:153-225)
    # ------------------------------------------------------------------

    def run(self):
        self.counter += 1
        self._poll_remote()
        cfg = self.config
        for i, motor_idx in enumerate(cfg.leg_joint2motor_idx):
            self.qj[i] = self.low_state.motor_state[motor_idx].q
            self.dqj[i] = self.low_state.motor_state[motor_idx].dq

        quat = self.low_state.imu_state.quaternion      # wxyz
        ang_vel = np.array(
            [self.low_state.imu_state.gyroscope], dtype=np.float32
        )
        if cfg.imu_type == "torso":
            waist_idx = cfg.arm_waist_joint2motor_idx[0]
            quat, ang_vel = transform_imu_data(
                waist_yaw=self.low_state.motor_state[waist_idx].q,
                waist_yaw_omega=self.low_state.motor_state[waist_idx].dq,
                imu_quat=quat,
                imu_omega=ang_vel,
            )

        gravity_orientation = get_gravity_orientation(quat)
        qj_obs = (self.qj - cfg.default_angles) * cfg.dof_pos_scale
        dqj_obs = self.dqj * cfg.dof_vel_scale
        ang_vel = np.asarray(ang_vel).reshape(-1)[:3] * cfg.ang_vel_scale

        self.cmd[0] = self.remote_controller.ly
        self.cmd[1] = self.remote_controller.lx * -1
        self.cmd[2] = self.remote_controller.rx * -1

        # shared deploy obs layout (deploy/obs_layout.py — same table as
        # the MuJoCo harness and the C++ controller)
        obs_layout.build_obs(
            self.obs_segments, self.obs,
            ang_vel=ang_vel, gravity=gravity_orientation,
            command=self.cmd * cfg.cmd_scale * cfg.max_cmd,
            dof_pos=qj_obs, dof_vel=dqj_obs, last_action=self.action,
            phase_t=self.counter * cfg.control_dt,
        )

        self.action = np.asarray(
            self.policy(self.obs.copy()), dtype=np.float32
        ).reshape(-1)
        self.target_dof_pos = (
            cfg.default_angles + self.action * cfg.action_scale
        )

        for i, motor_idx in enumerate(cfg.leg_joint2motor_idx):
            mc = self.low_cmd.motor_cmd[motor_idx]
            mc.q = float(self.target_dof_pos[i])
            mc.qd = 0
            mc.kp = cfg.kps[i]
            mc.kd = cfg.kds[i]
            mc.tau = 0
        self._hold_arm_waist()
        self.send_cmd(self.low_cmd)
        self.sleep(cfg.control_dt)

    def damp(self):
        create_damping_cmd(self.low_cmd)
        self.send_cmd(self.low_cmd)


def main():
    import argparse
    import os

    parser = argparse.ArgumentParser()
    parser.add_argument("net", type=str, help="network interface")
    parser.add_argument("config", type=str,
                        help="config file name in the configs folder")
    args = parser.parse_args()
    config_path = os.path.join(
        os.path.dirname(__file__), "configs", args.config
    )
    config = Config(config_path)

    from unitree_rl_gym_tpu_torch.deploy.deploy_real.transport import DDSTransport

    transport = DDSTransport(config, net_if=args.net)
    controller = Controller(config, transport)
    controller.zero_torque_state()
    controller.move_to_default_pos()
    controller.default_pos_state()
    while True:
        try:
            controller.run()
            if controller.remote_controller.button[KeyMap.select] == 1:
                break
        except KeyboardInterrupt:
            break
    controller.damp()
    print("Exit")


if __name__ == "__main__":
    main()

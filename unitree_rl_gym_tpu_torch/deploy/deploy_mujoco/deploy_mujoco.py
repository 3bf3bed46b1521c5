"""Sim2Sim validation: run an exported policy in MuJoCo (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_mujoco/deploy_mujoco.py``).

The reference harness's loop: 500 Hz MuJoCo stepping with PD torques from
the latest targets, a policy tick every ``control_decimation`` steps (50
Hz) that rebuilds the training observation (omega, gravity from quat,
command, joint offsets, velocities, last action, 0.8 s phase clock;
:mod:`..obs_layout`), and wall-clock pacing only when a viewer is attached.

  * headless by default (``--headless`` / no DISPLAY), so it doubles as the
    automated cross-simulator test;
  * the policy may be a TorchScript file (``.pt``, what the port's
    ``scripts/play.py`` exports) or a flat-weight export directory (the
    numpy runtime, no torch needed at the edge);
  * returns summary stats (height, distance) for tests to hold.

``mujoco`` and ``yaml`` are imported by the functions that use them, so the
module imports where neither is installed.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.deploy import obs_layout


def get_gravity_orientation(quaternion):
    """Projected gravity from a wxyz quaternion (deploy_mujoco.py:12-24)."""
    qw, qx, qy, qz = quaternion
    g = np.zeros(3)
    g[0] = 2 * (-qz * qx + qw * qy)
    g[1] = -2 * (qz * qy + qw * qx)
    g[2] = 1 - 2 * (qw * qw + qz * qz)
    return g


def pd_control(target_q, q, kp, target_dq, dq, kd):
    return (target_q - q) * kp + (target_dq - dq) * kd


def load_policy(path: str):
    """TorchScript file or flat-export directory -> callable obs->action
    (on the CPU)."""
    if os.path.isdir(path):
        from unitree_rl_gym_tpu_torch.export.numpy_policy import NumpyPolicy

        np_policy = NumpyPolicy(path)
        return lambda obs: np.asarray(np_policy(obs[None])[0])
    import torch

    mod = torch.jit.load(path, map_location="cpu")

    def policy(obs):
        t = torch.from_numpy(obs.astype(np.float32)).unsqueeze(0)
        return mod(t).detach().numpy().squeeze()

    return policy


def load_config(config_path: str) -> dict:
    import yaml

    with open(config_path) as f:
        config = yaml.safe_load(f)
    for key in ("policy_path", "xml_path"):
        config[key] = (
            config[key]
            .replace("{UNITREE_RL_GYM_TPU_ROOT_DIR}", UNITREE_RL_GYM_TPU_ROOT_DIR)
            .replace("{LEGGED_GYM_ROOT_DIR}", UNITREE_RL_GYM_TPU_ROOT_DIR)
        )
    return config


def run(config: dict, headless: bool = True, max_steps: int | None = None,
        policy=None):
    """Run the sim2sim loop; returns summary stats."""
    import mujoco

    policy = policy or load_policy(config["policy_path"])
    simulation_dt = config["simulation_dt"]
    control_decimation = config["control_decimation"]
    kps = np.array(config["kps"], dtype=np.float32)
    kds = np.array(config["kds"], dtype=np.float32)
    default_angles = np.array(config["default_angles"], dtype=np.float32)
    ang_vel_scale = config["ang_vel_scale"]
    dof_pos_scale = config["dof_pos_scale"]
    dof_vel_scale = config["dof_vel_scale"]
    action_scale = config["action_scale"]
    cmd_scale = np.array(config["cmd_scale"], dtype=np.float32)
    num_actions = config["num_actions"]
    num_obs = config["num_obs"]
    cmd = np.array(config["cmd_init"], dtype=np.float32)

    action = np.zeros(num_actions, dtype=np.float32)
    target_dof_pos = default_angles.copy()
    obs = np.zeros(num_obs, dtype=np.float32)
    obs_segments = obs_layout.layout_for(num_obs, num_actions)

    m = mujoco.MjModel.from_xml_path(config["xml_path"])
    d = mujoco.MjData(m)
    m.opt.timestep = simulation_dt
    # start from the default joint configuration
    d.qpos[7:] = default_angles

    total_steps = max_steps or int(
        config["simulation_duration"] / simulation_dt
    )
    viewer = None
    if not headless:
        import mujoco.viewer

        viewer = mujoco.viewer.launch_passive(m, d)

    heights = []
    counter = 0
    try:
        for _ in range(total_steps):
            step_start = time.time()
            tau = pd_control(
                target_dof_pos, d.qpos[7:], kps,
                np.zeros_like(kds), d.qvel[6:], kds,
            )
            d.ctrl[:] = tau
            mujoco.mj_step(m, d)

            counter += 1
            if counter % control_decimation == 0:
                quat = d.qpos[3:7]          # wxyz (MuJoCo)
                # shared deploy obs layout (deploy/obs_layout.py — same
                # table as deploy_real and the C++ controller)
                obs_layout.build_obs(
                    obs_segments, obs,
                    ang_vel=d.qvel[3:6] * ang_vel_scale,
                    gravity=get_gravity_orientation(quat),
                    command=cmd * cmd_scale,
                    dof_pos=(d.qpos[7:] - default_angles) * dof_pos_scale,
                    dof_vel=d.qvel[6:] * dof_vel_scale,
                    last_action=action,
                    phase_t=counter * simulation_dt,
                )
                action = np.asarray(policy(obs.copy()), dtype=np.float32)
                target_dof_pos = action * action_scale + default_angles
                heights.append(float(d.qpos[2]))

            if viewer is not None:
                viewer.sync()
                dt_left = m.opt.timestep - (time.time() - step_start)
                if dt_left > 0:
                    time.sleep(dt_left)
    finally:
        if viewer is not None:
            viewer.close()

    return {
        "steps": counter,
        "sim_time": counter * simulation_dt,
        "final_height": float(d.qpos[2]),
        "mean_height": float(np.mean(heights)) if heights else 0.0,
        "min_height": float(np.min(heights)) if heights else 0.0,
        "distance_x": float(d.qpos[0]),
        "fell": bool(heights and min(heights) < 0.35),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("config_file", type=str,
                        help="config file name in the configs folder")
    parser.add_argument("--headless", action="store_true", default=False)
    args = parser.parse_args()
    cfg_path = os.path.join(
        os.path.dirname(__file__), "configs", args.config_file
    )
    config = load_config(cfg_path)
    stats = run(config, headless=args.headless or not os.environ.get("DISPLAY"))
    print(stats)


if __name__ == "__main__":
    main()

"""Go2 MuJoCo cross-sim scene and harnesses, walk and handstand
(counterpart of ``unitree_rl_gym_tpu/deploy/deploy_mujoco/go2_scene.py``,
on the port's go2 and go2_handstand cfgs).

The reference ships MuJoCo deploy scenes only for the humanoids, so the
*training* URDF is wrapped into a MuJoCo model via ``MjSpec`` (freejoint +
ground plane + per-joint torque motors, as ``utils/viz.py`` does), and two
harnesses replay exported policies against it:

  * :func:`run_go2_walk` — velocity-tracking walk (deploy_mujoco.run's 50
    Hz PD loop with the go2 48-dim training observation, which leads with
    the body-frame base linear velocity, a quantity only a simulator can
    measure);
  * :func:`run_go2_handstand` — handstand hold: starts inverted at the
    handstand keyframe and runs the exported handstand policy with the
    training env's rear-leg target clamp and MuJoCo-derived foot contact
    flags.

Cross-simulator in the strong sense: different engine, different
integrator and a different sim dt (500 Hz here vs 200 Hz training).
``mujoco`` is imported by the functions that use it.
"""

from __future__ import annotations

import os

import numpy as np

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR

GO2_URDF = "resources/robots/go2/urdf/go2.urdf"

# training joint order (envs/go2.py cfg / URDF traversal order)
GO2_JOINTS = [
    "FL_hip_joint", "FL_thigh_joint", "FL_calf_joint",
    "FR_hip_joint", "FR_thigh_joint", "FR_calf_joint",
    "RL_hip_joint", "RL_thigh_joint", "RL_calf_joint",
    "RR_hip_joint", "RR_thigh_joint", "RR_calf_joint",
]


def build_go2_model(joint_names=GO2_JOINTS):
    """MuJoCo model from the training URDF: freejoint + plane + one torque
    motor per joint in *training* dof order (ctrl[i] = torque on joint i)."""
    import mujoco

    spec = mujoco.MjSpec.from_file(
        os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, GO2_URDF)
    )
    spec.worldbody.first_body().add_freejoint()
    spec.worldbody.add_geom(
        type=mujoco.mjtGeom.mjGEOM_PLANE, size=[0, 0, 1],
        rgba=[0.85, 0.85, 0.85, 1.0],
    )
    for name in joint_names:
        a = spec.add_actuator()
        a.name = name
        a.trntype = mujoco.mjtTrn.mjTRN_JOINT
        a.target = name
        a.gear = [1.0] + [0.0] * 5
    m = spec.compile()
    qadr = np.array(
        [m.jnt_qposadr[m.joint(n).id] for n in joint_names], np.int64
    )
    vadr = np.array(
        [m.jnt_dofadr[m.joint(n).id] for n in joint_names], np.int64
    )
    return m, qadr, vadr


def _quat_rotate_inverse_wxyz(q, v):
    """R(q)^T v for a wxyz quaternion."""
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return R.T @ v


def _foot_contact_forces(m, d, foot_geom_ids):
    """Per-foot normal contact force vs the ground plane [4]."""
    import mujoco

    f = np.zeros(len(foot_geom_ids))
    idx = {g: i for i, g in enumerate(foot_geom_ids)}
    buf = np.zeros(6)
    for c in range(d.ncon):
        con = d.contact[c]
        for g in (con.geom1, con.geom2):
            if g in idx:
                mujoco.mj_contactForce(m, d, c, buf)
                f[idx[g]] += abs(buf[0])   # normal component
    return f


def _foot_geoms(m, order=("FL", "FR", "RL", "RR")):
    """Geom ids of the four feet. MuJoCo's URDF import fuses the
    fixed-jointed foot links into the calf bodies, so each foot is the
    lowest sphere geom on its ``*_calf`` body."""
    import mujoco

    ids = []
    for prefix in order:
        body = m.body(f"{prefix}_calf").id
        spheres = [
            g for g in range(m.ngeom)
            if m.geom_bodyid[g] == body
            and m.geom_type[g] == mujoco.mjtGeom.mjGEOM_SPHERE
        ]
        assert spheres, f"no sphere geom on {prefix}_calf"
        # distal-most sphere = the foot
        ids.append(max(spheres, key=lambda g: abs(m.geom_pos[g][2])))
    return ids


def run_go2_walk(policy, cmd=(0.5, 0.0, 0.0), duration_s: float = 5.0,
                 sim_dt: float = 0.002, control_decimation: int = 10):
    """50 Hz walk rollout; returns summary stats (deploy_mujoco.run's
    contract, go2-sized). Policy consumes the 48-dim training obs."""
    import mujoco

    from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg

    cfg = go2_rough_cfg()
    osc = cfg.normalization.obs_scales
    default_angles = np.array(
        [cfg.init_state.default_joint_angles[j] for j in GO2_JOINTS],
        np.float32,
    )
    kp = float(cfg.control.stiffness["joint"])
    kd = float(cfg.control.damping["joint"])
    action_scale = cfg.control.action_scale

    m, qadr, vadr = build_go2_model()
    m.opt.timestep = sim_dt
    d = mujoco.MjData(m)
    d.qpos[2] = cfg.init_state.pos[2]
    d.qpos[3] = 1.0                       # wxyz identity
    d.qpos[qadr] = default_angles
    mujoco.mj_forward(m, d)

    cmd = np.asarray(cmd, np.float32)
    cmd_scale = np.array([osc["lin_vel"], osc["lin_vel"], osc["ang_vel"]])
    action = np.zeros(12, np.float32)
    target = default_angles.copy()
    heights = []
    steps = int(duration_s / sim_dt)
    for t in range(steps):
        q = d.qpos[qadr]
        dq = d.qvel[vadr]
        d.ctrl[:] = kp * (target - q) - kd * dq
        mujoco.mj_step(m, d)
        if (t + 1) % control_decimation == 0:
            quat = d.qpos[3:7]
            lin_b = _quat_rotate_inverse_wxyz(quat, d.qvel[0:3])
            grav = _quat_rotate_inverse_wxyz(quat, np.array([0.0, 0.0, -1.0]))
            obs = np.concatenate([
                lin_b * osc["lin_vel"],
                d.qvel[3:6] * osc["ang_vel"],
                grav,
                cmd * cmd_scale,
                (d.qpos[qadr] - default_angles) * osc["dof_pos"],
                d.qvel[vadr] * osc["dof_vel"],
                action,
            ]).astype(np.float32)
            action = np.asarray(policy(obs), np.float32)
            target = action * action_scale + default_angles
            heights.append(float(d.qpos[2]))
    return {
        "distance_x": float(d.qpos[0]),
        "mean_height": float(np.mean(heights)),
        "min_height": float(np.min(heights)),
        "fell": bool(min(heights) < 0.15),
    }


def run_go2_handstand(policy, init_state=None, duration_s: float = 5.0,
                      sim_dt: float = 0.0025, control_decimation: int = 10):
    # Defaults give a 40 Hz policy tick — matching the handstand env's
    # control rate (sim dt 0.005 x decimation 5).
    """Handstand hold in MuJoCo with the training env's rear-leg clamp
    (go2_handstand_env.py:326-350) and MuJoCo-derived foot contact flags.

    ``init_state``: optional (base_pos [3], base_quat_xyzw [4],
    joint_q [12], base_ang_vel_b [3], base_lin_vel_b [3], joint_qd [12])
    — typically a *balanced hold* captured from the training engine, so
    the test isolates "can the policy stabilize the handstand in a
    different engine" from the much harsher drop-and-catch of the RSI
    reset (which even in-engine only succeeds from < 10 cm drops).
    Default: inverted keyframe drop from 0.5 m (the RSI init pose).

    Returns per-tick ``g_z`` (projected gravity z: +1 = inverted) and
    ``height`` traces."""
    import mujoco

    from unitree_rl_gym_tpu_torch.envs.go2_handstand import (
        HANDSTAND_POSE, REAR_JOINTS, go2_handstand_cfg,
    )

    cfg = go2_handstand_cfg()
    osc = cfg.normalization.obs_scales
    default_angles = np.array(
        [cfg.init_state.default_joint_angles[j] for j in GO2_JOINTS],
        np.float32,
    )
    hs_pose = np.array([HANDSTAND_POSE[j] for j in GO2_JOINTS], np.float32)
    rear_idx = np.array([GO2_JOINTS.index(j) for j in REAR_JOINTS])
    kp = float(cfg.control.stiffness["joint"])
    kd = float(cfg.control.damping["joint"])
    action_scale = cfg.control.action_scale

    m, qadr, vadr = build_go2_model()
    m.opt.timestep = sim_dt
    d = mujoco.MjData(m)
    if init_state is None:
        # inverted keyframe drop (training RSI init, handstand
        # _sample_reset): pitched 180 deg about +y at the handstand pose
        d.qpos[2] = 0.5
        d.qpos[3:7] = [0.0, 0.0, 1.0, 0.0]
        d.qpos[qadr] = hs_pose
    else:
        pos, quat_xyzw, q, w_b, v_b, qd = init_state
        d.qpos[0:3] = pos
        d.qpos[3:7] = np.concatenate(([quat_xyzw[3]], quat_xyzw[:3]))
        d.qpos[qadr] = q
        # MuJoCo freejoint qvel: linear world, angular body
        R = _quat_rotmat_wxyz(np.asarray(d.qpos[3:7]))
        d.qvel[0:3] = R @ np.asarray(v_b)
        d.qvel[3:6] = w_b
        d.qvel[vadr] = qd
    mujoco.mj_forward(m, d)
    foot_geoms = _foot_geoms(m)

    action = np.zeros(12, np.float32)
    target = hs_pose.copy()
    gz, height = [], []
    steps = int(duration_s / sim_dt)
    for t in range(steps):
        q = d.qpos[qadr]
        dq = d.qvel[vadr]
        d.ctrl[:] = kp * (target - q) - kd * dq
        mujoco.mj_step(m, d)
        if (t + 1) % control_decimation == 0:
            quat = d.qpos[3:7]
            grav = _quat_rotate_inverse_wxyz(quat, np.array([0.0, 0.0, -1.0]))
            cf = _foot_contact_forces(m, d, foot_geoms)
            flags = (cf > 5.0).astype(np.float32)     # FL FR RL RR
            obs = np.concatenate([
                d.qvel[3:6] * osc["ang_vel"],
                grav,
                (d.qpos[qadr] - default_angles) * osc["dof_pos"],
                d.qvel[vadr] * osc["dof_vel"],
                action,
                flags[:2],                            # front feet
                flags[2:],                            # hind feet
            ]).astype(np.float32)
            action = np.asarray(policy(obs), np.float32)
            target = action * action_scale + default_angles
            # rear-leg clamp (go2_handstand_env.py:326-350)
            target[rear_idx] = np.clip(
                target[rear_idx], hs_pose[rear_idx] - 0.15,
                hs_pose[rear_idx] + 0.15,
            )
            gz.append(float(grav[2]))
            height.append(float(d.qpos[2]))
    return {
        "g_z": np.asarray(gz),
        "height": np.asarray(height),
        "final_height": float(d.qpos[2]),
    }


def _quat_rotmat_wxyz(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])

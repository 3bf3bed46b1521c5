"""IMU rotation helpers (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/common/rotation_helper.py``, the
same code; reference: deploy_real/common/rotation_helper.py).

Pure-numpy implementations (no scipy dependency at the robot edge)."""

from __future__ import annotations

import numpy as np


def get_gravity_orientation(quaternion):
    """Projected gravity from a wxyz IMU quaternion
    (rotation_helper.py:5-17)."""
    qw, qx, qy, qz = quaternion
    g = np.zeros(3)
    g[0] = 2 * (-qz * qx + qw * qy)
    g[1] = -2 * (qz * qy + qw * qx)
    g[2] = 1 - 2 * (qw * qw + qz * qz)
    return g


def _quat_wxyz_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _matrix_to_quat_wxyz(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def transform_imu_data(waist_yaw, waist_yaw_omega, imu_quat, imu_omega):
    """Torso-IMU -> pelvis-frame transform for H1/H1_2
    (rotation_helper.py:20-25): undo the waist yaw joint."""
    cy, sy = np.cos(waist_yaw), np.sin(waist_yaw)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    R_torso = _quat_wxyz_to_matrix(np.asarray(imu_quat, dtype=np.float64))
    R_pelvis = R_torso @ Rz.T
    w = Rz @ np.asarray(imu_omega[0], dtype=np.float64) - np.array(
        [0.0, 0.0, waist_yaw_omega]
    )
    return _matrix_to_quat_wxyz(R_pelvis), w

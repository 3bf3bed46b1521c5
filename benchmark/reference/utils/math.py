"""Quaternion / rotation math on tensors (counterpart of
``unitree_rl_gym_tpu/utils/math.py``).

Quaternions are stored ``[x, y, z, w]`` (scalar-last), as in the JAX
package. Every function broadcasts over leading batch dims (``[N, 4]``
quaternions, ``[N, 3]`` vectors) and runs under ``torch.func.vmap``. The
two random draws take a ``torch.Generator`` where the JAX functions take a
PRNG key.
"""

from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """Safe L2 normalization along ``dim``."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True), min=eps)


def quat_identity(shape=(), device=None) -> torch.Tensor:
    """Identity quaternions of ``shape`` (xyzw)."""
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for xyzw quaternions."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        (
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ),
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat((-q[..., :3], q[..., 3:4]), dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q`` (body -> world)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


quat_apply = quat_rotate


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by the inverse of ``q`` (world -> body)."""
    return quat_rotate(quat_conjugate(q), v)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion from rotation ``angle`` about unit ``axis``."""
    half = 0.5 * angle
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat((xyz, torch.cos(half)[..., None]), dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> 3x3 rotation matrix (body -> world)."""
    x, y, z, w = q.unbind(-1)
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    m = torch.stack(
        (
            1.0 - (yy + zz), xy - wz, xz + wy,
            xy + wz, 1.0 - (xx + zz), yz - wx,
            xz - wy, yz + wx, 1.0 - (xx + yy),
        ),
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation with world-frame angular velocity:
    q' = normalize(q + 0.5*dt * [omega, 0] ⊗ q)."""
    omega_quat = torch.cat((omega_world, torch.zeros_like(omega_world[..., :1])), dim=-1)
    dq = 0.5 * dt * quat_mul(omega_quat, q)
    return normalize(q + dq)


def get_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> stacked (roll, pitch, yaw) (isaacgym_utils.get_euler_xyz)."""
    qx, qy, qz, qw = q.unbind(-1)
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return torch.stack((roll, pitch, yaw), dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the yaw component of ``q`` to ``v``."""
    q_yaw = torch.cat((torch.zeros_like(q[..., :2]), q[..., 2:4]), dim=-1)
    return quat_rotate(normalize(q_yaw), v)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic xyz euler -> xyzw quaternion."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        (
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ),
        dim=-1,
    )


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] (mod into [0, 2pi) then shift)."""
    a = torch.remainder(angles, 2.0 * math.pi)
    return a - 2.0 * math.pi * (a > math.pi)


def rand_uniform(generator: torch.Generator, lo, hi, shape) -> torch.Tensor:
    """U(lo, hi) of ``shape`` from ``generator``, on its device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def rand_sqrt_uniform(generator: torch.Generator, lower, upper, shape) -> torch.Tensor:
    """Signed-sqrt-shaped draws in [lower, upper] (legged_gym's
    ``torch_rand_sqrt_float``)."""
    r = 2.0 * torch.rand(shape, generator=generator, device=generator.device) - 1.0
    r = torch.where(r < 0.0, -torch.sqrt(-r), torch.sqrt(r))
    r = (r + 1.0) / 2.0
    return (upper - lower) * r + lower


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack((zero, -z, y, z, zero, -x, -y, x, zero), dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))

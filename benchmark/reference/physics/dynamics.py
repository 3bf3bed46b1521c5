"""Articulated rigid-body model and the per-env dynamics (counterpart of
``unitree_rl_gym_tpu/physics/dynamics.py``).

:class:`DynModel`, forward kinematics, velocity propagation, the RNEA bias
forces, CRBA, an explicit Cholesky inverse, the passive joint torque,
forward dynamics and semi-implicit integration, each of one env on
unbatched tensors. The env build uses them for the contact preconditioner
(``contact.point_effective_mass``); physics/engine.py's control step, mapped
over the env batch with ``torch.func.vmap`` (``backend.control_step_vmap``),
is the per-env formulation the batched paths are held against. Nothing
writes into a tensor in place and nothing branches on a tensor's value, so
every function runs under ``vmap``. The batched control step runs in
physics/soa.py (plain PyTorch) and in the CUDA kernel (physics/cuda_step.py).

Generalized coordinates, as in the JAX package:
  q = (base_pos[3], base_quat[4 xyzw], joint_q[nj])
  v = [base_ang(3, body frame); base_lin(3, body frame); joint_qd[nj]]
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from reference.physics import spatial as sp
from reference.utils import math as tmath


@dataclasses.dataclass(frozen=True, eq=False)
class DynModel:
    """Static robot model: float32 CPU tensors + the tree's parent tuple.
    ``eq=False`` keeps identity hashing (physics/backend.py caches by it)."""

    parent: Tuple[int, ...]        # dyn-body parent indices, parent[0] == -1
    joint_axis: torch.Tensor       # [nj, 3]
    Etree: torch.Tensor            # [nj, 3, 3]
    rtree: torch.Tensor            # [nj, 3]
    I_sp: torch.Tensor             # [nb, 6, 6] spatial inertia, body frame
    base_mass: float
    armature: float
    dof_damping: torch.Tensor      # [nj]
    dof_friction: torch.Tensor     # [nj]
    dof_vel_limit: torch.Tensor    # [nj] (inf = unlimited)
    dof_lower: torch.Tensor        # [nj] hard limits (inf = unlimited)
    dof_upper: torch.Tensor
    rb_dyn_idx: torch.Tensor       # [nrb] int
    rb_rot: torch.Tensor           # [nrb, 3, 3]
    rb_pos: torch.Tensor           # [nrb, 3]
    cp_dyn: torch.Tensor           # [ncp] int, dynamic body of each point
    cp_body: torch.Tensor          # [ncp] int, report body of each point
    cp_pos: torch.Tensor           # [ncp, 3] offset in dyn body frame
    cp_radius: torch.Tensor        # [ncp]
    gravity: torch.Tensor          # [3]

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def nj(self) -> int:
        return self.nb - 1

    @property
    def nv(self) -> int:
        return self.nb + 5  # 6 + nj


def fk(model: DynModel, base_pos, base_quat, joint_q, v):
    """Forward kinematics of one env (``v`` may carry leading batch dims,
    which the velocity outputs then carry too).

    Returns R_w [nb,3,3], p_w [nb,3], (E_up [nj,3,3], r_up [nj,3]),
    v_b [..., nb, 6]."""
    E_up = sp.rot_axis(model.joint_axis, joint_q) @ model.Etree
    r_up = model.rtree
    R_w = [tmath.quat_to_rotmat(base_quat)]
    p_w = [base_pos]
    for i in range(1, model.nb):
        par, j = model.parent[i], i - 1
        R_w.append(R_w[par] @ E_up[j].T)
        p_w.append(p_w[par] + R_w[par] @ r_up[j])
    v_b = velocity_prop(model, E_up, r_up, v)
    return torch.stack(R_w), torch.stack(p_w), (E_up, r_up), v_b


def velocity_prop(model: DynModel, E_up, r_up, v):
    """Generalized velocity [..., nv] -> per-body spatial velocities
    [..., nb, 6]."""
    v_b = [v[..., :6]]
    zeros = torch.zeros_like(v[..., :3])
    for i in range(1, model.nb):
        j = i - 1
        vi = sp.xform_motion(E_up[j], r_up[j], v_b[model.parent[i]])
        S_qd = torch.cat((model.joint_axis[j] * v[..., 6 + j, None], zeros), dim=-1)
        v_b.append(vi + S_qd)
    return torch.stack(v_b, dim=-2)


def _scaled_inertias(model: DynModel, mass_scale):
    """Spatial inertias [nb, 6, 6] with the base's scaled by the
    added-mass DR factor ``mass_scale`` (uniform-density scaling)."""
    ms = torch.as_tensor(mass_scale, dtype=model.I_sp.dtype,
                         device=model.I_sp.device).reshape(1)
    scale = torch.cat((ms, torch.ones(model.nb - 1, dtype=ms.dtype, device=ms.device)))
    return model.I_sp * scale[:, None, None]


def _motion_axis(model: DynModel, j):
    """Joint j's motion subspace [axis; 0] (6)."""
    return torch.cat((model.joint_axis[j], torch.zeros_like(model.joint_axis[j])))


def bias_forces(model: DynModel, fk_out, v, f_ext, mass_scale):
    """RNEA with qdd = 0: the generalized bias C(q,v)v + g - f_ext [nv];
    ``f_ext`` [nb, 6] spatial forces in body coords."""
    nb, nj = model.nb, model.nj
    R_w, _, (E_up, r_up), v_b = fk_out
    I_sp = _scaled_inertias(model, mass_scale)
    g_body = R_w[0].T @ model.gravity
    a = [torch.cat((torch.zeros_like(g_body), -g_body))]
    for i in range(1, nb):
        j = i - 1
        ai = sp.xform_motion(E_up[j], r_up[j], a[model.parent[i]])
        a.append(ai + sp.cross_motion(v_b[i], _motion_axis(model, j) * v[6 + j]))
    f = [I_sp[i] @ a[i] + sp.cross_force(v_b[i], I_sp[i] @ v_b[i]) - f_ext[i]
         for i in range(nb)]
    bias_j = [None] * nj
    for i in range(nb - 1, 0, -1):
        j = i - 1
        bias_j[j] = _motion_axis(model, j) @ f[i]
        f[model.parent[i]] = f[model.parent[i]] + sp.xform_force_inv(
            E_up[j], r_up[j], f[i])
    return torch.cat((f[0], torch.stack(bias_j)))


def mass_matrix(model: DynModel, fk_out, mass_scale=1.0):
    """CRBA joint-space inertia H(q) [nv, nv] (+armature on the diagonal)
    from :func:`fk`'s output, assembled from its blocks (no writes in
    place)."""
    nb, nj = model.nb, model.nj
    _, _, (E_up, r_up), _ = fk_out
    Ic = list(_scaled_inertias(model, mass_scale).unbind(0))
    for i in range(nb - 1, 0, -1):
        j = i - 1
        Ic[model.parent[i]] = Ic[model.parent[i]] + sp.transform_inertia_to_parent(
            E_up[j], r_up[j], Ic[i]
        )
    zero = torch.zeros((), dtype=model.I_sp.dtype, device=model.I_sp.device)
    base_cols = [None] * nj             # H[:6, 6 + j]
    joint = [[zero] * nj for _ in range(nj)]  # H[6:, 6:]
    for i in range(1, nb):
        j = i - 1
        S = _motion_axis(model, j)
        F = Ic[i] @ S
        joint[j][j] = S @ F + model.armature
        k = i
        while model.parent[k] != -1:
            F = sp.xform_force_inv(E_up[k - 1], r_up[k - 1], F)
            k = model.parent[k]
            if k == 0:
                base_cols[j] = F
            else:
                jj = k - 1
                joint[jj][j] = joint[j][jj] = _motion_axis(model, jj) @ F
    B = torch.stack(base_cols, dim=-1)                       # [6, nj]
    D = torch.stack([torch.stack(row) for row in joint])     # [nj, nj]
    return torch.cat((torch.cat((Ic[0], B), dim=-1),
                      torch.cat((B.T, D), dim=-1)), dim=-2)


def cholesky_inverse(H):
    """Explicit H^{-1} of a small SPD matrix: column Cholesky, forward
    substitution for L^{-1}, then L^{-T} L^{-1} (the JAX package's
    unrolled formulation, same operation order; ``rsqrt`` of the pivot
    clamped at 1e-12)."""
    n = H.shape[-1]
    rows = torch.arange(n, device=H.device)
    cols = []
    for j in range(n):
        if j:
            Lj = torch.stack([cols[k][j] for k in range(j)])
            s = H[:, j] - torch.stack(cols[:j], dim=-1) @ Lj
        else:
            s = H[:, j]
        inv_d = torch.rsqrt(torch.clamp(s[j], min=1e-12))
        col = s * inv_d
        col = col * (rows >= j)
        cols.append(col)
    L = torch.stack(cols, dim=-1)
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    xrows = []
    for i in range(n):
        acc = L[i, :i] @ torch.stack(xrows, dim=-2) if i else 0.0
        xrows.append((eye[i] - acc) / L[i, i])
    X = torch.stack(xrows, dim=-2)
    return X.T @ X


def passive_torque(model: DynModel, qd_j):
    """URDF joint damping + smoothed dry friction (PhysX dof props)."""
    return -model.dof_damping * qd_j - model.dof_friction * torch.tanh(qd_j / 0.1)


def forward_dynamics(model: DynModel, fk_out, v, tau_joint, f_ext, mass_scale):
    """qdd = H(q)^{-1} (tau - bias) [nv] of one env: ``tau_joint`` [nj] the
    actuation torques, ``f_ext`` [nb, 6] external spatial forces in body
    coords, ``mass_scale`` the base-mass DR factor."""
    bias = bias_forces(model, fk_out, v, f_ext, mass_scale)
    H = mass_matrix(model, fk_out, mass_scale)
    tau = torch.cat((torch.zeros_like(v[:6]),
                     tau_joint + passive_torque(model, v[6:])))
    return cholesky_inverse(H) @ (tau - bias)


def integrate(model: DynModel, base_pos, base_quat, joint_q, v, qdd, dt):
    """Semi-implicit Euler: v += dt*qdd, then the positions with the *new*
    velocity; the base's angular velocity integrated on SO(3)."""
    v_new = v + dt * qdd
    R0 = tmath.quat_to_rotmat(base_quat)
    base_pos_new = base_pos + dt * (R0 @ v_new[3:6])
    base_quat_new = tmath.quat_integrate(base_quat, R0 @ v_new[:3], dt)
    joint_q_new = joint_q + dt * v_new[6:]
    return base_pos_new, base_quat_new, joint_q_new, v_new

"""Spatial (6-D) rigid-body algebra, Featherstone convention (counterpart of
``unitree_rl_gym_tpu/physics/spatial.py``).

Spatial vectors are ``[angular(3); linear(3)]`` in body coordinates.
Transforms are ``(E, r)`` pairs: ``E`` rotates A-frame coords into B-frame
coords, ``r`` is the origin of B expressed in A. Everything broadcasts over
leading batch dims and runs under ``torch.func.vmap``. The build-time
dynamics (models/robot.py, physics/contact.py::point_effective_mass) and
the per-env control step (physics/engine.py, the vmap formulation) use
this module; the batched control step runs in physics/soa.py and the CUDA
kernel.
"""

from __future__ import annotations

import torch

from reference.utils.math import skew


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _mv(E, v):
    return torch.einsum("...ij,...j->...i", E, v)


def _mtv(E, v):
    return torch.einsum("...ji,...j->...i", E, v)


def xform_compose(E1, r1, E2, r2):
    """Compose X1∘X2: first X2 (A->B), then X1 (B->C); returns the (E, r)
    of the A->C transform (Featherstone RBDA eq. 2.26)."""
    return E1 @ E2, r2 + _mtv(E2, r1)


def xform_inv(E, r):
    """Inverse transform (B->A from A->B)."""
    return E.transpose(-1, -2), -_mv(E, r)


def xform_motion(E, r, v):
    """Apply motion transform: v_B = X v_A for v = [w; v]."""
    w, vl = v[..., :3], v[..., 3:]
    wB = _mv(E, w)
    vB = _mv(E, vl - _cross(r, w))
    return torch.cat((wB, vB), dim=-1)


def xform_motion_inv(E, r, v):
    """Apply inverse motion transform: v_A = X^{-1} v_B."""
    w, vl = v[..., :3], v[..., 3:]
    wA = _mtv(E, w)
    vA = _mtv(E, vl) + _cross(r, wA)
    return torch.cat((wA, vA), dim=-1)


def xform_force(E, r, f):
    """Apply force transform: n_B = E(n - r x f), f_B = E f."""
    n, fl = f[..., :3], f[..., 3:]
    nB = _mv(E, n - _cross(r, fl))
    fB = _mv(E, fl)
    return torch.cat((nB, fB), dim=-1)


def xform_force_inv(E, r, f):
    """Inverse force transform: f_A = X^{*} f_B (child force -> parent)."""
    n, fl = f[..., :3], f[..., 3:]
    fA = _mtv(E, fl)
    nA = _mtv(E, n) + _cross(r, fA)
    return torch.cat((nA, fA), dim=-1)


def motion_matrix(E, r):
    """Explicit 6x6 Plücker motion matrix [[E, 0], [-E skew(r), E]]."""
    Z = torch.zeros_like(E)
    top = torch.cat((E, Z), dim=-1)
    bot = torch.cat((-E @ skew(r), E), dim=-1)
    return torch.cat((top, bot), dim=-2)


def crm(v):
    """Spatial motion cross-product operator v x as a 6x6 matrix."""
    sw, sv = skew(v[..., :3]), skew(v[..., 3:])
    Z = torch.zeros_like(sw)
    top = torch.cat((sw, Z), dim=-1)
    bot = torch.cat((sv, sw), dim=-1)
    return torch.cat((top, bot), dim=-2)


def cross_motion(v, m):
    """v x_m m without the 6x6 operator."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat((_cross(w, mw), _cross(vl, mw) + _cross(w, ml)), dim=-1)


def cross_force(v, f):
    """v x_f f = -(v x_m)^T f."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat((_cross(w, n) + _cross(vl, fl), _cross(w, fl)), dim=-1)


def spatial_inertia(mass, com, inertia_com):
    """6x6 spatial inertia about the body frame origin from the URDF
    <inertial> block: [[I_com + m cx cx^T, m cx], [m cx^T, m 1]]."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    top = torch.cat(
        (inertia_com + m * cx @ cx.transpose(-1, -2), m * cx), dim=-1
    )
    bot = torch.cat((m * cx.transpose(-1, -2), m * eye), dim=-1)
    return torch.cat((top, bot), dim=-2)


def transform_inertia_to_parent(E, r, I_child):
    """I_parent = X^T I_child X for the motion transform X = (E, r)."""
    X = motion_matrix(E, r)
    return X.transpose(-1, -2) @ I_child @ X


def rot_axis(axis, q):
    """E = R(axis, q)^T (Rodrigues) for a revolute joint of angle ``q``."""
    c = torch.cos(q)[..., None, None]
    s = torch.sin(q)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    R = eye * c + s * skew(axis) + (1.0 - c) * axis[..., :, None] * axis[..., None, :]
    return R.transpose(-1, -2)


def rpy_matrix(rpy):
    """URDF rpy (fixed-axis XYZ) -> rotation matrix R = Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    R = torch.stack(
        (
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ),
        dim=-1,
    )
    return R.reshape(R.shape[:-1] + (3, 3))

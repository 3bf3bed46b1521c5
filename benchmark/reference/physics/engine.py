"""Physics state, PD constants and the per-env control step (counterpart
of the JAX package's ``physics/engine.py``: ``PhysicsState``, ``PDParams``,
``control_step``, ``rb_states``).

``control_step`` advances one env by one control step (``decimation``
substeps of PD torque, FK, RNEA bias, CRBA, explicit inverse, free
velocity, the impulse solve of physics/contact.py, the velocity caps,
semi-implicit integration and the joint-limit projection) on unbatched
tensors. ``backend.control_step_vmap`` maps it over the env batch with
``torch.func.vmap``: the per-env formulation that the JAX package keeps as
its portable spec, held against the batched plain version (physics/soa.py)
and the CUDA kernels. Nothing on the training or play path calls it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference.physics import contact as ct
from reference.physics import dynamics as dyn


@dataclasses.dataclass
class PhysicsState:
    """Per-env mechanical state (generalized coordinates), batched [N, ...]
    (one env's in :func:`control_step`: [3], [4], [nj], [nv])."""

    base_pos: torch.Tensor   # [N, 3] world
    base_quat: torch.Tensor  # [N, 4] xyzw
    joint_q: torch.Tensor    # [N, nj]
    v: torch.Tensor          # [N, nv] = [base ang(body); base lin(body); qd]

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class PDParams:
    """Per-joint PD controller constants."""

    kp: np.ndarray            # [nj]
    kd: np.ndarray            # [nj]
    torque_limit: np.ndarray  # [nj] URDF effort limits
    clip_torque: bool = True


def control_step(model: dyn.DynModel, cparams: ct.ContactParams, pd: PDParams,
                 sim_dt: float, decimation: int, state: PhysicsState, target_q,
                 friction_env, mass_scale, m_eff_n, m_eff_t, ground_fn=None,
                 cstiff=None):
    """Advance one env by one control step (``decimation`` substeps):
    ``target_q`` [nj] the PD target, ``friction_env`` / ``mass_scale`` the
    env's DR scalars, ``m_eff_n`` / ``m_eff_t`` [ncp] the contact
    preconditioner, ``ground_fn`` the terrain height lookup (None: the z=0
    plane), ``cstiff`` the contact-stiffness DR scale (None: 1).

    ``model`` lies on the state's device. Returns (new_state, aux), aux
    from the last substep and the settled state: torques [nj], cf_rb
    [nrb, 3] world contact forces, rb_pos_w and rb_vel_w [nrb, 3]."""
    dev = state.v.device

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    kp, kd, lim = const(pd.kp), const(pd.kd), const(pd.torque_limit)
    m_eff_n, m_eff_t = const(m_eff_n), const(m_eff_t)
    no_ext = torch.zeros((model.nb, 6), device=dev)
    s = state
    tau = cf_rb = None
    for _ in range(decimation):
        fk_out = dyn.fk(model, s.base_pos, s.base_quat, s.joint_q, s.v)
        R_w, p_w, (E_up, r_up), _ = fk_out

        tau = kp * (target_q - s.joint_q) - kd * s.v[6:]
        if pd.clip_torque:
            tau = torch.clamp(tau, -lim, lim)

        bias = dyn.bias_forces(model, fk_out, s.v, no_ext, mass_scale)
        Hinv = dyn.cholesky_inverse(dyn.mass_matrix(model, fk_out, mass_scale))
        tau_gen = torch.cat((torch.zeros_like(s.v[:6]),
                             tau + dyn.passive_torque(model, s.v[6:])))
        v_free = s.v + sim_dt * (Hinv @ (tau_gen - bias))

        v_new, cf_rb = ct.contact_solve(
            model, cparams, E_up, r_up, R_w, p_w, Hinv, v_free, m_eff_n,
            m_eff_t, friction_env, sim_dt, ground_fn=ground_fn,
            stiff_scale=1.0 if cstiff is None else cstiff,
        )
        # PhysX's joint-velocity clamp and rigid-body velocity caps on the
        # base: keep a diverging contact state finite
        ang, lin = cparams.max_angular_velocity, cparams.max_linear_velocity
        v_new = torch.cat((
            torch.clamp(v_new[:3], -ang, ang),
            torch.clamp(v_new[3:6], -lin, lin),
            torch.clamp(v_new[6:], -model.dof_vel_limit, model.dof_vel_limit),
        ))

        bp, bq, q, _ = dyn.integrate(model, s.base_pos, s.base_quat, s.joint_q,
                                     v_new, torch.zeros_like(v_new), sim_dt)
        # hard joint limits (PhysX constraint as a projection): clamp q and
        # zero the velocity driving into the limit
        qd = v_new[6:]
        qd = torch.where(q < model.dof_lower, torch.clamp(qd, min=0.0), qd)
        qd = torch.where(q > model.dof_upper, torch.clamp(qd, max=0.0), qd)
        q = torch.clamp(q, model.dof_lower, model.dof_upper)
        s = PhysicsState(base_pos=bp, base_quat=bq, joint_q=q,
                         v=torch.cat((v_new[:6], qd)))
    # post-loop refresh: world kinematics of the settled state
    R_w, p_w, _, v_b = dyn.fk(model, s.base_pos, s.base_quat, s.joint_q, s.v)
    rb_pos_w, rb_vel_w = rb_states(model, R_w, p_w, v_b)
    aux = {"torques": tau, "cf_rb": cf_rb, "rb_pos_w": rb_pos_w,
           "rb_vel_w": rb_vel_w}
    return s, aux


def rb_states(model: dyn.DynModel, R_w, p_w, v_b):
    """World position and linear velocity [nrb, 3] of every report body:
    p = p_b + R_b rb_pos, v = R_b (vl + w x rb_pos)."""
    b = model.rb_dyn_idx
    Rb, pb, vb = R_w[b], p_w[b], v_b[b]
    pos = pb + torch.einsum("rij,rj->ri", Rb, model.rb_pos)
    v_local = vb[:, 3:] + torch.linalg.cross(vb[:, :3], model.rb_pos, dim=-1)
    vel = torch.einsum("rij,rj->ri", Rb, v_local)
    return pos, vel

"""The reference's control step: the SoA plain version of the port's
``physics/backend.py`` (``control_step_soa``), on every device.

``control_step`` keeps the port's signature so the copied env calls it; it
always runs the plain version (``block`` and ``cstiff`` as the port's
plain path takes them)."""

from __future__ import annotations

import weakref

import numpy as np
import torch

from reference.physics import dynamics as dyn
from reference.physics import engine as eng
from reference.physics import soa

_SOA_CACHE: "weakref.WeakKeyDictionary[dyn.DynModel, soa.SoAModel]" = (
    weakref.WeakKeyDictionary()
)


def soa_model_for(model: dyn.DynModel) -> soa.SoAModel:
    sm = _SOA_CACHE.get(model)
    if sm is None:
        sm = _SOA_CACHE[model] = soa.build_soa_model(model)
    return sm


def control_step_soa(model, cparams, pd, sim_dt, decimation, state, target,
                     friction, mass_scale, m_eff_n, m_eff_t, gh=None,
                     want_phi=False, cstiff=None, ground_fn=None):
    """Batched SoA control step in plain PyTorch (``gh``, ``ground_fn``,
    ``cstiff``: see the module docstring).

    ``want_phi`` adds ``aux["min_abs_phi"]`` [N]: the smallest |penetration|
    of any contact point over the substeps, which tells a comparison with
    the kernel where a contact activation sits on the edge (phi ~ 0)."""
    m = soa_model_for(model)
    kp = [float(x) for x in pd.kp]
    kd = [float(x) for x in pd.kd]
    lim = [float(x) for x in pd.torque_limit]
    m_eff_n = np.asarray(m_eff_n)[m.cp_perm]
    m_eff_t = np.asarray(m_eff_t)[m.cp_perm]

    bp = tuple(state.base_pos.unbind(-1))
    bq = tuple(state.base_quat.unbind(-1))
    q = list(state.joint_q.unbind(-1))
    v = list(state.v.unbind(-1))
    tgt = list(target.unbind(-1))
    min_phi = None
    for _ in range(decimation):
        bp, bq, q, v, tau, pn, pt, phi = soa.substep_s(
            m, cparams, kp, kd, lim, pd.clip_torque, sim_dt,
            bp, bq, q, v, tgt, friction, mass_scale, m_eff_n, m_eff_t, gh,
            cstiff, ground_fn,
        )
        if want_phi:
            a = phi.abs().amin(dim=0)
            min_phi = a if min_phi is None else torch.minimum(min_phi, a)
    new_state = eng.PhysicsState(
        base_pos=torch.stack(bp, -1), base_quat=torch.stack(bq, -1),
        joint_q=torch.stack(q, -1), v=torch.stack(v, -1),
    )
    # post-loop refresh: world kinematics of the settled state
    R_w, p_w, E_up, v_b = soa.fk_s(m, bp, bq, q, v)
    rb_pos, rb_vel = soa.rb_states_s(m, R_w, p_w, v_b)
    cf = soa.cf_rb_s(m, pn, pt, sim_dt, state.joint_q[:, 0])
    aux = {
        "torques": torch.stack(tau, -1),
        "cf_rb": torch.stack([torch.stack(r, -1) for r in cf], 1),
        "rb_pos_w": torch.stack([torch.stack(p, -1) for p in rb_pos], 1),
        "rb_vel_w": torch.stack([torch.stack(u, -1) for u in rb_vel], 1),
    }
    if gh is not None or ground_fn is not None:
        _, x_w = soa.point_world_positions_s(m, R_w, p_w, bp[0])
        aux["p_xy"] = torch.cat([x_w[0], x_w[1]], dim=0)
    if want_phi:
        aux["min_abs_phi"] = min_phi
    return new_state, aux


def sample_point_heights(model, state, ground_fn):
    """The ground height under every contact point at the step-start state,
    rows [ncp, N] (the kernels' ``gh`` layout): one FK, the points' world
    xy, then ``ground_fn`` on them."""
    m = soa_model_for(model)
    bp = tuple(state.base_pos.unbind(-1))
    R_w, p_w, _, _ = soa.fk_s(m, bp, tuple(state.base_quat.unbind(-1)),
                              list(state.joint_q.unbind(-1)), list(state.v.unbind(-1)))
    _, x_w = soa.point_world_positions_s(m, R_w, p_w, bp[0])
    return ground_fn(torch.stack([x_w[0], x_w[1]], dim=-1))


def control_step(model, cparams, pd, sim_dt, decimation, state, target,
                 friction, mass_scale, m_eff_n, m_eff_t, gh=None, cstiff=None,
                 block=None, ground_fn=None):
    """The plain control step of every env (``block`` is ignored: the
    reference holds all envs)."""
    return control_step_soa(
        model, cparams, pd, sim_dt, decimation, state, target, friction,
        mass_scale, m_eff_n, m_eff_t, gh, cstiff=cstiff, ground_fn=ground_fn)

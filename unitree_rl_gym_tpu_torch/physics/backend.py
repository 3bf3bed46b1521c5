"""Control-step dispatch (counterpart of ``unitree_rl_gym_tpu/physics/
backend.py``: ``soa_model_for``, ``control_step_soa``, ``control_step``).

Two implementations of the decimated control step:

  * ``soa``  — physics/soa.py over [N] tensors: the plain PyTorch version,
               the path of every CPU tensor;
  * kernels K1 (flat ground), K3 (terrain) and K2 (either, with the
               per-env contact-stiffness scale ``cstiff``) — the
               hand-written CUDA kernels (physics/cuda_step.py), the only
               path of a CUDA tensor.

``control_step`` picks one by the tensors' device and the operands given,
and nothing else: there is no probe and no fallback, so on a CUDA tensor it
launches K1 (``gh`` and ``cstiff`` None), K3 (``gh`` given) or K2
(``cstiff`` given, with or without ``gh``), or raises. chip_smoke.py
calls ``control_step_soa`` itself to hold the kernels against the plain
version on the card.

Terrain follows the JAX package's kernel formulation on every device:
``gh`` [ncp,N] rows hold the ground height under every contact point at the
start of the control step, frozen across its substeps. The JAX package's
CPU path instead resamples the heightfield every substep (its
``ground_fn``); that mode is not ported.

``cstiff`` [N] scales every env's contact de-penetration bias after its
clamp to ``max_depenetration_velocity`` (the JAX package's order).

Both return ``(PhysicsState, aux)`` with aux = {torques [N,nj],
cf_rb [N,nrb,3], rb_pos_w [N,nrb,3], rb_vel_w [N,nrb,3]}, and with ``gh``
also p_xy [2*ncp,N] rows: the end-of-step world x (rows 0..ncp-1) and y of
every point, from which the env computes the next step's ``gh``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.physics import dynamics as dyn
from unitree_rl_gym_tpu_torch.physics import engine as eng
from unitree_rl_gym_tpu_torch.physics import soa

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
                     want_phi=False, cstiff=None):
    """Batched SoA control step in plain PyTorch (``gh``, ``cstiff``: see
    the module docstring).

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
            cstiff,
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
    if gh is not None:
        _, x_w = soa.point_world_positions_s(m, R_w, p_w, bp[0])
        aux["p_xy"] = torch.cat([x_w[0], x_w[1]], dim=0)
    if want_phi:
        aux["min_abs_phi"] = min_phi
    return new_state, aux


def control_step(model, cparams, pd, sim_dt, decimation, state, target,
                 friction, mass_scale, m_eff_n, m_eff_t, gh=None, cstiff=None):
    """The control step of every env: the plain version on a CPU tensor;
    on any other, kernel K2 when ``cstiff`` is given (with or without
    ``gh``), else K3 when ``gh`` is given and K1 when it is not (through
    their wrappers, which raise on anything they do not take)."""
    if state.joint_q.device.type == "cpu":
        return control_step_soa(
            model, cparams, pd, sim_dt, decimation, state, target, friction,
            mass_scale, m_eff_n, m_eff_t, gh, cstiff=cstiff,
        )
    args = (soa_model_for(model), cparams, pd, sim_dt, decimation, state,
            target, friction, mass_scale, m_eff_n, m_eff_t)
    if cstiff is not None:
        return cuda_step.control_step_cs(*args, cstiff, gh)
    if gh is None:
        return cuda_step.control_step(*args)
    return cuda_step.control_step_terrain(*args, gh)

"""Control-step dispatch (counterpart of ``unitree_rl_gym_tpu/physics/
backend.py``: ``soa_model_for``, ``control_step_vmap``,
``control_step_soa``, ``sample_point_heights``, ``control_step``).

Three implementations of the decimated control step:

  * ``soa``  — physics/soa.py over [N] tensors: the plain PyTorch version,
               the path of every CPU tensor;
  * kernels K1 (flat ground), K3 (terrain) and K2 (either, with the
               per-env contact-stiffness scale ``cstiff``) — the
               hand-written CUDA kernels (physics/cuda_step.py), the only
               path of a CUDA tensor;
  * ``vmap`` — the per-env formulation (physics/engine.py) mapped over the
               batch with ``torch.func.vmap``: ``control_step_vmap``, a
               function of its own that tests and chip_smoke.py hold the
               others against. ``control_step`` never picks it.

``control_step`` picks the plain version or a kernel by the tensors'
device, the operands given and the caller's env block, and nothing else:
there is no probe and no fallback, so on a CUDA tensor it launches K1
(``gh`` and ``cstiff`` None), K3 (``gh`` given) or K2 (``cstiff`` given,
with or without ``gh``) — as K4, the rank's launch of that instance on its
env block, when the caller passes a ``parallel.mesh.EnvBlock`` of more than
one rank — or raises. chip_smoke.py calls ``control_step_soa`` itself to
hold the kernels against the plain version on the card.

Terrain has two formulations, as in the JAX package. The kernels' (and
the env's, on every device): ``gh`` [ncp,N] rows hold the ground height
under every contact point at the start of the control step, frozen across
its substeps. The per-substep one: ``ground_fn`` (xy [..., 2] world meters
-> heights, e.g. ``TerrainGrid.height_at``) samples the heightfield at every
substep's own point positions; the plain version and ``control_step_vmap``
run it. Given ``ground_fn`` without ``gh``, ``control_step`` runs the plain
version's per-substep sampling on a CPU tensor, and on a CUDA tensor
samples ``gh`` once with :func:`sample_point_heights` (one FK of the
step-start state) and launches K3 (or K2) on it, as the JAX package's
Pallas path does.

``cstiff`` [N] scales every env's contact de-penetration bias after its
clamp to ``max_depenetration_velocity`` (the JAX package's order).

All return ``(PhysicsState, aux)`` with aux = {torques [N,nj],
cf_rb [N,nrb,3], rb_pos_w [N,nrb,3], rb_vel_w [N,nrb,3]}, and on terrain
(``control_step_soa`` and the kernels, given ``gh`` or ``ground_fn``) also
p_xy [2*ncp,N] rows: the end-of-step world x (rows 0..ncp-1) and y of every
point, from which the env computes the next step's ``gh``.
"""

from __future__ import annotations

import dataclasses
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


def control_step_vmap(model, cparams, pd, sim_dt, decimation, state, target,
                      friction, mass_scale, m_eff_n, m_eff_t, ground_fn=None,
                      cstiff=None):
    """The per-env control step (``engine.control_step``) mapped over the
    env batch with ``torch.func.vmap``; ``cstiff`` defaults to ones. Returns
    the batched state and aux (no ``p_xy``)."""
    dev = state.v.device
    model = dataclasses.replace(model, **{
        f.name: getattr(model, f.name).to(dev) for f in dataclasses.fields(model)
        if torch.is_tensor(getattr(model, f.name))})

    def one_env(bp, bq, q, v, tgt, fric, mass, cs):
        s, aux = eng.control_step(
            model, cparams, pd, sim_dt, decimation,
            eng.PhysicsState(base_pos=bp, base_quat=bq, joint_q=q, v=v),
            tgt, fric, mass, m_eff_n, m_eff_t, ground_fn=ground_fn, cstiff=cs)
        return (s.base_pos, s.base_quat, s.joint_q, s.v), aux

    if cstiff is None:
        cstiff = torch.ones_like(friction)
    (bp, bq, q, v), aux = torch.func.vmap(one_env)(
        state.base_pos, state.base_quat, state.joint_q, state.v, target,
        friction, mass_scale, cstiff)
    return eng.PhysicsState(base_pos=bp, base_quat=bq, joint_q=q, v=v), aux


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
    """The control step of every env: the plain version on a CPU tensor;
    on any other, kernel K2 when ``cstiff`` is given (with or without
    ``gh``), else K3 when ``gh`` is given and K1 when it is not (through
    their wrappers, which raise on anything they do not take). With
    ``ground_fn`` and no ``gh``, a CPU tensor samples the heightfield every
    substep and a CUDA tensor takes ``gh = sample_point_heights(...)`` once
    (the module docstring).

    ``block`` (``parallel.mesh.EnvBlock``): the tensors hold this rank's
    env block, not every env. With more than one rank, a CUDA tensor goes
    to K4 (the rank's launch of the same instance on its block) and a CPU
    tensor to the plain version on the block; the step has no traffic
    between ranks."""
    if gh is None and ground_fn is not None and state.joint_q.device.type != "cpu":
        gh = sample_point_heights(model, state, ground_fn)
    if block is not None and block.world_size > 1:
        n = state.joint_q.shape[0]
        if n != block.n_local:
            raise ValueError(f"{n} envs given, rank {block.rank}'s block "
                             f"holds {block.n_local}")
        if state.joint_q.device.type != "cpu":
            return cuda_step.control_step_sharded(
                soa_model_for(model), cparams, pd, sim_dt, decimation, state,
                target, friction, mass_scale, m_eff_n, m_eff_t, block, gh,
                cstiff)
    if state.joint_q.device.type == "cpu":
        return control_step_soa(
            model, cparams, pd, sim_dt, decimation, state, target, friction,
            mass_scale, m_eff_n, m_eff_t, gh, cstiff=cstiff, ground_fn=ground_fn,
        )
    args = (soa_model_for(model), cparams, pd, sim_dt, decimation, state,
            target, friction, mass_scale, m_eff_n, m_eff_t)
    if cstiff is not None:
        return cuda_step.control_step_cs(*args, cstiff, gh)
    if gh is None:
        return cuda_step.control_step(*args)
    return cuda_step.control_step_terrain(*args, gh)

"""Contact-solver parameters, the per-env impulse solve and the build-time
preconditioner (counterpart of ``unitree_rl_gym_tpu/physics/contact.py``:
``ContactParams``, ``point_kinematics``, ``contact_solve``,
``point_effective_mass``).

``contact_solve`` is the per-env formulation (physics/engine.py, mapped
over the env batch by ``backend.control_step_vmap``): the point-velocity
Jacobian and its response through H^{-1} built once a substep, then a
fixed-iteration projected Gauss-Seidel over every point at once. The
batched solve runs per substep in physics/soa.py (plain PyTorch) and in
the CUDA kernel (csrc/control_step.cuh)."""

from __future__ import annotations

import dataclasses

import torch

from reference.physics import dynamics as dyn


@dataclasses.dataclass(frozen=True)
class ContactParams:
    iterations: int = 8                      # 2x PhysX num_position_iterations
    baumgarte: float = 0.2                   # position-error gain
    max_depenetration_velocity: float = 1.0
    terrain_friction: float = 1.0            # plane material friction
    restitution: float = 0.0
    relaxation: float = 1.0                  # SOR factor on impulse deltas
    max_angular_velocity: float = 1000.0     # PhysX rigid-body velocity caps
    max_linear_velocity: float = 1000.0


def point_kinematics(model: dyn.DynModel, R_w, p_w, v_b):
    """World position [ncp,3] and velocity [..., ncp, 3] of every contact
    point (``v_b`` may carry leading batch dims)."""
    b = model.cp_dyn
    Rb, pb = R_w[b], p_w[b]
    vb = v_b[..., b, :]
    x = pb + torch.einsum("cij,cj->ci", Rb, model.cp_pos)
    v_local = vb[..., 3:] + torch.linalg.cross(
        vb[..., :3], model.cp_pos.expand_as(vb[..., :3]), dim=-1
    )
    v = torch.einsum("cij,...cj->...ci", Rb, v_local)
    return x, v


def contact_solve(model: dyn.DynModel, params: ContactParams, E_up, r_up, R_w,
                  p_w, Hinv, v, m_eff_n, m_eff_t, friction_env, dt: float,
                  ground_fn=None, stiff_scale=1.0):
    """The impulse solve of one env: ``Hinv`` [nv, nv] the explicit inverse
    mass matrix, ``v`` [nv] the velocity after the free dynamics,
    ``m_eff_n``/``m_eff_t`` [ncp] the preconditioner, ``friction_env`` the
    env's DR shape friction, ``ground_fn`` xy [..., 2] -> ground height
    (None: the z=0 plane), ``stiff_scale`` the contact-stiffness DR scale
    of the de-penetration bias. Returns (v_new [nv], cf_rb [nrb, 3]), the
    world contact force of every report body."""
    nv, nb, nrb = model.nv, model.nb, model.rb_rot.shape[0]
    dev = model.cp_pos.device
    mu = 0.5 * (params.terrain_friction + friction_env)

    # contact geometry is frozen for the solve (positions do not change)
    x, _ = point_kinematics(model, R_w, p_w, dyn.velocity_prop(model, E_up, r_up, v))
    ground_height = ground_fn(x[:, :2]) if ground_fn is not None else 0.0
    phi = model.cp_radius + ground_height - x[:, 2]
    active = phi > 0.0
    v_bias = stiff_scale * torch.clamp(
        params.baumgarte * torch.clamp(phi, min=0.0) / dt,
        max=params.max_depenetration_velocity,
    )

    # loop invariants: the point-velocity Jacobian A [ncp, 3, nv] (the nv
    # basis velocities through the kinematics, which are linear in v), its
    # normal and tangent rows, and their responses A H^{-1}
    eye = torch.eye(nv, dtype=torch.float32, device=dev)
    _, v_pt = point_kinematics(model, R_w, p_w, dyn.velocity_prop(model, E_up, r_up, eye))
    A = v_pt.permute(1, 2, 0)
    An, At = A[:, 2, :], A[:, :2, :]
    AHn = An @ Hinv
    AHt = torch.einsum("cdn,nm->cdm", At, Hinv)

    # block-Jacobi scaling: 1 / #active points on the same dyn body, the
    # segment sums as one-hot products
    onehot_dyn = (model.cp_dyn[None, :] == torch.arange(nb, device=dev)[:, None]).float()
    n_active = onehot_dyn @ active.float()
    jacobi = 1.0 / torch.clamp(n_active[model.cp_dyn], min=1.0)
    kn = params.relaxation * jacobi * m_eff_n
    kt = (params.relaxation * jacobi * m_eff_t)[:, None]

    pn = torch.zeros_like(phi)
    pt = torch.zeros_like(x[:, :2])
    for _ in range(params.iterations):
        vn = An @ v
        vt = torch.einsum("cdn,n->cd", At, v)
        # normal: target velocity +v_bias (de-penetration), accumulated >= 0
        dpn = kn * (v_bias - vn)
        pn_new = torch.where(active, torch.clamp(pn + dpn, min=0.0), 0.0)
        dpn = pn_new - pn
        # tangential: drive vt to 0 inside the cone |pt| <= mu * pn
        pt_new = pt + torch.where(active[:, None], -kt * vt, 0.0)
        pt_norm = torch.linalg.vector_norm(pt_new, dim=-1)
        cone = mu * pn_new
        scale = torch.where(pt_norm > cone, cone / (pt_norm + 1e-9), 1.0)
        pt_new = pt_new * scale[:, None]
        dpt = pt_new - pt
        # dv = H^{-1} J^T dp through the response matrices
        v = v + (dpn @ AHn + torch.einsum("cd,cdm->m", dpt, AHt))
        pn, pt = pn_new, pt_new

    # the net world contact force of every report body (impulse / dt)
    f_world = torch.cat((pt, pn[:, None]), dim=-1) / dt
    onehot_rb = (model.cp_body[None, :] == torch.arange(nrb, device=dev)[:, None]).float()
    return v, onehot_rb @ f_world


def point_effective_mass(model: dyn.DynModel, base_quat, base_pos, joint_q):
    """Diagonal effective masses 1/(J H^{-1} J^T) of each contact point in the
    world z (normal) and x/y (tangent, averaged) directions at a nominal
    pose: the PGS preconditioner, fixed at env build."""
    nv = model.nv
    eye = torch.eye(nv, dtype=torch.float32)
    fk_out = dyn.fk(model, base_pos, base_quat, joint_q, torch.zeros(nv))
    R_w, p_w, (E_up, r_up), _ = fk_out
    # point velocities of the nv basis velocities: A [ncp, 3, nv]
    _, v_pt = point_kinematics(model, R_w, p_w, dyn.velocity_prop(model, E_up, r_up, eye))
    A = v_pt.permute(1, 2, 0)
    Hinv = dyn.cholesky_inverse(dyn.mass_matrix(model, fk_out, 1.0))
    Hib = torch.einsum("cdn,nm->cdm", A, Hinv)
    D = torch.einsum("cdn,cen->cde", A, Hib)
    m_n = 1.0 / torch.clamp(D[:, 2, 2], min=1e-6)
    m_t = 1.0 / torch.clamp(0.5 * (D[:, 0, 0] + D[:, 1, 1]), min=1e-6)
    return m_n, m_t

"""Env-SoA (structure-of-arrays) control step: the plain PyTorch version of
the CUDA kernels K1 and K3 (counterpart of ``unitree_rl_gym_tpu/physics/soa.py``).

Every physical scalar is a ``[N]`` tensor over the env batch, vectors and
matrices are Python tuples of those, and the small recursions (FK, RNEA,
CRBA, sparse Cholesky) unroll in Python. Model constants stay Python
floats, so the ``_add``/``_mul``/``_mac`` helpers fold multiplies by
structural 0 / ±1 away exactly as the JAX package does; the PGS and
decimation loops are Python ``for`` loops.

This module is the reference the CUDA kernels (csrc/control_step.cuh,
physics/cuda_step.py) are held against, and the path a CPU tensor takes
(physics/backend.py). It launches thousands of tiny ops per control step,
so on the card it is a correctness yardstick, not a fast path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference.physics import dynamics as dyn

# ---------------------------------------------------------------------------
# scalar algebra with build-time constant folding
# ---------------------------------------------------------------------------

Scalar = Any  # float (build-time constant) | torch.Tensor (env batch)


def _is_const(x) -> bool:
    return isinstance(x, (int, float, np.floating))


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as one rounded division on every device, as the kernel
    and the JAX package divide: torch divides a CUDA tensor by a Python
    scalar as a product with the scalar's float32 reciprocal, which rounds
    otherwise (the PGS solve amplifies that last bit)."""
    return x / torch.full_like(x, s)


def _add(a, b):
    if _is_const(a) and a == 0.0:
        return b
    if _is_const(b) and b == 0.0:
        return a
    if _is_const(a) and _is_const(b):
        return float(a) + float(b)
    return a + b


def _sub(a, b):
    if _is_const(b) and b == 0.0:
        return a
    if _is_const(a) and _is_const(b):
        return float(a) - float(b)
    if _is_const(a) and a == 0.0:
        return -b
    return a - b


def _mul(a, b):
    if _is_const(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return _neg(b)
    if _is_const(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return _neg(a)
    if _is_const(a) and _is_const(b):
        return float(a) * float(b)
    return a * b


def _neg(a):
    if _is_const(a):
        return -float(a)
    return -a


def _mac(acc, a, b):
    """acc + a*b with structural-zero folding."""
    return _add(acc, _mul(a, b))


def _dot(xs: Sequence, ys: Sequence):
    acc = 0.0
    for x, y in zip(xs, ys):
        acc = _mac(acc, x, y)
    return acc


# vec3 = (x, y, z); mat33 = ((..),(..),(..)) rows; svec = (vec3 ang, vec3 lin)


def v3_add(a, b):
    return tuple(_add(x, y) for x, y in zip(a, b))


def v3_sub(a, b):
    return tuple(_sub(x, y) for x, y in zip(a, b))


def v3_scale(a, s):
    return tuple(_mul(x, s) for x in a)


def v3_cross(a, b):
    return (
        _sub(_mul(a[1], b[2]), _mul(a[2], b[1])),
        _sub(_mul(a[2], b[0]), _mul(a[0], b[2])),
        _sub(_mul(a[0], b[1]), _mul(a[1], b[0])),
    )


def m33_vec(M, v):
    return tuple(_dot(row, v) for row in M)


def m33_T(M):
    return tuple(tuple(M[j][i] for j in range(3)) for i in range(3))


def m33_Tvec(M, v):
    return tuple(_dot((M[0][i], M[1][i], M[2][i]), v) for i in range(3))


def m33_mul(A, B):
    Bt = m33_T(B)
    return tuple(tuple(_dot(A[i], Bt[j]) for j in range(3)) for i in range(3))


def sv_add(a, b):
    return (v3_add(a[0], b[0]), v3_add(a[1], b[1]))


# ---------------------------------------------------------------------------
# static model
# ---------------------------------------------------------------------------


def _f3(a) -> Tuple[float, float, float]:
    return (float(a[0]), float(a[1]), float(a[2]))


def _fm33(M):
    return tuple(tuple(float(M[i][j]) for j in range(3)) for i in range(3))


@dataclasses.dataclass(frozen=True)
class SoAModel:
    """Build-time constants extracted from :class:`dynamics.DynModel`.

    All numeric fields are Python floats / tuples so the algebra helpers can
    fold structural zeros. Contact points are permuted to be sorted by
    dynamic body so body<->point traffic is static slicing.
    """

    nb: int
    nj: int
    nv: int
    ncp: int
    nrb: int
    parent: Tuple[int, ...]
    axis: Tuple[Tuple[float, float, float], ...]
    Etree: Tuple
    rtree: Tuple
    # spatial inertia blocks (I about origin, m*skew(c), mass) per body
    I_blk: Tuple          # [(Ic 3x3, Hc 3x3, mass float), ...]
    armature: float
    dof_damping: Tuple[float, ...]
    dof_friction: Tuple[float, ...]
    dof_vel_limit: Tuple[float, ...]
    dof_lower: Tuple[float, ...]
    dof_upper: Tuple[float, ...]
    gravity: Tuple[float, float, float]
    base_mass: float
    # contact points (sorted by cp_dyn)
    cp_slice: Tuple[Tuple[int, int], ...]   # per dyn body [start, end)
    cp_pos: np.ndarray                      # [ncp, 3] body-frame offsets
    cp_radius: np.ndarray                   # [ncp]
    cp_rb: Tuple[Tuple[int, ...], ...]      # per report body: point indices
    cp_perm: np.ndarray                     # original -> sorted permutation
    # report bodies
    rb_dyn: Tuple[int, ...]
    rb_rot: Tuple
    rb_pos: Tuple
    # cholesky elimination order (joints first, base last: no cross-chain
    # fill-in for star-of-chains trees like quadrupeds/humanoids)
    chol_order: Tuple[int, ...]


def build_soa_model(model: dyn.DynModel) -> SoAModel:
    nb, nj, nv = model.nb, model.nj, model.nv
    I_sp = np.asarray(model.I_sp)
    I_blk = tuple(
        (_fm33(I_sp[i, :3, :3]), _fm33(I_sp[i, :3, 3:]), float(I_sp[i, 5, 5]))
        for i in range(nb)
    )
    cp_dyn = np.asarray(model.cp_dyn)
    perm = np.argsort(cp_dyn, kind="stable")
    cp_dyn_s = cp_dyn[perm]
    cp_body_s = np.asarray(model.cp_body)[perm]
    ncp = cp_dyn.shape[0]
    starts = np.searchsorted(cp_dyn_s, np.arange(nb))
    ends = np.searchsorted(cp_dyn_s, np.arange(nb) + 1)
    nrb = int(np.asarray(model.rb_rot).shape[0])
    cp_rb = tuple(
        tuple(int(i) for i in np.nonzero(cp_body_s == r)[0]) for r in range(nrb)
    )
    return SoAModel(
        nb=nb, nj=nj, nv=nv, ncp=ncp, nrb=nrb,
        parent=tuple(model.parent),
        axis=tuple(_f3(a) for a in np.asarray(model.joint_axis)),
        Etree=tuple(_fm33(E) for E in np.asarray(model.Etree)),
        rtree=tuple(_f3(r) for r in np.asarray(model.rtree)),
        I_blk=I_blk,
        armature=float(model.armature),
        dof_damping=tuple(float(d) for d in np.asarray(model.dof_damping)),
        dof_friction=tuple(float(f) for f in np.asarray(model.dof_friction)),
        dof_vel_limit=tuple(
            float(v) for v in np.asarray(model.dof_vel_limit)
        ),
        dof_lower=tuple(float(v) for v in np.asarray(model.dof_lower)),
        dof_upper=tuple(float(v) for v in np.asarray(model.dof_upper)),
        gravity=_f3(np.asarray(model.gravity)),
        base_mass=float(model.base_mass),
        cp_slice=tuple(
            (int(s), int(e)) for s, e in zip(starts, ends)
        ),
        cp_pos=np.asarray(model.cp_pos)[perm].astype(np.float32),
        cp_radius=np.asarray(model.cp_radius)[perm].astype(np.float32),
        cp_rb=cp_rb,
        cp_perm=perm,
        rb_dyn=tuple(int(i) for i in np.asarray(model.rb_dyn_idx)),
        rb_rot=tuple(_fm33(R) for R in np.asarray(model.rb_rot)),
        rb_pos=tuple(_f3(p) for p in np.asarray(model.rb_pos)),
        chol_order=tuple(range(6, nv)) + tuple(range(6)),
    )


# ---------------------------------------------------------------------------
# quaternion / joint rotation (scalar SoA)
# ---------------------------------------------------------------------------


def quat_to_rotmat_s(q):
    """xyzw quaternion (4 scalars) -> 3x3 rotation (body->world)."""
    x, y, z, w = q
    x2, y2, z2 = _add(x, x), _add(y, y), _add(z, z)
    xx, yy, zz = _mul(x, x2), _mul(y, y2), _mul(z, z2)
    xy, xz, yz = _mul(x, y2), _mul(x, z2), _mul(y, z2)
    wx, wy, wz = _mul(w, x2), _mul(w, y2), _mul(w, z2)
    return (
        (_sub(1.0, _add(yy, zz)), _sub(xy, wz), _add(xz, wy)),
        (_add(xy, wz), _sub(1.0, _add(xx, zz)), _sub(yz, wx)),
        (_sub(xz, wy), _add(yz, wx), _sub(1.0, _add(xx, yy))),
    )


def joint_rot_T(axis, q):
    """rot_axis semantics (spatial.py:136-148): R(axis, q)^T, Rodrigues with
    a constant unit axis — entries are affine in (cos q, sin q)."""
    c, s = torch.cos(q), torch.sin(q)
    ax, ay, az = axis
    one_c = _sub(1.0, c)
    # R = c*I + s*skew(a) + (1-c) a a^T ; return R^T
    R = [[0.0] * 3 for _ in range(3)]
    a = (ax, ay, az)
    sk = ((0.0, -az, ay), (az, 0.0, -ax), (-ay, ax, 0.0))
    for i in range(3):
        for j in range(3):
            t = _mul(_mul(a[i], a[j]), one_c)
            if i == j:
                t = _add(t, c)
            t = _mac(t, sk[i][j], s)
            R[i][j] = t
    return tuple(tuple(R[j][i] for j in range(3)) for i in range(3))


def quat_integrate_s(q, omega_w, dt):
    """q' = normalize(q + 0.5*dt*[w,0] ⊗ q) (math.quat_integrate)."""
    ox, oy, oz = omega_w
    x, y, z, w = q
    h = 0.5 * dt
    # quat_mul((ox,oy,oz,0), (x,y,z,w))
    dx = _mul(h, _add(_mul(ox, w), _sub(_mul(oy, z), _mul(oz, y))))
    dy = _mul(h, _add(_mul(oy, w), _sub(_mul(oz, x), _mul(ox, z))))
    dz = _mul(h, _add(_mul(oz, w), _sub(_mul(ox, y), _mul(oy, x))))
    dw = _mul(h, _neg(_add(_add(_mul(ox, x), _mul(oy, y)), _mul(oz, z))))
    x, y, z, w = _add(x, dx), _add(y, dy), _add(z, dz), _add(w, dw)
    n2 = _add(_add(_mul(x, x), _mul(y, y)), _add(_mul(z, z), _mul(w, w)))
    inv = torch.rsqrt(torch.clamp(n2, min=1e-18))
    return (_mul(x, inv), _mul(y, inv), _mul(z, inv), _mul(w, inv))


# ---------------------------------------------------------------------------
# spatial ops on ((ang vec3), (lin vec3)) pairs
# ---------------------------------------------------------------------------


def xform_motion_s(E, r, v):
    w, vl = v
    wB = m33_vec(E, w)
    vB = m33_vec(E, v3_sub(vl, v3_cross(r, w)))
    return (wB, vB)


def xform_force_inv_s(E, r, f):
    n, fl = f
    fA = m33_Tvec(E, fl)
    nA = v3_add(m33_Tvec(E, n), v3_cross(r, fA))
    return (nA, fA)


def cross_motion_s(v, m):
    w, vl = v
    mw, ml = m
    return (v3_cross(w, mw), v3_add(v3_cross(vl, mw), v3_cross(w, ml)))


def cross_force_s(v, f):
    w, vl = v
    n, fl = f
    return (v3_add(v3_cross(w, n), v3_cross(vl, fl)), v3_cross(w, fl))


def apply_inertia(blk, v, scale=1.0):
    """[n; f] = I_sp @ [w; vl] for I_sp = [[Ic, Hc],[Hc^T, m*1]],
    optionally scaled (base-mass DR, dynamics._scaled_inertias)."""
    Ic, Hc, m = blk
    w, vl = v
    n = v3_add(m33_vec(Ic, w), m33_vec(Hc, vl))
    f = v3_add(m33_Tvec(Hc, w), v3_scale(vl, m))
    if not (_is_const(scale) and scale == 1.0):
        n = v3_scale(n, scale)
        f = v3_scale(f, scale)
    return (n, f)


# ---------------------------------------------------------------------------
# FK / RNEA / CRBA (unrolled recursions)
# ---------------------------------------------------------------------------


def fk_s(m: SoAModel, bp, bq, q, v):
    """Returns (R_w [nb mat33], p_w [nb vec3], E_up [nj mat33], v_b [nb sv])."""
    E_up = []
    for j in range(m.nj):
        Ej = joint_rot_T(m.axis[j], q[j])
        E_up.append(m33_mul(Ej, m.Etree[j]))
    R0 = quat_to_rotmat_s(bq)
    R_w: List = [R0]
    p_w: List = [bp]
    v_b: List = [((v[0], v[1], v[2]), (v[3], v[4], v[5]))]
    for i in range(1, m.nb):
        par, j = m.parent[i], i - 1
        R_w.append(m33_mul(R_w[par], m33_T(E_up[j])))
        p_w.append(v3_add(p_w[par], m33_vec(R_w[par], m.rtree[j])))
        vi = xform_motion_s(E_up[j], m.rtree[j], v_b[par])
        qd = v[6 + j]
        S_qd = (v3_scale(m.axis[j], qd), (0.0, 0.0, 0.0))
        v_b.append(sv_add(vi, S_qd))
    return R_w, p_w, E_up, v_b


def velocity_prop_s(m: SoAModel, E_up, v):
    v_b: List = [((v[0], v[1], v[2]), (v[3], v[4], v[5]))]
    for i in range(1, m.nb):
        j = i - 1
        vi = xform_motion_s(E_up[j], m.rtree[j], v_b[m.parent[i]])
        S_qd = (v3_scale(m.axis[j], v[6 + j]), (0.0, 0.0, 0.0))
        v_b.append(sv_add(vi, S_qd))
    return v_b


def force_backward_s(m: SoAModel, E_up, f_b):
    """Adjoint of velocity_prop_s: per-body spatial forces (body coords) ->
    generalized force [nv] (the backward half of dynamics.bias_forces)."""
    f = list(f_b)
    tau = [0.0] * m.nj
    for i in range(m.nb - 1, 0, -1):
        j = i - 1
        tau[j] = _dot(m.axis[j], f[i][0])
        f[m.parent[i]] = sv_add(
            f[m.parent[i]], xform_force_inv_s(E_up[j], m.rtree[j], f[i])
        )
    n0, f0 = f[0]
    return list(n0) + list(f0) + tau


def bias_s(m: SoAModel, R_w, E_up, v_b, v, mass_scale):
    """RNEA with qdd=0, f_ext=0 (dynamics.bias_forces)."""
    g = m.gravity
    g_body = m33_Tvec(R_w[0], g)
    a: List = [((0.0, 0.0, 0.0), tuple(_neg(x) for x in g_body))]
    for i in range(1, m.nb):
        j = i - 1
        ai = xform_motion_s(E_up[j], m.rtree[j], a[m.parent[i]])
        S_qd = (v3_scale(m.axis[j], v[6 + j]), (0.0, 0.0, 0.0))
        a.append(sv_add(ai, cross_motion_s(v_b[i], S_qd)))
    f_b = []
    for i in range(m.nb):
        scale = mass_scale if i == 0 else 1.0
        fi = apply_inertia(m.I_blk[i], a[i], scale)
        fi = sv_add(fi, cross_force_s(v_b[i], apply_inertia(m.I_blk[i], v_b[i], scale)))
        f_b.append(fi)
    return force_backward_s(m, E_up, f_b)


def _inertia_to_parent(E, r, blk):
    """(Ic, Hc, Mc) block transform X^T I X for X=(E,r) (spatial.py:129-133).
    Blocks here are full 3x3s (Mc dense after accumulation)."""
    Ic, Hc, Mc = blk
    sk = ((0.0, _neg(r[2]), r[1]), (r[2], 0.0, _neg(r[0])), (_neg(r[1]), r[0], 0.0))
    F = tuple(
        tuple(_neg(_dot(E[i], (sk[0][j], sk[1][j], sk[2][j]))) for j in range(3))
        for i in range(3)
    )  # F = -E @ skew(r)
    # I X = [[Ic E + Hc F, Hc E], [Hc^T E + Mc F, Mc E]]
    IcE = m33_mul(Ic, E)
    HcF = m33_mul(Hc, F)
    HcE = m33_mul(Hc, E)
    HcTE = m33_mul(m33_T(Hc), E)
    McF = m33_mul(Mc, F)
    McE = m33_mul(Mc, E)
    A = tuple(tuple(_add(IcE[i][j], HcF[i][j]) for j in range(3)) for i in range(3))
    C = tuple(tuple(_add(HcTE[i][j], McF[i][j]) for j in range(3)) for i in range(3))
    # X^T (I X): top = E^T A + F^T C ; coupling = E^T HcE + F^T McE ; mass = E^T McE
    def mTa_add(P, Q, M1, M2):
        # P^T M1 + Q^T M2
        return tuple(
            tuple(
                _add(
                    _dot((P[0][i], P[1][i], P[2][i]), (M1[0][j], M1[1][j], M1[2][j])),
                    _dot((Q[0][i], Q[1][i], Q[2][i]), (M2[0][j], M2[1][j], M2[2][j])),
                )
                for j in range(3)
            )
            for i in range(3)
        )
    Ip = mTa_add(E, F, A, C)
    Hp = mTa_add(E, F, HcE, McE)
    Mp = tuple(
        tuple(
            _dot((E[0][i], E[1][i], E[2][i]), (McE[0][j], McE[1][j], McE[2][j]))
            for j in range(3)
        )
        for i in range(3)
    )
    return (Ip, Hp, Mp)


def _blk_full(blk, scale=1.0):
    """Constant (Ic, Hc, m) -> dense-block (Ic, Hc, Mc) with opt. scaling."""
    Ic, Hc, mass = blk
    Mc = ((mass, 0.0, 0.0), (0.0, mass, 0.0), (0.0, 0.0, mass))
    if _is_const(scale) and scale == 1.0:
        return (Ic, Hc, Mc)
    sc = lambda M: tuple(tuple(_mul(M[i][j], scale) for j in range(3)) for i in range(3))
    return (sc(Ic), sc(Hc), sc(Mc))


def crba_s(m: SoAModel, E_up, mass_scale) -> Dict[Tuple[int, int], Scalar]:
    """Joint-space inertia as a sparse dict {(i,j): scalar}, i >= j
    (dynamics.mass_matrix)."""
    Ic = [
        _blk_full(m.I_blk[i], mass_scale if i == 0 else 1.0) for i in range(m.nb)
    ]
    for i in range(m.nb - 1, 0, -1):
        j = i - 1
        t = _inertia_to_parent(E_up[j], m.rtree[j], Ic[i])
        p = m.parent[i]
        Ic[p] = tuple(
            tuple(
                tuple(_add(Ic[p][b][r][c], t[b][r][c]) for c in range(3))
                for r in range(3)
            )
            for b in range(3)
        )
    H: Dict[Tuple[int, int], Scalar] = {}
    # base 6x6 block: [[Ic0, Hc0],[Hc0^T, Mc0]]
    I0, H0, M0 = Ic[0]
    for r in range(3):
        for c in range(3):
            if r >= c:
                H[(r, c)] = I0[r][c]
                H[(3 + r, 3 + c)] = M0[r][c]
            H[(3 + r, c)] = H0[c][r]  # (Hc^T)[r][c]
    for i in range(1, m.nb):
        j = i - 1
        # F = Ic[i] @ S, S = [axis; 0]
        Icb, Hcb, _ = Ic[i]
        Fn = m33_vec(Icb, m.axis[j])
        Ff = m33_vec(tuple(tuple(Hcb[r][c] for r in range(3)) for c in range(3)), m.axis[j])  # Hc^T axis
        H[(6 + j, 6 + j)] = _add(_dot(m.axis[j], Fn), m.armature)
        F = (Fn, Ff)
        k = i
        while m.parent[k] != -1:
            F = xform_force_inv_s(E_up[k - 1], m.rtree[k - 1], F)
            k = m.parent[k]
            if k == 0:
                for r in range(3):
                    H[(6 + j, r)] = F[0][r]
                    H[(6 + j, 3 + r)] = F[1][r]
            else:
                jj = k - 1
                H[(6 + j, 6 + jj)] = _dot(m.axis[jj], F[0])
    return H



# ---------------------------------------------------------------------------
# sparse Cholesky (dict-based, explicit elimination order)
# ---------------------------------------------------------------------------


def chol_factor_s(H: Dict[Tuple[int, int], Scalar], order: Sequence[int]):
    """L D^{1/2} factor of the permuted H; returns (L dict keyed on permuted
    positions, rinv list of 1/sqrt(diag), pos). Structural zeros are never
    emitted."""
    n = len(order)
    pos = {v: i for i, v in enumerate(order)}

    def h(i, j):  # permuted lookup, H stored lower
        a, b = order[i], order[j]
        if a < b:
            a, b = b, a
        return H.get((a, b), 0.0)

    L: Dict[Tuple[int, int], Scalar] = {}
    rinv: List[Scalar] = [0.0] * n
    for j in range(n):
        for i in range(j, n):
            s = h(i, j)
            for k in range(j):
                lik = L.get((i, k))
                ljk = L.get((j, k))
                if lik is not None and ljk is not None:
                    s = _sub(s, _mul(lik, ljk))
            if i == j:
                rinv[j] = torch.rsqrt(torch.clamp(s, min=1e-12))
                L[(j, j)] = _mul(s, rinv[j])
            else:
                if _is_const(s) and s == 0.0:
                    continue
                L[(i, j)] = _mul(s, rinv[j])
    return L, rinv, pos


def chol_solve_s(L, rinv, pos, order, b: Sequence[Scalar]):
    """Solve H x = b given the factor from chol_factor_s (natural indexing in
    and out)."""
    n = len(order)
    y: List[Scalar] = [0.0] * n
    for i in range(n):
        s = b[order[i]]
        for k in range(i):
            lik = L.get((i, k))
            if lik is not None and not (_is_const(y[k]) and y[k] == 0.0):
                s = _sub(s, _mul(lik, y[k]))
        y[i] = _mul(s, rinv[i])
    x: List[Scalar] = [0.0] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            lki = L.get((k, i))
            if lki is not None and not (_is_const(x[k]) and x[k] == 0.0):
                s = _sub(s, _mul(lki, x[k]))
        x[i] = _mul(s, rinv[i])
    out = [0.0] * n
    for i in range(n):
        out[order[i]] = x[i]
    return out


# ---------------------------------------------------------------------------
# contact (point dim vectorized: per-point quantities are [ncp, N])
# ---------------------------------------------------------------------------


def _pc(arr: np.ndarray, like: torch.Tensor):
    """Per-point constant [ncp] -> [ncp, 1] tensor beside ``like``."""
    return torch.as_tensor(
        np.asarray(arr, np.float32), device=like.device
    ).reshape(-1, 1)


def _gather(m: SoAModel, vals: Sequence[Scalar], like: torch.Tensor):
    """Per-dyn-body scalars -> per-point [ncp, N] via static slices (points
    are sorted by body)."""
    pieces = []
    for b in range(m.nb):
        s, e = m.cp_slice[b]
        if e == s:
            continue
        v = vals[b]
        if _is_const(v):
            v = torch.full_like(like, float(v))
        pieces.append(v[None].expand((e - s,) + tuple(v.shape)))
    return torch.cat(pieces, dim=0)


def _scatter_sum(m: SoAModel, parr):
    """Per-point [ncp, N] -> per-dyn-body list of sums, added point after
    point in order (the kernel's order; a device reduction would choose its
    own)."""
    out = []
    for b in range(m.nb):
        s, e = m.cp_slice[b]
        acc = 0.0
        for i in range(s, e):
            acc = acc + parr[i]
        out.append(acc)
    return out


def point_world_positions_s(m: SoAModel, R_w, p_w, like):
    """World lever arms r_w and point positions x_w, 3-lists of [ncp, N]."""
    rc_c = [_pc(m.cp_pos[:, k], like) for k in range(3)]
    r_w = []
    for i in range(3):
        per_body = []
        for b in range(m.nb):
            s, e = m.cp_slice[b]
            if e == s:
                continue
            piece = 0.0
            for k in range(3):
                piece = piece + rc_c[k][s:e] * R_w[b][i][k][None]
            per_body.append(piece)
        r_w.append(torch.cat(per_body, dim=0))
    pg = [_gather(m, [p_w[b][i] for b in range(m.nb)], like) for i in range(3)]
    x_w = [pg[i] + r_w[i] for i in range(3)]
    return r_w, x_w


def contact_solve_s(m: SoAModel, params, E_up, R_w, p_w, chol,
                    v: List[Scalar], m_eff_n: np.ndarray, m_eff_t: np.ndarray,
                    friction_env, dt: float, gh_frozen=None, cstiff=None,
                    ground_fn=None):
    """PGS impulse solve (the JAX package's ``contact_solve_s``).
    ``gh_frozen`` [ncp,N] holds the ground height under every point, frozen
    across the control step's substeps; without it, ``ground_fn`` (xy
    [ncp, N, 2] world meters -> heights [ncp, N]) samples the heights at
    this substep's own point positions; with neither the ground is the z=0
    plane. ``cstiff`` [N] is the per-env contact-stiffness
    scale of the de-penetration bias, applied after its clamp to
    ``max_depenetration_velocity`` (the JAX order, so a stiff env may
    exceed that cap); None leaves the bias as it is.
    Returns (v_new [nv], pn [ncp,N], (ptx, pty), phi [ncp,N])."""
    L, rinv, pos = chol
    like = next(x for x in v if not _is_const(x))
    mu = _mul(0.5, _add(params.terrain_friction, friction_env))

    radius_c = _pc(m.cp_radius, like)
    men = _pc(m_eff_n, like)
    met = _pc(m_eff_t, like)

    r_w, x_w = point_world_positions_s(m, R_w, p_w, like)
    if gh_frozen is None and ground_fn is not None:
        gh_frozen = ground_fn(torch.stack([x_w[0], x_w[1]], dim=-1))
    if gh_frozen is None:
        phi = radius_c - x_w[2]
    else:
        phi = radius_c + gh_frozen - x_w[2]
    active = phi > 0.0
    activef = active.to(torch.float32)
    v_bias = torch.clamp(
        _div(params.baumgarte * torch.clamp(phi, min=0.0), dt),
        max=params.max_depenetration_velocity,
    )
    if cstiff is not None:
        v_bias = v_bias * cstiff[None]

    # block-Jacobi scaling: 1 / #active points on the same dyn body
    n_active = _scatter_sum(m, activef)
    jacobi = 1.0 / torch.clamp(_gather(m, n_active, like), min=1.0)

    kn = params.relaxation * jacobi * men
    kt = params.relaxation * jacobi * met
    mu_b = mu if _is_const(mu) else mu[None]

    def point_vels(v_b_list):
        """v_pt = v_w + w_w x r_w, rotating at body level."""
        w_w, l_w = [], []
        for b in range(m.nb):
            wb, lb = v_b_list[b]
            w_w.append(m33_vec(R_w[b], wb))
            l_w.append(m33_vec(R_w[b], lb))
        wg = [_gather(m, [w_w[b][i] for b in range(m.nb)], like) for i in range(3)]
        lg = [_gather(m, [l_w[b][i] for b in range(m.nb)], like) for i in range(3)]
        return [
            lg[0] + wg[1] * r_w[2] - wg[2] * r_w[1],
            lg[1] + wg[2] * r_w[0] - wg[0] * r_w[2],
            lg[2] + wg[0] * r_w[1] - wg[1] * r_w[0],
        ]

    def gen_force(dp):
        """World point impulses (3 arrays) -> generalized impulse [nv]."""
        n_w = [
            r_w[1] * dp[2] - r_w[2] * dp[1],
            r_w[2] * dp[0] - r_w[0] * dp[2],
            r_w[0] * dp[1] - r_w[1] * dp[0],
        ]
        nb_sum = [_scatter_sum(m, n_w[i]) for i in range(3)]
        fb_sum = [_scatter_sum(m, dp[i]) for i in range(3)]
        f_b = []
        for b in range(m.nb):
            nw = (nb_sum[0][b], nb_sum[1][b], nb_sum[2][b])
            fw = (fb_sum[0][b], fb_sum[1][b], fb_sum[2][b])
            f_b.append((m33_Tvec(R_w[b], nw), m33_Tvec(R_w[b], fw)))
        return force_backward_s(m, E_up, f_b)

    zero_p = torch.zeros((m.ncp,) + tuple(like.shape), dtype=torch.float32,
                         device=like.device)
    vv = [x if not _is_const(x) else torch.full_like(like, float(x)) for x in v]
    pn, ptx, pty = zero_p, zero_p, zero_p
    for _ in range(params.iterations):
        vb = velocity_prop_s(m, E_up, vv)
        vp = point_vels(vb)
        dpn = kn * (v_bias - vp[2])
        pn_new = torch.where(active, torch.clamp(pn + dpn, min=0.0), 0.0)
        dpn = pn_new - pn
        dptx = torch.where(active, -kt * vp[0], 0.0)
        dpty = torch.where(active, -kt * vp[1], 0.0)
        ptx_n, pty_n = ptx + dptx, pty + dpty
        pt_norm = torch.sqrt(ptx_n * ptx_n + pty_n * pty_n)
        cone = mu_b * pn_new
        scale = torch.where(pt_norm > cone, cone / (pt_norm + 1e-9), 1.0)
        ptx_n, pty_n = ptx_n * scale, pty_n * scale
        dptx, dpty = ptx_n - ptx, pty_n - pty
        f_gen = gen_force([dptx, dpty, dpn])
        dv = chol_solve_s(L, rinv, pos, m.chol_order, f_gen)
        vv = [_add(vv[k], dv[k]) for k in range(m.nv)]
        pn, ptx, pty = pn_new, ptx_n, pty_n
    return vv, pn, (ptx, pty), phi


# ---------------------------------------------------------------------------
# full substep (engine.control_step inner body)
# ---------------------------------------------------------------------------


def substep_s(m, params, pd_kp, pd_kd, pd_lim, clip_torque, sim_dt,
              bp, bq, q, v, target, friction_env, mass_scale,
              m_eff_n, m_eff_t, gh_frozen=None, cstiff=None, ground_fn=None):
    """One physics substep. All args/returns are scalar lists / tuples of
    [N] tensors; ``gh_frozen`` [ncp,N] is the ground height under every
    point, or else ``ground_fn`` samples it at this substep's positions
    (neither: the z=0 plane; :func:`contact_solve_s`), ``cstiff`` [N] the
    contact-stiffness scale (None: 1). Returns (bp, bq, q, v, tau, pn,
    (ptx, pty), phi)."""
    R_w, p_w, E_up, v_b = fk_s(m, bp, bq, q, v)

    tau = [
        _sub(_mul(pd_kp[j], _sub(target[j], q[j])), _mul(pd_kd[j], v[6 + j]))
        for j in range(m.nj)
    ]
    if clip_torque:
        tau = [torch.clamp(tau[j], -pd_lim[j], pd_lim[j]) for j in range(m.nj)]

    bias = bias_s(m, R_w, E_up, v_b, v, mass_scale)
    H = crba_s(m, E_up, mass_scale)
    chol = chol_factor_s(H, m.chol_order)
    rhs = []
    for k in range(m.nv):
        if k < 6:
            rhs.append(_neg(bias[k]))
        else:
            j = k - 6
            passive = _sub(
                _mul(-m.dof_damping[j], v[6 + j]),
                _mul(m.dof_friction[j], torch.tanh(_div(v[6 + j], 0.1)))
                if m.dof_friction[j] != 0.0 else 0.0,
            )
            rhs.append(_sub(_add(tau[j], passive), bias[k]))
    qdd = chol_solve_s(chol[0], chol[1], chol[2], m.chol_order, rhs)
    v_free = [_add(v[k], _mul(sim_dt, qdd[k])) for k in range(m.nv)]

    v_new, pn, pt, phi = contact_solve_s(
        m, params, E_up, R_w, p_w, chol, v_free, m_eff_n, m_eff_t,
        friction_env, sim_dt, gh_frozen, cstiff, ground_fn,
    )

    # PhysX-parity joint velocity clamp and base velocity caps
    for j in range(m.nj):
        lim = m.dof_vel_limit[j]
        if np.isfinite(lim):
            v_new[6 + j] = torch.clamp(v_new[6 + j], -lim, lim)
    for k in range(3):
        v_new[k] = torch.clamp(
            v_new[k], -params.max_angular_velocity, params.max_angular_velocity
        )
        v_new[3 + k] = torch.clamp(
            v_new[3 + k], -params.max_linear_velocity,
            params.max_linear_velocity,
        )

    # semi-implicit integration with the old-quat frame
    R0 = R_w[0]
    om_w = m33_vec(R0, (v_new[0], v_new[1], v_new[2]))
    vel_w = m33_vec(R0, (v_new[3], v_new[4], v_new[5]))
    bp = tuple(_add(bp[i], _mul(sim_dt, vel_w[i])) for i in range(3))
    bq = quat_integrate_s(bq, om_w, sim_dt)
    q = [_add(q[j], _mul(sim_dt, v_new[6 + j])) for j in range(m.nj)]

    # hard joint limits: clamp q, zero qd into the limit
    for j in range(m.nj):
        lo, up = m.dof_lower[j], m.dof_upper[j]
        if not (np.isfinite(lo) or np.isfinite(up)):
            continue
        qd = v_new[6 + j]
        qd = torch.where(q[j] < lo, torch.clamp(qd, min=0.0), qd)
        qd = torch.where(q[j] > up, torch.clamp(qd, max=0.0), qd)
        v_new[6 + j] = qd
        q[j] = torch.clamp(q[j], lo, up)
    return bp, bq, q, v_new, tau, pn, pt, phi


def rb_states_s(m: SoAModel, R_w, p_w, v_b):
    """World pos/vel of report bodies: p = p_b + R_b rb_pos,
    v = R_b (vl + w x rb_pos)."""
    pos, vel = [], []
    for r in range(m.nrb):
        b = m.rb_dyn[r]
        rp = m.rb_pos[r]
        w, vl = v_b[b]
        pos.append(v3_add(p_w[b], m33_vec(R_w[b], rp)))
        vel.append(m33_vec(R_w[b], v3_add(vl, v3_cross(w, rp))))
    return pos, vel


def cf_rb_s(m: SoAModel, pn, pt, dt, like):
    """Per-report-body world contact force [nrb][3] from final impulses."""
    fx, fy, fz = _div(pt[0], dt), _div(pt[1], dt), _div(pn, dt)
    zeros = torch.zeros_like(like)
    out = []
    for r in range(m.nrb):
        idx = m.cp_rb[r]
        if not idx:
            out.append((zeros, zeros, zeros))
        else:
            out.append((
                sum(fx[i] for i in idx),
                sum(fy[i] for i in idx),
                sum(fz[i] for i in idx),
            ))
    return out

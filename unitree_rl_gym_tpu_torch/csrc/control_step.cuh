// Per-env body of kernels K1 (flat ground), K3 (terrain) and K2 (either,
// with a per-env contact stiffness), the decimated
// physics control step: `decimation` x (PD torque + clip, FK, RNEA bias +
// passive terms,
// CRBA, Cholesky factor and solve, PGS contact with Baumgarte bias,
// block-Jacobi scaling and friction cone, velocity caps, semi-implicit
// integration, joint-limit projection), then FK of the settled state,
// report-body positions / velocities and report-body contact forces.
//
// K3 is the HAS_GH = true instance of the same template: every contact
// point's ground height gh (read once per control step, frozen across the
// substeps) enters the penetration depth phi = (radius + gh) - z, and the
// world xy of every point at the end of the step is written out (p_xy),
// from which the env computes the next step's gh. K1 is HAS_GH = false:
// the z = 0 plane, no p_xy.
//
// K2 is the HAS_CS = true instances (flat and terrain): the env's contact
// stiffness cs (read once per control step into a register) multiplies
// every point's de-penetration bias after its clamp. With cs = 1 the
// product is exact, so K2 gives K1's (or K3's) bits.
//
// The arithmetic restates unitree_rl_gym_tpu_torch/physics/soa.py (itself
// the port of the JAX package's physics/soa.py) for ONE env in plain C++:
// the same recursions, the same elimination order (joints first, base
// last), the same operation order inside each dot product. The model's
// structure is read at run time from a ModelTables struct built once by
// physics/cuda_step.py (tables, not generated code), and its sizes come
// from the build as -DUTRL_NB, -DUTRL_NCP and -DUTRL_NRB.
//
// Everything here is __host__ __device__: the CUDA kernel
// (control_step.cu) runs it once per thread, and a host harness
// (host_harness.cpp, compiled by g++ in the tests) runs it once per env on
// the CPU, so the kernel's math is held against the plain PyTorch version
// on machines without a GPU.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define UTRL_HD __host__ __device__ __forceinline__
#else
#define UTRL_HD inline
#endif

// 1/sqrt(x) as the plain version's torch.rsqrt computes it on each device:
// CUDA's rsqrtf on the card, a rounded division of a rounded sqrt on the
// CPU. The contact solve amplifies a last-bit difference in the Cholesky
// pivots into visible velocity differences, so the two must round alike.
UTRL_HD float utrl_rsqrt(float x) {
#ifdef __CUDA_ARCH__
    return rsqrtf(x);
#else
    return 1.0f / sqrtf(x);
#endif
}

#if !defined(UTRL_NB) || !defined(UTRL_NCP) || !defined(UTRL_NRB)
#error "UTRL_NB, UTRL_NCP and UTRL_NRB come from the build (physics/cuda_step.py)"
#endif

#define UTRL_NJ (UTRL_NB - 1)
#define UTRL_NV (UTRL_NB + 5)

// Every field is 4 bytes wide, so the struct has no padding and
// physics/cuda_step.py packs it field by field in this order; the build
// exports sizeof(ModelTables) and the wrapper checks it.
struct ModelTables {
    int parent[UTRL_NB];          // dyn-body parent, parent[0] = -1
    int cp_start[UTRL_NB];        // points sorted by dyn body: [start, end)
    int cp_end[UTRL_NB];
    int cp_rb[UTRL_NCP];          // report body of each (sorted) point
    int rb_dyn[UTRL_NRB];         // dyn body of each report body
    int chol_order[UTRL_NV];      // elimination order (joints, then base)
    int chol_pos[UTRL_NV];        // inverse of chol_order
    int iterations;               // PGS iterations
    int decimation;               // substeps per control step
    int clip_torque;
    float axis[UTRL_NJ][3];
    float Etree[UTRL_NJ][9];      // row-major 3x3
    float rtree[UTRL_NJ][3];
    float Ic[UTRL_NB][9];         // spatial inertia blocks about the origin
    float Hc[UTRL_NB][9];
    float mass[UTRL_NB];
    float dof_damping[UTRL_NJ];
    float dof_friction[UTRL_NJ];
    float dof_vel_limit[UTRL_NJ]; // inf = unlimited
    float dof_lower[UTRL_NJ];     // -inf / inf = unlimited
    float dof_upper[UTRL_NJ];
    float kp[UTRL_NJ];
    float kd[UTRL_NJ];
    float torque_limit[UTRL_NJ];
    float cp_pos[UTRL_NCP][3];    // body-frame offsets, sorted
    float cp_radius[UTRL_NCP];
    float m_eff_n[UTRL_NCP];      // PGS preconditioner, sorted
    float m_eff_t[UTRL_NCP];
    float rb_pos[UTRL_NRB][3];
    float gravity[3];
    float armature;
    float sim_dt;
    float baumgarte;
    float max_depenetration_velocity;
    float terrain_friction;
    float relaxation;
    float max_angular_velocity;
    float max_linear_velocity;
};

// ---------------------------------------------------------------------------
// 3-vectors and row-major 3x3 matrices; sums run left to right as in soa.py
// ---------------------------------------------------------------------------

UTRL_HD void utrl_mv(const float* E, const float* v, float* o) {
    for (int i = 0; i < 3; ++i)
        o[i] = E[3 * i] * v[0] + E[3 * i + 1] * v[1] + E[3 * i + 2] * v[2];
}

UTRL_HD void utrl_mtv(const float* E, const float* v, float* o) {
    for (int i = 0; i < 3; ++i)
        o[i] = E[i] * v[0] + E[3 + i] * v[1] + E[6 + i] * v[2];
}

// C = A @ B
UTRL_HD void utrl_mm(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                         + A[3 * i + 2] * B[6 + j];
}

// C = A^T @ B
UTRL_HD void utrl_mtm(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

UTRL_HD void utrl_cross(const float* a, const float* b, float* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

UTRL_HD float utrl_dot(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

UTRL_HD float utrl_clip(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// v_B = X v_A for the motion transform (E, r): (E w, E (vl - r x w))
UTRL_HD void utrl_xform_motion(const float* E, const float* r, const float* v,
                               float* o) {
    float rw[3], t[3];
    utrl_cross(r, v, rw);
    for (int i = 0; i < 3; ++i) t[i] = v[3 + i] - rw[i];
    utrl_mv(E, v, o);
    utrl_mv(E, t, o + 3);
}

// f_A = X^* f_B: (E^T n + r x E^T fl, E^T fl)
UTRL_HD void utrl_xform_force_inv(const float* E, const float* r, const float* f,
                                  float* o) {
    float fA[3], nA[3], rf[3];
    utrl_mtv(E, f + 3, fA);
    utrl_mtv(E, f, nA);
    utrl_cross(r, fA, rf);
    for (int i = 0; i < 3; ++i) {
        o[i] = nA[i] + rf[i];
        o[3 + i] = fA[i];
    }
}

// [n; f] = scale * [Ic w + Hc vl; Hc^T w + m vl]
UTRL_HD void utrl_apply_inertia(const ModelTables& M, int b, const float* v,
                                float scale, float* o) {
    float a[3], c[3];
    utrl_mv(M.Ic[b], v, a);
    utrl_mv(M.Hc[b], v + 3, c);
    for (int i = 0; i < 3; ++i) o[i] = a[i] + c[i];
    utrl_mtv(M.Hc[b], v, a);
    for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + v[3 + i] * M.mass[b];
    for (int i = 0; i < 6; ++i) o[i] *= scale;
}

// ---------------------------------------------------------------------------
// kinematics
// ---------------------------------------------------------------------------

struct UtrlKin {
    float R[UTRL_NB][9];    // body -> world
    float p[UTRL_NB][3];    // body origins in world
    float E[UTRL_NJ][9];    // parent -> child coordinate rotation
};

// joint_rot_T(axis, q) @ Etree: R = ((a a^T)(1-c) + c I) + s skew(a), E = R^T
UTRL_HD void utrl_joint_E(const ModelTables& M, int j, float q, float* E) {
    const float c = cosf(q), s = sinf(q), one_c = 1.0f - c;
    const float* a = M.axis[j];
    const float sk[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0], -a[1], a[0], 0.f};
    float Rt[9];
    for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k) {
            float t = (a[i] * a[k]) * one_c;
            if (i == k) t = t + c;
            Rt[3 * k + i] = t + sk[3 * i + k] * s;
        }
    utrl_mm(Rt, M.Etree[j], E);
}

UTRL_HD void utrl_quat_to_rotmat(const float* q, float* R) {
    const float x = q[0], y = q[1], z = q[2], w = q[3];
    const float x2 = x + x, y2 = y + y, z2 = z + z;
    const float xx = x * x2, yy = y * y2, zz = z * z2;
    const float xy = x * y2, xz = x * z2, yz = y * z2;
    const float wx = w * x2, wy = w * y2, wz = w * z2;
    R[0] = 1.0f - (yy + zz); R[1] = xy - wz;          R[2] = xz + wy;
    R[3] = xy + wz;          R[4] = 1.0f - (xx + zz); R[5] = yz - wx;
    R[6] = xz - wy;          R[7] = yz + wx;          R[8] = 1.0f - (xx + yy);
}

// per-body spatial velocities (body coords) from a generalized velocity
UTRL_HD void utrl_velocity_prop(const ModelTables& M, const UtrlKin& K,
                                const float* v, float vb[][6]) {
    for (int i = 0; i < 6; ++i) vb[0][i] = v[i];
    for (int i = 1; i < UTRL_NB; ++i) {
        const int j = i - 1;
        utrl_xform_motion(K.E[j], M.rtree[j], vb[M.parent[i]], vb[i]);
        for (int k = 0; k < 3; ++k) vb[i][k] = vb[i][k] + M.axis[j][k] * v[6 + j];
    }
}

UTRL_HD void utrl_fk(const ModelTables& M, const float* bp, const float* bq,
                     const float* q, UtrlKin& K) {
    for (int j = 0; j < UTRL_NJ; ++j) utrl_joint_E(M, j, q[j], K.E[j]);
    utrl_quat_to_rotmat(bq, K.R[0]);
    for (int i = 0; i < 3; ++i) K.p[0][i] = bp[i];
    for (int i = 1; i < UTRL_NB; ++i) {
        const int par = M.parent[i], j = i - 1;
        float Et[9];
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) Et[3 * a + b] = K.E[j][3 * b + a];
        utrl_mm(K.R[par], Et, K.R[i]);
        float t[3];
        utrl_mv(K.R[par], M.rtree[j], t);
        for (int k = 0; k < 3; ++k) K.p[i][k] = K.p[par][k] + t[k];
    }
}

// adjoint of velocity_prop: per-body forces (body coords, destroyed) ->
// generalized force [nv]
UTRL_HD void utrl_force_backward(const ModelTables& M, const UtrlKin& K,
                                 float f[][6], float* out) {
    for (int i = UTRL_NB - 1; i > 0; --i) {
        const int j = i - 1, par = M.parent[i];
        out[6 + j] = utrl_dot(M.axis[j], f[i]);
        float t[6];
        utrl_xform_force_inv(K.E[j], M.rtree[j], f[i], t);
        for (int k = 0; k < 6; ++k) f[par][k] = f[par][k] + t[k];
    }
    for (int k = 0; k < 6; ++k) out[k] = f[0][k];
}

// ---------------------------------------------------------------------------
// dynamics: RNEA bias, CRBA into the permuted dense H, in-place Cholesky
// ---------------------------------------------------------------------------

UTRL_HD void utrl_bias(const ModelTables& M, const UtrlKin& K, const float vb[][6],
                       const float* v, float mass_scale, float* bias) {
    float a[UTRL_NB][6], f[UTRL_NB][6];
    float gb[3];
    utrl_mtv(K.R[0], M.gravity, gb);
    for (int k = 0; k < 3; ++k) {
        a[0][k] = 0.0f;
        a[0][3 + k] = -gb[k];
    }
    for (int i = 1; i < UTRL_NB; ++i) {
        const int j = i - 1;
        utrl_xform_motion(K.E[j], M.rtree[j], a[M.parent[i]], a[i]);
        // + v_i x_m (axis qd, 0) = (w x S qd, vl x S qd)
        float Sq[3], c1[3], c2[3];
        for (int k = 0; k < 3; ++k) Sq[k] = M.axis[j][k] * v[6 + j];
        utrl_cross(vb[i], Sq, c1);
        utrl_cross(vb[i] + 3, Sq, c2);
        for (int k = 0; k < 3; ++k) {
            a[i][k] = a[i][k] + c1[k];
            a[i][3 + k] = a[i][3 + k] + c2[k];
        }
    }
    for (int i = 0; i < UTRL_NB; ++i) {
        const float scale = i == 0 ? mass_scale : 1.0f;
        float Ia[6], Iv[6], c1[3], c2[3], c3[3];
        utrl_apply_inertia(M, i, a[i], scale, Ia);
        utrl_apply_inertia(M, i, vb[i], scale, Iv);
        // v x_f (Iv) = (w x n + vl x f, w x f)
        utrl_cross(vb[i], Iv, c1);
        utrl_cross(vb[i] + 3, Iv + 3, c2);
        utrl_cross(vb[i], Iv + 3, c3);
        for (int k = 0; k < 3; ++k) {
            f[i][k] = Ia[k] + (c1[k] + c2[k]);
            f[i][3 + k] = Ia[3 + k] + c3[k];
        }
    }
    utrl_force_backward(M, K, f, bias);
}

// X^T I X for X = (E, r) on (Ic, Hc, Mc) blocks, added into dst
UTRL_HD void utrl_inertia_to_parent_add(const float* E, const float* r,
                                        const float* blk, float* dst) {
    const float* Ic = blk;
    const float* Hc = blk + 9;
    const float* Mc = blk + 18;
    const float sk[9] = {0.f, -r[2], r[1], r[2], 0.f, -r[0], -r[1], r[0], 0.f};
    float F[9];  // F = -E skew(r)
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            F[3 * i + j] = -(E[3 * i] * sk[j] + E[3 * i + 1] * sk[3 + j]
                             + E[3 * i + 2] * sk[6 + j]);
    float IcE[9], HcF[9], HcE[9], HcTE[9], McF[9], McE[9], A[9], C[9];
    utrl_mm(Ic, E, IcE);
    utrl_mm(Hc, F, HcF);
    utrl_mm(Hc, E, HcE);
    utrl_mtm(Hc, E, HcTE);
    utrl_mm(Mc, F, McF);
    utrl_mm(Mc, E, McE);
    for (int k = 0; k < 9; ++k) {
        A[k] = IcE[k] + HcF[k];
        C[k] = HcTE[k] + McF[k];
    }
    float t1[9], t2[9];
    utrl_mtm(E, A, t1);
    utrl_mtm(F, C, t2);
    for (int k = 0; k < 9; ++k) dst[k] += t1[k] + t2[k];
    utrl_mtm(E, HcE, t1);
    utrl_mtm(F, McE, t2);
    for (int k = 0; k < 9; ++k) dst[9 + k] += t1[k] + t2[k];
    utrl_mtm(E, McE, t1);
    for (int k = 0; k < 9; ++k) dst[18 + k] += t1[k];
}

// H (lower) written straight into elimination-order coordinates
UTRL_HD void utrl_hset(const ModelTables& M, float H[][UTRL_NV], int a, int b,
                       float val) {
    int i = M.chol_pos[a], j = M.chol_pos[b];
    if (i < j) {
        const int t = i; i = j; j = t;
    }
    H[i][j] = val;
}

UTRL_HD void utrl_crba(const ModelTables& M, const UtrlKin& K, float mass_scale,
                       float H[][UTRL_NV]) {
    float Icb[UTRL_NB][27];  // composite (Ic, Hc, Mc) per body
    for (int i = 0; i < UTRL_NB; ++i) {
        const float s = i == 0 ? mass_scale : 1.0f;
        for (int k = 0; k < 9; ++k) {
            Icb[i][k] = M.Ic[i][k] * s;
            Icb[i][9 + k] = M.Hc[i][k] * s;
            Icb[i][18 + k] = (k % 4 == 0) ? M.mass[i] * s : 0.0f;
        }
    }
    for (int i = UTRL_NB - 1; i > 0; --i) {
        const int j = i - 1;
        utrl_inertia_to_parent_add(K.E[j], M.rtree[j], Icb[i], Icb[M.parent[i]]);
    }
    for (int i = 0; i < UTRL_NV; ++i)
        for (int k = 0; k < UTRL_NV; ++k) H[i][k] = 0.0f;
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
            if (r >= c) {
                utrl_hset(M, H, r, c, Icb[0][3 * r + c]);
                utrl_hset(M, H, 3 + r, 3 + c, Icb[0][18 + 3 * r + c]);
            }
            utrl_hset(M, H, 3 + r, c, Icb[0][9 + 3 * c + r]);
        }
    for (int i = 1; i < UTRL_NB; ++i) {
        const int j = i - 1;
        const float* ax = M.axis[j];
        float F[6];
        utrl_mv(Icb[i], ax, F);           // Ic axis
        utrl_mtv(Icb[i] + 9, ax, F + 3);  // Hc^T axis
        utrl_hset(M, H, 6 + j, 6 + j, utrl_dot(ax, F) + M.armature);
        int k = i;
        while (M.parent[k] != -1) {
            float t[6];
            utrl_xform_force_inv(K.E[k - 1], M.rtree[k - 1], F, t);
            for (int c = 0; c < 6; ++c) F[c] = t[c];
            k = M.parent[k];
            if (k == 0) {
                for (int r = 0; r < 6; ++r) utrl_hset(M, H, 6 + j, r, F[r]);
            } else {
                utrl_hset(M, H, 6 + j, 6 + (k - 1), utrl_dot(M.axis[k - 1], F));
            }
        }
    }
}

// in-place L D^{1/2} factor of the permuted H; rinv = 1/sqrt(pivot)
UTRL_HD void utrl_chol_factor(float L[][UTRL_NV], float* rinv) {
    for (int j = 0; j < UTRL_NV; ++j) {
        for (int i = j; i < UTRL_NV; ++i) {
            float s = L[i][j];
            for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
            if (i == j) {
                rinv[j] = utrl_rsqrt(fmaxf(s, 1e-12f));
                L[j][j] = s * rinv[j];
            } else {
                L[i][j] = s * rinv[j];
            }
        }
    }
}

// H x = b, b and x in natural indexing (x may alias b)
UTRL_HD void utrl_chol_solve(const ModelTables& M, const float L[][UTRL_NV],
                             const float* rinv, const float* b, float* x) {
    float y[UTRL_NV];
    for (int i = 0; i < UTRL_NV; ++i) {
        float s = b[M.chol_order[i]];
        for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
        y[i] = s * rinv[i];
    }
    for (int i = UTRL_NV - 1; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < UTRL_NV; ++k) s = s - L[k][i] * y[k];
        y[i] = s * rinv[i];
    }
    for (int i = 0; i < UTRL_NV; ++i) x[M.chol_order[i]] = y[i];
}

// ---------------------------------------------------------------------------
// PGS contact on the z = 0 plane (HAS_GH = false) or above per-point ground
// heights gh[c] (HAS_GH = true)
// ---------------------------------------------------------------------------

struct UtrlContact {
    float r_w[UTRL_NCP][3];   // world lever arms from the body origin
    float v_bias[UTRL_NCP];
    float pn[UTRL_NCP];
    float ptx[UTRL_NCP];
    float pty[UTRL_NCP];
    unsigned char active[UTRL_NCP];
    float jacobi[UTRL_NB];    // 1 / #active points on the body
};

// HAS_CS: the de-penetration bias is scaled by the env's contact stiffness
// cs after its clamp (the JAX package's order; cs = 1 leaves every bit)
template <bool HAS_GH, bool HAS_CS>
UTRL_HD void utrl_contact(const ModelTables& M, const UtrlKin& K,
                          const float L[][UTRL_NV], const float* rinv,
                          float* vv, float fric, const float* gh, float cs,
                          UtrlContact& C) {
    const float mu = 0.5f * (M.terrain_friction + fric);
    for (int b = 0; b < UTRL_NB; ++b) {
        float n_active = 0.0f;
        for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c) {
            const float* rc = M.cp_pos[c];
            for (int i = 0; i < 3; ++i)
                C.r_w[c][i] = rc[0] * K.R[b][3 * i] + rc[1] * K.R[b][3 * i + 1]
                            + rc[2] * K.R[b][3 * i + 2];
            const float z = K.p[b][2] + C.r_w[c][2];
            const float phi = HAS_GH ? (M.cp_radius[c] + gh[c]) - z
                                     : M.cp_radius[c] - z;
            C.active[c] = phi > 0.0f;
            C.v_bias[c] = fminf(M.baumgarte * fmaxf(phi, 0.0f) / M.sim_dt,
                                M.max_depenetration_velocity);
            if (HAS_CS) C.v_bias[c] = C.v_bias[c] * cs;
            C.pn[c] = C.ptx[c] = C.pty[c] = 0.0f;
            n_active += C.active[c] ? 1.0f : 0.0f;
        }
        C.jacobi[b] = 1.0f / fmaxf(n_active, 1.0f);
    }
    for (int it = 0; it < M.iterations; ++it) {
        float vb[UTRL_NB][6], f[UTRL_NB][6], gen[UTRL_NV];
        utrl_velocity_prop(M, K, vv, vb);
        for (int b = 0; b < UTRL_NB; ++b) {
            float ww[3], lw[3], nsum[3] = {0.f, 0.f, 0.f}, fsum[3] = {0.f, 0.f, 0.f};
            utrl_mv(K.R[b], vb[b], ww);
            utrl_mv(K.R[b], vb[b] + 3, lw);
            const float kb = M.relaxation * C.jacobi[b];
            for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c) {
                const float* r = C.r_w[c];
                const float vp0 = lw[0] + ww[1] * r[2] - ww[2] * r[1];
                const float vp1 = lw[1] + ww[2] * r[0] - ww[0] * r[2];
                const float vp2 = lw[2] + ww[0] * r[1] - ww[1] * r[0];
                const bool act = C.active[c];
                const float kn = kb * M.m_eff_n[c], kt = kb * M.m_eff_t[c];
                const float pn = C.pn[c], ptx = C.ptx[c], pty = C.pty[c];
                const float pn_new = act ? fmaxf(pn + kn * (C.v_bias[c] - vp2), 0.0f)
                                         : 0.0f;
                float ptx_n = ptx + (act ? -kt * vp0 : 0.0f);
                float pty_n = pty + (act ? -kt * vp1 : 0.0f);
                const float pt_norm = sqrtf(ptx_n * ptx_n + pty_n * pty_n);
                const float cone = mu * pn_new;
                const float scale = pt_norm > cone ? cone / (pt_norm + 1e-9f) : 1.0f;
                ptx_n = ptx_n * scale;
                pty_n = pty_n * scale;
                const float dp[3] = {ptx_n - ptx, pty_n - pty, pn_new - pn};
                float nw[3];
                utrl_cross(r, dp, nw);
                for (int i = 0; i < 3; ++i) {
                    nsum[i] += nw[i];
                    fsum[i] += dp[i];
                }
                C.pn[c] = pn_new;
                C.ptx[c] = ptx_n;
                C.pty[c] = pty_n;
            }
            utrl_mtv(K.R[b], nsum, f[b]);
            utrl_mtv(K.R[b], fsum, f[b] + 3);
        }
        utrl_force_backward(M, K, f, gen);
        utrl_chol_solve(M, L, rinv, gen, gen);
        for (int k = 0; k < UTRL_NV; ++k) vv[k] = vv[k] + gen[k];
    }
}

// ---------------------------------------------------------------------------
// one substep and the whole control step of env n
// ---------------------------------------------------------------------------

template <bool HAS_GH, bool HAS_CS>
UTRL_HD void utrl_substep(const ModelTables& M, float* bp, float* bq, float* q,
                          float* v, const float* target, float fric,
                          float mass_scale, const float* gh, float cs,
                          float* tau, UtrlContact& C) {
    UtrlKin K;
    float vb[UTRL_NB][6], bias[UTRL_NV], L[UTRL_NV][UTRL_NV], rinv[UTRL_NV];
    float rhs[UTRL_NV];
    utrl_fk(M, bp, bq, q, K);
    utrl_velocity_prop(M, K, v, vb);
    for (int j = 0; j < UTRL_NJ; ++j) {
        float t = M.kp[j] * (target[j] - q[j]) - M.kd[j] * v[6 + j];
        if (M.clip_torque) t = utrl_clip(t, -M.torque_limit[j], M.torque_limit[j]);
        tau[j] = t;
    }
    utrl_bias(M, K, vb, v, mass_scale, bias);
    utrl_crba(M, K, mass_scale, L);
    utrl_chol_factor(L, rinv);
    for (int k = 0; k < 6; ++k) rhs[k] = -bias[k];
    for (int j = 0; j < UTRL_NJ; ++j) {
        const float qd = v[6 + j];
        float passive = -M.dof_damping[j] * qd;
        if (M.dof_friction[j] != 0.0f)
            passive = passive - M.dof_friction[j] * tanhf(qd / 0.1f);
        rhs[6 + j] = (tau[j] + passive) - bias[6 + j];
    }
    float vv[UTRL_NV];
    utrl_chol_solve(M, L, rinv, rhs, vv);
    for (int k = 0; k < UTRL_NV; ++k) vv[k] = v[k] + M.sim_dt * vv[k];

    utrl_contact<HAS_GH, HAS_CS>(M, K, L, rinv, vv, fric, gh, cs, C);

    for (int j = 0; j < UTRL_NJ; ++j)
        vv[6 + j] = utrl_clip(vv[6 + j], -M.dof_vel_limit[j], M.dof_vel_limit[j]);
    for (int k = 0; k < 3; ++k) {
        vv[k] = utrl_clip(vv[k], -M.max_angular_velocity, M.max_angular_velocity);
        vv[3 + k] = utrl_clip(vv[3 + k], -M.max_linear_velocity,
                              M.max_linear_velocity);
    }

    // semi-implicit integration in the substep-start frame
    float om[3], vw[3];
    utrl_mv(K.R[0], vv, om);
    utrl_mv(K.R[0], vv + 3, vw);
    for (int i = 0; i < 3; ++i) bp[i] = bp[i] + M.sim_dt * vw[i];
    {
        const float h = 0.5f * M.sim_dt;
        const float x = bq[0], y = bq[1], z = bq[2], w = bq[3];
        const float ox = om[0], oy = om[1], oz = om[2];
        const float nx = x + h * (ox * w + (oy * z - oz * y));
        const float ny = y + h * (oy * w + (oz * x - ox * z));
        const float nz = z + h * (oz * w + (ox * y - oy * x));
        const float nw = w + h * -((ox * x + oy * y) + oz * z);
        const float n2 = (nx * nx + ny * ny) + (nz * nz + nw * nw);
        const float inv = utrl_rsqrt(fmaxf(n2, 1e-18f));
        bq[0] = nx * inv;
        bq[1] = ny * inv;
        bq[2] = nz * inv;
        bq[3] = nw * inv;
    }
    for (int j = 0; j < UTRL_NJ; ++j) {
        float qj = q[j] + M.sim_dt * vv[6 + j];
        float qd = vv[6 + j];
        const float lo = M.dof_lower[j], up = M.dof_upper[j];
        if (qj < lo) qd = fmaxf(qd, 0.0f);
        if (qj > up) qd = fminf(qd, 0.0f);
        q[j] = utrl_clip(qj, lo, up);
        vv[6 + j] = qd;
    }
    for (int k = 0; k < UTRL_NV; ++k) v[k] = vv[k];
}

// Row n of every [N, k] operand in, row n of every [N, k] output out. With
// HAS_GH, column n of gh_in [NCP, n_envs] in and of pxy_out [2*NCP, n_envs]
// out (the JAX package's row layout: coalesced across a warp's envs). With
// HAS_CS, element n of cstiff [n_envs] in, read once into a register.
template <bool HAS_GH, bool HAS_CS>
UTRL_HD void utrl_control_step_env(
    const ModelTables& M, int n, int n_envs,
    const float* bp_in, const float* bq_in, const float* q_in, const float* v_in,
    const float* target_in, const float* friction, const float* mass_scale,
    const float* gh_in, const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out) {
    float bp[3], bq[4], q[UTRL_NJ], v[UTRL_NV], target[UTRL_NJ], tau[UTRL_NJ];
    for (int i = 0; i < 3; ++i) bp[i] = bp_in[3 * n + i];
    for (int i = 0; i < 4; ++i) bq[i] = bq_in[4 * n + i];
    for (int j = 0; j < UTRL_NJ; ++j) {
        q[j] = q_in[UTRL_NJ * n + j];
        target[j] = target_in[UTRL_NJ * n + j];
        tau[j] = 0.0f;
    }
    for (int k = 0; k < UTRL_NV; ++k) v[k] = v_in[UTRL_NV * n + k];
    const float fric = friction[n], ms = mass_scale[n];
    const float cs = HAS_CS ? cstiff[n] : 1.0f;
    float gh[HAS_GH ? UTRL_NCP : 1] = {0.0f};
    if (HAS_GH)
        for (int c = 0; c < UTRL_NCP; ++c) gh[c] = gh_in[c * n_envs + n];

    UtrlContact C;
    for (int s = 0; s < M.decimation; ++s)
        utrl_substep<HAS_GH, HAS_CS>(M, bp, bq, q, v, target, fric, ms, gh,
                                     cs, tau, C);

    // settled state: world kinematics, report bodies, contact forces
    UtrlKin K;
    float vb[UTRL_NB][6];
    utrl_fk(M, bp, bq, q, K);
    utrl_velocity_prop(M, K, v, vb);
    for (int r = 0; r < UTRL_NRB; ++r) {
        const int b = M.rb_dyn[r];
        const float* rp = M.rb_pos[r];
        float t[3], wr[3], vl[3];
        utrl_mv(K.R[b], rp, t);
        utrl_cross(vb[b], rp, wr);
        for (int i = 0; i < 3; ++i) vl[i] = vb[b][3 + i] + wr[i];
        utrl_mv(K.R[b], vl, wr);
        for (int i = 0; i < 3; ++i) {
            rbp_out[3 * (UTRL_NRB * n + r) + i] = K.p[b][i] + t[i];
            rbv_out[3 * (UTRL_NRB * n + r) + i] = wr[i];
            cf_out[3 * (UTRL_NRB * n + r) + i] = 0.0f;
        }
    }
    for (int c = 0; c < UTRL_NCP; ++c) {
        float* cf = cf_out + 3 * (UTRL_NRB * n + M.cp_rb[c]);
        cf[0] += C.ptx[c] / M.sim_dt;
        cf[1] += C.pty[c] / M.sim_dt;
        cf[2] += C.pn[c] / M.sim_dt;
    }
    if (HAS_GH) {
        // end-of-step world xy of every point: p_b + R_b cp_pos
        for (int b = 0; b < UTRL_NB; ++b)
            for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c) {
                const float* rc = M.cp_pos[c];
                for (int i = 0; i < 2; ++i)
                    pxy_out[(i * UTRL_NCP + c) * n_envs + n] =
                        K.p[b][i] + (rc[0] * K.R[b][3 * i]
                                     + rc[1] * K.R[b][3 * i + 1]
                                     + rc[2] * K.R[b][3 * i + 2]);
            }
    }
    for (int i = 0; i < 3; ++i) bp_out[3 * n + i] = bp[i];
    for (int i = 0; i < 4; ++i) bq_out[4 * n + i] = bq[i];
    for (int j = 0; j < UTRL_NJ; ++j) {
        q_out[UTRL_NJ * n + j] = q[j];
        tau_out[UTRL_NJ * n + j] = tau[j];
    }
    for (int k = 0; k < UTRL_NV; ++k) v_out[UTRL_NV * n + k] = v[k];
}

#ifdef __CUDACC__
// One thread per env; the instances are launched by control_step.cu (K1, K3)
// and control_step_cs.cu (K2) in blocks of kUtrlThreads.
static const int kUtrlThreads = 32;

template <bool HAS_GH, bool HAS_CS>
__global__ void __launch_bounds__(kUtrlThreads) utrl_control_step_kernel(
    const ModelTables* __restrict__ M, int n_envs,
    const float* __restrict__ bp, const float* __restrict__ bq,
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ target, const float* __restrict__ friction,
    const float* __restrict__ mass_scale, const float* __restrict__ gh,
    const float* __restrict__ cstiff,
    float* __restrict__ bp_out, float* __restrict__ bq_out,
    float* __restrict__ q_out, float* __restrict__ v_out,
    float* __restrict__ tau_out, float* __restrict__ cf_out,
    float* __restrict__ rbp_out, float* __restrict__ rbv_out,
    float* __restrict__ pxy_out) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_envs) return;
    utrl_control_step_env<HAS_GH, HAS_CS>(
        *M, n, n_envs, bp, bq, q, v, target, friction, mass_scale, gh, cstiff,
        bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out, rbv_out,
        pxy_out);
}
#endif  // __CUDACC__

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
// stiffness cs (read once per control step) multiplies every point's
// de-penetration bias after its clamp. With cs = 1 the product is exact,
// so K2 gives K1's (or K3's) bits.
//
// The arithmetic restates unitree_rl_gym_tpu_torch/physics/soa.py (itself
// the port of the JAX package's physics/soa.py) for ONE env in plain C++:
// the same recursions, the same elimination order (joints first, base
// last), the same operation order inside each dot product and each sum.
// The model's structure is read at run time from a ModelTables struct
// built once by physics/cuda_step.py (tables, not generated code), and its
// sizes come from the build as -DUTRL_NB, -DUTRL_NCP and -DUTRL_NRB.
//
// Schedule: one warp of 32 lanes computes one env. Its working set (the
// state, the kinematics, H and its factor, the body velocities and forces,
// the contact points) lives in a per-warp UtrlScratch, which is the warp's
// slice of shared memory on the card. The work is a sequence of phases
// (utrl_phase): in each, every lane runs the same body on its own share of
// the items (points, joints, bodies, report bodies, rows of H, one per
// lane, strided where there are more than 32), reads only what earlier
// phases wrote, writes only its own items, and the warp synchronises
// before the next phase. Recursions over the tree run level by level from
// the tables' depth masks (a parent's children add into it in descending
// body order, as in the one-env loop); the joints' part of the Cholesky
// factor and of both triangular solves runs by elimination-tree levels (an
// entry is computed once every entry it needs is final), and the base's
// dense 6 x 6 block on one lane. Every sum keeps its terms' order (points
// in point order, Cholesky terms in ascending k, skipping only structural
// zeros). So each output is the same sequence of roundings as in the
// one-thread-per-env form this replaced; only the order in which
// independent values are computed moved.
//
// Everything here is __host__ __device__: the CUDA kernel (control_step.cu)
// runs a phase once per lane of a warp, and a host harness
// (host_harness.cpp, compiled by g++ in the tests) runs it as a loop over
// the 32 lanes on the CPU, so the kernel's schedule is held against the
// plain PyTorch version on machines without a GPU.
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
#define UTRL_NTRI (UTRL_NV * (UTRL_NV + 1) / 2)

static const int kUtrlLanes = 32;
// The launch: kUtrlWarps envs (one warp each) per block, and the resident
// blocks per SM that the kernel's __launch_bounds__ asks for.
static const int kUtrlWarps = 4;
static const int kUtrlBlocksPerSM = 8;

// Every field is 4 bytes wide, so the struct has no padding and
// physics/cuda_step.py packs it field by field in this order; the build
// exports sizeof(ModelTables) and the wrapper checks it.
struct ModelTables {
    int parent[UTRL_NB];          // dyn-body parent, parent[0] = -1
    int cp_start[UTRL_NB];        // points sorted by dyn body: [start, end)
    int cp_end[UTRL_NB];
    int cp_rb[UTRL_NCP];          // report body of each (sorted) point (read by
                                  // earlier builds: fields are only appended)
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
    // the warp schedule's tables (physics/cuda_step.py::tree_levels,
    // chol_levels), sets of bodies or positions as bit masks (bit i = i)
    unsigned depth_mask[UTRL_NB]; // bodies at each depth (base 0)
    int n_depth;                  // 1 + the largest depth
    unsigned child_mask[UTRL_NB]; // children of each body
    int cp_dyn[UTRL_NCP];         // dyn body of each (sorted) point
    unsigned chol_row[UTRL_NV];   // structural nonzeros k < i of L's row i
    unsigned chol_col[UTRL_NV];   // ... and k > i of its column i
    unsigned chol_lvl_f[UTRL_NV]; // positions at each elimination-tree level
    unsigned chol_lvl_b[UTRL_NV]; // from the leaves (f) and from the root (b)
    int n_lvl_f;
    int n_lvl_b;
    int depth_body[UTRL_NB];      // bodies by depth, ascending within one
    int depth_first[UTRL_NB];     // each depth's first entry of depth_body
    int rb_pt[UTRL_NCP];          // points by report body, ascending within one
    int rb_pt_start[UTRL_NRB];    // each report body's entries of rb_pt
    int rb_pt_end[UTRL_NRB];
};

static_assert(UTRL_NB <= 32 && UTRL_NV <= 32,
              "the level tables hold sets of bodies and of dofs in 32 bits");

// lowest and highest set bit of m != 0
UTRL_HD int utrl_lowest(unsigned m) {
#ifdef __CUDA_ARCH__
    return __ffs(m) - 1;
#else
    return __builtin_ctz(m);
#endif
}

UTRL_HD int utrl_highest(unsigned m) {
#ifdef __CUDA_ARCH__
    return 31 - __clz(m);
#else
    return 31 - __builtin_clz(m);
#endif
}

UTRL_HD int utrl_popc(unsigned m) {
#ifdef __CUDA_ARCH__
    return __popc(m);
#else
    return __builtin_popcount(m);
#endif
}

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

// Column `col` of X^T I X for X = (E, r) on an (Ic, Hc, Mc) block:
// o[3 r + col], o[9 + 3 r + col], o[18 + 3 r + col] for r = 0..2. Each
// entry is the sum the whole-block product forms for it:
// Ip = E^T (Ic E + Hc F) + F^T (Hc^T E + Mc F), Hp = E^T Hc E + F^T Mc E,
// Mp = E^T Mc E, with F = -E skew(r).
UTRL_HD void utrl_inertia_to_parent_col(const float* E, const float* r,
                                        const float* blk, int col, float* o) {
    const float* Ic = blk;
    const float* Hc = blk + 9;
    const float* Mc = blk + 18;
    const float sk[9] = {0.f, -r[2], r[1], r[2], 0.f, -r[0], -r[1], r[0], 0.f};
    float F[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            F[3 * i + j] = -(E[3 * i] * sk[j] + E[3 * i + 1] * sk[3 + j]
                             + E[3 * i + 2] * sk[6 + j]);
    // column col of F, selected in registers (F is indexed by constants only)
    float Fc[3];
    for (int m = 0; m < 3; ++m)
        Fc[m] = col == 0 ? F[3 * m] : col == 1 ? F[3 * m + 1] : F[3 * m + 2];
    // column col of A = Ic E + Hc F, C = Hc^T E + Mc F, Hc E and Mc E
    float A[3], C[3], HcE[3], McE[3];
    for (int m = 0; m < 3; ++m) {
        const float IcE = Ic[3 * m] * E[col] + Ic[3 * m + 1] * E[3 + col]
                        + Ic[3 * m + 2] * E[6 + col];
        const float HcF = Hc[3 * m] * Fc[0] + Hc[3 * m + 1] * Fc[1]
                        + Hc[3 * m + 2] * Fc[2];
        const float HcTE = Hc[m] * E[col] + Hc[3 + m] * E[3 + col]
                         + Hc[6 + m] * E[6 + col];
        const float McF = Mc[3 * m] * Fc[0] + Mc[3 * m + 1] * Fc[1]
                        + Mc[3 * m + 2] * Fc[2];
        A[m] = IcE + HcF;
        C[m] = HcTE + McF;
        HcE[m] = Hc[3 * m] * E[col] + Hc[3 * m + 1] * E[3 + col]
               + Hc[3 * m + 2] * E[6 + col];
        McE[m] = Mc[3 * m] * E[col] + Mc[3 * m + 1] * E[3 + col]
               + Mc[3 * m + 2] * E[6 + col];
    }
    for (int i = 0; i < 3; ++i) {
        const float t1 = E[i] * A[0] + E[3 + i] * A[1] + E[6 + i] * A[2];
        const float t2 = F[i] * C[0] + F[3 + i] * C[1] + F[6 + i] * C[2];
        o[3 * i + col] = t1 + t2;
        const float h1 = E[i] * HcE[0] + E[3 + i] * HcE[1] + E[6 + i] * HcE[2];
        const float h2 = F[i] * McE[0] + F[3 + i] * McE[1] + F[6 + i] * McE[2];
        o[9 + 3 * i + col] = h1 + h2;
        o[18 + 3 * i + col] = E[i] * McE[0] + E[3 + i] * McE[1] + E[6 + i] * McE[2];
    }
}

// packed lower triangle of an NV x NV matrix: entry (i, j), i >= j
UTRL_HD int utrl_tri(int i, int j) { return i * (i + 1) / 2 + j; }

// H (lower) written straight into elimination-order coordinates
UTRL_HD void utrl_hset(const ModelTables& M, float* H, int a, int b, float val) {
    int i = M.chol_pos[a], j = M.chol_pos[b];
    if (i < j) {
        const int t = i; i = j; j = t;
    }
    H[utrl_tri(i, j)] = val;
}

// ---------------------------------------------------------------------------
// the per-warp scratch and the phase loop
// ---------------------------------------------------------------------------

struct UtrlKin {
    float R[UTRL_NB][9];    // body -> world
    float p[UTRL_NB][3];    // body origins in world
    float E[UTRL_NJ][9];    // parent -> child coordinate rotation
};

// One env's working set. The union's members are live in turn within a
// substep: the RNEA accelerations, then CRBA's composite inertias, then
// the contact points (whose impulses of the last substep are read once
// more by the report-body pass).
template <bool HAS_GH>
struct UtrlScratch {
    float bp[3], bq[4], q[UTRL_NJ], v[UTRL_NV], target[UTRL_NJ], tau[UTRL_NJ];
    float gh[HAS_GH ? UTRL_NCP : 1];
    float fric, mass_scale, cs;
    UtrlKin K;
    float vb[UTRL_NB][6];    // body velocities (body coords)
    float f[UTRL_NB][6];     // body forces, turned into their parent's terms
    float L[UTRL_NTRI];      // H, then its L D^{1/2} factor, packed lower
    float rinv[UTRL_NV];     // 1 / sqrt(pivot)
    float rhs[UTRL_NV];      // RNEA bias, then the substep's right-hand side
    float vv[UTRL_NV];       // the substep's velocity
    float gen[UTRL_NV];      // generalized contact force
    float y[UTRL_NV];        // a solve's vector in elimination order
    unsigned rem[UTRL_NV];   // the forward solve's terms still to subtract
    union {
        struct {
            float a[UTRL_NB][6];        // RNEA accelerations
        } rnea;
        struct {
            float Icb[UTRL_NB][27];     // composite (Ic, Hc, Mc) per body
            float T[UTRL_NB][27];       // each body's block in its parent's frame
        } crba;
        struct {
            float r_w[UTRL_NCP][3];     // world lever arms from the body origin
            float v_bias[UTRL_NCP];
            float pn[UTRL_NCP];
            float ptx[UTRL_NCP];
            float pty[UTRL_NCP];
            float dp[UTRL_NCP][3];      // this sweep's impulse increments
            float wl[UTRL_NB][6];       // world angular / linear body velocity
            float jacobi[UTRL_NB];      // 1 / #active points on the body
            unsigned char active[UTRL_NCP];
        } c;
    } u;
};

// Run body(lane) for every lane of the warp, then synchronise the warp: on
// the card each lane runs it once; on the host the lanes run one after
// another (in reverse with -DUTRL_HOST_LANES_REVERSED, which the tests use
// to show that no phase reads what another lane of it writes).
//
// The lane id is read anew in every phase (a volatile read the compiler
// cannot hoist), so what each lane derives from it is recomputed where it
// is used instead of held in registers across the whole kernel.
template <class F>
UTRL_HD void utrl_phase(F&& body) {
#ifdef __CUDA_ARCH__
    int lane;
    asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
    body(lane);
    __syncwarp();
#elif defined(UTRL_HOST_LANES_REVERSED)
    for (int lane = kUtrlLanes - 1; lane >= 0; --lane) body(lane);
#else
    for (int lane = 0; lane < kUtrlLanes; ++lane) body(lane);
#endif
}

// ---------------------------------------------------------------------------
// kinematics and the tree recursions, level by level
// ---------------------------------------------------------------------------

template <class S>
UTRL_HD void utrl_fk(const ModelTables& M, S& s) {
    utrl_phase([&](int lane) {
        for (int j = lane; j < UTRL_NJ; j += kUtrlLanes)
            utrl_joint_E(M, j, s.q[j], s.K.E[j]);
        if (lane == kUtrlLanes - 1) {
            utrl_quat_to_rotmat(s.bq, s.K.R[0]);
            for (int i = 0; i < 3; ++i) s.K.p[0][i] = s.bp[i];
        }
    });
    for (int d = 1; d < M.n_depth; ++d) {
        const unsigned level = M.depth_mask[d];
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NB; i += kUtrlLanes) {
                if (!(level >> i & 1u)) continue;
                const int par = M.parent[i], j = i - 1;
                float Et[9];
                for (int a = 0; a < 3; ++a)
                    for (int b = 0; b < 3; ++b) Et[3 * a + b] = s.K.E[j][3 * b + a];
                utrl_mm(s.K.R[par], Et, s.K.R[i]);
                float t[3];
                utrl_mv(s.K.R[par], M.rtree[j], t);
                for (int k = 0; k < 3; ++k) s.K.p[i][k] = s.K.p[par][k] + t[k];
            }
        });
    }
}

// per-body spatial velocities (body coords) from a generalized velocity v;
// WORLD also writes each body's world angular and linear velocity (PGS).
// Level by level, a lane a body; the base (vb[0] = v[0:6]) shares its
// children's phase: they read v.
template <bool WORLD, class S>
UTRL_HD void utrl_velocity_prop(const ModelTables& M, S& s, const float* v) {
    for (int d = 1; d == 1 || d < M.n_depth; ++d) {
        const unsigned level = M.depth_mask[d] | (d == 1 ? 1u : 0u);
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NB; i += kUtrlLanes) {
                if (!(level >> i & 1u)) continue;
                float* vb = s.vb[i];
                if (i == 0) {
                    for (int k = 0; k < 6; ++k) vb[k] = v[k];
                } else {
                    const int j = i - 1, par = M.parent[i];
                    utrl_xform_motion(s.K.E[j], M.rtree[j], par == 0 ? v : s.vb[par], vb);
                    for (int k = 0; k < 3; ++k) vb[k] = vb[k] + M.axis[j][k] * v[6 + j];
                }
                if (WORLD) {
                    utrl_mv(s.K.R[i], vb, s.u.c.wl[i]);
                    utrl_mv(s.K.R[i], vb + 3, s.u.c.wl[i] + 3);
                }
            }
        });
    }
}

// adjoint of velocity_prop: per-body forces s.f (body coords, destroyed)
// -> generalized force out [nv]. Deepest level first, a lane a body: each
// body adds its children's terms in descending body order, then hands its
// own on (X^* f, in place). `force(i)`, where given, first writes body i's
// force, on the lane of body i, in the deepest level's phase.
struct UtrlNoForce {
    UTRL_HD void operator()(int) const {}
};

template <class S, class Force = UtrlNoForce>
UTRL_HD void utrl_force_backward(const ModelTables& M, S& s, float* out,
                                 Force force = Force()) {
    for (int d = M.n_depth - 1; d >= 0; --d) {
        const unsigned level = M.depth_mask[d];
        const bool first = d == M.n_depth - 1;
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NB; i += kUtrlLanes) {
                if (first) force(i);
                if (!(level >> i & 1u)) continue;
                float* fi = s.f[i];
                for (unsigned cm = M.child_mask[i]; cm; cm &= ~(1u << utrl_highest(cm))) {
                    const float* fc = s.f[utrl_highest(cm)];
                    for (int k = 0; k < 6; ++k) fi[k] = fi[k] + fc[k];
                }
                if (i == 0) {
                    for (int k = 0; k < 6; ++k) out[k] = fi[k];
                } else {
                    const int j = i - 1;
                    out[6 + j] = utrl_dot(M.axis[j], fi);
                    float t[6];
                    utrl_xform_force_inv(s.K.E[j], M.rtree[j], fi, t);
                    for (int k = 0; k < 6; ++k) fi[k] = t[k];
                }
            }
        });
    }
}

// ---------------------------------------------------------------------------
// dynamics: RNEA bias, CRBA into the permuted packed H, Cholesky by levels
// ---------------------------------------------------------------------------

// bias [nv] into s.rhs; needs s.vb of s.v
template <class S>
UTRL_HD void utrl_bias(const ModelTables& M, S& s) {
    float(*a)[6] = s.u.rnea.a;
    for (int d = 0; d < M.n_depth; ++d) {
        const unsigned level = M.depth_mask[d];
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NB; i += kUtrlLanes) {
                if (!(level >> i & 1u)) continue;
                if (i == 0) {
                    float gb[3];
                    utrl_mtv(s.K.R[0], M.gravity, gb);
                    for (int k = 0; k < 3; ++k) {
                        a[0][k] = 0.0f;
                        a[0][3 + k] = -gb[k];
                    }
                    continue;
                }
                const int j = i - 1;
                utrl_xform_motion(s.K.E[j], M.rtree[j], a[M.parent[i]], a[i]);
                // + v_i x_m (axis qd, 0) = (w x S qd, vl x S qd)
                float Sq[3], c1[3], c2[3];
                for (int k = 0; k < 3; ++k) Sq[k] = M.axis[j][k] * s.v[6 + j];
                utrl_cross(s.vb[i], Sq, c1);
                utrl_cross(s.vb[i] + 3, Sq, c2);
                for (int k = 0; k < 3; ++k) {
                    a[i][k] = a[i][k] + c1[k];
                    a[i][3 + k] = a[i][3 + k] + c2[k];
                }
            }
        });
    }
    utrl_phase([&](int lane) {
        for (int i = lane; i < UTRL_NB; i += kUtrlLanes) {
            const float scale = i == 0 ? s.mass_scale : 1.0f;
            float Ia[6], Iv[6], c1[3], c2[3], c3[3];
            utrl_apply_inertia(M, i, a[i], scale, Ia);
            utrl_apply_inertia(M, i, s.vb[i], scale, Iv);
            // v x_f (Iv) = (w x n + vl x f, w x f)
            utrl_cross(s.vb[i], Iv, c1);
            utrl_cross(s.vb[i] + 3, Iv + 3, c2);
            utrl_cross(s.vb[i], Iv + 3, c3);
            for (int k = 0; k < 3; ++k) {
                s.f[i][k] = Ia[k] + (c1[k] + c2[k]);
                s.f[i][3 + k] = Ia[3 + k] + c3[k];
            }
        }
    });
    utrl_force_backward(M, s, s.rhs);
}

// H into s.L (elimination order, packed lower)
template <class S>
UTRL_HD void utrl_crba(const ModelTables& M, S& s) {
    float(*Icb)[27] = s.u.crba.Icb;
    float(*T)[27] = s.u.crba.T;
    utrl_phase([&](int lane) {
        for (int i = lane; i < UTRL_NB; i += kUtrlLanes) {
            const float sc = i == 0 ? s.mass_scale : 1.0f;
            for (int k = 0; k < 9; ++k) {
                Icb[i][k] = M.Ic[i][k] * sc;
                Icb[i][9 + k] = M.Hc[i][k] * sc;
                Icb[i][18 + k] = (k % 4 == 0) ? M.mass[i] * sc : 0.0f;
            }
        }
        for (int e = lane; e < UTRL_NTRI; e += kUtrlLanes) s.L[e] = 0.0f;
    });
    // composites, deepest level first: each body's block into its parent's
    // frame (three lanes a body, a column each), then each parent adds its
    // children's in descending body order (a lane an entry)
    for (int d = M.n_depth - 1; d > 0; --d) {
        const unsigned parents = M.depth_mask[d - 1];
        const int first = M.depth_first[d], count = utrl_popc(M.depth_mask[d]);
        utrl_phase([&](int lane) {
            for (int e = lane; e < 3 * count; e += kUtrlLanes) {
                const int i = M.depth_body[first + e / 3];
                utrl_inertia_to_parent_col(s.K.E[i - 1], M.rtree[i - 1], Icb[i],
                                           e % 3, T[i]);
            }
        });
        utrl_phase([&](int lane) {
            for (int k = lane; k < 27; k += kUtrlLanes)
                for (unsigned pm = parents; pm; pm &= pm - 1) {
                    const int p = utrl_lowest(pm);
                    float acc = Icb[p][k];
                    for (unsigned cm = M.child_mask[p]; cm; cm &= ~(1u << utrl_highest(cm)))
                        acc = acc + T[utrl_highest(cm)][k];
                    Icb[p][k] = acc;
                }
        });
    }
    // the base block, and one column per joint walking up its chain
    utrl_phase([&](int lane) {
        for (int e = lane; e < UTRL_NJ + 9; e += kUtrlLanes) {
            if (e >= UTRL_NJ) {
                const int r = (e - UTRL_NJ) / 3, c = (e - UTRL_NJ) % 3;
                if (r >= c) {
                    utrl_hset(M, s.L, r, c, Icb[0][3 * r + c]);
                    utrl_hset(M, s.L, 3 + r, 3 + c, Icb[0][18 + 3 * r + c]);
                }
                utrl_hset(M, s.L, 3 + r, c, Icb[0][9 + 3 * c + r]);
                continue;
            }
            const int j = e, i = j + 1;
            const float* ax = M.axis[j];
            float F[6];
            utrl_mv(Icb[i], ax, F);           // Ic axis
            utrl_mtv(Icb[i] + 9, ax, F + 3);  // Hc^T axis
            utrl_hset(M, s.L, 6 + j, 6 + j, utrl_dot(ax, F) + M.armature);
            int k = i;
            while (M.parent[k] != -1) {
                float t[6];
                utrl_xform_force_inv(s.K.E[k - 1], M.rtree[k - 1], F, t);
                for (int c = 0; c < 6; ++c) F[c] = t[c];
                k = M.parent[k];
                if (k == 0) {
                    for (int r = 0; r < 6; ++r) utrl_hset(M, s.L, 6 + j, r, F[r]);
                } else {
                    utrl_hset(M, s.L, 6 + j, 6 + (k - 1), utrl_dot(M.axis[k - 1], F));
                }
            }
        }
    });
}

// The elimination order puts the joints first and the base's six dofs last
// (SoAModel.chol_order), and the base rows of H, and so of L, are dense:
// the joints run by levels of the elimination tree, one phase a level, and
// the base block's 6 x 6 triangle is one lane's, in registers.
#define UTRL_B0 (UTRL_NV - 6)                    // first base position
#define UTRL_JOINTS ((1u << UTRL_NJ) - 1u)       // the joint positions
static_assert(UTRL_NJ >= 1, "a model with joints");

// packed lower triangle of the base block: entry (i, j), 0 <= j <= i < 6
UTRL_HD int utrl_btri(int i, int j) { return i * (i + 1) / 2 + j; }

// In-place L D^{1/2} factor of the permuted H; rinv = 1/sqrt(pivot). Entry
// (i, j) subtracts L[i][k] L[j][k] for every k < j where both are
// structural nonzeros, in ascending k (the plain version's terms; a
// structural zero adds nothing), then scales by rinv[j]. The joints' columns
// level by level of the elimination tree from its leaves (the pivots of the
// level, then every row's entries in them); then every base-block entry's
// joint terms, one lane an entry; then the base block's own terms, column
// by column, on one lane.
template <class S>
UTRL_HD void utrl_chol_factor(const ModelTables& M, S& s) {
    float* L = s.L;
    for (int l = 0; l < M.n_lvl_f && (M.chol_lvl_f[l] & UTRL_JOINTS); ++l) {
        const unsigned level = M.chol_lvl_f[l];
        utrl_phase([&](int lane) {
            for (int j = lane; j < UTRL_NV; j += kUtrlLanes) {
                if (!(level >> j & 1u)) continue;
                const int rj = utrl_tri(j, 0);
                float t = L[rj + j];
                for (unsigned m = M.chol_row[j]; m; m &= m - 1) {
                    const float ljk = L[rj + utrl_lowest(m)];
                    t = t - ljk * ljk;
                }
                s.rinv[j] = utrl_rsqrt(fmaxf(t, 1e-12f));
                L[rj + j] = t * s.rinv[j];
            }
        });
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NV; i += kUtrlLanes) {
                const int ri = utrl_tri(i, 0);
                for (unsigned mj = M.chol_row[i] & level; mj; mj &= mj - 1) {
                    const int j = utrl_lowest(mj), rj = utrl_tri(j, 0);
                    float t = L[ri + j];
                    for (unsigned m = M.chol_row[i] & M.chol_row[j]; m; m &= m - 1) {
                        const int k = utrl_lowest(m);
                        t = t - L[ri + k] * L[rj + k];
                    }
                    L[ri + j] = t * s.rinv[j];
                }
            }
        });
    }
    utrl_phase([&](int lane) {
        for (int e = lane; e < 21; e += kUtrlLanes) {
            int bi = 0;
            while (utrl_btri(bi + 1, 0) <= e) ++bi;
            const int i = UTRL_B0 + bi, j = UTRL_B0 + e - utrl_btri(bi, 0);
            const int ri = utrl_tri(i, 0), rj = utrl_tri(j, 0);
            float t = L[ri + j];
            for (unsigned m = M.chol_row[i] & M.chol_row[j] & UTRL_JOINTS; m; m &= m - 1) {
                const int k = utrl_lowest(m);
                t = t - L[ri + k] * L[rj + k];
            }
            L[ri + j] = t;
        }
    });
    utrl_phase([&](int lane) {
        if (lane != 0) return;
        float B[21];
        for (int i = 0; i < 6; ++i)
            for (int j = 0; j <= i; ++j) B[utrl_btri(i, j)] = L[utrl_tri(UTRL_B0 + i, UTRL_B0 + j)];
        for (int j = 0; j < 6; ++j) {
            float t = B[utrl_btri(j, j)];
            for (int k = 0; k < j; ++k) t = t - B[utrl_btri(j, k)] * B[utrl_btri(j, k)];
            const float r = utrl_rsqrt(fmaxf(t, 1e-12f));
            s.rinv[UTRL_B0 + j] = r;
            B[utrl_btri(j, j)] = t * r;
            for (int i = j + 1; i < 6; ++i) {
                float u = B[utrl_btri(i, j)];
                for (int k = 0; k < j; ++k) u = u - B[utrl_btri(i, k)] * B[utrl_btri(j, k)];
                B[utrl_btri(i, j)] = u * r;
            }
        }
        for (int i = 0; i < 6; ++i)
            for (int j = 0; j <= i; ++j) L[utrl_tri(UTRL_B0 + i, UTRL_B0 + j)] = B[utrl_btri(i, j)];
    });
}

// H x = b (natural indexing); out(k, x_k) stores x_k. Each entry subtracts
// its terms in ascending k. Forward: the joints by levels from the leaves,
// where a row subtracts each term as soon as its y_k is final (so the base
// rows start on their joint terms at the joints' levels), then the base
// rows' remaining joint terms, a lane a row, then the base block on one
// lane. Back: the base block on one lane, then the joints by levels from
// the root.
template <class S, class Out>
UTRL_HD void utrl_chol_solve(const ModelTables& M, S& s, const float* b, Out out) {
    const float* L = s.L;
    float* y = s.y;
    unsigned final = 0;  // positions whose y is final
    for (int l = 0; l < M.n_lvl_f && (M.chol_lvl_f[l] & UTRL_JOINTS); ++l) {
        const unsigned level = M.chol_lvl_f[l];
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NV; i += kUtrlLanes) {
                if (final >> i & 1u) continue;
                float t = l == 0 ? b[M.chol_order[i]] : y[i];
                unsigned rem = l == 0 ? M.chol_row[i] : s.rem[i];
                const unsigned wait = rem & ~final;
                unsigned ready = wait ? rem & ((wait & (~wait + 1u)) - 1u) : rem;
                rem &= ~ready;
                const int ri = utrl_tri(i, 0);
                for (; ready; ready &= ready - 1) {
                    const int k = utrl_lowest(ready);
                    t = t - L[ri + k] * y[k];
                }
                y[i] = level >> i & 1u ? t * s.rinv[i] : t;
                s.rem[i] = rem;
            }
        });
        final |= level;
    }
    utrl_phase([&](int lane) {
        if (lane >= 6) return;
        const int i = UTRL_B0 + lane, ri = utrl_tri(i, 0);
        float t = y[i];
        for (unsigned m = s.rem[i] & UTRL_JOINTS; m; m &= m - 1) {
            const int k = utrl_lowest(m);
            t = t - L[ri + k] * y[k];
        }
        y[i] = t;
    });
    utrl_phase([&](int lane) {
        if (lane != 0) return;
        float yb[6];
        for (int r = 0; r < 6; ++r) {
            const int ri = utrl_tri(UTRL_B0 + r, UTRL_B0);
            float t = y[UTRL_B0 + r];
            for (int q = 0; q < r; ++q) t = t - L[ri + q] * yb[q];
            yb[r] = t * s.rinv[UTRL_B0 + r];
        }
        for (int r = 5; r >= 0; --r) {
            float t = yb[r];
            for (int q = r + 1; q < 6; ++q)
                t = t - L[utrl_tri(UTRL_B0 + q, UTRL_B0 + r)] * yb[q];
            yb[r] = t * s.rinv[UTRL_B0 + r];
        }
        for (int r = 0; r < 6; ++r) {
            y[UTRL_B0 + r] = yb[r];
            out(M.chol_order[UTRL_B0 + r], yb[r]);
        }
    });
    for (int l = 0; l < M.n_lvl_b; ++l) {
        const unsigned level = M.chol_lvl_b[l] & UTRL_JOINTS;
        if (!level) continue;
        utrl_phase([&](int lane) {
            for (int i = lane; i < UTRL_NV; i += kUtrlLanes) {
                if (!(level >> i & 1u)) continue;
                float t = y[i];
                for (unsigned m = M.chol_col[i]; m; m &= m - 1) {
                    const int k = utrl_lowest(m);
                    t = t - L[utrl_tri(k, i)] * y[k];
                }
                y[i] = t * s.rinv[i];
                out(M.chol_order[i], y[i]);
            }
        });
    }
}

// ---------------------------------------------------------------------------
// PGS contact on the z = 0 plane (HAS_GH = false) or above per-point ground
// heights gh[c] (HAS_GH = true); HAS_CS scales the de-penetration bias by
// the env's contact stiffness cs after its clamp (the JAX package's order;
// cs = 1 leaves every bit)
// ---------------------------------------------------------------------------

template <bool HAS_GH, bool HAS_CS, class S>
UTRL_HD void utrl_contact(const ModelTables& M, S& s) {
    auto& C = s.u.c;
    utrl_phase([&](int lane) {
        for (int c = lane; c < UTRL_NCP; c += kUtrlLanes) {
            const int b = M.cp_dyn[c];
            const float* rc = M.cp_pos[c];
            const float* R = s.K.R[b];
            for (int i = 0; i < 3; ++i)
                C.r_w[c][i] = rc[0] * R[3 * i] + rc[1] * R[3 * i + 1]
                            + rc[2] * R[3 * i + 2];
            const float z = s.K.p[b][2] + C.r_w[c][2];
            const float phi = HAS_GH ? (M.cp_radius[c] + s.gh[c]) - z
                                     : M.cp_radius[c] - z;
            C.active[c] = phi > 0.0f;
            C.v_bias[c] = fminf(M.baumgarte * fmaxf(phi, 0.0f) / M.sim_dt,
                                M.max_depenetration_velocity);
            if (HAS_CS) C.v_bias[c] = C.v_bias[c] * s.cs;
            C.pn[c] = C.ptx[c] = C.pty[c] = 0.0f;
        }
    });
    utrl_phase([&](int lane) {
        for (int b = lane; b < UTRL_NB; b += kUtrlLanes) {
            float n_active = 0.0f;
            for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c)
                n_active += C.active[c] ? 1.0f : 0.0f;
            C.jacobi[b] = 1.0f / fmaxf(n_active, 1.0f);
        }
    });
    const float mu = 0.5f * (M.terrain_friction + s.fric);
    for (int it = 0; it < M.iterations; ++it) {
        utrl_velocity_prop<true>(M, s, s.vv);
        // every point's impulses against the same body velocities (Jacobi)
        utrl_phase([&](int lane) {
            for (int c = lane; c < UTRL_NCP; c += kUtrlLanes) {
                const int b = M.cp_dyn[c];
                const float* ww = C.wl[b];
                const float* lw = C.wl[b] + 3;
                const float kb = M.relaxation * C.jacobi[b];
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
                C.dp[c][0] = ptx_n - ptx;
                C.dp[c][1] = pty_n - pty;
                C.dp[c][2] = pn_new - pn;
                C.pn[c] = pn_new;
                C.ptx[c] = ptx_n;
                C.pty[c] = pty_n;
            }
        });
        // each body's force from its points' increments, summed in point
        // order into body coordinates, in the force pass's first phase
        utrl_force_backward(M, s, s.gen, [&](int b) {
            float nsum[3] = {0.f, 0.f, 0.f}, fsum[3] = {0.f, 0.f, 0.f};
            for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c) {
                float nw[3];
                utrl_cross(C.r_w[c], C.dp[c], nw);
                for (int i = 0; i < 3; ++i) {
                    nsum[i] += nw[i];
                    fsum[i] += C.dp[c][i];
                }
            }
            utrl_mtv(s.K.R[b], nsum, s.f[b]);
            utrl_mtv(s.K.R[b], fsum, s.f[b] + 3);
        });
        utrl_chol_solve(M, s, s.gen, [&](int k, float x) { s.vv[k] = s.vv[k] + x; });
    }
}

// ---------------------------------------------------------------------------
// one substep and the whole control step of one env
// ---------------------------------------------------------------------------

template <bool HAS_GH, bool HAS_CS, class S>
UTRL_HD void utrl_substep(const ModelTables& M, S& s) {
    utrl_fk(M, s);
    utrl_velocity_prop<false>(M, s, s.v);
    utrl_bias(M, s);
    utrl_crba(M, s);
    utrl_chol_factor(M, s);
    // PD torque + clip, passive terms, right-hand side (in place of bias)
    utrl_phase([&](int lane) {
        for (int j = lane; j < UTRL_NJ; j += kUtrlLanes) {
            float t = M.kp[j] * (s.target[j] - s.q[j]) - M.kd[j] * s.v[6 + j];
            if (M.clip_torque) t = utrl_clip(t, -M.torque_limit[j], M.torque_limit[j]);
            s.tau[j] = t;
            const float qd = s.v[6 + j];
            float passive = -M.dof_damping[j] * qd;
            if (M.dof_friction[j] != 0.0f)
                passive = passive - M.dof_friction[j] * tanhf(qd / 0.1f);
            s.rhs[6 + j] = (t + passive) - s.rhs[6 + j];
        }
        if (lane == kUtrlLanes - 1)
            for (int k = 0; k < 6; ++k) s.rhs[k] = -s.rhs[k];
    });
    utrl_chol_solve(M, s, s.rhs,
                    [&](int k, float x) { s.vv[k] = s.v[k] + M.sim_dt * x; });

    utrl_contact<HAS_GH, HAS_CS>(M, s);

    // velocity caps, then semi-implicit integration in the substep-start
    // frame and the joint-limit projection
    utrl_phase([&](int lane) {
        for (int j = lane; j < UTRL_NJ; j += kUtrlLanes) {
            const float vj = utrl_clip(s.vv[6 + j], -M.dof_vel_limit[j],
                                       M.dof_vel_limit[j]);
            float qj = s.q[j] + M.sim_dt * vj;
            float qd = vj;
            const float lo = M.dof_lower[j], up = M.dof_upper[j];
            if (qj < lo) qd = fmaxf(qd, 0.0f);
            if (qj > up) qd = fminf(qd, 0.0f);
            s.q[j] = utrl_clip(qj, lo, up);
            s.v[6 + j] = qd;
        }
        if (lane != kUtrlLanes - 1) return;
        float vv[6];
        for (int k = 0; k < 3; ++k) {
            vv[k] = utrl_clip(s.vv[k], -M.max_angular_velocity, M.max_angular_velocity);
            vv[3 + k] = utrl_clip(s.vv[3 + k], -M.max_linear_velocity,
                                  M.max_linear_velocity);
        }
        float om[3], vw[3];
        utrl_mv(s.K.R[0], vv, om);
        utrl_mv(s.K.R[0], vv + 3, vw);
        for (int i = 0; i < 3; ++i) s.bp[i] = s.bp[i] + M.sim_dt * vw[i];
        const float h = 0.5f * M.sim_dt;
        const float x = s.bq[0], y = s.bq[1], z = s.bq[2], w = s.bq[3];
        const float ox = om[0], oy = om[1], oz = om[2];
        const float nx = x + h * (ox * w + (oy * z - oz * y));
        const float ny = y + h * (oy * w + (oz * x - ox * z));
        const float nz = z + h * (oz * w + (ox * y - oy * x));
        const float nw = w + h * -((ox * x + oy * y) + oz * z);
        const float n2 = (nx * nx + ny * ny) + (nz * nz + nw * nw);
        const float inv = utrl_rsqrt(fmaxf(n2, 1e-18f));
        s.bq[0] = nx * inv;
        s.bq[1] = ny * inv;
        s.bq[2] = nz * inv;
        s.bq[3] = nw * inv;
        for (int k = 0; k < 6; ++k) s.v[k] = vv[k];
    });
}

// Row n of every [N, k] operand in, row n of every [N, k] output out. With
// HAS_GH, column n of gh_in [NCP, n_envs] in and of pxy_out [2*NCP, n_envs]
// out (the JAX package's row layout). With HAS_CS, element n of cstiff
// [n_envs] in. `s` is the env's scratch, for the warp that computes it.
template <bool HAS_GH, bool HAS_CS>
UTRL_HD void utrl_control_step_env(
    const ModelTables& M, UtrlScratch<HAS_GH>& s, int n, int n_envs,
    const float* bp_in, const float* bq_in, const float* q_in, const float* v_in,
    const float* target_in, const float* friction, const float* mass_scale,
    const float* gh_in, const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out) {
    utrl_phase([&](int lane) {
        if (lane < 3) s.bp[lane] = bp_in[3 * n + lane];
        if (lane < 4) s.bq[lane] = bq_in[4 * n + lane];
        for (int j = lane; j < UTRL_NJ; j += kUtrlLanes) {
            s.q[j] = q_in[UTRL_NJ * n + j];
            s.target[j] = target_in[UTRL_NJ * n + j];
            s.tau[j] = 0.0f;
        }
        for (int k = lane; k < UTRL_NV; k += kUtrlLanes) s.v[k] = v_in[UTRL_NV * n + k];
        if (HAS_GH)
            for (int c = lane; c < UTRL_NCP; c += kUtrlLanes)
                s.gh[c] = gh_in[c * n_envs + n];
        if (lane == kUtrlLanes - 1) {
            s.fric = friction[n];
            s.mass_scale = mass_scale[n];
            s.cs = HAS_CS ? cstiff[n] : 1.0f;
        }
    });

    for (int sub = 0; sub < M.decimation; ++sub) utrl_substep<HAS_GH, HAS_CS>(M, s);

    // settled state: world kinematics, report bodies, contact forces
    utrl_fk(M, s);
    utrl_velocity_prop<false>(M, s, s.v);
    const auto& C = s.u.c;
    utrl_phase([&](int lane) {
        for (int r = lane; r < UTRL_NRB; r += kUtrlLanes) {
            const int b = M.rb_dyn[r];
            const float* rp = M.rb_pos[r];
            float t[3], wr[3], vl[3];
            utrl_mv(s.K.R[b], rp, t);
            utrl_cross(s.vb[b], rp, wr);
            for (int i = 0; i < 3; ++i) vl[i] = s.vb[b][3 + i] + wr[i];
            utrl_mv(s.K.R[b], vl, wr);
            float cf[3] = {0.0f, 0.0f, 0.0f};
            for (int q = M.rb_pt_start[r]; q < M.rb_pt_end[r]; ++q) {
                const int c = M.rb_pt[q];
                cf[0] += C.ptx[c] / M.sim_dt;
                cf[1] += C.pty[c] / M.sim_dt;
                cf[2] += C.pn[c] / M.sim_dt;
            }
            for (int i = 0; i < 3; ++i) {
                rbp_out[3 * (UTRL_NRB * n + r) + i] = s.K.p[b][i] + t[i];
                rbv_out[3 * (UTRL_NRB * n + r) + i] = wr[i];
                cf_out[3 * (UTRL_NRB * n + r) + i] = cf[i];
            }
        }
    });
    utrl_phase([&](int lane) {
        if (HAS_GH)
            // end-of-step world xy of every point: p_b + R_b cp_pos
            for (int c = lane; c < UTRL_NCP; c += kUtrlLanes) {
                const int b = M.cp_dyn[c];
                const float* rc = M.cp_pos[c];
                for (int i = 0; i < 2; ++i)
                    pxy_out[(i * UTRL_NCP + c) * n_envs + n] =
                        s.K.p[b][i] + (rc[0] * s.K.R[b][3 * i]
                                       + rc[1] * s.K.R[b][3 * i + 1]
                                       + rc[2] * s.K.R[b][3 * i + 2]);
            }
        if (lane < 3) bp_out[3 * n + lane] = s.bp[lane];
        if (lane < 4) bq_out[4 * n + lane] = s.bq[lane];
        for (int j = lane; j < UTRL_NJ; j += kUtrlLanes) {
            q_out[UTRL_NJ * n + j] = s.q[j];
            tau_out[UTRL_NJ * n + j] = s.tau[j];
        }
        for (int k = lane; k < UTRL_NV; k += kUtrlLanes) v_out[UTRL_NV * n + k] = s.v[k];
    });
}

#ifdef __CUDACC__
// One warp per env, kUtrlWarps envs per block, each warp's UtrlScratch in
// the block's dynamic shared memory. __launch_bounds__ asks for
// kUtrlBlocksPerSM resident blocks (64 registers a thread); whether that
// many fit the SM's shared memory is what utrl_resident_blocks reports
// from the runtime's occupancy calculator (chip_smoke.py's build phase
// gates it: 4096 envs resident at once on the H100's 132 SMs).
template <bool HAS_GH, bool HAS_CS>
__global__ void __launch_bounds__(kUtrlLanes * kUtrlWarps, kUtrlBlocksPerSM)
utrl_control_step_kernel(
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
    extern __shared__ float utrl_smem[];
    const int w = (int)(threadIdx.x / kUtrlLanes);
    const int n = (int)blockIdx.x * kUtrlWarps + w;
    if (n >= n_envs) return;  // the whole warp: one env per warp
    UtrlScratch<HAS_GH>* scratch = reinterpret_cast<UtrlScratch<HAS_GH>*>(utrl_smem);
    utrl_control_step_env<HAS_GH, HAS_CS>(
        *M, scratch[w], n, n_envs, bp, bq, q, v, target, friction, mass_scale,
        gh, cstiff, bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out,
        rbv_out, pxy_out);
}

// The <HAS_GH, HAS_CS> instance's dynamic shared memory per block, into
// `smem`; a block above 48 KB opts in to it here.
template <bool HAS_GH, bool HAS_CS>
cudaError_t utrl_opt_in(int* smem) {
    static_assert(kUtrlWarps * sizeof(UtrlScratch<HAS_GH>) <= 232448,
                  "a block's scratch exceeds the 227 KB a block can use");
    *smem = (int)(kUtrlWarps * sizeof(UtrlScratch<HAS_GH>));
    if (*smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(utrl_control_step_kernel<HAS_GH, HAS_CS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                *smem);
}

// Launch the <HAS_GH, HAS_CS> instance on `stream` (gh and cstiff may be
// null where it does not read them); returns the first CUDA error.
template <bool HAS_GH, bool HAS_CS>
int utrl_launch(const void* model, int n_envs, const float* bp, const float* bq,
                const float* q, const float* v, const float* target,
                const float* friction, const float* mass_scale, const float* gh,
                const float* cstiff, float* bp_out, float* bq_out, float* q_out,
                float* v_out, float* tau_out, float* cf_out, float* rbp_out,
                float* rbv_out, float* pxy_out, void* stream) {
    if (n_envs <= 0) return 0;
    int smem = 0;
    const cudaError_t err = utrl_opt_in<HAS_GH, HAS_CS>(&smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n_envs + kUtrlWarps - 1) / kUtrlWarps;
    utrl_control_step_kernel<HAS_GH, HAS_CS><<<blocks, kUtrlLanes * kUtrlWarps, smem, (cudaStream_t)stream>>>(
        (const ModelTables*)model, n_envs, bp, bq, q, v, target, friction,
        mass_scale, gh, cstiff, bp_out, bq_out, q_out, v_out, tau_out, cf_out,
        rbp_out, rbv_out, pxy_out);
    return (int)cudaGetLastError();
}

// Blocks of the <HAS_GH, HAS_CS> instance resident on one SM of the
// current device at its launch's block size and dynamic shared memory, as
// the runtime's occupancy calculator gives it; a CUDA error as its
// negative.
template <bool HAS_GH, bool HAS_CS>
int utrl_resident_blocks_of() {
    int smem = 0, blocks = 0;
    cudaError_t err = utrl_opt_in<HAS_GH, HAS_CS>(&smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, utrl_control_step_kernel<HAS_GH, HAS_CS>,
            kUtrlLanes * kUtrlWarps, smem);
    return err == cudaSuccess ? blocks : -(int)err;
}
#endif  // __CUDACC__

// The exports every library built from this header shares (each library is
// one translation unit that includes it once): the sizes the wrapper and
// the tests check, and the launch's shape.
extern "C" long long utrl_model_bytes(void) {
    return (long long)sizeof(ModelTables);
}

// bytes of one env's (one warp's) scratch, as the kernel's launch sizes it
extern "C" long long utrl_scratch_bytes(int terrain) {
    return terrain ? (long long)sizeof(UtrlScratch<true>)
                   : (long long)sizeof(UtrlScratch<false>);
}

// envs (warps) per block, and the resident blocks per SM that
// __launch_bounds__ asks for
extern "C" int utrl_envs_per_block(void) { return kUtrlWarps; }
extern "C" int utrl_blocks_per_sm_asked(void) { return kUtrlBlocksPerSM; }

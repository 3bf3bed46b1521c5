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
// Schedule: a group of kUtrlGroup (G) lanes computes one env, and a warp
// holds kUtrlLanes / G envs, one a group. Each env's working set (the
// state, the kinematics, H and its factor, the body velocities and forces,
// the contact impulse increments) lives in its UtrlScratch, the group's
// slice of shared memory on the card. The work is a sequence of phases
// (utrl_phase): in each, every lane of every group runs the same body on
// its own share of its env's items (points, joints, bodies, report bodies,
// rows of H, strided by G), reads only what earlier phases wrote, writes
// only its own items, and the warp synchronises before the next phase.
// Every group runs the same phase sequence (the tables and the loop counts
// are the model's, not the env's), so one full-warp __syncwarp serves all.
// The recursions over the tree (FK, velocities, RNEA, forces) run a lane
// per chain of the tree (a body, then its only child while it has one:
// go2's legs), a phase per level of chains, each body's result carried to
// the next in registers (a parent's children add into it in descending
// body order, as in the one-env loop); CRBA's composites run level by
// level from the depth masks; the joints' part of the Cholesky factor and
// of both triangular solves a lane per chain of the elimination tree (an
// entry is computed once every entry it needs is final), and the base's
// dense 6 x 6 block on lane 0. What a lane alone reads across phases
// stays in its registers (UtrlLane): its contact points' lever arms,
// biases, preconditioned gains and impulses for a whole substep's PGS
// sweeps, and the base block's factor.
// Every sum keeps its terms' order (points in point order, Cholesky terms
// in ascending k, skipping only structural zeros). So each output is the
// same sequence of roundings as in a plain one-thread-per-env loop; only
// the order in which independent values are computed moved.
//
// Everything here is __host__ __device__: the CUDA kernel (control_step.cu)
// runs a phase once per lane of a warp, and a host harness
// (host_harness.cpp, compiled by g++ in the tests) runs it as a loop over
// the 32 lanes of an emulated warp of 32 / G envs on the CPU, so the
// kernel's schedule is held against the plain PyTorch version on machines
// without a GPU.
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
// G, the lanes of one env, and the envs of a warp
static const int kUtrlGroup = 8;
static const int kUtrlEnvsPerWarp = kUtrlLanes / kUtrlGroup;
// The launch: kUtrlEnvsPerBlock envs (kUtrlWarps warps) per block, and the
// resident blocks per SM that the kernel's __launch_bounds__ asks for: 32
// envs (8 warps) an SM, 4224 on the H100's 132 SMs, at up to 255
// registers a thread.
static const int kUtrlEnvsPerBlock = 8;
static const int kUtrlWarps = kUtrlEnvsPerBlock / kUtrlEnvsPerWarp;
static const int kUtrlBlocksPerSM = 4;
// contact points per lane: point c is lane c % G's, slot c / G
static const int kUtrlPoints = (UTRL_NCP + kUtrlGroup - 1) / kUtrlGroup;
// The PGS point phase reads the body velocities of kUtrlWvSlots slots into
// registers before it updates them: all of a lane's slots, unless ten or
// more slots are every one filled (NCP a multiple of G, so no slot's check
// can end the loop: g1's 80 points), where the 60 loads held at once spill
// at 255 registers; then half of them at a time. Each point's update reads
// only body velocities, which the phase does not write, so either order
// gives the same bits.
static const int kUtrlWvSlots =
    (UTRL_NCP % kUtrlGroup == 0 && kUtrlPoints >= 10) ? (kUtrlPoints + 1) / 2
                                                       : kUtrlPoints;
static_assert(kUtrlGroup >= 8 && (kUtrlGroup & (kUtrlGroup - 1)) == 0
              && kUtrlGroup <= kUtrlLanes,
              "a group is a power of two of at least 8 lanes (the base's six rows)");
static_assert(kUtrlEnvsPerBlock % kUtrlEnvsPerWarp == 0, "whole warps a block");

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
    // body_chains, elim_chains), sets of bodies or positions as bit masks
    // (bit i = i)
    unsigned depth_mask[UTRL_NB]; // bodies at each depth (base 0)
    int n_depth;                  // 1 + the largest depth
    unsigned child_mask[UTRL_NB]; // children of each body
    int cp_dyn[UTRL_NCP];         // dyn body of each (sorted) point
    unsigned chol_row[UTRL_NV];   // structural nonzeros k < i of L's row i
    unsigned chol_col[UTRL_NV];   // ... and k > i of its column i
    // chains of the kinematic tree: bodies chain by chain, each from its
    // head down (chain c: entries [bchain_first[c], bchain_first[c + 1])),
    // the chains of level l: [bchain_lvl[l], bchain_lvl[l + 1]); the base
    // alone is level 0
    int bchain_body[UTRL_NB];
    int bchain_first[UTRL_NB + 1];
    int bchain_lvl[UTRL_NB + 1];
    int n_bchain_lvl;
    // chains of the joints' elimination tree, the same way: joint
    // positions, each chain from its head (nearest the base rows) down
    int echain_pos[UTRL_NJ];
    int echain_first[UTRL_NJ + 1];
    int echain_lvl[UTRL_NJ + 1];
    int n_echain_lvl;
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
// the per-env scratch, the per-lane registers and the phase loop
// ---------------------------------------------------------------------------

struct UtrlKin {
    float R[UTRL_NB][9];    // body -> world
    float p[UTRL_NB][3];    // body origins in world
    float E[UTRL_NJ][9];    // parent -> child coordinate rotation
};

// One env's working set. The union's members are live in turn within a
// substep: the RNEA accelerations, then CRBA's composite inertias, then
// what the contact solve's lanes share (whose impulses of the last
// substep's last sweep are read once more by the report-body pass).
template <bool HAS_GH>
struct UtrlScratch {
    float bp[3], bq[4], q[UTRL_NJ], v[UTRL_NV], target[UTRL_NJ], tau[UTRL_NJ];
    float gh[HAS_GH ? UTRL_NCP : 1];
    float fric, mass_scale, cs;
    UtrlKin K;
    float vb[UTRL_NB][6];    // body velocities (body coords)
    float f[UTRL_NB][6];     // body forces, turned into their parent's terms
    float L[UTRL_NTRI];      // H, then its L D^{1/2} factor, packed lower
                             // (the base block's factor: lane 0's UtrlLane)
    float rinv[UTRL_NV];     // 1 / sqrt(pivot) of the joints
    float rhs[UTRL_NV];      // RNEA bias, then the substep's right-hand side
    float vv[UTRL_NV];       // the substep's velocity
    float gen[UTRL_NV];      // generalized contact force
    float y[UTRL_NV];        // a solve's vector in elimination order
    union {
        struct {
            float a[UTRL_NB][6];        // RNEA accelerations
        } rnea;
        struct {
            float Icb[UTRL_NB][27];     // composite (Ic, Hc, Mc) per body
            float T[UTRL_NB][27];       // each body's block in its parent's frame
        } crba;
        struct {
            float pn[UTRL_NCP];         // the last sweep's impulses
            float ptx[UTRL_NCP];
            float pty[UTRL_NCP];
            float dp[UTRL_NCP][3];      // this sweep's impulse increments
            float nw[UTRL_NCP][3];      // ... and their moments r_w x dp
            float wl[UTRL_NB][6];       // world angular / linear body velocity
            float jacobi[UTRL_NB];      // 1 / #active points on the body
            unsigned char active[UTRL_NCP];
        } c;
    } u;
};

// One env's scratch in words, and the stride of the envs of a warp: the
// next count of words = G (mod 32), so that group g starts g * G banks
// along and the groups' lanes of a phase fall in different banks.
template <bool HAS_GH>
struct UtrlLayout {
    static constexpr int words = (int)((sizeof(UtrlScratch<HAS_GH>) + 3) / 4);
    static constexpr int stride = (words - kUtrlGroup + 31) / 32 * 32 + kUtrlGroup;
};

// What one lane alone reads across phases, in its registers on the card
// (on the host, one per lane of the emulated warp).
struct UtrlLane {
    // its contact points c = lane + p * G, slot p (c < NCP): set once per
    // substep, held across the substep's PGS sweeps
    int b[kUtrlPoints];                        // dyn body
    float r_w[kUtrlPoints][3];                 // world lever arm from its origin
    float v_bias[kUtrlPoints];
    float kn[kUtrlPoints], kt[kUtrlPoints];    // (relaxation * jacobi) * m_eff
    float pn[kUtrlPoints], ptx[kUtrlPoints], pty[kUtrlPoints];
    unsigned active;                           // bit p: slot p in contact
    float mu;                                  // the env's friction coefficient
    // lane 0: the base block's L D^{1/2} factor (packed lower) and its
    // pivots' 1 / sqrt, from the factor to the substep's last solve
    float Lb[21], rinvb[6];
};

// A warp's envs: group g (lanes g G .. g G + G - 1) computes env n0 + g in
// the scratch at g * stride words; each lane's UtrlLane (on the card the
// thread's own, on the host the lane's of `lanes`).
template <bool HAS_GH>
struct UtrlWarp {
    float* scratch;
    UtrlLane* lanes;
    int n0;
    UTRL_HD UtrlScratch<HAS_GH>& env(int g) const {
        return *reinterpret_cast<UtrlScratch<HAS_GH>*>(
            scratch + g * UtrlLayout<HAS_GH>::stride);
    }
    UTRL_HD UtrlLane& lane(int hw) const {
#ifdef __CUDA_ARCH__
        (void)hw;
        return *lanes;
#else
        return lanes[hw];
#endif
    }
};

// Run body(s, lane, r, n) on every lane of the warp, then synchronise the
// warp: s is the scratch of the lane's env, lane its index in the env's
// group (0 .. G - 1), r its registers and n the env (n_envs or more in a
// group of the last warp that has none). On the card each lane runs it
// once; on the host the lanes run one after another (in reverse with
// -DUTRL_HOST_LANES_REVERSED, the lanes of each group and the groups both:
// the tests use it to show that no phase reads what another lane of it,
// of its env or of another, writes).
template <class W, class F>
UTRL_HD void utrl_phase(const W& w, F&& body) {
#ifdef __CUDA_ARCH__
    const int hw = (int)(threadIdx.x % kUtrlLanes);
    body(w.env(hw / kUtrlGroup), hw % kUtrlGroup, w.lane(hw), w.n0 + hw / kUtrlGroup);
    __syncwarp();
#else
    for (int i = 0; i < kUtrlLanes; ++i) {
#ifdef UTRL_HOST_LANES_REVERSED
        const int hw = kUtrlLanes - 1 - i;
#else
        const int hw = i;
#endif
        body(w.env(hw / kUtrlGroup), hw % kUtrlGroup, w.lane(hw),
             w.n0 + hw / kUtrlGroup);
    }
#endif
}

// f(node, start) for each node of the lane's chains among c0 .. c1 - 1
// (every G-th from c0 + lane; chain c: nodes[first[c] .. first[c + 1] - 1]),
// each chain from its head down, or from its tail up with UP; start marks
// a chain's first node. A pass carries what a node hands on to the next in
// registers, and writes each node's result to the scratch only at its end:
// a store to the scratch between two loads from it would hold the second
// one back (the compiler cannot tell the two addresses apart).
template <bool UP, class F>
UTRL_HD void utrl_chain_walk(const int* first, const int* nodes, int c0, int c1,
                             int lane, F&& f) {
    for (int c = c0 + lane; c < c1; c += kUtrlGroup) {
        const int q0 = first[c], n = first[c + 1] - q0;
        for (int k = 0; k < n; ++k) f(nodes[UP ? q0 + n - 1 - k : q0 + k], k == 0);
    }
}

// ---------------------------------------------------------------------------
// kinematics and the tree recursions, chain by chain
// ---------------------------------------------------------------------------

template <class W>
UTRL_HD void utrl_fk(const ModelTables& M, const W& w) {
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        for (int j = lane; j < UTRL_NJ; j += kUtrlGroup)
            utrl_joint_E(M, j, s.q[j], s.K.E[j]);
        if (lane == kUtrlGroup - 1) {
            utrl_quat_to_rotmat(s.bq, s.K.R[0]);
            for (int i = 0; i < 3; ++i) s.K.p[0][i] = s.bp[i];
        }
    });
    // a phase a chain level from 1, each lane a chain from its head down
    for (int l = 1; l < M.n_bchain_lvl; ++l) {
        const int c0 = M.bchain_lvl[l], c1 = M.bchain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            float Rp[9], pp[3];  // the parent's rotation and origin
            utrl_chain_walk<false>(M.bchain_first, M.bchain_body, c0, c1, lane,
                                   [&](int i, bool start) {
                const int par = M.parent[i], j = i - 1;
                if (start) {
                    for (int k = 0; k < 9; ++k) Rp[k] = s.K.R[par][k];
                    for (int k = 0; k < 3; ++k) pp[k] = s.K.p[par][k];
                }
                float Et[9], Ri[9], t[3];
                for (int a = 0; a < 3; ++a)
                    for (int b = 0; b < 3; ++b) Et[3 * a + b] = s.K.E[j][3 * b + a];
                utrl_mm(Rp, Et, Ri);
                utrl_mv(Rp, M.rtree[j], t);
                for (int k = 0; k < 3; ++k) pp[k] = pp[k] + t[k];
                for (int k = 0; k < 9; ++k) s.K.R[i][k] = Rp[k] = Ri[k];
                for (int k = 0; k < 3; ++k) s.K.p[i][k] = pp[k];
            });
        });
    }
}

// per-body spatial velocities (body coords) from a generalized velocity
// vsel(s); WORLD also writes each body's world angular and linear velocity
// (PGS). A phase a chain level from 1, each lane a chain from its head
// down; the base's chain (vb[0] = v[0:6]) shares level 1's phase: its
// children read v.
template <bool WORLD, class W, class V>
UTRL_HD void utrl_velocity_prop(const ModelTables& M, const W& w, V vsel) {
    for (int l = 1; l < M.n_bchain_lvl; ++l) {
        const int c0 = l == 1 ? 0 : M.bchain_lvl[l], c1 = M.bchain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            const float* v = vsel(s);
            float vb[6];  // the last body's velocity: its child's parent's
            utrl_chain_walk<false>(M.bchain_first, M.bchain_body, c0, c1, lane,
                                   [&](int i, bool start) {
                if (i == 0) {
                    for (int k = 0; k < 6; ++k) vb[k] = v[k];
                } else {
                    const int j = i - 1, par = M.parent[i];
                    if (start) {
                        const float* vp = par == 0 ? v : s.vb[par];
                        for (int k = 0; k < 6; ++k) vb[k] = vp[k];
                    }
                    float o[6];
                    utrl_xform_motion(s.K.E[j], M.rtree[j], vb, o);
                    const float qd = v[6 + j];
                    for (int k = 0; k < 3; ++k) vb[k] = o[k] + M.axis[j][k] * qd;
                    for (int k = 3; k < 6; ++k) vb[k] = o[k];
                }
                if (WORLD) {
                    float o[6];
                    utrl_mv(s.K.R[i], vb, o);
                    utrl_mv(s.K.R[i], vb + 3, o + 3);
                    for (int k = 0; k < 6; ++k) s.u.c.wl[i][k] = o[k];
                }
                for (int k = 0; k < 6; ++k) s.vb[i][k] = vb[k];
            });
        });
    }
}

// adjoint of velocity_prop: per-body forces s.f (body coords, destroyed)
// -> generalized force osel(s) [nv]. A phase a chain level from the
// deepest, each lane a chain from its tail up: each body adds its
// children's terms in descending body order (a child is the body before
// it on the chain or the head of a deeper chain), then hands its own on
// (X^* f, into s.f). `force(s, r, i, f)` gives body i's own force f: by
// default s.f[i]; the contact solve's from its points.
struct UtrlNoForce {
    template <class S, class R>
    UTRL_HD void operator()(S& s, R&, int i, float* f) const {
        for (int k = 0; k < 6; ++k) f[k] = s.f[i][k];
    }
};

template <class W, class Out, class Force = UtrlNoForce>
UTRL_HD void utrl_force_backward(const ModelTables& M, const W& w, Out osel,
                                 Force force = Force()) {
    for (int l = M.n_bchain_lvl - 1; l >= 0; --l) {
        const int c0 = M.bchain_lvl[l], c1 = M.bchain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto& r, auto&&...) {
            float* out = osel(s);
            float t[6];  // the term the last body handed on
            int prev = -1;
            utrl_chain_walk<true>(M.bchain_first, M.bchain_body, c0, c1, lane,
                                  [&](int i, bool start) {
                if (start) prev = -1;
                float fi[6];
                force(s, r, i, fi);
                for (unsigned cm = M.child_mask[i]; cm; cm &= ~(1u << utrl_highest(cm))) {
                    const int c = utrl_highest(cm);
                    if (c == prev) {
                        for (int k = 0; k < 6; ++k) fi[k] = fi[k] + t[k];
                    } else {
                        const float* fc = s.f[c];
                        for (int k = 0; k < 6; ++k) fi[k] = fi[k] + fc[k];
                    }
                }
                if (i == 0) {
                    for (int k = 0; k < 6; ++k) out[k] = fi[k];
                } else {
                    const int j = i - 1;
                    out[6 + j] = utrl_dot(M.axis[j], fi);
                    utrl_xform_force_inv(s.K.E[j], M.rtree[j], fi, t);
                    for (int k = 0; k < 6; ++k) s.f[i][k] = t[k];
                }
                prev = i;
            });
        });
    }
}

// ---------------------------------------------------------------------------
// dynamics: RNEA bias, CRBA into the permuted packed H, Cholesky by chains
// ---------------------------------------------------------------------------

// bias [nv] into s.rhs; needs s.vb of s.v. The accelerations a phase a
// chain level, each lane a chain from its head down.
template <class W>
UTRL_HD void utrl_bias(const ModelTables& M, const W& w) {
    for (int l = 0; l < M.n_bchain_lvl; ++l) {
        const int c0 = M.bchain_lvl[l], c1 = M.bchain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            float ai[6];  // the last body's acceleration: its child's parent's
            utrl_chain_walk<false>(M.bchain_first, M.bchain_body, c0, c1, lane,
                                   [&](int i, bool start) {
                if (i == 0) {
                    float gb[3];
                    utrl_mtv(s.K.R[0], M.gravity, gb);
                    for (int k = 0; k < 3; ++k) {
                        ai[k] = 0.0f;
                        ai[3 + k] = -gb[k];
                    }
                } else {
                    const int j = i - 1;
                    if (start)
                        for (int k = 0; k < 6; ++k) ai[k] = s.u.rnea.a[M.parent[i]][k];
                    float o[6];
                    utrl_xform_motion(s.K.E[j], M.rtree[j], ai, o);
                    // + v_i x_m (axis qd, 0) = (w x S qd, vl x S qd)
                    float Sq[3], c1[3], c2[3];
                    for (int k = 0; k < 3; ++k) Sq[k] = M.axis[j][k] * s.v[6 + j];
                    utrl_cross(s.vb[i], Sq, c1);
                    utrl_cross(s.vb[i] + 3, Sq, c2);
                    for (int k = 0; k < 3; ++k) {
                        ai[k] = o[k] + c1[k];
                        ai[3 + k] = o[3 + k] + c2[k];
                    }
                }
                for (int k = 0; k < 6; ++k) s.u.rnea.a[i][k] = ai[k];
            });
        });
    }
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        float(*a)[6] = s.u.rnea.a;
        for (int i = lane; i < UTRL_NB; i += kUtrlGroup) {
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
    utrl_force_backward(M, w, [](auto& s) { return s.rhs; });
}

// H into s.L (elimination order, packed lower)
template <class W>
UTRL_HD void utrl_crba(const ModelTables& M, const W& w) {
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        float(*Icb)[27] = s.u.crba.Icb;
        for (int i = lane; i < UTRL_NB; i += kUtrlGroup) {
            const float sc = i == 0 ? s.mass_scale : 1.0f;
            for (int k = 0; k < 9; ++k) {
                Icb[i][k] = M.Ic[i][k] * sc;
                Icb[i][9 + k] = M.Hc[i][k] * sc;
                Icb[i][18 + k] = (k % 4 == 0) ? M.mass[i] * sc : 0.0f;
            }
        }
        for (int e = lane; e < UTRL_NTRI; e += kUtrlGroup) s.L[e] = 0.0f;
    });
    // composites, deepest level first: each body's block into its parent's
    // frame (three lanes a body, a column each), then each parent adds its
    // children's in descending body order (a lane an entry)
    for (int d = M.n_depth - 1; d > 0; --d) {
        const unsigned parents = M.depth_mask[d - 1];
        const int first = M.depth_first[d], count = utrl_popc(M.depth_mask[d]);
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            for (int e = lane; e < 3 * count; e += kUtrlGroup) {
                const int i = M.depth_body[first + e / 3];
                utrl_inertia_to_parent_col(s.K.E[i - 1], M.rtree[i - 1], s.u.crba.Icb[i],
                                           e % 3, s.u.crba.T[i]);
            }
        });
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            float(*Icb)[27] = s.u.crba.Icb;
            for (int k = lane; k < 27; k += kUtrlGroup)
                for (unsigned pm = parents; pm; pm &= pm - 1) {
                    const int p = utrl_lowest(pm);
                    float acc = Icb[p][k];
                    for (unsigned cm = M.child_mask[p]; cm; cm &= ~(1u << utrl_highest(cm)))
                        acc = acc + s.u.crba.T[utrl_highest(cm)][k];
                    Icb[p][k] = acc;
                }
        });
    }
    // the base block, and one column per joint walking up its chain
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        float(*Icb)[27] = s.u.crba.Icb;
        for (int e = lane; e < UTRL_NJ + 9; e += kUtrlGroup) {
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
// the joints run by chains of the elimination tree, a phase a level, and
// the base block's 6 x 6 triangle is lane 0's, in its registers.
#define UTRL_B0 (UTRL_NV - 6)                    // first base position
#define UTRL_JOINTS ((1u << UTRL_NJ) - 1u)       // the joint positions
static_assert(UTRL_NJ >= 1, "a model with joints");

// packed lower triangle of the base block: entry (i, j), 0 <= j <= i < 6
UTRL_HD int utrl_btri(int i, int j) { return i * (i + 1) / 2 + j; }

// In-place L D^{1/2} factor of the permuted H; rinv = 1/sqrt(pivot). Entry
// (i, j) subtracts L[i][k] L[j][k] for every k < j where both are
// structural nonzeros, in ascending k (the plain version's terms; a
// structural zero adds nothing), then scales by rinv[j]. The joints'
// columns a phase a level of elimination chains from the deepest, each
// lane a chain from its tail up (a column's pivot, then its entries in
// every row below; each term's column is the column's descendant, on the
// chain before it or on a deeper chain); then every base-block entry's
// joint terms, one lane an entry; then the base block's own terms, column
// by column, on lane 0, which keeps the block's factor and pivots in its
// registers (UtrlLane::Lb, rinvb) for the substep's solves.
template <class W>
UTRL_HD void utrl_chol_factor(const ModelTables& M, const W& w) {
    for (int l = M.n_echain_lvl - 1; l >= 0; --l) {
        const int c0 = M.echain_lvl[l], c1 = M.echain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            float* L = s.L;
            utrl_chain_walk<true>(M.echain_first, M.echain_pos, c0, c1, lane,
                                  [&](int j, bool) {
                const int rj = utrl_tri(j, 0);
                float t = L[rj + j];
                for (unsigned m = M.chol_row[j]; m; m &= m - 1) {
                    const float ljk = L[rj + utrl_lowest(m)];
                    t = t - ljk * ljk;
                }
                s.rinv[j] = utrl_rsqrt(fmaxf(t, 1e-12f));
                L[rj + j] = t * s.rinv[j];
                for (unsigned mi = M.chol_col[j]; mi; mi &= mi - 1) {
                    const int i = utrl_lowest(mi), ri = utrl_tri(i, 0);
                    float u = L[ri + j];
                    for (unsigned m = M.chol_row[i] & M.chol_row[j]; m; m &= m - 1) {
                        const int k = utrl_lowest(m);
                        u = u - L[ri + k] * L[rj + k];
                    }
                    L[ri + j] = u * s.rinv[j];
                }
            });
        });
    }
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        float* L = s.L;
        for (int e = lane; e < 21; e += kUtrlGroup) {
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
    utrl_phase(w, [&](auto& s, int lane, auto& r, auto&&...) {
        if (lane != 0) return;
        float* B = r.Lb;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j <= i; ++j)
                B[utrl_btri(i, j)] = s.L[utrl_tri(UTRL_B0 + i, UTRL_B0 + j)];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            float t = B[utrl_btri(j, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) t = t - B[utrl_btri(j, k)] * B[utrl_btri(j, k)];
            const float rj = utrl_rsqrt(fmaxf(t, 1e-12f));
            r.rinvb[j] = rj;
            B[utrl_btri(j, j)] = t * rj;
#pragma unroll
            for (int i = j + 1; i < 6; ++i) {
                float u = B[utrl_btri(i, j)];
#pragma unroll
                for (int k = 0; k < j; ++k) u = u - B[utrl_btri(i, k)] * B[utrl_btri(j, k)];
                B[utrl_btri(i, j)] = u * rj;
            }
        }
    });
}

// H x = b (natural indexing; b = bsel(s)); out(s, k, x_k) stores x_k.
// Each entry subtracts its terms in ascending k (every k in turn, a
// structural zero skipped, so a lane issues a row's loads at once instead
// of one after another). Forward: the joint rows a phase a level of
// elimination chains from the deepest, each lane a chain from its tail
// up; then the base rows' joint terms, a lane a row; then the base block
// on lane 0 from its registers. Back: the base block on lane 0, then the
// joint rows a phase a level from 0, each lane a chain from its head down.
template <class W, class Rhs, class Out>
UTRL_HD void utrl_chol_solve(const ModelTables& M, const W& w, Rhs bsel, Out out) {
    for (int l = M.n_echain_lvl - 1; l >= 0; --l) {
        const int c0 = M.echain_lvl[l], c1 = M.echain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            const float* b = bsel(s);
            utrl_chain_walk<true>(M.echain_first, M.echain_pos, c0, c1, lane,
                                  [&](int i, bool) {
                const int ri = utrl_tri(i, 0);
                const unsigned row = M.chol_row[i];
                float t = b[M.chol_order[i]];
#pragma unroll
                for (int k = 0; k < UTRL_NJ; ++k)
                    if (row >> k & 1u) t = t - s.L[ri + k] * s.y[k];
                s.y[i] = t * s.rinv[i];
            });
        });
    }
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        if (lane >= 6) return;
        const int i = UTRL_B0 + lane, ri = utrl_tri(i, 0);
        const unsigned row = M.chol_row[i];
        float t = bsel(s)[M.chol_order[i]];
#pragma unroll
        for (int k = 0; k < UTRL_NJ; ++k)
            if (row >> k & 1u) t = t - s.L[ri + k] * s.y[k];
        s.y[i] = t;
    });
    utrl_phase(w, [&](auto& s, int lane, auto& r, auto&&...) {
        if (lane != 0) return;
        float yb[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            float t = s.y[UTRL_B0 + i];
#pragma unroll
            for (int q = 0; q < i; ++q) t = t - r.Lb[utrl_btri(i, q)] * yb[q];
            yb[i] = t * r.rinvb[i];
        }
#pragma unroll
        for (int i = 5; i >= 0; --i) {
            float t = yb[i];
#pragma unroll
            for (int q = i + 1; q < 6; ++q) t = t - r.Lb[utrl_btri(q, i)] * yb[q];
            yb[i] = t * r.rinvb[i];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            s.y[UTRL_B0 + i] = yb[i];
            out(s, M.chol_order[UTRL_B0 + i], yb[i]);
        }
    });
    for (int l = 0; l < M.n_echain_lvl; ++l) {
        const int c0 = M.echain_lvl[l], c1 = M.echain_lvl[l + 1];
        utrl_phase(w, [&](auto& s, int lane, auto&&...) {
            utrl_chain_walk<false>(M.echain_first, M.echain_pos, c0, c1, lane,
                                   [&](int i, bool) {
                const unsigned col = M.chol_col[i];
                // the base rows' terms read first (every joint's column
                // holds every base row: physics/cuda_step.py::chol_pattern)
                float lb[6], yb[6];
#pragma unroll
                for (int k = 0; k < 6; ++k) {
                    lb[k] = s.L[utrl_tri(UTRL_B0 + k, i)];
                    yb[k] = s.y[UTRL_B0 + k];
                }
                float t = s.y[i];
#pragma unroll
                for (int k = 0; k < UTRL_B0; ++k)
                    if (col >> k & 1u) t = t - s.L[utrl_tri(k, i)] * s.y[k];
#pragma unroll
                for (int k = 0; k < 6; ++k) t = t - lb[k] * yb[k];
                const float yi = t * s.rinv[i];
                s.y[i] = yi;
                out(s, M.chol_order[i], yi);
            });
        });
    }
}

// ---------------------------------------------------------------------------
// PGS contact on the z = 0 plane (HAS_GH = false) or above per-point ground
// heights gh[c] (HAS_GH = true); HAS_CS scales the de-penetration bias by
// the env's contact stiffness cs after its clamp (the JAX package's order;
// cs = 1 leaves every bit). Each lane's points (c = lane + p G) stay in its
// registers from the set-up phase to the last sweep: lever arm, bias,
// contact, the preconditioned gains (formed in the first sweep) and the
// impulses; the lanes share only what another lane reads: each point's
// contact (the Jacobi counts), its increments and their moments (the
// bodies' sums), and the last sweep's impulses (the report bodies').
// ---------------------------------------------------------------------------

template <bool HAS_GH, bool HAS_CS, class W>
UTRL_HD void utrl_contact(const ModelTables& M, const W& w) {
    utrl_phase(w, [&](auto& s, int lane, auto& r, auto&&...) {
        auto& C = s.u.c;
        r.active = 0u;
        r.mu = 0.5f * (M.terrain_friction + s.fric);
#pragma unroll
        for (int p = 0; p < kUtrlPoints; ++p) {
            const int c = lane + p * kUtrlGroup;
            if (c >= UTRL_NCP) break;
            const int b = M.cp_dyn[c];
            const float* rc = M.cp_pos[c];
            const float* R = s.K.R[b];
            float* rw = r.r_w[p];
            for (int i = 0; i < 3; ++i)
                rw[i] = rc[0] * R[3 * i] + rc[1] * R[3 * i + 1] + rc[2] * R[3 * i + 2];
            const float z = s.K.p[b][2] + rw[2];
            const float phi = HAS_GH ? (M.cp_radius[c] + s.gh[c]) - z
                                     : M.cp_radius[c] - z;
            C.active[c] = phi > 0.0f;
            r.active |= (phi > 0.0f ? 1u : 0u) << p;
            float bias = fminf(M.baumgarte * fmaxf(phi, 0.0f) / M.sim_dt,
                               M.max_depenetration_velocity);
            if (HAS_CS) bias = bias * s.cs;
            r.b[p] = b;
            r.v_bias[p] = bias;
            r.pn[p] = r.ptx[p] = r.pty[p] = 0.0f;
            if (M.iterations == 0) C.pn[c] = C.ptx[c] = C.pty[c] = 0.0f;
        }
    });
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        auto& C = s.u.c;
        for (int b = lane; b < UTRL_NB; b += kUtrlGroup) {
            float n_active = 0.0f;
            for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c)
                n_active += C.active[c] ? 1.0f : 0.0f;
            C.jacobi[b] = 1.0f / fmaxf(n_active, 1.0f);
        }
    });
    for (int it = 0; it < M.iterations; ++it) {
        utrl_velocity_prop<true>(M, w, [](auto& s) { return s.vv; });
        const bool first = it == 0, last = it == M.iterations - 1;
        // every point's impulses against the same body velocities (Jacobi):
        // the body velocities of kUtrlWvSlots slots read first, then those
        // slots' updates and stores
        utrl_phase(w, [&](auto& s, int lane, auto& r, auto&&...) {
            auto& C = s.u.c;
#pragma unroll
            for (int p0 = 0; p0 < kUtrlPoints; p0 += kUtrlWvSlots) {
                float wv[kUtrlWvSlots][6];
#pragma unroll
                for (int q = 0; q < kUtrlWvSlots; ++q) {
                    const int p = p0 + q, c = lane + p * kUtrlGroup;
                    if (p >= kUtrlPoints || c >= UTRL_NCP) break;
                    const int b = r.b[p];
                    for (int k = 0; k < 6; ++k) wv[q][k] = C.wl[b][k];
                    if (first) {
                        const float kb = M.relaxation * C.jacobi[b];
                        r.kn[p] = kb * M.m_eff_n[c];
                        r.kt[p] = kb * M.m_eff_t[c];
                    }
                }
#pragma unroll
                for (int q = 0; q < kUtrlWvSlots; ++q) {
                    const int p = p0 + q, c = lane + p * kUtrlGroup;
                    if (p >= kUtrlPoints || c >= UTRL_NCP) break;
                    const float* ww = wv[q];
                    const float* lw = wv[q] + 3;
                    const float* rw = r.r_w[p];
                    const float vp0 = lw[0] + ww[1] * rw[2] - ww[2] * rw[1];
                    const float vp1 = lw[1] + ww[2] * rw[0] - ww[0] * rw[2];
                    const float vp2 = lw[2] + ww[0] * rw[1] - ww[1] * rw[0];
                    const bool act = r.active >> p & 1u;
                    const float kn = r.kn[p], kt = r.kt[p];
                    const float pn = r.pn[p], ptx = r.ptx[p], pty = r.pty[p];
                    const float pn_new = act ? fmaxf(pn + kn * (r.v_bias[p] - vp2), 0.0f)
                                             : 0.0f;
                    float ptx_n = ptx + (act ? -kt * vp0 : 0.0f);
                    float pty_n = pty + (act ? -kt * vp1 : 0.0f);
                    const float pt_norm = sqrtf(ptx_n * ptx_n + pty_n * pty_n);
                    const float cone = r.mu * pn_new;
                    const float scale = pt_norm > cone ? cone / (pt_norm + 1e-9f) : 1.0f;
                    ptx_n = ptx_n * scale;
                    pty_n = pty_n * scale;
                    const float dp[3] = {ptx_n - ptx, pty_n - pty, pn_new - pn};
                    utrl_cross(rw, dp, C.nw[c]);
                    for (int i = 0; i < 3; ++i) C.dp[c][i] = dp[i];
                    r.pn[p] = pn_new;
                    r.ptx[p] = ptx_n;
                    r.pty[p] = pty_n;
                    if (last) {
                        C.pn[c] = pn_new;
                        C.ptx[c] = ptx_n;
                        C.pty[c] = pty_n;
                    }
                }
            }
        });
        // each body's force from its points' increments and moments, summed
        // in point order into body coordinates, on the lane that hands the
        // body on
        utrl_force_backward(M, w, [](auto& s) { return s.gen; },
                            [&](auto& s, auto&, int b, float* f) {
            auto& C = s.u.c;
            float nsum[3] = {0.f, 0.f, 0.f}, fsum[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
            for (int c = M.cp_start[b]; c < M.cp_end[b]; ++c)
                for (int i = 0; i < 3; ++i) {
                    nsum[i] += C.nw[c][i];
                    fsum[i] += C.dp[c][i];
                }
            utrl_mtv(s.K.R[b], nsum, f);
            utrl_mtv(s.K.R[b], fsum, f + 3);
        });
        utrl_chol_solve(M, w, [](auto& s) { return s.gen; },
                        [&](auto& s, int k, float x) { s.vv[k] = s.vv[k] + x; });
    }
}

// ---------------------------------------------------------------------------
// one substep and the whole control step of a warp's envs
// ---------------------------------------------------------------------------

template <bool HAS_GH, bool HAS_CS, class W>
UTRL_HD void utrl_substep(const ModelTables& M, const W& w) {
    utrl_fk(M, w);
    utrl_velocity_prop<false>(M, w, [](auto& s) { return s.v; });
    utrl_bias(M, w);
    utrl_crba(M, w);
    utrl_chol_factor(M, w);
    // PD torque + clip, passive terms, right-hand side (in place of bias)
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        for (int j = lane; j < UTRL_NJ; j += kUtrlGroup) {
            float t = M.kp[j] * (s.target[j] - s.q[j]) - M.kd[j] * s.v[6 + j];
            if (M.clip_torque) t = utrl_clip(t, -M.torque_limit[j], M.torque_limit[j]);
            s.tau[j] = t;
            const float qd = s.v[6 + j];
            float passive = -M.dof_damping[j] * qd;
            if (M.dof_friction[j] != 0.0f)
                passive = passive - M.dof_friction[j] * tanhf(qd / 0.1f);
            s.rhs[6 + j] = (t + passive) - s.rhs[6 + j];
        }
        if (lane == kUtrlGroup - 1)
            for (int k = 0; k < 6; ++k) s.rhs[k] = -s.rhs[k];
    });
    utrl_chol_solve(M, w, [](auto& s) { return s.rhs; },
                    [&](auto& s, int k, float x) { s.vv[k] = s.v[k] + M.sim_dt * x; });

    utrl_contact<HAS_GH, HAS_CS>(M, w);

    // velocity caps, then semi-implicit integration in the substep-start
    // frame and the joint-limit projection
    utrl_phase(w, [&](auto& s, int lane, auto&&...) {
        for (int j = lane; j < UTRL_NJ; j += kUtrlGroup) {
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
        if (lane != kUtrlGroup - 1) return;
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
        const float x = s.bq[0], y = s.bq[1], z = s.bq[2], q3 = s.bq[3];
        const float ox = om[0], oy = om[1], oz = om[2];
        const float nx = x + h * (ox * q3 + (oy * z - oz * y));
        const float ny = y + h * (oy * q3 + (oz * x - ox * z));
        const float nz = z + h * (oz * q3 + (ox * y - oy * x));
        const float nw = q3 + h * -((ox * x + oy * y) + oz * z);
        const float n2 = (nx * nx + ny * ny) + (nz * nz + nw * nw);
        const float inv = utrl_rsqrt(fmaxf(n2, 1e-18f));
        s.bq[0] = nx * inv;
        s.bq[1] = ny * inv;
        s.bq[2] = nz * inv;
        s.bq[3] = nw * inv;
        for (int k = 0; k < 6; ++k) s.v[k] = vv[k];
    });
}

// The control step of the warp's envs w.n0 .. w.n0 + 32 / G - 1: row n of
// every [N, k] operand in, row n of every [N, k] output out. With HAS_GH,
// column n of gh_in [NCP, n_envs] in and of pxy_out [2*NCP, n_envs] out
// (the JAX package's row layout). With HAS_CS, element n of cstiff
// [n_envs] in. A group whose env is past n_envs (in the last warp) runs
// every phase on the last env's inputs and writes nothing.
template <bool HAS_GH, bool HAS_CS>
UTRL_HD void utrl_control_step_warp(
    const ModelTables& M, const UtrlWarp<HAS_GH>& w, int n_envs,
    const float* bp_in, const float* bq_in, const float* q_in, const float* v_in,
    const float* target_in, const float* friction, const float* mass_scale,
    const float* gh_in, const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out) {
    utrl_phase(w, [&](auto& s, int lane, auto&, int n) {
        if (n >= n_envs) n = n_envs - 1;
        if (lane < 3) s.bp[lane] = bp_in[3 * n + lane];
        if (lane < 4) s.bq[lane] = bq_in[4 * n + lane];
        for (int j = lane; j < UTRL_NJ; j += kUtrlGroup) {
            s.q[j] = q_in[UTRL_NJ * n + j];
            s.target[j] = target_in[UTRL_NJ * n + j];
            s.tau[j] = 0.0f;
        }
        for (int k = lane; k < UTRL_NV; k += kUtrlGroup) s.v[k] = v_in[UTRL_NV * n + k];
        if (HAS_GH)
            for (int c = lane; c < UTRL_NCP; c += kUtrlGroup)
                s.gh[c] = gh_in[c * n_envs + n];
        if (lane == kUtrlGroup - 1) {
            s.fric = friction[n];
            s.mass_scale = mass_scale[n];
            s.cs = HAS_CS ? cstiff[n] : 1.0f;
        }
    });

    for (int sub = 0; sub < M.decimation; ++sub) utrl_substep<HAS_GH, HAS_CS>(M, w);

    // settled state: world kinematics, report bodies, contact forces
    utrl_fk(M, w);
    utrl_velocity_prop<false>(M, w, [](auto& s) { return s.v; });
    utrl_phase(w, [&](auto& s, int lane, auto&, int n) {
        if (n >= n_envs) return;
        const auto& C = s.u.c;
        for (int r = lane; r < UTRL_NRB; r += kUtrlGroup) {
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
    utrl_phase(w, [&](auto& s, int lane, auto&, int n) {
        if (n >= n_envs) return;
        if (HAS_GH)
            // end-of-step world xy of every point: p_b + R_b cp_pos
            for (int c = lane; c < UTRL_NCP; c += kUtrlGroup) {
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
        for (int j = lane; j < UTRL_NJ; j += kUtrlGroup) {
            q_out[UTRL_NJ * n + j] = s.q[j];
            tau_out[UTRL_NJ * n + j] = s.tau[j];
        }
        for (int k = lane; k < UTRL_NV; k += kUtrlGroup) v_out[UTRL_NV * n + k] = s.v[k];
    });
}

#ifdef __CUDACC__
// kUtrlWarps warps of 32 / G envs per block, each env's UtrlScratch in the
// block's dynamic shared memory, each lane's UtrlLane in its registers.
// __launch_bounds__ asks for kUtrlBlocksPerSM resident blocks (32 envs an
// SM: 255 registers a thread); whether that many fit the SM's
// shared memory is what utrl_resident_blocks reports from the runtime's
// occupancy calculator (chip_smoke.py's build phase gates it: 4096 envs
// resident at once on the H100's 132 SMs).
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
    const int wi = (int)(threadIdx.x / kUtrlLanes);
    const int n0 = ((int)blockIdx.x * kUtrlWarps + wi) * kUtrlEnvsPerWarp;
    if (n0 >= n_envs) return;  // the whole warp: no env of it is real
    UtrlLane lane;
    const UtrlWarp<HAS_GH> w{
        utrl_smem + wi * kUtrlEnvsPerWarp * UtrlLayout<HAS_GH>::stride, &lane, n0};
    utrl_control_step_warp<HAS_GH, HAS_CS>(
        *M, w, n_envs, bp, bq, q, v, target, friction, mass_scale, gh, cstiff,
        bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out, rbv_out, pxy_out);
}

// The <HAS_GH, HAS_CS> instance's dynamic shared memory per block, into
// `smem`; a block above 48 KB opts in to it here.
template <bool HAS_GH, bool HAS_CS>
cudaError_t utrl_opt_in(int* smem) {
    static_assert(kUtrlEnvsPerBlock * UtrlLayout<HAS_GH>::stride * 4 <= 232448,
                  "a block's scratch exceeds the 227 KB a block can use");
    *smem = kUtrlEnvsPerBlock * UtrlLayout<HAS_GH>::stride * 4;
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
    const int blocks = (n_envs + kUtrlEnvsPerBlock - 1) / kUtrlEnvsPerBlock;
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

// bytes of one env's scratch, as the kernel's launch sizes it (padded to
// its stride)
extern "C" long long utrl_scratch_bytes(int terrain) {
    return 4LL * (terrain ? UtrlLayout<true>::stride : UtrlLayout<false>::stride);
}

// lanes per env (G), envs per block, and the resident blocks per SM that
// __launch_bounds__ asks for
extern "C" int utrl_lanes_per_env(void) { return kUtrlGroup; }
extern "C" int utrl_envs_per_block(void) { return kUtrlEnvsPerBlock; }
extern "C" int utrl_blocks_per_sm_asked(void) { return kUtrlBlocksPerSM; }

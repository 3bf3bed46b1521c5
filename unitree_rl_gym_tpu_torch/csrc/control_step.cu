// Kernels K1 and K3: the decimated physics control step on flat ground (K1)
// and on heightfield terrain (K3), a group of 8 lanes per env and four
// envs a warp, for Hopper (nvcc -gencode arch=compute_90a,code=sm_90a).
//
// Replace the JAX package's Pallas TPU kernel
// unitree_rl_gym_tpu/physics/pallas_step.py::_kernel as launched by
// control_step_pallas: K1 its flat variant (has_gh=False, has_cs=False), K3
// its terrain variant (has_gh=True, has_cs=False). Both are instances of one
// template (control_step.cuh, HAS_GH, HAS_CS = false); K2, its HAS_CS
// instances, is launched from control_step_cs.cu, a library of its own.
// K3 adds per env 68 ground heights read (272 bytes for go2) and 136 point
// coordinates written (544 bytes), both in the JAX package's [points, envs]
// row layout; its arithmetic is K1's plus the point xy of the settled
// state, and it is bound by operations as K1 is
// (physics/cuda_step.py::flops_per_env, bytes_per_env).
//
// What bounds it on this card: arithmetic and latency, not bytes. Per env
// and control step it reads about 200 bytes of state and writes about
// 1.3 KB (state, torques, 3 x 29 report-body vectors for go2), ~6 MB at
// 4096 envs: ~2 us at 3.35 TB/s. It does ~0.28 MFLOP per env (4 substeps of
// FK, RNEA, CRBA, an 18x18 Cholesky and 8 PGS sweeps over 68 points; the
// exact count is physics/cuda_step.py::flops_per_env), ~1.14 GFLOP at 4096
// envs: ~17 us at 67 TFLOP/s fp32. The operation bound is the larger.
//
// What the design does about it. The work of one env is a chain of
// dependent steps (tree recursions, a sparse Cholesky factor and two
// triangular solves per PGS sweep), most of them a handful of items wide.
// A group of 8 lanes computes one env (control_step.cuh): its 68 points, 12
// joints, 29 report bodies and 18 rows of H are spread over the lanes; the
// tree passes and the joints' part of the factor and both solves run a
// lane per chain of the tree (go2: a leg each, base alone), the base's
// dense 6 x 6 block on one lane; each env's working set (5.9 KB for K1 at
// go2's sizes, 6.2 KB for K3) lives in its slice of shared memory, and
// what one lane alone reads across phases (its points' lever arms,
// biases, gains and impulses for a substep's sweeps, the base block's
// factor) in its registers. Four envs share a warp, so a phase a few
// items wide issues once for four envs. 4096 envs are 1024 warps, eight
// an SM: the launch asks for 4 resident blocks of 8 envs (255 registers a
// thread, no spills; utrl_resident_blocks reads what the runtime grants),
// all 4096 resident at once. The outputs are the one-thread form's bits.
// PERF.md §6 holds the card times and what bounds the kernel now.
//
// Built by physics/cuda_step.py into a shared library with a plain C
// interface (loaded with ctypes): no PyTorch headers in the build.
#include <cuda_runtime.h>

#include "control_step.cuh"

// resident blocks per SM of the flat (terrain = 0) or terrain instance on
// the current device; a CUDA error as its negative
extern "C" int utrl_resident_blocks(int terrain) {
    return terrain ? utrl_resident_blocks_of<true, false>()
                   : utrl_resident_blocks_of<false, false>();
}

// K1. Launches on `stream` and returns the first CUDA error; synchronizes
// nothing.
extern "C" int utrl_control_step(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, void* stream) {
    return utrl_launch<false, false>(
        model, n_envs, bp, bq, q, v, target, friction, mass_scale, nullptr,
        nullptr, bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out,
        rbv_out, nullptr, stream);
}

// K3: K1's operands plus gh [NCP, n_envs] in and pxy [2*NCP, n_envs] out.
extern "C" int utrl_control_step_terrain(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* gh,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out,
    void* stream) {
    return utrl_launch<true, false>(
        model, n_envs, bp, bq, q, v, target, friction, mass_scale, gh, nullptr,
        bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out, rbv_out,
        pxy_out, stream);
}

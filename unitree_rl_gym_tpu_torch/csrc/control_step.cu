// Kernels K1 and K3: the decimated physics control step on flat ground (K1)
// and on heightfield terrain (K3), one warp per env, for Hopper
// (nvcc -gencode arch=compute_90a,code=sm_90a).
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
// What the design does about it. The one-thread-per-env form this replaces
// (1.27-1.34 ms per launch at 4096 go2 envs on an H100 80GB HBM3 at 700 W,
// ~76x the bound) put ~1 warp on each SM, every dependent operation waited
// out its latency, and its working set (255 registers and a 7.5 KB stack
// frame) lived in local memory. Here one warp computes one env: its 68
// points, 12 joints, 29 report bodies and 18 rows of H are spread over the
// 32 lanes; the tree recursions and the joints' part of the Cholesky
// factor and solves run level by level, the base's dense 6 x 6 block on
// one lane in registers (control_step.cuh); and the working set (6.2 KB for
// K1 at go2's sizes, 6.5 KB for K3) lives in the warp's slice of shared
// memory. 4096 envs are 4096 warps, ~31 per SM; the launch asks for 8
// resident blocks of 4 warps (64 registers a thread, no spills) so that
// all are resident at once and an SM switches to another env while one
// waits (utrl_resident_blocks reads what the runtime grants). The outputs
// are the one-thread form's bits. What bounds it now is each env's chain of ~800 dependent phases
// (8 PGS sweeps x 4 substeps, each a velocity pass, the point updates, the
// force pass with the per-body sums and the two triangular solves): one
// env alone takes about half the time of 4096, and the eight warps that
// share a scheduler at 4096 envs issue the rest, most of a narrow phase's
// lanes idle. Measured by chip_smoke.py (phase `time` also times 132 envs,
// one per SM); PERF.md §6 holds the card times.
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

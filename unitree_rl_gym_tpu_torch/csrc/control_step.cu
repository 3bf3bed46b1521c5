// Kernels K1 and K3: the decimated physics control step on flat ground (K1)
// and on heightfield terrain (K3), one thread per env, for Hopper
// (nvcc -gencode arch=compute_90a,code=sm_90a).
//
// Replace the JAX package's Pallas TPU kernel
// unitree_rl_gym_tpu/physics/pallas_step.py::_kernel as launched by
// control_step_pallas: K1 its flat variant (has_gh=False, has_cs=False), K3
// its terrain variant (has_gh=True, has_cs=False). Both are instances of one
// template (control_step.cuh, HAS_GH, HAS_CS = false); K2, its HAS_CS
// instances, is launched from control_step_cs.cu, a library of its own.
// K3 adds per env 68 ground heights read (272 bytes for go2) and 136 point coordinates written (544 bytes),
// both in the JAX package's [points, envs] row layout, so a warp's 32
// envs read and write 128 contiguous bytes per point; its arithmetic is
// K1's plus the point xy of the settled state, and it is bound by
// operations as K1 is (physics/cuda_step.py::flops_per_env, bytes_per_env).
//
// What bounds it on this card: arithmetic and latency, not bytes. Per env
// and control step it reads about 200 bytes of state and writes about
// 1.3 KB (state, torques, 3 x 29 report-body vectors for go2), ~6 MB at
// 4096 envs: ~2 us at 3.35 TB/s. It does ~0.3 MFLOP per env (4 substeps of
// FK, RNEA, CRBA, an 18x18 Cholesky and 8 PGS sweeps over 68 points; the
// exact count is physics/cuda_step.py::flops_per_env), ~1.14 GFLOP at 4096
// envs: ~17 us at 67 TFLOP/s fp32. The operation bound is the larger.
// The design is far from either (on an H100 80GB HBM3 at 700 W, measured by
// chip_smoke.py at 4096 go2 envs: K1 1.24-1.29 ms per launch, ~75x the
// bound; K3 1.44 ms, ~85x): one thread per env puts ~1 warp on each of the
// 132 SMs at 4096 envs, every dependent multiply-add waits out its latency,
// and the per-thread working set (H, its factor, PGS impulses of every
// point; ptxas: 255 registers and a 7.5-7.7 KB stack frame) lives in local
// memory, served from L1/L2. What the design does about that for now:
// small blocks (32 threads) so the 4096 envs spread
// over all SMs instead of queueing on a few, model tables read with
// warp-uniform indices (broadcast loads), and no global traffic beyond one
// read of each input and one write of each output. Spreading the points
// across the lanes of a warp and keeping the working set in shared memory
// is the redesign this leaves for a later change.
//
// Built by physics/cuda_step.py into a shared library with a plain C
// interface (loaded with ctypes): no PyTorch headers in the build.
#include <cuda_runtime.h>

#include "control_step.cuh"

extern "C" long long utrl_model_bytes(void) {
    return (long long)sizeof(ModelTables);
}

// K1. Launches on `stream` and returns cudaGetLastError(); synchronizes
// nothing.
extern "C" int utrl_control_step(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, void* stream) {
    if (n_envs <= 0) return 0;
    const int blocks = (n_envs + kUtrlThreads - 1) / kUtrlThreads;
    utrl_control_step_kernel<false, false>
        <<<blocks, kUtrlThreads, 0, (cudaStream_t)stream>>>(
            (const ModelTables*)model, n_envs, bp, bq, q, v, target, friction,
            mass_scale, nullptr, nullptr, bp_out, bq_out, q_out, v_out,
            tau_out, cf_out, rbp_out, rbv_out, nullptr);
    return (int)cudaGetLastError();
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
    if (n_envs <= 0) return 0;
    const int blocks = (n_envs + kUtrlThreads - 1) / kUtrlThreads;
    utrl_control_step_kernel<true, false>
        <<<blocks, kUtrlThreads, 0, (cudaStream_t)stream>>>(
            (const ModelTables*)model, n_envs, bp, bq, q, v, target, friction,
            mass_scale, gh, nullptr, bp_out, bq_out, q_out, v_out, tau_out,
            cf_out, rbp_out, rbv_out, pxy_out);
    return (int)cudaGetLastError();
}

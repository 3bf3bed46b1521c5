// Kernel K2: the decimated physics control step with a per-env contact
// stiffness, on flat ground and on heightfield terrain, a group of 8 lanes
// per env and four envs a warp, for Hopper (nvcc -gencode
// arch=compute_90a,code=sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// unitree_rl_gym_tpu/physics/pallas_step.py::_kernel as launched by
// control_step_pallas with the contact-stiffness operand (has_cs=True; the
// `cs` block of pallas_step.py:102-103, :133, :251-252), with and without
// terrain heights (has_gh). It is the HAS_CS = true pair of instances of
// the per-env template of K1 and K3 (control_step.cuh): each env reads its
// scale cs once per control step into its scratch and multiplies every
// contact point's de-penetration bias by it, after the bias's clamp to
// max_depenetration_velocity (the JAX order). With cs = 1 the product is
// exact and K2 returns K1's (or K3's) bits.
//
// What bounds it on this card: as K1, arithmetic and latency, not bytes.
// K2 adds 4 bytes in per env and one multiply per point and substep to
// K1's work (physics/cuda_step.py::flops_per_env, bytes_per_env with
// cs=True); at the go2 handstand's sizes (79 contact points, decimation 5)
// that is 0.37 MFLOP per env, 1.5 GFLOP at 4096 envs, ~23 us at 67 TFLOP/s
// fp32, against 5.9 MB of state in and out, ~2 us at 3.35 TB/s. The design
// is K1's (control_step.cu), sized for K2: its 79 points are ten a lane
// (c = lane + 8 p), each lane's kept in its registers across a substep's
// eight sweeps; ~6.3 KB of shared memory an env at 79 points
// (chip_smoke.py's phase `time_cs` prints it and the resident blocks per
// SM that the runtime grants); PERF.md §6 holds its card times beside
// the earlier one-thread-per-env and one-warp-per-env forms'.
//
// Built by physics/cuda_step.py into its own shared library with a plain C
// interface (loaded with ctypes), in parallel with control_step.cu's.
#include <cuda_runtime.h>

#include "control_step.cuh"

// resident blocks per SM of the flat (terrain = 0) or terrain instance on
// the current device; a CUDA error as its negative
extern "C" int utrl_resident_blocks(int terrain) {
    return terrain ? utrl_resident_blocks_of<true, true>()
                   : utrl_resident_blocks_of<false, true>();
}

// K2 on flat ground: K1's operands plus cstiff [n_envs]. Launches on
// `stream` and returns the first CUDA error; synchronizes nothing.
extern "C" int utrl_control_step_cs(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, void* stream) {
    return utrl_launch<false, true>(
        model, n_envs, bp, bq, q, v, target, friction, mass_scale, nullptr,
        cstiff, bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out,
        rbv_out, nullptr, stream);
}

// K2 on terrain: K3's operands plus cstiff [n_envs].
extern "C" int utrl_control_step_terrain_cs(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* gh, const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out,
    void* stream) {
    return utrl_launch<true, true>(
        model, n_envs, bp, bq, q, v, target, friction, mass_scale, gh, cstiff,
        bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out, rbv_out,
        pxy_out, stream);
}

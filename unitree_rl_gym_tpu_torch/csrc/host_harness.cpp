// Host build of the per-env body of kernels K1, K3 and K2
// (control_step.cuh), for tests on machines without a GPU: g++ -O1 -shared
// -fPIC, loaded with ctypes. It runs the kernel's warp schedule, each
// phase a loop over the 32 lanes of a warp of 32 / G envs (G lanes each),
// one warp after another, on one scratch buffer of the warp's envs at the
// card's stride and one UtrlLane per lane, both filled with NaN before
// every warp (a read of anything no phase wrote shows in the outputs). The
// last warp of an n_envs that is not a multiple of 32 / G has groups
// without an env, as on the card. -DUTRL_HOST_LANES_REVERSED runs each
// phase's lanes in reverse: the lanes of each group and the groups both.
// Never a runtime path of the port.
#include <math.h>
#include <string.h>

#include <vector>

#include "control_step.cuh"

// The instance <HAS_GH, HAS_CS> over every env; gh and cstiff may be null
// where the instance does not read them.
template <bool HAS_GH, bool HAS_CS>
static int run(const void* model, int n_envs, const float* bp, const float* bq,
               const float* q, const float* v, const float* target,
               const float* friction, const float* mass_scale, const float* gh,
               const float* cstiff, float* bp_out, float* bq_out, float* q_out,
               float* v_out, float* tau_out, float* cf_out, float* rbp_out,
               float* rbv_out, float* pxy_out) {
    const ModelTables& M = *(const ModelTables*)model;
    std::vector<float> scratch((size_t)kUtrlEnvsPerWarp * UtrlLayout<HAS_GH>::stride);
    std::vector<UtrlLane> lanes(kUtrlLanes);
    for (int n0 = 0; n0 < n_envs; n0 += kUtrlEnvsPerWarp) {
        // all bits set: NaN in every float
        memset(scratch.data(), 0xff, scratch.size() * sizeof(float));
        memset(lanes.data(), 0xff, lanes.size() * sizeof(UtrlLane));
        const UtrlWarp<HAS_GH> w{scratch.data(), lanes.data(), n0};
        utrl_control_step_warp<HAS_GH, HAS_CS>(
            M, w, n_envs, bp, bq, q, v, target, friction, mass_scale, gh,
            cstiff, bp_out, bq_out, q_out, v_out, tau_out, cf_out, rbp_out,
            rbv_out, pxy_out);
    }
    return 0;
}

// K1's body.
extern "C" int utrl_control_step_host(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out) {
    return run<false, false>(model, n_envs, bp, bq, q, v, target, friction,
                             mass_scale, nullptr, nullptr, bp_out, bq_out,
                             q_out, v_out, tau_out, cf_out, rbp_out, rbv_out,
                             nullptr);
}

// K3's body: gh [NCP, n_envs] in, pxy [2*NCP, n_envs] out.
extern "C" int utrl_control_step_terrain_host(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* gh,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out) {
    return run<true, false>(model, n_envs, bp, bq, q, v, target, friction,
                            mass_scale, gh, nullptr, bp_out, bq_out, q_out,
                            v_out, tau_out, cf_out, rbp_out, rbv_out, pxy_out);
}

// K2's body on flat ground: cstiff [n_envs] in.
extern "C" int utrl_control_step_cs_host(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out) {
    return run<false, true>(model, n_envs, bp, bq, q, v, target, friction,
                            mass_scale, nullptr, cstiff, bp_out, bq_out, q_out,
                            v_out, tau_out, cf_out, rbp_out, rbv_out, nullptr);
}

// K2's body on terrain: gh and cstiff in, pxy out.
extern "C" int utrl_control_step_terrain_cs_host(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* gh, const float* cstiff,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out) {
    return run<true, true>(model, n_envs, bp, bq, q, v, target, friction,
                           mass_scale, gh, cstiff, bp_out, bq_out, q_out,
                           v_out, tau_out, cf_out, rbp_out, rbv_out, pxy_out);
}

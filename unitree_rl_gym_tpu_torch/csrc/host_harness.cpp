// Host build of the per-env body of kernels K1 and K3 (control_step.cuh),
// for tests on machines without a GPU: g++ -O1 -shared -fPIC, loaded with
// ctypes. It runs the same arithmetic as the CUDA kernels, one env after
// another. Never a runtime path of the port.
#include "control_step.cuh"

extern "C" long long utrl_model_bytes(void) {
    return (long long)sizeof(ModelTables);
}

extern "C" int utrl_control_step_host(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out) {
    const ModelTables& M = *(const ModelTables*)model;
    for (int n = 0; n < n_envs; ++n)
        utrl_control_step_env<false>(M, n, n_envs, bp, bq, q, v, target,
                                     friction, mass_scale, nullptr, bp_out,
                                     bq_out, q_out, v_out, tau_out, cf_out,
                                     rbp_out, rbv_out, nullptr);
    return 0;
}

// K3's body: gh [NCP, n_envs] in, pxy [2*NCP, n_envs] out.
extern "C" int utrl_control_step_terrain_host(
    const void* model, int n_envs,
    const float* bp, const float* bq, const float* q, const float* v,
    const float* target, const float* friction, const float* mass_scale,
    const float* gh,
    float* bp_out, float* bq_out, float* q_out, float* v_out, float* tau_out,
    float* cf_out, float* rbp_out, float* rbv_out, float* pxy_out) {
    const ModelTables& M = *(const ModelTables*)model;
    for (int n = 0; n < n_envs; ++n)
        utrl_control_step_env<true>(M, n, n_envs, bp, bq, q, v, target,
                                    friction, mass_scale, gh, bp_out, bq_out,
                                    q_out, v_out, tau_out, cf_out, rbp_out,
                                    rbv_out, pxy_out);
    return 0;
}

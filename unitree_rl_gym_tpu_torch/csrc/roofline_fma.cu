// The fp32 FMA probe of scripts/roofline.py, for Hopper (nvcc -gencode
// arch=compute_90a,code=sm_90a): y[i] = x[i] after outer x UTRL_FMA_INNER
// dependent fused multiply-adds acc = fmaf(acc, a, b), one thread an
// element.
//
// Counterpart of the JAX package's roofline.vpu_f32
// (unitree_rl_gym_tpu/scripts/roofline.py:114), a jnp chain that XLA fuses
// into one loop on the TPU's vector unit. torch's eager ops cannot fuse it:
// each multiply and add would be a pass over HBM, and the probe would
// measure bandwidth. Here every element's chain stays in a register, so
// the kernel reads 4 bytes and writes 4 bytes an element for 2 * outer *
// UTRL_FMA_INNER flops: it is bound by the FP32 pipes (H100 SXM: 132 SMs x
// 128 lanes x 2 flops a cycle). fmaf is one instruction whatever -fmad is
// set to, and a, b and outer are run-time values, so the compiler can
// neither contract nor fold the chain; each output depends on all of it.
// The inner loop is unrolled whole and the outer by 16, so the loop's own
// instructions take ~2% of the issue slots. 256 threads a block; a grid of
// n / 256 blocks (4M elements: 16384 blocks, ~16 waves of the 132 SMs at 8
// resident blocks each).
//
// Built by physics/cuda_step.py::build_source into a shared library with a
// plain C interface (loaded with ctypes).
#include <cuda_runtime.h>

#ifndef UTRL_FMA_INNER
#define UTRL_FMA_INNER 8
#endif

__global__ void __launch_bounds__(256) utrl_fma_chain_kernel(
    const float* __restrict__ x, float* __restrict__ y, long long n,
    int outer, float a, float b) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float acc = x[i];
#pragma unroll 16
    for (int o = 0; o < outer; ++o) {
#pragma unroll
        for (int k = 0; k < UTRL_FMA_INNER; ++k) acc = fmaf(acc, a, b);
    }
    y[i] = acc;
}

extern "C" int utrl_fma_inner() { return UTRL_FMA_INNER; }

// Launches on `stream` and returns the first CUDA error; synchronizes
// nothing.
extern "C" int utrl_fma_chain(const float* x, float* y, long long n, int outer,
                              float a, float b, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    utrl_fma_chain_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(x, y, n, outer, a, b);
    return (int)cudaGetLastError();
}

"""Measured single-card roofline of the H100 (counterpart of
``unitree_rl_gym_tpu/scripts/roofline.py``, which measures a TPU's MXU, VPU
and HBM):

    python -m unitree_rl_gym_tpu_torch.scripts.roofline

Measures, on the card, the rates the port's hot paths consume, each from a
loop of dependent operations timed with CUDA events after a warm-up:

  * dispatch:   one tiny kernel launch and its ``torch.cuda.synchronize()``
                (host clock), the overhead every eager op and launch pays;
  * gemm_bf16:  8192 x 8192 bf16 ``torch.matmul``, 4 chained (tensor cores);
  * gemm_thin:  the PPO update's matmul chain at its real shapes, go2's
                minibatch 24576 x [48 -> 512 -> 256 -> 128 -> 12] in bf16
                with a 12 -> 48 fold-back (not counted) so the 32 rounds
                depend on each other, as eager torch ops launch it;
  * fma_f32:    256 x 8 dependent fp32 FMAs on each element of a 2048 x 2048
                array: the hand-written kernel ``csrc/roofline_fma.cu``
                (:func:`fma_chain`; torch's eager ops would make each FMA a
                pass over HBM), the physics kernels' resource;
  * hbm:        a 256 MB fp32 array read and written 16 times (in-place add).

Prints one JSON object with the rates and the H100 SXM data sheet's
figures beside them. :func:`fma_chain` on a CPU tensor runs its plain
version (:func:`fma_chain_plain`, the same chain in torch ops); on a CUDA
tensor it launches the kernel (built at first use by ``cuda_step``'s build
machinery) and counts the launch in :data:`LAUNCHES_FMA`.
"""

import ctypes
import functools
import json
import time

import torch

from unitree_rl_gym_tpu_torch import resolve_device

# H100 SXM data sheet (NVIDIA, 700 W): fp32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
DATASHEET_H100_SXM = {"fp32_tflops": 67.0, "bf16_dense_tflops": 989.0,
                      "hbm_gbps": 3350.0}
GEMM_N, GEMM_K = 8192, 4
THIN_MB, THIN_DIMS, THIN_K = 24576, (48, 512, 256, 128, 12), 32
FMA_SHAPE, FMA_OUTER, FMA_INNER = (2048, 2048), 256, 8
FMA_A, FMA_B = 1.000001, 1e-6
HBM_N, HBM_K = 256 * 1024 * 1024 // 4, 16   # 256 MB of fp32
FMA_SOURCE = "roofline_fma.cu"

# kernel launches since the last reset (chip_smoke.py zeroes it around the
# path it drives)
LAUNCHES_FMA = 0


def gemm_flops(n=GEMM_N, k=GEMM_K):
    return k * 2 * n ** 3


def thin_flops(mb=THIN_MB, dims=THIN_DIMS, k=THIN_K):
    """The chain's counted flops: the forward layers, not the fold-back."""
    return k * sum(2 * mb * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def fma_flops(shape=FMA_SHAPE, outer=FMA_OUTER, inner=FMA_INNER):
    n = 1
    for d in shape:
        n *= d
    return 2 * outer * inner * n


def fma_bytes(shape=FMA_SHAPE):
    """Each fp32 input element read once and each output written once."""
    n = 1
    for d in shape:
        n *= d
    return 2 * 4 * n


def hbm_bytes(n=HBM_N, k=HBM_K):
    """k passes, each reading and writing n fp32 elements."""
    return k * 2 * n * 4


@functools.cache
def _fma_library():
    """The probe's library, built (or found by the hash of its source) and
    loaded once per process."""
    from unitree_rl_gym_tpu_torch.physics import cuda_step

    lib = ctypes.CDLL(cuda_step.build_source((FMA_SOURCE,), cuda_step.NVCC_FLAGS,
                                             "roofline_fma"))
    lib.utrl_fma_inner.restype = ctypes.c_int
    lib.utrl_fma_inner.argtypes = []
    lib.utrl_fma_chain.restype = ctypes.c_int
    lib.utrl_fma_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return lib


def fma_chain_plain(x, outer=FMA_OUTER, a=FMA_A, b=FMA_B):
    """The plain version: ``outer`` x 8 rounds of ``acc = acc * a + b`` in
    torch ops, each round rounded to float32 once as ``fmaf`` rounds it
    (float64 holds the product of two float32 values exactly; a multiply
    and an add each rounded to float32 would drift from the kernel by up to
    2.4e-4 over the 2048 rounds)."""
    a, b = float(torch.tensor(a, dtype=torch.float32)), float(torch.tensor(b, dtype=torch.float32))
    acc = x
    for _ in range(outer * FMA_INNER):
        acc = (acc.double() * a + b).float()
    return acc


def fma_chain(x, outer=FMA_OUTER, a=FMA_A, b=FMA_B):
    """``fma_chain_plain`` with each round one fused multiply-add: the plain
    version on a CPU tensor, the kernel on a contiguous float32 CUDA tensor
    (launched on the current stream); anything else raises."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, outer, a, b)
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fma_chain takes a contiguous float32 CUDA or CPU tensor, "
                         f"not {x.dtype} on {x.device}")
    lib = _fma_library()
    if lib.utrl_fma_inner() != FMA_INNER:
        raise RuntimeError(f"{FMA_SOURCE} was built with another UTRL_FMA_INNER")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.utrl_fma_chain(x.data_ptr(), y.data_ptr(), x.numel(), int(outer),
                                 float(a), float(b), stream)
    if err != 0:
        raise RuntimeError(f"roofline_fma launch failed: cudaError {err}")
    global LAUNCHES_FMA
    LAUNCHES_FMA += 1
    return y


def event_ms(fn, iters=8, warmup=2):
    """Device ms per call of ``fn()`` (CUDA events around ``iters`` calls
    after ``warmup``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def dispatch_overhead_ms(dev, iters=16):
    """Host ms of one tiny launch and its synchronise."""
    x = torch.zeros((8, 128), device=dev)
    for _ in range(4):
        x.add_(1.0)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        x.add_(1.0)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def gemm_bf16(dev):
    """(TFLOP/s, ms a call) of GEMM_K chained square bf16 matmuls."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((GEMM_N, GEMM_N), device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn((GEMM_N, GEMM_N), device=dev, generator=g).to(torch.bfloat16)

    def mm():
        y = a
        for _ in range(GEMM_K):
            y = torch.matmul(y, b)
        return y

    ms = event_ms(mm)
    return gemm_flops() / (ms * 1e-3) / 1e12, ms


def gemm_thin(dev):
    """(TFLOP/s, ms a call) of THIN_K rounds of the update's matmul chain."""
    g = torch.Generator(device=dev).manual_seed(1)
    d = THIN_DIMS
    ws = [(0.01 * torch.randn((d[i], d[i + 1]), device=dev, generator=g)).to(torch.bfloat16)
          for i in range(len(d) - 1)]
    w_back = (0.01 * torch.randn((d[-1], d[0]), device=dev, generator=g)).to(torch.bfloat16)
    x = torch.randn((THIN_MB, d[0]), device=dev, generator=g).to(torch.bfloat16)

    def chain():
        y = x
        for _ in range(THIN_K):
            for w in ws:
                y = y @ w
            y = y @ w_back
        return y

    ms = event_ms(chain)
    return thin_flops() / (ms * 1e-3) / 1e12, ms


def fma_input(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    return torch.rand(FMA_SHAPE, device=dev, generator=g) + 0.5


def fma_f32(dev):
    """(TFLOP/s, ms a launch) of the FMA kernel."""
    x = fma_input(dev)
    ms = event_ms(lambda: fma_chain(x))
    return fma_flops() / (ms * 1e-3) / 1e12, ms


def hbm(dev):
    """(GB/s, ms a call) of HBM_K in-place passes over 256 MB."""
    x = torch.ones((HBM_N,), device=dev)

    def stream():
        for _ in range(HBM_K):
            x.add_(1.0)

    ms = event_ms(stream)
    return hbm_bytes() / (ms * 1e-3) / 1e9, ms


def measure(dev):
    """Every rate, with the ms each probe's call took."""
    oh = dispatch_overhead_ms(dev)
    gemm, gemm_ms = gemm_bf16(dev)
    thin, thin_ms = gemm_thin(dev)
    fma, fma_ms = fma_f32(dev)
    bw, hbm_ms = hbm(dev)
    return {
        "device": torch.cuda.get_device_name(dev),
        "dispatch_overhead_ms": oh,
        "gemm_bf16_tflops": gemm,
        "gemm_thin_tflops": thin,
        "fma_f32_tflops": fma,
        "hbm_gbps": bw,
        "ms_per_call": {"gemm_bf16": gemm_ms, "gemm_thin": thin_ms,
                        "fma_f32": fma_ms, "hbm": hbm_ms},
        "datasheet_h100_sxm": DATASHEET_H100_SXM,
    }


# each measured rate and the data sheet's figure it cannot exceed
RATE_DATASHEET = {"gemm_bf16_tflops": "bf16_dense_tflops",
                  "gemm_thin_tflops": "bf16_dense_tflops",
                  "fma_f32_tflops": "fp32_tflops", "hbm_gbps": "hbm_gbps"}


def main():
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    print(json.dumps(measure(resolve_device(None))))


if __name__ == "__main__":
    main()

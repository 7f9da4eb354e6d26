// Device work of the Ocean Performance / PerformanceEmpiric envs, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX envs burn device time in a per-lane
// lax.fori_loop (pufferlib_tpu/ocean/ocean.py:243-251, :284-290) that XLA
// runs on the device with no host sync. Same function as the plain
// pufferlib_tpu_torch.ops.cuda.burn.burn_reference:
//
//   for i in 0 .. iters[lane]-1:   x[lane] = x[lane] * 1.0000001f + 1e-9f
//
// Bound: latency. Each lane's loop is a chain of dependent multiply-adds,
// so one thread a lane, the count read on the device (the host never
// learns it); the step takes as long as the largest count. Each product
// and sum is rounded on its own (__fmul_rn / __fadd_rn, no contraction
// to an FMA), as the plain version's two torch operations round, so the
// kernel gives the plain version's bits.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) burn_kernel(
        float* __restrict__ x, const int* __restrict__ iters, int n) {
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= n) return;
    float v = x[lane];
    const int k = iters[lane];
    for (int i = 0; i < k; ++i) v = __fadd_rn(__fmul_rn(v, 1.0000001f), 1e-9f);
    x[lane] = v;
}

}  // namespace

extern "C" {

// x: (n,) float32, updated in place; iters: (n,) int32, a count <= 0
// leaves its lane as it is.
int ocean_burn(float* x, const int* iters, int n, cudaStream_t stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    burn_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(x, iters, n);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

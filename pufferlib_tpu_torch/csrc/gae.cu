// Per-env GAE with bootstrap, for Hopper (sm_90a).
//
// Replaces the TPU kernel pufferlib_tpu/ops/pallas/gae.py
// (compute_gae_pallas / _gae_kernel). Same function as the plain
// pufferlib_tpu_torch.ops.gae.compute_gae:
//
//   adv[t] = delta[t] + gamma*lambda*(1-d[t]) * adv[t+1],   adv[T] = 0
//   delta[t] = r[t] + gamma*v[t+1]*(1-d[t]) - v[t],         v[T] = last_value
//
// Bound: memory. It reads 3*T*E + E floats and writes T*E floats, a few
// flops each; at the trainer's (T=64, E=8192) that is 8.4 MB, 2.5 us at
// 3.35 TB/s.
//
// Design: one thread per env lane walks t = T-1..0 with the advantage in a
// register. Lanes are contiguous in the row-major (T, E) layout, so a
// warp's loads and stores at one t are 128-byte coalesced. A thread has
// only one lane, so its loads are issued CHUNK timesteps at a time into
// registers before the dependent recurrence consumes them: with few
// threads in flight (E of them), that is what keeps enough bytes in
// flight to approach the memory rate. The ragged edge is masked (no
// padding of E to a tile, unlike the TPU's 256-lane blocks). Every
// product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction), in the plain version's order, so the kernel gives the
// plain version's bits.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 16;

__global__ void __launch_bounds__(THREADS) gae_kernel(
        const float* __restrict__ rewards, const float* __restrict__ values,
        const float* __restrict__ dones, const float* __restrict__ last_value,
        float* __restrict__ adv, int T, int E, float gamma, float gamma_lambda) {
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= E) return;
    float next_value = last_value[e];
    float carry = 0.f;
    for (int t_hi = T - 1; t_hi >= 0; t_hi -= CHUNK) {
        float r[CHUNK], v[CHUNK], d[CHUNK];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            const int t = t_hi - k;
            if (t >= 0) {
                const size_t i = (size_t)t * E + e;
                r[k] = rewards[i];
                v[k] = values[i];
                d[k] = dones[i];
            }
        }
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            const int t = t_hi - k;
            if (t >= 0) {
                const float nonterm = __fsub_rn(1.f, d[k]);
                const float delta = __fsub_rn(
                    __fadd_rn(r[k], __fmul_rn(__fmul_rn(gamma, next_value),
                                              nonterm)),
                    v[k]);
                carry = __fadd_rn(delta,
                    __fmul_rn(__fmul_rn(gamma_lambda, nonterm), carry));
                adv[(size_t)t * E + e] = carry;
                next_value = v[k];
            }
        }
    }
}

}  // namespace

extern "C" {

// rewards, values, dones, adv: (T, E) float32 row-major; last_value: (E,).
// gamma_lambda is gamma*lambda, rounded once to float by the caller.
int gae_forward(const float* rewards, const float* values, const float* dones,
                const float* last_value, float* adv, int T, int E, float gamma,
                float gamma_lambda, cudaStream_t stream) {
    if (T <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
    const int blocks = (E + THREADS - 1) / THREADS;
    gae_kernel<<<blocks, THREADS, 0, stream>>>(
        rewards, values, dones, last_value, adv, T, E, gamma, gamma_lambda);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// Design: the recurrence runs along T, so a lane's loads would wait on
// each other if a thread asked for them as it walks; instead a block owns a
// column of LANES env lanes over all of T and puts every load of the
// column in flight at once. Its warps copy the column's rows of rewards,
// values and dones into shared memory with cp.async (a row of 32 f32
// lanes is 128 contiguous bytes: 16-byte copies where E % 4 == 0 and the
// arrays are 16-byte aligned, else 4-byte ones; zeros past E). Then one
// warp walks t = T-1..0, a thread a lane, from shared memory, writing adv
// over the rewards, and every warp stores the column with coalesced
// stores. Where T is longer than TC steps, the column goes in chunks of
// TC steps in reverse through a ring of two, so that the next chunk's
// copy overlaps this chunk's recurrence and stores. (64, 8192) is 256
// blocks. Every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn, no FMA contraction), in the plain version's order, so the
// kernel gives the plain version's bits; no parallel scan over T, which
// would change the order of the sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int THREADS = 128;
constexpr int TC = 64;      // timesteps a chunk
constexpr int STAGES = 2;
constexpr int CHUNK_FLOATS = 3 * TC * LANES;  // rewards, values, dones

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 4 : 0)
                 : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) gae_kernel(
        const float* __restrict__ rewards, const float* __restrict__ values,
        const float* __restrict__ dones, const float* __restrict__ last_value,
        float* __restrict__ adv, int T, int E, float gamma, float gamma_lambda) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x;
    const int e0 = blockIdx.x * LANES;
    const int lanes = min(LANES, E - e0);
    const int chunks = (T + TC - 1) / TC;
    // chunk k holds steps lo .. hi-1, hi = T - k*TC; row t - lo of each
    // array at sm + slot*CHUNK_FLOATS + (a*TC + t - lo)*LANES
    auto fetch = [&](int k) {
        if (k < chunks) {
            float* s = sm + (k % STAGES) * CHUNK_FLOATS;
            const int hi = T - k * TC, lo = max(0, hi - TC), n = hi - lo;
            constexpr int PER_ROW = VEC ? LANES / 4 : LANES;
            for (int i = tid; i < 3 * n * PER_ROW; i += THREADS) {
                const int a = i / (n * PER_ROW), rem = i % (n * PER_ROW);
                const int row = rem / PER_ROW, l = rem % PER_ROW * (VEC ? 4 : 1);
                const float* src = a == 0 ? rewards : a == 1 ? values : dones;
                const bool ok = l < lanes;
                const float* g = ok ? src + (size_t)(lo + row) * E + e0 + l : src;
                float* d = s + (a * TC + row) * LANES + l;
                if (VEC) cp_async16(d, g, ok);
                else cp_async4(d, g, ok);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    fetch(0);
    fetch(1);

    const int lane = tid % 32;
    float next_value = tid < lanes ? last_value[e0 + tid] : 0.f;
    float carry = 0.f;
    for (int k = 0; k < chunks; ++k) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        float* s = sm + (k % STAGES) * CHUNK_FLOATS;
        const int hi = T - k * TC, lo = max(0, hi - TC), n = hi - lo;
        if (tid < 32) {
            for (int t = n - 1; t >= 0; --t) {
                const float r = s[t * LANES + lane];
                const float v = s[(TC + t) * LANES + lane];
                const float d = s[(2 * TC + t) * LANES + lane];
                const float nonterm = __fsub_rn(1.f, d);
                const float delta = __fsub_rn(
                    __fadd_rn(r, __fmul_rn(__fmul_rn(gamma, next_value), nonterm)), v);
                carry = __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lambda, nonterm), carry));
                s[t * LANES + lane] = carry;
                next_value = v;
            }
        }
        __syncthreads();
        if (VEC) {
            for (int i = tid; i < n * LANES / 4; i += THREADS) {
                const int row = i / (LANES / 4), l = i % (LANES / 4) * 4;
                if (l < lanes)
                    *reinterpret_cast<float4*>(adv + (size_t)(lo + row) * E + e0 + l) =
                        *reinterpret_cast<const float4*>(s + row * LANES + l);
            }
        } else {
            for (int i = tid; i < n * LANES; i += THREADS) {
                const int row = i / LANES, l = i % LANES;
                if (l < lanes) adv[(size_t)(lo + row) * E + e0 + l] = s[row * LANES + l];
            }
        }
        // the slot is read out: the chunk two ahead may land in it
        __syncthreads();
        fetch(k + 2);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool VEC>
int launch(const float* rewards, const float* values, const float* dones,
           const float* last_value, float* adv, int T, int E, float gamma,
           float gamma_lambda, cudaStream_t stream) {
    const int chunks = (T + TC - 1) / TC;
    const size_t smem = sizeof(float) * CHUNK_FLOATS * (chunks < STAGES ? chunks : STAGES);
    cudaError_t err = cudaFuncSetAttribute(
        gae_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (E + LANES - 1) / LANES;
    gae_kernel<VEC><<<blocks, THREADS, smem, stream>>>(
        rewards, values, dones, last_value, adv, T, E, gamma, gamma_lambda);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rewards, values, dones, adv: (T, E) float32 row-major; last_value: (E,).
// gamma_lambda is gamma*lambda, rounded once to float by the caller.
int gae_forward(const float* rewards, const float* values, const float* dones,
                const float* last_value, float* adv, int T, int E, float gamma,
                float gamma_lambda, cudaStream_t stream) {
    if (T <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
    if (E % 4 == 0 && aligned16(rewards) && aligned16(values) && aligned16(dones) &&
        aligned16(adv))
        return launch<true>(rewards, values, dones, last_value, adv, T, E, gamma,
                            gamma_lambda, stream);
    return launch<false>(rewards, values, dones, last_value, adv, T, E, gamma, gamma_lambda,
                         stream);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

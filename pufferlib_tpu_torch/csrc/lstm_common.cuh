// Device code shared by the LSTM kernels csrc/lstm_cat.cu, csrc/lstm_enc.cu,
// csrc/lstm_scan.cu and csrc/lstm_archive.cu, for Hopper (sm_90a). See
// those files for which TPU kernel each replaces and what bounds it. The
// cell kernels themselves are csrc/lstm_tc.cuh's (bf16, tensor cores) and
// csrc/lstm_f32.cuh's (f32, FMA); this file holds what they share:
//
// * device helpers: loads of f32 or bf16 values (ld), the rounding to the
//   compute dtype (to_cdt), the sigmoid, one (row, unit) of the reverse
//   step (dgates_chain), bf16 packing, and the host's launch helpers
//   (prepare, reduce, dispatch on the hidden size and compute dtype);
// * Mode: the function a bf16 cell kernel computes per step, after its
//   TPU kernel, and what follows from it (has_encoder, rounded_acts,
//   rounded_db);
// * the split-K (splitk) + reduce_partials of the bf16 backwards
//   (csrc/lstm_tc.cuh): the weight gradients dW = [x | h_prev]^T dgates
//   (and dW_enc = feats^T dpre) are contractions over K = T*B rows. The
//   TPU kernels add them into one output block across a sequential grid;
//   Hopper blocks run at once, so each block here writes the partial sum
//   of its K-split, and a second pass adds the partials in split order.
//   No atomics: the result is the same from run to run. Operands held as
//   bf16 rows (every [x | h_prev] and dgates slab) run
//   gemm_tn_splitk_ring: 128 x 128 outputs a block and a 4-stage cp.async
//   ring, so that a split reads its rows of A N / 128 times and of dg M /
//   128 times through L2 (about 0.54 GB a call at cat's 256 x 512 output
//   over 131072 rows, where 64 x 64 tiles read 1.07 GB). Sources it
//   cannot copy 16 bytes at a time (enc5's [feats | 1], feature rows of
//   odd width) keep the register-staged 64 x 64 kernel
//   gemm_tn_splitk_mma. The f32 weight gradients are lstm_f32.cuh's
//   split-K SGEMMs, added by reduce_partials too.
//
// The split-K runs on bf16 tensor cores. Products of bf16-rounded operands
// are exact in f32, so the bf16 kernels differ from the plain PyTorch
// versions only in the order of f32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace lstm {

constexpr int MAX_SMEM = 227 * 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
    return __bfloat162float(p[i]);
}

// v rounded to the compute dtype E, carried in f32
template <typename E>
__device__ __forceinline__ float to_cdt(float v) {
    if constexpr (std::is_same<E, bf16>::value)
        return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// The function a bf16 cell kernel (csrc/lstm_tc.cuh) computes per step,
// after its TPU kernel
enum Mode {
    CAT,    // gates = [x_t | h] @ [W_ih; W_hh] + b: one sum over K = D + H
    ENC,    // CAT behind the fused encoder; backward with f32 activations
            // and db from the unrounded dgates (lstm_enc._bwd_kernel)
    ENC5,   // backward only: ENC with the activations rounded to the compute
            // dtype and db from the rounded dgates (lstm_enc5._bwd_kernel)
    XP,     // gates = x_proj_t + h @ W_hh: the projection is an operand, in
            // its own dtype S (lstm._fwd_kernel, _bwd_kernel)
    FUSED,  // gates = (x_t @ W_ih + b) + h @ W_hh: two f32 sums, then added
            // (lstm._fwd_fused_kernel, _bwd_fused_kernel)
    // The archived variants (csrc/lstm_archive.cu), all behind the encoder:
    ENC2,   // FUSED whose first sum passes through the compute dtype before
            // the recurrent one is added; backward with f32 activations and
            // db from the rounded dgates (archive/lstm_enc2)
    ENC3,   // backward only: activations rounded, db from the unrounded
            // dgates (archive/lstm_enc3._bwd_kernel)
    ENC4,   // backward only: f32 activations, db from the rounded dgates
            // (archive/lstm_enc4._bwd_kernel)
    ENC6,   // backward only: ENC5's function on two half tiles per block
            // (archive/lstm_enc6._bwd_kernel)
};
__host__ __device__ constexpr bool has_encoder(int mode) {
    return mode == ENC || mode == ENC5 || mode >= ENC2;
}
// the gate activations pass through the compute dtype (a stored slab on the TPU)
__host__ __device__ constexpr bool rounded_acts(int mode) {
    return mode == ENC5 || mode == ENC3 || mode == ENC6;
}
// db sums the dgates rounded to the compute dtype, not the f32 ones
__host__ __device__ constexpr bool rounded_db(int mode) {
    return mode == ENC5 || mode == ENC2 || mode == ENC4 || mode == ENC6;
}

// One (row, unit) of the reverse step, in the order of operations of the
// TPU kernels' _bwd_kernel: the f32 dgates d (i, f, g, o) from the gate
// activations, dhv = dh + g_outs_t, c_t and c_prev. dc comes in as the
// carried dc and leaves as dc_prev.
__device__ __forceinline__ void dgates_chain(float (&d)[4], float& dc, float dhv, float ai,
                                             float af, float ag, float ao, float ct,
                                             float cp) {
    const float tc = tanhf(ct);
    const float dov = dhv * tc;
    const float dcv = dc + dhv * ao * (1.f - tc * tc);
    const float di = dcv * ag, dgg = dcv * ai, df = dcv * cp;
    d[0] = di * ai * (1.f - ai);
    d[1] = df * af * (1.f - af);
    d[2] = dgg * (1.f - ag * ag);
    d[3] = dov * ao * (1.f - ao);
    dc = dcv * af;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(float a, float b, float c, float d, float e,
                                       float f, float g, float h) {
    return make_uint4(pack2(a, b), pack2(c, d), pack2(e, f), pack2(g, h));
}

// eight bf16 from a 16-byte aligned address (i a multiple of 8)
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, size_t i) {
    return *reinterpret_cast<const uint4*>(p + i);
}

// Row k of the bf16 operand [x | h_prev] of dW = [x | h_prev]^T dgates: x
// from a (T*B, D) array, h_prev = h0 (rounded) for the first B rows, else
// the stored outs of the previous step, which is outs row k - B.
struct XHRows {
    const bf16* x;
    const float* h0;
    const bf16* outs;
    int B, D, H;
    // h0 already rounded to bf16 (B, H), where the caller has it: the ring
    // then copies those rows too; else they are rounded as they load
    const bf16* h16 = nullptr;
    // elements m .. m+7 of row k, as bf16 (m a multiple of 8; D and H
    // are multiples of 8, so the eight never straddle x and h_prev)
    __device__ __forceinline__ uint4 load8(size_t k, int m) const {
        if (m < D) return load8_bf16(x, k * D + m);
        m -= D;
        if (k >= (size_t)B) return load8_bf16(outs, (k - B) * H + m);
        const float* p = h0 + k * H + m;
        return pack8(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]);
    }
    // where the ring may copy elements m .. m+7 of row k from, or null:
    // the h0 rows without h16 go through load8
    __device__ __forceinline__ const bf16* src8(size_t k, int m) const {
        if (m < D) return x + k * D + m;
        m -= D;
        if (k >= (size_t)B) return outs + (k - B) * H + m;
        return h16 ? h16 + k * H + m : nullptr;
    }
};

// Row k of a (K, width) bf16 array
struct Rows {
    const bf16* p;
    int width;
    __device__ __forceinline__ uint4 load8(size_t k, int m) const {
        const size_t i = k * width + m;
        if (m + 8 <= width && i % 8 == 0) return load8_bf16(p, i);
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = m + q < width ? ld(p, i + q) : 0.f;
        return pack8(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
    }
    // the ring's copy source (rows whose width is a multiple of 8)
    __device__ __forceinline__ const bf16* src8(size_t k, int m) const {
        return p + k * width + m;
    }
};

// Which operand sources the ring (gemm_tn_splitk_ring) takes: bf16 rows
// that it can copy 16 bytes at a time. Others (enc5's [feats | 1],
// feature rows of odd width) keep the register-staged kernel.
template <class S>
struct RingSource : std::false_type {};
template <>
struct RingSource<Rows> : std::true_type {};
template <>
struct RingSource<XHRows> : std::true_type {};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline bool ring_serves(const Rows& r) { return r.width % 8 == 0 && aligned16(r.p); }
inline bool ring_serves(const XHRows& r) {
    return r.D % 8 == 0 && r.H % 8 == 0 && aligned16(r.x) && aligned16(r.outs) &&
           aligned16(r.h16);
}

// part[s][m][n] = sum_{k in split s} a(k, m) * bm(k, n), the splits on
// blockIdx.z, on bf16 tensor cores for bf16 operands (exact in
// bf16: the compute dtype's values): mma.sync m16n8k16 with f32
// accumulation. Tiles of TM x TN outputs, TK rows of K per stage, staged
// in shared memory as bf16 with rows padded to TP elements (144 bytes:
// the eight row addresses of an ldmatrix hit eight different 16-byte
// bank groups). Four warps, each a 32 x 32 quarter of the tile: per
// 16-row step two A fragments (16 x 16, ldmatrix.x4.trans of the [k][m]
// tile) and four B fragments (16 x 8, two ldmatrix.x4.trans of [k][n]).
constexpr int TM = 64, TN = 64, TK = 32, TP = 72;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 16 bytes, or 16 zero bytes (nothing read) when !ok
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class SA, class SB>
__global__ void __launch_bounds__(128) gemm_tn_splitk_mma(SA a, SB bm, float* __restrict__ part,
                                                          int M, int N, long long K,
                                                          long long per_split) {
    __shared__ __align__(16) bf16 as[TK][TP];
    __shared__ __align__(16) bf16 bs[TK][TP];
    const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
    const long long kb = (long long)blockIdx.z * per_split;
    const long long ke = kb + per_split < K ? kb + per_split : K;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    float acc[2][4][4] = {};
    // a thread stages VL runs of eight elements of each operand per stage,
    // fetched one stage ahead
    constexpr int VL = TK * TM / 8 / 128;
    uint4 ra[VL], rb[VL];
    const uint4 zero = make_uint4(0, 0, 0, 0);
    auto fetch = [&](long long k0) {
#pragma unroll
        for (int q = 0; q < VL; ++q) {
            const int idx = threadIdx.x + q * 128, kk = idx / (TM / 8), m8 = idx % (TM / 8) * 8;
            const long long k = k0 + kk;
            ra[q] = k < ke && m0 + m8 < M ? a.load8((size_t)k, m0 + m8) : zero;
            rb[q] = k < ke && n0 + m8 < N ? bm.load8((size_t)k, n0 + m8) : zero;
        }
    };
    fetch(kb);
    for (long long k0 = kb; k0 < ke; k0 += TK) {
#pragma unroll
        for (int q = 0; q < VL; ++q) {
            const int idx = threadIdx.x + q * 128, kk = idx / (TM / 8), m8 = idx % (TM / 8) * 8;
            *reinterpret_cast<uint4*>(&as[kk][m8]) = ra[q];
            *reinterpret_cast<uint4*>(&bs[kk][m8]) = rb[q];
        }
        __syncthreads();
        if (k0 + TK < ke) fetch(k0 + TK);
#pragma unroll
        for (int ks = 0; ks < TK; ks += 16) {
            uint32_t af[2][4], bfr[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                ldsm_x4_trans(af[i], &as[ks + lane % 8 + (lane / 16) * 8]
                                        [wm + i * 16 + (lane / 8) % 2 * 8]);
#pragma unroll
            for (int jb = 0; jb < 2; ++jb)
                ldsm_x4_trans(bfr[jb], &bs[ks + lane % 8 + (lane / 8) % 2 * 8]
                                          [wn + jb * 16 + (lane / 16) * 8]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2],
                             bfr[j / 2][(j % 2) * 2 + 1]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int m = m0 + wm + i * 16 + lane / 4 + (c / 2) * 8;
                const int n = n0 + wn + j * 8 + (lane % 4) * 2 + c % 2;
                if (m < M && n < N) part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j][c];
            }
}

// The same contraction for the card's larger tiles: RM x RN = 128 x 128
// outputs a block, eight warps of 64 x 32, so that a split reads each row
// of A N / 128 times and each row of dg M / 128 times (4 and 2 at cat's
// and fused's M = 256, N = 512; 8 and 4 on the 64 x 64 tiles above). The
// operands stream through a ring of RSTAGES stages of RK rows of K in
// dynamic shared memory ([k][m] and [k][n], rows padded to RP against bank
// conflicts), filled by cp.async RSTAGES - 1 stages ahead of the products,
// one barrier a stage. An operand row that is not bf16 in device memory
// (h0 in f32, where the caller has no rounded copy) is rounded through
// registers into its place in the stage. Every split starts at a multiple
// of RK (splitk_per_split), so only the last stage of the last split is
// short; rows past K and columns past M or N stage as zeros.
constexpr int RM = 128, RN = 128, RK = 32, RSTAGES = 4, RTHREADS = 256, RP = RM + 8;
static_assert(RM == RN, "one padded row width for both operands");
constexpr size_t RING_SMEM = sizeof(bf16) * RSTAGES * 2 * RK * RP;

template <class S>
__device__ __forceinline__ void ring_stage8(bf16* dst, const S& src, size_t k, int m, bool ok) {
    const bf16* p = ok ? src.src8(k, m) : nullptr;
    if (p)
        cp_async16(dst, p);
    else
        *reinterpret_cast<uint4*>(dst) = ok ? src.load8(k, m) : make_uint4(0, 0, 0, 0);
}

template <class SA, class SB>
__global__ void __launch_bounds__(RTHREADS, 2)
    gemm_tn_splitk_ring(SA a, SB bm, float* __restrict__ part, int M, int N, long long K,
                        long long per_split) {
    extern __shared__ __align__(16) unsigned char smem_ring[];
    bf16* ring = reinterpret_cast<bf16*>(smem_ring);  // RSTAGES x (A (RK, RP), B (RK, RP))
    const int m0 = blockIdx.x * RM, n0 = blockIdx.y * RN;
    const long long kb = (long long)blockIdx.z * per_split;
    const long long ke = kb + per_split < K ? kb + per_split : K;
    const int steps = kb < ke ? (int)((ke - kb + RK - 1) / RK) : 0;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4 * 64, wn = warp % 4 * 32;
    float acc[4][4][4] = {};
    // every call commits a group, empty past the last step, so that
    // cp_async_wait<RSTAGES - 2> finds the stage about to be multiplied
    // complete
    auto load = [&](int step) {
        if (step < steps) {
            bf16* as = ring + (size_t)(step % RSTAGES) * 2 * RK * RP;
            bf16* bs = as + RK * RP;
            const long long k0 = kb + (long long)step * RK;
#pragma unroll
            for (int q = 0; q < RK * RM / 8 / RTHREADS; ++q) {
                const int i = threadIdx.x + q * RTHREADS, kk = i / (RM / 8), c = i % (RM / 8) * 8;
                const long long k = k0 + kk;
                ring_stage8(as + kk * RP + c, a, (size_t)k, m0 + c, k < ke && m0 + c < M);
                ring_stage8(bs + kk * RP + c, bm, (size_t)k, n0 + c, k < ke && n0 + c < N);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < RSTAGES - 1; ++s) load(s);
    for (int step = 0; step < steps; ++step) {
        cp_async_wait<RSTAGES - 2>();
        // every thread is past the stage before: its slot may be filled again
        __syncthreads();
        load(step + RSTAGES - 1);
        const bf16* as = ring + (size_t)(step % RSTAGES) * 2 * RK * RP;
        const bf16* bs = as + RK * RP;
#pragma unroll
        for (int ks = 0; ks < RK; ks += 16) {
            uint32_t af[4][4], bfr[2][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldsm_x4_trans(af[i], as + (ks + lane % 8 + (lane / 16) * 8) * RP + wm + i * 16 +
                                         (lane / 8) % 2 * 8);
#pragma unroll
            for (int jb = 0; jb < 2; ++jb)
                ldsm_x4_trans(bfr[jb], bs + (ks + lane % 8 + (lane / 8) % 2 * 8) * RP + wn +
                                           jb * 16 + (lane / 16) * 8);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2],
                             bfr[j / 2][(j % 2) * 2 + 1]);
        }
    }
    cp_async_wait<0>();
    // N is a multiple of 8, so a pair of columns is in or out together
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = m0 + wm + i * 16 + lane / 4 + half * 8;
                const int n = n0 + wn + j * 8 + (lane % 4) * 2;
                if (m < M && n < N)
                    *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + m) * N + n) =
                        make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
            }
}

// Rows of K a split of the ring takes: ceil(K / splits) rounded up to a
// whole stage (lstm_common.splitk_ranges in python); the last splits may
// be short or empty (an empty split writes zeros)
inline long long ring_per_split(long long K, int splits) {
    const long long per = (K + splits - 1) / splits;
    return (per + RK - 1) / RK * RK;
}

// out[i] = sum_{s < S} part[s][i], added in order s = 0 .. S-1
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int S, long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int p = 0; p < S; ++p) s += part[(size_t)p * n + i];
        out[i] = s;
    }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
    if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

inline cudaError_t reduce(const float* part, float* out, int S, long long n,
                          cudaStream_t stream) {
    long long blocks = (n + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    reduce_partials<<<(int)blocks, 256, 0, stream>>>(part, out, S, n);
    return cudaGetLastError();
}

// dW = a^T bm of bf16 operands on the tensor cores, through the ring where
// both sources can be copied 16 bytes at a time (gemm_tn_splitk_ring, 128
// x 128 tiles) and else register-staged (gemm_tn_splitk_mma, 64 x 64).
// Then the partials added in split order. (f32 weight gradients run
// lstm_f32.cuh's split-K SGEMM.)
template <class SA, class SB>
cudaError_t splitk(SA a, SB bm, float* part, float* out, int M, int N, long long K,
                   int splits, cudaStream_t stream) {
    if (splits < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    bool ring = false;
    if constexpr (RingSource<SA>::value && RingSource<SB>::value) {
        if ((ring = M % 8 == 0 && N % 8 == 0 && ring_serves(a) && ring_serves(bm))) {
            auto kernel = gemm_tn_splitk_ring<SA, SB>;
            if ((err = prepare(kernel, RING_SMEM)) != cudaSuccess) return err;
            const dim3 rgrid((M + RM - 1) / RM, (N + RN - 1) / RN, splits);
            kernel<<<rgrid, RTHREADS, RING_SMEM, stream>>>(a, bm, part, M, N, K,
                                                          ring_per_split(K, splits));
        }
    }
    if (!ring) {
        const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN, splits);
        gemm_tn_splitk_mma<SA, SB><<<grid, 128, 0, stream>>>(a, bm, part, M, N, K,
                                                            (K + splits - 1) / splits);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return reduce(part, out, splits, (long long)M * N, stream);
}

// The hidden sizes a family's kernels are built for
template <int... Hs>
struct Hidden {};
// every family's, in both dtypes
using KernelHidden = Hidden<32, 64, 128>;

// Fn<H, E>::run(args...) for the runtime H among Hs, else
// cudaErrorInvalidValue
template <template <int, typename> class Fn, typename E, int... Hs, typename... Args>
int dispatch_over(Hidden<Hs...>, int H, Args... args) {
    int err = (int)cudaErrorInvalidValue;
    (void)((H == Hs && (err = (int)Fn<Hs, E>::run(args...), true)) || ...);
    return err;
}

// dispatch on the hidden size and the compute dtype: bf16 at KernelHidden,
// f32 at F32 (KernelHidden, but for cat's f32 pair, csrc/lstm_cat.cu,
// which adds 256)
template <template <int, typename> class Fn, class F32 = KernelHidden, typename... Args>
int dispatch(int H, int bf16_cdt, Args... args) {
    return bf16_cdt ? dispatch_over<Fn, bf16>(KernelHidden{}, H, args...)
                    : dispatch_over<Fn, float>(F32{}, H, args...);
}

}  // namespace lstm

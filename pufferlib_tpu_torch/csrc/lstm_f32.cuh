// The resident f32 pairs of enc5 (csrc/lstm_enc.cu), cat (csrc/lstm_cat.cu)
// and lstm_scan_fused (csrc/lstm_scan.cu) for Hopper (sm_90a): the products
// that do not depend on h run as FMA SGEMMs over all T*B rows outside the
// time loop, and the loop keeps W_hh on chip for all T steps in a thread
// block cluster. Replaces, in f32, the same TPU kernels as those files:
// lstm_enc._impl (the forward of enc5 and lstm_scan_enc) and
// lstm_enc5._hoisted_bwd, lstm_cat._impl and lstm_cat._bwd, and lstm.py's
// _lstm_fused_impl and _lstm_fused_bwd. Products are f32 FMAs only (no
// TF32): the tensor cores have no exact f32 product. Cat is enc5 without
// the encoder, fused is cat with its sums split in two (TWO_SUMS below):
// all three pairs run the pieces below (cell_forward, cell_backward), enc5
// behind its encoder SGEMM and with dx under the relu mask. The archived
// enc2's pair (csrc/lstm_archive.cu; the TPU kernels archive/lstm_enc2._impl
// and _bwd) is enc5's with fused's two sums (enc5_forward<H, true>,
// enc5_backward<H, true>). Mode XP (lstm_scan, csrc/lstm_scan.cu, TPU
// kernels lstm.py's _lstm_fwd_impl and _lstm_scan_bwd; the archived tm,
// csrc/lstm_archive.cu, TPU kernels archive/lstm_tm._fwd_impl_tm and
// _lstm_tm_bwd, one step a launch) is fused's pair with the projection
// x_proj given: the forward (xp_forward) is fused's loop with x_proj as
// its slab and no SGEMM; in the backward (xp_backward_steps) the pre-pass
// adds x_proj in place of the kept slab, the loop's dgates are dx_proj,
// and there is no dx, W_ih or db.
//
// Bound: at T = 16, B = 8192, D = H = 128 the cat forward does 34.4 GFLOP
// and its backward 103.1 (enc5 with F = 49: 36.0 and 106.4), against
// 0.1-0.3 GB of device memory: bound by operations at 67 TFLOP/s (0.513
// and 1.539 ms; enc5 0.537 and 1.588). Cat's backward from the kept slab
// needs 85.9 GFLOP and 0.27 GB more read: 1.282 ms; fused's function has
// cat's bounds (0.513 and 1.539 ms; 1.282 from its kept slab). Mode XP's
// forward does the recurrent product's 17.2 GFLOP once against 0.2-0.3 GB
// (x_proj in, outs and cseq out): 0.256 ms; its backward does it three
// times (the gate recompute, dh_prev, dW_hh) against 0.8 GB: 0.769 ms. At
// memory's shape (T 8, B 512, F 1) enc5's bounds are 0.016 and 0.048 ms,
// and a step of the loop's latency (a barrier, the cell math) sets the
// time.
//
// Forward (cell_forward; enc5_forward runs the encoder first):
// 0. enc5 only: the encoder xs = relu(feats @ W_enc + b_enc), one SGEMM
//    over T*B rows; x below is xs;
// 1. xw = x @ W_ih, an SGEMM into a (T*B, 4H) f32 slab (TWO_SUMS, fused
//    and enc2: xw = x @ W_ih + b, the bias added in the SGEMM's epilogue);
// 2. forward_loop: a cluster of CS = H / U blocks owns R batch rows (U =
//    32 or 64 units a block and RT = 4 or 16 rows a thread, picked from B:
//    plan; at H 256, which cat's pair alone is built for, U 32 and RT 4 in
//    clusters of 8 blocks, the portable maximum, of 9 row groups: R 36);
//    block `rank` holds the
//    four gate columns of units rank*U .. rank*U+U-1 of W_hh in shared
//    memory (4 U H floats: 128 KiB at U 64, H 128 and at U 32, H 256) for
//    all T steps, and every block holds the whole h_t of its R rows. Each
//    step a
//    thread starts its sums from the slab, adds h @ W_hh and b, updates
//    c and h of its unit for RT rows, and writes h into every block of the
//    cluster through distributed shared memory; one cluster barrier a
//    step orders those writes before the next step's reads (h is double
//    buffered). Each sum is the one-sum-over-K order of the TPU kernels: x
//    over k < D from zero (the slab), then h over k < H, then the bias.
//    TWO_SUMS keeps fused's (and enc2's) two sums, as their TPU kernels
//    do: h @ W_hh from zero, then the slab (x @ W_ih + b) added to it; the
//    next step's slab is then read during the cell math and the exchange,
//    not during the product. Mode XP's forward
//    (xp_forward) is this TWO_SUMS loop alone, x_proj (f32 or bf16) its
//    slab, over steps [t0, t1): the whole sequence, or tm's one step a
//    launch, W_hh staged into shared memory by every launch;
// Backward (cell_backward; enc5_backward recomputes the encoder first and
// adds [dW_enc; db_enc] last), tc::backward's hoisted schedule on FMA:
// 1. a pre-pass: acts = act([x | h_prev] @ [W_ih; W_hh] + b), one SGEMM
//    whose epilogue applies the sigmoids and tanh, into a (T*B, 4H) slab;
//    cat keeps the forward's xw (autograd saves it) and starts each sum
//    from it, continuing over h_prev @ W_hh alone: half the FMAs, the
//    same chain of sums, the same bits; fused (TWO_SUMS) keeps its xw too
//    and sums h_prev @ W_hh from zero, the epilogue adding the slab before
//    the activations: the forward loop's sums, the same bits;
// 2. backward_loop: the same clusters walk t = T-1 .. 0; a thread makes
//    the dgates of its unit and RT rows from the activations (dgates_chain)
//    and sums db, then each block forms the partial dh_prev of every unit
//    over its own 4 U gate columns (W_hh^T's slice held for all T steps)
//    and writes each unit's partial into the block that owns the unit;
//    that block adds the CS partials in rank order. Two cluster barriers a
//    step: the dgates complete and every partial read, then the partials
//    written;
// 3. dx = dg @ W_ih^T, an SGEMM (enc5: dpre, with the relu mask as its
//    epilogue; at few row tiles split over K, the partials added in split
//    order, under the mask for enc5);
// 4. [dW_ih; dW_hh] = [x | h_prev]^T dg (and enc5's [dW_enc; db_enc] =
//    [feats | 1]^T dpre), split-K SGEMMs whose partials are added in split
//    order; db the ordered sum of the loop blocks' partials. No atomics:
//    two runs give the same bits.
// Mode XP (xp_backward_steps) runs 1 with x_proj as the slab, its
// activations written into the f32 dgates' own storage (dx_proj, or with
// bf16 x_proj an f32 scratch rounded into dx_proj after the loop), 2 with
// no db and the dgates written over the activations, and 4 for dW_hh
// alone; the time-major tm runs 2 one step a launch, the pre-pass with the
// first and dW_hh with the last.
//
// The SGEMM (sgemm): 128 x 128 outputs a block, 256 threads of 8 x 8,
// two blocks an SM (128 registers a thread; a few bytes spill), K in
// stages of 16 through a four-stage cp.async ring (feats, whose rows are
// not 16-byte chunks, four bytes a copy). Each output is one f32 FMA
// chain over K in order.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>

#include "lstm_common.cuh"

namespace lstm {
namespace f32 {

namespace cg = cooperative_groups;

// SMs of the current device
inline int sm_count() {
    static int n = 0;
    if (!n) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

// ---------------------------------------------------------------- SGEMM

constexpr int SBM = 128, SBN = 128, SBK = 16, SSTAGES = 4, STHREADS = 256;
constexpr int SAP = SBK + 4;             // row stride of an A tile staged [m][k]
constexpr int S_A = SBM * SAP;           // floats of an A stage ([m][k], or [k][m]: 2048)
constexpr int S_B = SBK * SBN;           // floats of a B stage ([k][n])
constexpr size_t SGEMM_SMEM = sizeof(float) * SSTAGES * (S_A + S_B);
static_assert(SBK * SBM <= S_A, "a [k][m] stage fits an A slot");

// four bytes from global to shared memory, asynchronously (cp.async's
// group, as the 16-byte copies)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// A row-major f32 matrix whose rows are whole 16-byte chunks (width a
// multiple of 4, 16-byte aligned rows): staged by cp.async
struct Mat {
    static constexpr bool ASYNC = true;
    const float* p;
    int ld;
    __device__ __forceinline__ const float* chunk(long long r, int c) const {
        return p + r * ld + c;
    }
};

// [x | h_prev] of every step: row r is x row r (D wide), then h0 row r
// for r < B, else outs row r - B (H wide)
struct XH {
    static constexpr bool ASYNC = true;
    const float* x;
    const float* h0;
    const float* outs;
    int B, D, H;
    __device__ __forceinline__ const float* chunk(long long r, int c) const {
        if (c < D) return x + r * D + c;
        c -= D;
        return r < B ? h0 + r * H + c : outs + (r - B) * H + c;
    }
};

// [W_ih; W_hh] (D + H, G): row r < D of W_ih, else of W_hh
struct WCat {
    static constexpr bool ASYNC = true;
    const float* w_ih;
    const float* w_hh;
    int D, G;
    __device__ __forceinline__ const float* chunk(long long r, int c) const {
        return r < D ? w_ih + r * G + c : w_hh + (r - D) * G + c;
    }
};

// feats (rows, F) of any width and alignment, and with ONES a column of
// ones at F: staged four bytes at a time
template <bool ONES>
struct Feats {
    static constexpr bool ASYNC = false;
    const float* p;
    int F;
    __device__ __forceinline__ void stage(float* dst, long long r, int c, bool ok) const {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (ok && c + q < F)
                cp_async4(dst + q, p + r * F + c + q);
            else
                dst[q] = ok && ONES && c + q == F ? 1.f : 0.f;
        }
    }
};

// columns c .. c+3 of row r of src into dst (16-byte aligned shared
// memory) by cp.async, or zeros when !ok
template <class S>
__device__ __forceinline__ void stage4(float* dst, const S& src, long long r, int c, bool ok,
                                       const float* any) {
    if constexpr (S::ASYNC)
        cp_async16_zfill(dst, ok ? src.chunk(r, c) : any, ok);
    else
        src.stage(dst, r, c, ok);
}

// out[m][n] = epi(sum_k A(m, k) B(k, n)) over the split blockIdx.z of K:
// rows k0 = z * per_split .. min(K, k0 + per_split). A_KMAJOR: A's source
// holds A^T (row k, column m; the weight gradients' [x | h_prev]^T dg),
// else A itself (row m, column k). B's source holds B (row k, column n),
// N a multiple of 4. Tiles of 128 x 128 on blockIdx.x (m) and .y (n).
// START: each sum starts from start[m][n] ((M, N) f32; cat's gate
// recompute continuing the forward's x @ W_ih), else from zero.
template <class SA, class SB, bool A_KMAJOR, class Epi, bool START = false>
__global__ void __launch_bounds__(STHREADS, 2)
    sgemm(SA a, SB bm, Epi epi, int M, int N, long long K, long long per_split,
          const float* any, const float* __restrict__ start) {
    extern __shared__ __align__(16) float smem_sgemm[];
    const int m0 = blockIdx.x * SBM, n0 = blockIdx.y * SBN;
    const long long kb = (long long)blockIdx.z * per_split;
    const long long ke = kb + per_split < K ? kb + per_split : K;
    const int steps = kb < ke ? (int)((ke - kb + SBK - 1) / SBK) : 0;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if constexpr (START) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n = n0 + h * 64 + tx * 4;
                if (m < M && n < N) {
                    const float4 v = *reinterpret_cast<const float4*>(start + (size_t)m * N + n);
                    acc[i][4 * h] = v.x;
                    acc[i][4 * h + 1] = v.y;
                    acc[i][4 * h + 2] = v.z;
                    acc[i][4 * h + 3] = v.w;
                }
            }
        }
    }
    // every call commits a group, empty past the last step
    auto load = [&](int step) {
        if (step < steps) {
            float* as = smem_sgemm + (size_t)(step % SSTAGES) * (S_A + S_B);
            float* bs = as + S_A;
            const long long k0 = kb + (long long)step * SBK;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int idx = threadIdx.x + q * STHREADS;
                if constexpr (A_KMAJOR) {
                    const int kk = idx / (SBM / 4), c = idx % (SBM / 4) * 4;
                    stage4(as + kk * SBM + c, a, k0 + kk, m0 + c, k0 + kk < ke && m0 + c < M, any);
                } else {
                    const int mm = idx / (SBK / 4), c = idx % (SBK / 4) * 4;
                    stage4(as + mm * SAP + c, a, m0 + mm, (int)(k0 + c),
                           m0 + mm < M && k0 + c < ke, any);
                }
                const int kk = idx / (SBN / 4), c = idx % (SBN / 4) * 4;
                stage4(bs + kk * SBN + c, bm, k0 + kk, n0 + c, k0 + kk < ke && n0 + c < N, any);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < SSTAGES - 1; ++s) load(s);
    for (int step = 0; step < steps; ++step) {
        cp_async_wait<SSTAGES - 2>();
        // every thread is past the stage before: its slot may be filled again
        __syncthreads();
        load(step + SSTAGES - 1);
        const float* as = smem_sgemm + (size_t)(step % SSTAGES) * (S_A + S_B);
        const float* bs = as + S_A;
#pragma unroll
        for (int k4 = 0; k4 < SBK; k4 += 4) {
            float av[8][4];
            if constexpr (A_KMAJOR) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float4 v = *reinterpret_cast<const float4*>(
                            as + (k4 + kk) * SBM + h * 64 + ty * 4);
                        av[4 * h][kk] = v.x;
                        av[4 * h + 1][kk] = v.y;
                        av[4 * h + 2][kk] = v.z;
                        av[4 * h + 3][kk] = v.w;
                    }
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        as + ((i / 4) * 64 + ty * 4 + i % 4) * SAP + k4);
                    av[i][0] = v.x;
                    av[i][1] = v.y;
                    av[i][2] = v.z;
                    av[i][3] = v.w;
                }
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float4 b0 = *reinterpret_cast<const float4*>(bs + (k4 + kk) * SBN + tx * 4);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(bs + (k4 + kk) * SBN + 64 + tx * 4);
                const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
            }
        }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = n0 + h * 64 + tx * 4;
            if (m < M && n < N)
                epi(m, n, make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                      acc[i][4 * h + 3]),
                    blockIdx.z);
        }
    }
}

// the encoder: relu(v + b_enc), a relu that keeps a NaN as jnp.maximum
struct EpiEncoder {
    float* xs;
    const float* b_enc;
    int D;
    __device__ __forceinline__ void operator()(int m, int n, float4 v, int) const {
        float r[4] = {v.x + b_enc[n], v.y + b_enc[n + 1], v.z + b_enc[n + 2], v.w + b_enc[n + 3]};
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q] = r[q] < 0.f ? 0.f : r[q];  // keeps a NaN
        *reinterpret_cast<float4*>(xs + (size_t)m * D + n) = make_float4(r[0], r[1], r[2], r[3]);
    }
};

// v, or with a non-null b (fused's projection) v + b
struct EpiStore {
    float* out;
    int ld;
    const float* b;
    __device__ __forceinline__ void operator()(int m, int n, float4 v, int) const {
        if (b) v = make_float4(v.x + b[n], v.y + b[n + 1], v.z + b[n + 2], v.w + b[n + 3]);
        *reinterpret_cast<float4*>(out + (size_t)m * ld + n) = v;
    }
};

// the split z's partial sums, (splits, M, N)
struct EpiPartial {
    float* part;
    int M, N;
    __device__ __forceinline__ void operator()(int m, int n, float4 v, int z) const {
        *reinterpret_cast<float4*>(part + ((size_t)z * M + m) * N + n) = v;
    }
};

// the gate activations i, f, g, o of v + b, or with a non-null slab ((M,
// 4H) in S: fused's kept x @ W_ih + b, or mode XP's x_proj, f32 or bf16)
// of slab + v, as the TWO_SUMS forward loop adds them
template <typename S = float>
struct EpiActs {
    float* acts;
    const float* b;
    int H;
    const S* slab;
    __device__ __forceinline__ void operator()(int m, int n, float4 v, int) const {
        float r[4] = {v.x, v.y, v.z, v.w};
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (slab) {
            const size_t i = (size_t)m * 4 * H + n;
            if constexpr (std::is_same<S, float>::value) {
                const float4 p = *reinterpret_cast<const float4*>(slab + i);
                s[0] = p.x;
                s[1] = p.y;
                s[2] = p.z;
                s[3] = p.w;
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) s[q] = ld(slab, i + q);
            }
        }
        const bool cell = n / H == 2;  // H % 4 == 0: the four share a gate
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            r[q] = slab ? s[q] + r[q] : r[q] + b[n + q];
            r[q] = cell ? tanhf(r[q]) : sigm(r[q]);
        }
        *reinterpret_cast<float4*>(acts + (size_t)m * 4 * H + n) =
            make_float4(r[0], r[1], r[2], r[3]);
    }
};

// dx, or with a mask (enc5's encoded inputs) dpre: dx where the mask is
// positive, else 0
struct EpiDx {
    float* dx;
    const float* mask;
    int D;
    __device__ __forceinline__ void operator()(int m, int n, float4 v, int) const {
        if (mask) {
            const float4 x = *reinterpret_cast<const float4*>(mask + (size_t)m * D + n);
            v = make_float4(x.x > 0.f ? v.x : 0.f, x.y > 0.f ? v.y : 0.f, x.z > 0.f ? v.z : 0.f,
                            x.w > 0.f ? v.w : 0.f);
        }
        *reinterpret_cast<float4*>(dx + (size_t)m * D + n) = v;
    }
};

// START: the sums start from start (M, N), else from zero
template <bool A_KMAJOR, bool START = false, class SA, class SB, class Epi>
cudaError_t gemm(SA a, SB bm, Epi epi, long long M, int N, long long K, int splits,
                 const float* any, cudaStream_t stream, const float* start = nullptr) {
    auto kernel = sgemm<SA, SB, A_KMAJOR, Epi, START>;
    if (START && !start) return cudaErrorInvalidValue;
    cudaError_t err = prepare(kernel, SGEMM_SMEM);
    if (err != cudaSuccess) return err;
    const long long mt = (M + SBM - 1) / SBM;
    if (splits < 1 || mt > 0x7fffffff) return cudaErrorInvalidValue;
    const long long per_split = splits == 1 ? K : ring_per_split(K, splits);
    const dim3 grid((unsigned)mt, (N + SBN - 1) / SBN, splits);
    kernel<<<grid, STHREADS, SGEMM_SMEM, stream>>>(a, bm, epi, (int)M, N, K, per_split, any,
                                                   start);
    return cudaGetLastError();
}

// dx[i] = the split-K partials (S, n) added in split order (as
// reduce_partials), or 0 where a non-null mask[i] is not positive
__global__ void dx_sum(const float* __restrict__ part, const float* __restrict__ mask,
                       float* __restrict__ dx, int S, long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int p = 0; p < S; ++p) s += part[(size_t)p * n + i];
        dx[i] = !mask || mask[i] > 0.f ? s : 0.f;
    }
}

// dst (cols, rows) = src (rows, cols)^T
__global__ void transpose(const float* __restrict__ src, float* __restrict__ dst, int rows,
                          int cols) {
    __shared__ float tile[32][33];
    const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int r = r0 + i, c = c0 + threadIdx.x;
        if (r < rows && c < cols) tile[i][threadIdx.x] = src[(size_t)r * cols + c];
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int c = c0 + i, r = r0 + threadIdx.x;
        if (r < rows && c < cols) dst[(size_t)c * rows + r] = tile[threadIdx.x][i];
    }
}

// ---------------------------------------------------------------- loops

constexpr int LTHREADS = 256;

// Row groups of a loop block of U units at hidden size H: LTHREADS / U,
// but 9 at H 256 (288 threads, R 36 rows a cluster of 8). An H100 holds
// 15 such clusters at once (cudaOccupancyMaxActiveClusters, 132 SMs), and
// a loop's time goes by waves of them: at R 36 config.yaml's nethack and
// nmmo updates (B 512) are one wave and nmmo3's (B 1024) two, at R 32 two
// and three.
constexpr int row_groups(int H, int U) { return H > 128 ? 9 : LTHREADS / U; }

// A loop block owns U units (all four gate columns of each) of the
// cluster's R = RG * RT batch rows; thread t owns unit t % U and RT rows
// of row group t / U. A warp shares its rows (broadcast reads of h and
// dgates) and reads consecutive units' weights.
template <int H, int U, int RT>
struct Loop {
    static constexpr int CS = H / U;               // blocks of a cluster
    static constexpr int RG = row_groups(H, U);    // row groups
    static constexpr int THREADS = RG * U;         // threads of a block
    static_assert(H % U == 0 && U % 32 == 0 && RT % 4 == 0, "the loop's tiling");
    static_assert(CS <= 8, "clusters of at most eight blocks (the portable size)");
    static constexpr int R = RG * RT;              // rows of a cluster
    static constexpr int G = 4 * H;
    static constexpr int HP = H + 4;               // row stride of an h buffer
    static constexpr int KL = 4 * U;               // a block's gate columns
    static constexpr int KP = KL + 4;              // row stride of its dgates tile
    // forward: W_hh's columns of the block's units (H, U, 4 gates), two
    // (R, HP) h buffers
    static constexpr int FWD_W = H * U * 4, FWD_H = R * HP;
    static constexpr size_t FWD_SMEM = sizeof(float) * (FWD_W + 2 * FWD_H);
    // backward: W_hh^T's rows of the block's gate columns (KL, U, CS), the
    // dgates (R, KP), a partial dh_prev from each rank (CS, R, U)
    static constexpr int BWD_W = KL * U * CS, BWD_DG = R * KP, BWD_P = CS * R * U;
    static constexpr size_t BWD_SMEM = sizeof(float) * (BWD_W + BWD_DG + BWD_P);
    static_assert(FWD_SMEM <= (size_t)MAX_SMEM && BWD_SMEM <= (size_t)MAX_SMEM, "shared memory");
};

// v[g][i] = slab[t][row0 + r0 + i][g * H + u] in f32 (a bf16 slab widened,
// which is exact), zero past the batch edge
template <int H, int RT, typename S = float>
__device__ __forceinline__ void load_gates(float (&v)[4][RT], const S* __restrict__ slab,
                                           int t, int B, int row0, int r0, int nrows, int u) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const bool ok = r0 + i < nrows;
        const S* p = slab + ((size_t)t * B + row0 + r0 + i) * 4 * H + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) v[g][i] = ok ? ld(p, (size_t)g * H) : 0.f;
    }
}

// xw: (T*B, 4H) f32, x_t @ W_ih of every step (the sums over k < D),
// which each step's sums continue over h, then b; TWO_SUMS: x_t @ W_ih + b
// (mode XP: x_proj, in S, f32 or bf16), added to h @ W_hh summed from zero
// (b unused). A null cseq skips its store. The grid is whole clusters of
// CS blocks along x, cluster blockIdx.x / CS taking rows R * (blockIdx.x /
// CS) onwards.
template <int H, int U, int RT, bool TWO_SUMS = false, typename S = float>
__global__ void __launch_bounds__(Loop<H, U, RT>::THREADS, 1)
    forward_loop(const S* __restrict__ xw, const float* __restrict__ h0,
                 const float* __restrict__ c0, const float* __restrict__ w_hh,
                 const float* __restrict__ b, float* __restrict__ outs, float* __restrict__ cseq,
                 float* __restrict__ hT, float* __restrict__ cT, int T, int B) {
    using L = Loop<H, U, RT>;
    constexpr int CS = L::CS, R = L::R, G = L::G, HP = L::HP;
    extern __shared__ __align__(16) float smem_loop[];
    float* w_s = smem_loop;           // (H, U) float4s: the four gates of (k, unit)
    float* hb = w_s + L::FWD_W;       // two (R, HP): h of the cluster's rows
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int row0 = (int)(blockIdx.x / CS) * R;
    const int nrows = min(R, B - row0);
    const int j = threadIdx.x % U, r0 = threadIdx.x / U * RT, u = rank * U + j;
    for (int i = threadIdx.x; i < H * U; i += L::THREADS) {
        const float* w = w_hh + (size_t)(i / U) * G + rank * U + i % U;
        *reinterpret_cast<float4*>(w_s + 4 * i) = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
    }
    for (int i = threadIdx.x; i < R * H; i += L::THREADS) {
        const int r = i / H, k = i % H;
        hb[r * HP + k] = r < nrows ? h0[(size_t)(row0 + r) * H + k] : 0.f;
    }
    float bias[4] = {0.f, 0.f, 0.f, 0.f}, h[RT], c[RT], nx[4][RT];
    if constexpr (!TWO_SUMS) {
#pragma unroll
        for (int g = 0; g < 4; ++g) bias[g] = b[g * H + u];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
        c[i] = r0 + i < nrows ? c0[(size_t)(row0 + r0 + i) * H + u] : 0.f;
    load_gates<H, RT, S>(nx, xw, 0, B, row0, r0, nrows, u);
    // every block of the cluster runs, with its h0 staged, before any
    // block writes into another's shared memory
    cluster.sync();
    for (int t = 0; t < T; ++t) {
        float acc[4][RT];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RT; ++i) acc[g][i] = TWO_SUMS ? 0.f : nx[g][i];
        if (!TWO_SUMS && t + 1 < T) load_gates<H, RT, S>(nx, xw, t + 1, B, row0, r0, nrows, u);
        const float* hc = hb + (t & 1) * L::FWD_H + r0 * HP;
        // the sums over k < H continue the slab's over k < D (TWO_SUMS:
        // start from zero), k in order
#pragma unroll 2
        for (int k = 0; k < H; k += 4) {
            float4 w[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                w[kk] = *reinterpret_cast<const float4*>(w_s + ((k + kk) * U + j) * 4);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                const float4 hv = *reinterpret_cast<const float4*>(hc + i * HP + k);
                const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    acc[0][i] = fmaf(hk[kk], w[kk].x, acc[0][i]);
                    acc[1][i] = fmaf(hk[kk], w[kk].y, acc[1][i]);
                    acc[2][i] = fmaf(hk[kk], w[kk].z, acc[2][i]);
                    acc[3][i] = fmaf(hk[kk], w[kk].w, acc[3][i]);
                }
            }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RT; ++i)
                acc[g][i] = TWO_SUMS ? nx[g][i] + acc[g][i] : acc[g][i] + bias[g];
        // TWO_SUMS: the next step's slab, read during the cell math, the
        // exchange and the barrier
        if (TWO_SUMS && t + 1 < T) load_gates<H, RT, S>(nx, xw, t + 1, B, row0, r0, nrows, u);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const float ig = sigm(acc[0][i]);
            const float fg = sigm(acc[1][i]);
            const float gg = tanhf(acc[2][i]);
            const float og = sigm(acc[3][i]);
            c[i] = fg * c[i] + ig * gg;
            h[i] = og * tanhf(c[i]);
            if (r0 + i < nrows) {
                const size_t idx = ((size_t)t * B + row0 + r0 + i) * H + u;
                outs[idx] = h[i];
                if (cseq) cseq[idx] = c[i];
            }
        }
        if (t + 1 < T) {
            // h_t into every block's next buffer: a warp writes 32
            // consecutive units of a row
            float* nxt = hb + ((t + 1) & 1) * L::FWD_H + r0 * HP + u;
#pragma unroll
            for (int m = 0; m < CS; ++m) {
                float* dst = cluster.map_shared_rank(nxt, m);
#pragma unroll
                for (int i = 0; i < RT; ++i) dst[i * HP] = h[i];
            }
            // the writes visible, and every read of the buffer they
            // overwrite next step done
            cluster.sync();
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        if (r0 + i < nrows) {
            const size_t idx = (size_t)(row0 + r0 + i) * H + u;
            hT[idx] = h[i];
            cT[idx] = c[i];
        }
    }
}

// The inputs of reverse step t for rows r0 .. r0+RT-1 of unit u: the
// activations, g_outs_t, c_t and c_{t-1} (c0 at t = 0), zero past the
// batch edge
template <int H, int RT>
__device__ __forceinline__ void load_step(float (&a)[4][RT], float (&gout)[RT], float (&ct)[RT],
                                          float (&cp)[RT], const float* acts,
                                          const float* __restrict__ g_outs,
                                          const float* __restrict__ cseq,
                                          const float* __restrict__ c0, int t, int B, int row0,
                                          int r0, int nrows, int u) {
    load_gates<H, RT>(a, acts, t, B, row0, r0, nrows, u);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const bool ok = r0 + i < nrows;
        const size_t idx = ((size_t)t * B + row0 + r0 + i) * H + u;
        gout[i] = ok ? g_outs[idx] : 0.f;
        ct[i] = ok ? cseq[idx] : 0.f;
        cp[i] = !ok ? 0.f : t == 0 ? c0[(size_t)(row0 + r0 + i) * H + u] : cseq[idx - (size_t)B * H];
    }
}

// acts: (T*B, 4H) f32, the gate activations of every step (the pre-pass);
// w_hh_t: W_hh^T (4H, H). Writes dg (T*B, 4H) f32, dh0, dc0 (B, H) and,
// unless it is null, db_part row blockIdx.x / CS: the block's sums of its
// gate columns' dgates, added over the row groups in order. Clusters as
// forward_loop's. dg may be acts itself (mode XP writes the dgates over
// their activations): a thread reads an activation, in load_step, before
// it writes the dgate of that row, unit and gate, and no other thread
// reads or writes that element; hence neither pointer is __restrict__.
template <int H, int U, int RT>
__global__ void __launch_bounds__(Loop<H, U, RT>::THREADS, 1)
    backward_loop(const float* acts, const float* __restrict__ w_hh_t,
                  const float* __restrict__ c0, const float* __restrict__ cseq,
                  const float* __restrict__ g_outs, const float* __restrict__ g_hT,
                  const float* __restrict__ g_cT, float* dg,
                  float* __restrict__ dh0, float* __restrict__ dc0,
                  float* __restrict__ db_part, int T, int B) {
    using L = Loop<H, U, RT>;
    constexpr int CS = L::CS, R = L::R, G = L::G, KL = L::KL, KP = L::KP, RG = L::RG;
    extern __shared__ __align__(16) float smem_loop[];
    // (KL, U, CS): W_hh[m * U + l][column kl]; at CS 8 (KL, 2, U, 4), ranks
    // 4q .. 4q+3 in plane q, so that a warp's float4 reads are consecutive
    float* wt_s = smem_loop;
    float* dg_s = wt_s + L::BWD_W;    // (R, KP): the step's dgates of the block's columns
    float* part = dg_s + L::BWD_DG;   // (CS, R, U): rank s's partial dh_prev of my units
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int row0 = (int)(blockIdx.x / CS) * R;
    const int nrows = min(R, B - row0);
    const int j = threadIdx.x % U, rg = threadIdx.x / U, r0 = rg * RT, u = rank * U + j;
    // local column kl = g * U + jj is gate g of unit rank * U + jj
    for (int i = threadIdx.x; i < KL * U; i += L::THREADS) {
        const int kl = i / U, l = i % U;
        const float* w = w_hh_t + (size_t)((kl / U) * H + rank * U + kl % U) * H + l;
        float v[CS];
#pragma unroll
        for (int m = 0; m < CS; ++m) v[m] = w[m * U];
        float* dst = wt_s + (size_t)i * CS;
        if constexpr (CS == 8) {
            dst = wt_s + ((size_t)kl * 2 * U + l) * 4;
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<float4*>(dst + 4 * U) = make_float4(v[4], v[5], v[6], v[7]);
        } else if constexpr (CS == 4) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else if constexpr (CS == 2) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
            for (int m = 0; m < CS; ++m) dst[m] = v[m];
        }
    }
    // a step's inputs, loaded during the step before it (its product)
    float a[4][RT], gout[RT], ct[RT], cp[RT];
    float dh[RT], dc[RT];
    float db_acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const bool ok = r0 + i < nrows;
        const size_t idx = (size_t)(row0 + r0 + i) * H + u;
        dh[i] = ok ? g_hT[idx] : 0.f;
        dc[i] = ok ? g_cT[idx] : 0.f;
    }
    load_step<H, RT>(a, gout, ct, cp, acts, g_outs, cseq, c0, T - 1, B, row0, r0, nrows, u);
    cluster.sync();
    for (int t = T - 1; t >= 0; --t) {
        // dh entering step t: the ranks' partials, added in rank order
        if (t < T - 1) {
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                float s = part[(r0 + i) * U + j];
#pragma unroll
                for (int m = 1; m < CS; ++m) s += part[(m * R + r0 + i) * U + j];
                dh[i] = s;
            }
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int r = r0 + i;
            float d[4];
            dgates_chain(d, dc[i], dh[i] + gout[i], a[0][i], a[1][i], a[2][i], a[3][i], ct[i],
                         cp[i]);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                dg_s[r * KP + g * U + j] = d[g];
                if (r < nrows) {
                    dg[((size_t)t * B + row0 + r) * G + g * H + u] = d[g];
                    db_acc[g] += d[g];
                }
            }
        }
        // the dgates tile whole, and every block past its reads of part
        cluster.sync();
        if (t > 0)
            load_step<H, RT>(a, gout, ct, cp, acts, g_outs, cseq, c0, t - 1, B, row0, r0, nrows,
                             u);
        // partial dh_prev of unit m * U + j of each rank m, over this
        // block's columns in order
        float acc[CS][RT];
#pragma unroll
        for (int m = 0; m < CS; ++m)
#pragma unroll
            for (int i = 0; i < RT; ++i) acc[m][i] = 0.f;
#pragma unroll 2
        for (int kl = 0; kl < KL; kl += 4) {
            float w[4][CS];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float* p = wt_s + ((kl + kk) * U + j) * CS;
                if constexpr (CS == 8) {
                    p = wt_s + ((size_t)(kl + kk) * 2 * U + j) * 4;
                    const float4 v0 = *reinterpret_cast<const float4*>(p);
                    const float4 v1 = *reinterpret_cast<const float4*>(p + 4 * U);
                    w[kk][0] = v0.x;
                    w[kk][1] = v0.y;
                    w[kk][2] = v0.z;
                    w[kk][3] = v0.w;
                    w[kk][4] = v1.x;
                    w[kk][5] = v1.y;
                    w[kk][6] = v1.z;
                    w[kk][7] = v1.w;
                } else if constexpr (CS == 4) {
                    const float4 v = *reinterpret_cast<const float4*>(p);
                    w[kk][0] = v.x;
                    w[kk][1] = v.y;
                    w[kk][2] = v.z;
                    w[kk][3] = v.w;
                } else if constexpr (CS == 2) {
                    const float2 v = *reinterpret_cast<const float2*>(p);
                    w[kk][0] = v.x;
                    w[kk][1] = v.y;
                } else {
#pragma unroll
                    for (int m = 0; m < CS; ++m) w[kk][m] = p[m];
                }
            }
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                const float4 dv = *reinterpret_cast<const float4*>(dg_s + (r0 + i) * KP + kl);
                const float dk[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int m = 0; m < CS; ++m) acc[m][i] = fmaf(dk[kk], w[kk][m], acc[m][i]);
            }
        }
#pragma unroll
        for (int m = 0; m < CS; ++m) {
            float* dst = cluster.map_shared_rank(part, m) + (rank * R + r0) * U + j;
#pragma unroll
            for (int i = 0; i < RT; ++i) dst[i * U] = acc[m][i];
        }
        // the partials visible
        cluster.sync();
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        float s = part[(r0 + i) * U + j];
#pragma unroll
        for (int m = 1; m < CS; ++m) s += part[(m * R + r0 + i) * U + j];
        if (r0 + i < nrows) {
            const size_t idx = (size_t)(row0 + r0 + i) * H + u;
            dh0[idx] = s;
            dc0[idx] = dc[i];
        }
    }
    if (!db_part) return;
    // db: dg_s is free (the loop ended on a barrier after its last read)
    float* red = dg_s;  // (RG, KL)
#pragma unroll
    for (int g = 0; g < 4; ++g) red[rg * KL + g * U + j] = db_acc[g];
    __syncthreads();
    for (int n = threadIdx.x; n < KL; n += L::THREADS) {
        float s = 0.f;
        for (int q = 0; q < RG; ++q) s += red[q * KL + n];
        db_part[(size_t)(blockIdx.x / CS) * G + (n / U) * H + rank * U + n % U] = s;
    }
}

// ---------------------------------------------------------------- host

constexpr int FORWARD_PHASES = 2;   // (encoder +) projection, loop
constexpr int DX_MAX_SPLITS = 4;    // dx's partials fit the (T*B, 4H) activations slab
constexpr int BACKWARD_PHASES = 4;  // (encoder +) pre-pass, loop, dx, dW + db

// A loop's tiling: U units a block (clusters of H / U blocks), RT rows a
// thread. Each hidden size up to 128 has two: BIG, many rows a thread for
// large batches (the FMAs of a thread's 4 x RT sums outweigh its shared
// loads), and SMALL, few, for small ones (more clusters on the card).
// plan() picks by the model of loop_cycles. H 256 (ONE) has SMALL alone,
// clusters of 8 blocks of U 32, RT 4 and 9 row groups (row_groups: a
// forward block 201.1 KiB of shared memory, a backward one 182.6): W_hh's
// slice at U 64 (256 KiB) or RT 8's two h buffers (274 KiB a forward
// block) are past a block's shared memory. BIG names SMALL there, so no
// tiling past it is instantiated.
struct LoopConfig {
    int U, RT;
};
template <int H>
struct LoopConfigs {
    static constexpr bool ONE = H > 128;
    static constexpr int SMALL_U = 32, SMALL_RT = 4;
    static constexpr int BIG_U = ONE ? SMALL_U : H == 32 ? 32 : 64, BIG_RT = ONE ? SMALL_RT : 16;
};

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& attr, int cs, int threads,
                                         int clusters, size_t smem, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs * clusters);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cfg;
}

// clusters of the loop L's kernel the card holds at once (0 if none
// fits)
template <class L, typename Kernel>
int max_active_clusters(Kernel kernel, size_t smem) {
    if (prepare(kernel, smem) != cudaSuccess) return 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(attr, L::CS, L::THREADS, 1, smem, 0);
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

// The model's cycles of a loop over B rows and one step: whole waves of
// the clusters the card holds at once, each step of a block the larger of
// its eight warps' FMA issue (8 RT cycles a k) and shared-memory
// wavefronts (2 RT + 32 a k: h broadcast, W 512 bytes a warp) over H,
// plus the cluster barrier, the exchange and the cell math (estimated at
// 1500, 2500 and 4500 cycles for clusters of 1, 2 and 4 blocks); blocks
// that share an SM share its rate. It only ranks the two tilings of H up
// to 128: H 256 has one (clusters of 8, which it has no estimate of), and
// plan() does not call it there.
inline double loop_cycles(int H, LoopConfig c, long long B, int maxc, int sms) {
    const int cs = H / c.U, rows = LTHREADS / c.U * c.RT;
    const long long tiles = (B + rows - 1) / rows;
    const long long waves = (tiles + maxc - 1) / maxc;
    const double share = (double)(tiles < maxc ? tiles : maxc) * cs / sms;
    const double step = (double)H * (8 * c.RT > 2 * c.RT + 32 ? 8 * c.RT : 2 * c.RT + 32) +
                        (cs == 1 ? 1500 : cs == 2 ? 2500 : 4500);
    return (double)waves * (share > 1.0 ? share : 1.0) * step;
}

// The tiling of the forward or backward loop at B rows: BIG or SMALL, the
// one of fewer modelled cycles (at H 256 SMALL, the one tiling), with the
// clusters it may hold at once (cudaOccupancyMaxActiveClusters, kept per
// kernel: the forward loop's instance of TWO_SUMS and slab type S).
struct Plan {
    LoopConfig config;
    int max_clusters;
    bool big;
};
template <int H, bool TWO_SUMS = false, typename S = float>
Plan plan(long long B, bool backward) {
    using C = LoopConfigs<H>;
    using Big = Loop<H, C::BIG_U, C::BIG_RT>;
    using Small = Loop<H, C::SMALL_U, C::SMALL_RT>;
    static int maxc[2][2] = {{-1, -1}, {-1, -1}};  // [backward][big]
    int* m = maxc[backward ? 1 : 0];
    if (m[0] < 0)
        m[0] = backward ? max_active_clusters<Small>(
                              backward_loop<H, C::SMALL_U, C::SMALL_RT>, Small::BWD_SMEM)
                        : max_active_clusters<Small>(
                              forward_loop<H, C::SMALL_U, C::SMALL_RT, TWO_SUMS, S>,
                              Small::FWD_SMEM);
    const LoopConfig big{C::BIG_U, C::BIG_RT}, small{C::SMALL_U, C::SMALL_RT};
    if constexpr (C::ONE) {
        return {small, m[0], false};
    } else {
        if (m[1] < 0)
            m[1] = backward
                ? max_active_clusters<Big>(backward_loop<H, C::BIG_U, C::BIG_RT>, Big::BWD_SMEM)
                : max_active_clusters<Big>(forward_loop<H, C::BIG_U, C::BIG_RT, TWO_SUMS, S>,
                                           Big::FWD_SMEM);
        const int sms = sm_count();
        bool use_big = m[1] > 0;
        if (m[1] > 0 && m[0] > 0)
            use_big = loop_cycles(H, big, B, m[1], sms) <= loop_cycles(H, small, B, m[0], sms);
        return {use_big ? big : small, use_big ? m[1] : m[0], use_big};
    }
}

// the loop L's kernel over `tiles` clusters
template <class L, typename Kernel, typename... Args>
cudaError_t launch_loop(Kernel kernel, long long tiles, size_t smem, cudaStream_t stream,
                        Args... args) {
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    if (tiles > 0x7fffffff / L::CS) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(attr, L::CS, L::THREADS, (int)tiles, smem, stream);
    if ((err = cudaLaunchKernelEx(&cfg, kernel, args...)) != cudaSuccess) return err;
    return cudaGetLastError();
}

template <int H, int U, int RT, bool TWO_SUMS, typename S>
cudaError_t run_forward_loop(const S* xw, const float* h0, const float* c0,
                             const float* w_hh, const float* b, float* outs, float* cseq,
                             float* hT, float* cT, int T, int B, cudaStream_t stream) {
    using L = Loop<H, U, RT>;
    const long long tiles = (B + L::R - 1) / L::R;
    return launch_loop<L>(forward_loop<H, U, RT, TWO_SUMS, S>, tiles, L::FWD_SMEM, stream, xw,
                          h0, c0, w_hh, b, outs, cseq, hT, cT, T, B);
}

// The forward loop over T steps of B rows at the tiling plan() picks for B
template <int H, bool TWO_SUMS, typename S = float>
cudaError_t run_planned_forward_loop(const S* xw, const float* h0, const float* c0,
                                     const float* w_hh, const float* b, float* outs,
                                     float* cseq, float* hT, float* cT, int T, int B,
                                     cudaStream_t stream) {
    using C = LoopConfigs<H>;
    return plan<H, TWO_SUMS, S>(B, false).big
        ? run_forward_loop<H, C::BIG_U, C::BIG_RT, TWO_SUMS>(xw, h0, c0, w_hh, b, outs, cseq, hT,
                                                             cT, T, B, stream)
        : run_forward_loop<H, C::SMALL_U, C::SMALL_RT, TWO_SUMS>(xw, h0, c0, w_hh, b, outs, cseq,
                                                                 hT, cT, T, B, stream);
}

template <int H, int U, int RT>
cudaError_t run_backward_loop(const float* acts, const float* w_hh_t, const float* c0,
                              const float* cseq, const float* g_outs, const float* g_hT,
                              const float* g_cT, float* dg, float* dh0, float* dc0,
                              float* db_part, int T, int B, int part_rows, long long* tiles_out,
                              cudaStream_t stream) {
    using L = Loop<H, U, RT>;
    const long long tiles = (B + L::R - 1) / L::R;
    if (db_part && tiles > part_rows) return cudaErrorInvalidValue;
    *tiles_out = tiles;
    return launch_loop<L>(backward_loop<H, U, RT>, tiles, L::BWD_SMEM, stream, acts, w_hh_t, c0,
                          cseq, g_outs, g_hT, g_cT, dg, dh0, dc0, db_part, T, B);
}

// The reverse loop over T steps of B rows at the tiling plan() picks for
// B; tiles_out: the loop's row tiles (db_part's rows it wrote)
template <int H>
cudaError_t run_planned_backward_loop(const float* acts, const float* w_hh_t, const float* c0,
                              const float* cseq, const float* g_outs, const float* g_hT,
                              const float* g_cT, float* dg, float* dh0, float* dc0,
                              float* db_part, int T, int B, int part_rows, long long* tiles_out,
                              cudaStream_t stream) {
    using C = LoopConfigs<H>;
    return plan<H>(B, true).big
        ? run_backward_loop<H, C::BIG_U, C::BIG_RT>(acts, w_hh_t, c0, cseq, g_outs, g_hT, g_cT,
                                                    dg, dh0, dc0, db_part, T, B, part_rows,
                                                    tiles_out, stream)
        : run_backward_loop<H, C::SMALL_U, C::SMALL_RT>(acts, w_hh_t, c0, cseq, g_outs, g_hT,
                                                        g_cT, dg, dh0, dc0, db_part, T, B,
                                                        part_rows, tiles_out, stream);
}

inline cudaError_t transpose_into(const float* src, float* dst, int rows, int cols,
                                  cudaStream_t stream) {
    transpose<<<dim3((cols + 31) / 32, (rows + 31) / 32), dim3(32, 8), 0, stream>>>(src, dst, rows,
                                                                                   cols);
    return cudaGetLastError();
}

// What cell_forward checks before its first launch (enc5_forward before
// its encoder's)
inline cudaError_t cell_forward_check(const float* x, const float* xw, int phases) {
    if (!xw || phases < 1 || phases > FORWARD_PHASES) return cudaErrorInvalidValue;
    // the SGEMM copies these rows 16 bytes at a time
    return aligned16(x) && aligned16(xw) ? cudaSuccess : cudaErrorMisalignedAddress;
}

// The cell's forward from x (T, B, D), f32, D == H (the caller checks):
// the projection xw = x @ W_ih (TWO_SUMS: x @ W_ih + b) into the scratch
// xw (T * B * 4H), then the loop. h0, c0 (B, H), w_ih (D, 4H), w_hh (H,
// 4H), b (4H,). Writes outs and, unless null, cseq (T, B, H), hT, cT (B,
// H). phases: FORWARD_PHASES runs it all, 1 stops after the projection.
template <int H, bool TWO_SUMS = false>
cudaError_t cell_forward(const float* x, const float* h0, const float* c0, const float* w_ih,
                         const float* w_hh, const float* b, float* outs, float* cseq, float* hT,
                         float* cT, float* xw, int T, int B, int D, int phases,
                         cudaStream_t stream) {
    constexpr int G = 4 * H;
    cudaError_t err = cell_forward_check(x, xw, phases);
    if (err != cudaSuccess) return err;
    const long long M = (long long)T * B;
    err = gemm<false>(Mat{x, D}, Mat{w_ih, G}, EpiStore{xw, G, TWO_SUMS ? b : nullptr}, M, G, D,
                      1, w_ih, stream);
    if (err != cudaSuccess || phases == 1) return err;
    return run_planned_forward_loop<H, TWO_SUMS>(xw, h0, c0, w_hh, b, outs, cseq, hT, cT, T, B,
                                                 stream);
}

// feats (T, B, F), h0, c0 (B, H), w_enc (F, D), b_enc (D,), w_ih (D, 4H),
// w_hh (H, 4H), b (4H,), all f32, D == H. Writes outs and, unless null,
// cseq (T, B, H), hT, cT (B, H). Scratch: xs (T * B * D) and xw (T * B
// * 4H). phases: FORWARD_PHASES runs the whole forward, 1 stops after the
// encoder and the projection (to time them). TWO_SUMS: the archived
// enc2's forward (csrc/lstm_archive.cu), whose gates are x @ W_ih + b and
// h @ W_hh summed apart (in f32 its roundings to the compute dtype are the
// identity): cell_forward's projection and loop with fused's two sums.
template <int H, bool TWO_SUMS = false>
cudaError_t enc5_forward(const float* feats, const float* h0, const float* c0,
                         const float* w_enc, const float* b_enc, const float* w_ih,
                         const float* w_hh, const float* b, float* outs, float* cseq, float* hT,
                         float* cT, float* xs, float* xw, int T, int B, int F, int phases,
                         cudaStream_t stream) {
    constexpr int D = H;
    if (!xs) return cudaErrorInvalidValue;
    if (!aligned16(w_enc)) return cudaErrorMisalignedAddress;
    cudaError_t err = cell_forward_check(xs, xw, phases);
    if (err != cudaSuccess) return err;
    if ((err = gemm<false>(Feats<false>{feats, F}, Mat{w_enc, D}, EpiEncoder{xs, b_enc, D},
                           (long long)T * B, D, F, 1, w_enc, stream)) != cudaSuccess)
        return err;
    return cell_forward<H, TWO_SUMS>(xs, h0, c0, w_ih, w_hh, b, outs, cseq, hT, cT, xw, T, B, D,
                                     phases, stream);
}

// What cell_backward checks before its first launch (enc5_backward before
// its encoder's)
inline cudaError_t cell_backward_check(const float* x, const float* h0, const float* outs,
                                      const float* dx, const float* dg, const float* dw_part,
                                      const float* work, int splits_w, int phases) {
    if (!work || phases < 1 || phases > BACKWARD_PHASES || splits_w < 1)
        return cudaErrorInvalidValue;
    // the SGEMMs copy these rows 16 bytes at a time
    for (const void* p : {(const void*)x, (const void*)h0, (const void*)outs, (const void*)dx,
                          (const void*)dg, (const void*)dw_part, (const void*)work})
        if (!aligned16(p)) return cudaErrorMisalignedAddress;
    return cudaSuccess;
}

// The cell's backward from x (T, B, D), f32, D == H (the caller checks),
// the forward's inputs, outs and cseq, and the gradients g_outs (T, B,
// H), g_hT, g_cT (B, H). xw: the forward's x @ W_ih (T * B * 4H), kept
// (cat), or null to recompute it (enc5): the same sums in the same order;
// TWO_SUMS (fused): the forward's x @ W_ih + b, which it needs.
// Writes dx (T, B, D) (with a non-null mask, dpre: dx where the mask is
// positive, else 0), dh0, dc0 (B, H), dw = [dW_ih; dW_hh] (D + H, 4H) and
// db (4H,). Scratch: dg (T * B * 4H), dw_part (splits_w, D + H, 4H),
// db_part (part_rows, 4H) with part_rows at least ceil(B / 32) (the
// loops' smallest tile), and `work`: the activations (T * B * 4H), then
// W_ih^T (4H * D) and W_hh^T (4H * H). phases: BACKWARD_PHASES runs it
// all; 1 .. 3 stop after the pre-pass, the loop or dx (to time them).
template <int H, bool TWO_SUMS = false>
cudaError_t cell_backward(const float* x, const float* xw, const float* h0, const float* c0,
                          const float* w_ih, const float* w_hh, const float* b, const float* outs,
                          const float* cseq, const float* g_outs, const float* g_hT,
                          const float* g_cT, float* dx, const float* mask, float* dh0,
                          float* dc0, float* dw, float* db, float* dg, float* dw_part,
                          float* db_part, float* work, int T, int B, int D, int splits_w,
                          int part_rows, int phases, cudaStream_t stream) {
    constexpr int G = 4 * H;
    cudaError_t err = cell_backward_check(x, h0, outs, dx, dg, dw_part, work, splits_w, phases);
    if (err != cudaSuccess) return err;
    if (TWO_SUMS && !xw) return cudaErrorInvalidValue;
    if (!aligned16(xw)) return cudaErrorMisalignedAddress;
    const long long M = (long long)T * B;
    float* acts = work;
    float* w_ih_t = acts + M * G;
    float* w_hh_t = w_ih_t + (size_t)G * D;
    const XH xh{x, h0, outs, B, D, H};
    const XH h_prev{x, h0, outs, B, 0, H};
    if constexpr (TWO_SUMS) {
        // fused's gates: h_prev @ W_hh from zero, then the kept xw (x @
        // W_ih + b) added to it in the epilogue, as the forward loop did
        err = gemm<false>(h_prev, Mat{w_hh, G}, EpiActs<>{acts, b, H, xw}, M, G, H, 1, w_ih,
                          stream);
    } else {
        // the gate recompute: each sum over k < D + H in order, then b;
        // from the forward's xw, the sums over k < D, it continues over
        // h_prev
        err = xw ? gemm<false, true>(h_prev, Mat{w_hh, G}, EpiActs<>{acts, b, H}, M, G, H, 1,
                                     w_ih, stream, xw)
                 : gemm<false>(xh, WCat{w_ih, w_hh, D, G}, EpiActs<>{acts, b, H}, M, G, D + H,
                               1, w_ih, stream);
    }
    if (err != cudaSuccess || phases == 1) return err;
    if ((err = transpose_into(w_hh, w_hh_t, H, G, stream)) != cudaSuccess) return err;
    long long tiles = 0;
    err = run_planned_backward_loop<H>(acts, w_hh_t, c0, cseq, g_outs, g_hT, g_cT, dg, dh0,
                                       dc0, db_part, T, B, part_rows, &tiles, stream);
    if (err != cudaSuccess || phases == 2) return err;
    if ((err = transpose_into(w_ih, w_ih_t, D, G, stream)) != cudaSuccess) return err;
    // dx = dg @ W_ih^T; where its tiles leave half the SMs idle (memory's
    // 4096 rows: 32 tiles), split over K up to four ways into the
    // activations' slab (read by nothing after the loop), the partials
    // added in split order (under the mask)
    const long long dx_tiles = (M + SBM - 1) / SBM;
    const int dx_splits = 2 * dx_tiles > sm_count() ? 1
        : (int)std::min<long long>(DX_MAX_SPLITS, (sm_count() + dx_tiles - 1) / dx_tiles);
    if (dx_splits == 1) {
        err = gemm<false>(Mat{dg, G}, Mat{w_ih_t, D}, EpiDx{dx, mask, D}, M, D, G, 1, w_ih,
                          stream);
    } else if ((err = gemm<false>(Mat{dg, G}, Mat{w_ih_t, D}, EpiPartial{acts, (int)M, D}, M, D,
                                  G, dx_splits, w_ih, stream)) == cudaSuccess) {
        dx_sum<<<(int)std::min<long long>((M * D + 255) / 256, 1024), 256, 0, stream>>>(
            acts, mask, dx, dx_splits, M * D);
        err = cudaGetLastError();
    }
    if (err != cudaSuccess || phases == 3) return err;
    if ((err = gemm<true>(xh, Mat{dg, G}, EpiPartial{dw_part, D + H, G}, D + H, G, M, splits_w,
                          w_ih, stream)) != cudaSuccess)
        return err;
    if ((err = reduce(dw_part, dw, splits_w, (long long)(D + H) * G, stream)) != cudaSuccess)
        return err;
    return reduce(db_part, db, (int)tiles, G, stream);
}

// Inputs as enc5_forward's, its outs and cseq, and the gradients g_outs
// (T, B, H), g_hT, g_cT (B, H). Writes dh0, dc0 (B, H), dwe (F + 1, D):
// dW_enc then db_enc, dw = [dW_ih; dW_hh] (D + H, 4H), db (4H,). Scratch:
// xs, dpre (T * B * D), dwe_part (splits_e, F + 1, D) and cell_backward's.
// The archived enc4's and enc6's f32 backwards (csrc/lstm_archive.cu) are
// this one, their roundings being the identity in f32. TWO_SUMS: the
// archived enc2's backward (csrc/lstm_archive.cu), whose
// gates are x @ W_ih + b and h_prev @ W_hh summed apart (in f32 its
// roundings to the compute dtype are the identity): x @ W_ih + b is one
// SGEMM with the bias in its epilogue, into dg, and cell_backward's
// pre-pass (fused's) adds it to h_prev @ W_hh. dg holds that slab until
// the pre-pass has read it and the loop writes the dgates over it: no
// scratch more than enc5's. phases: BACKWARD_PHASES runs it all; 1 .. 3
// stop after the encoder (and enc2's projection) and the pre-pass, the
// loop or dpre.
template <int H, bool TWO_SUMS = false>
cudaError_t enc5_backward(const float* feats, const float* h0, const float* c0,
                          const float* w_enc, const float* b_enc, const float* w_ih,
                          const float* w_hh, const float* b, const float* outs,
                          const float* cseq, const float* g_outs, const float* g_hT,
                          const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw,
                          float* db, float* xs, float* dpre, float* dg, float* dw_part,
                          float* db_part, float* dwe_part, float* work, int T, int B, int F,
                          int splits_w, int splits_e, int part_rows, int phases,
                          cudaStream_t stream) {
    constexpr int D = H, G = 4 * H;
    if (splits_e < 1) return cudaErrorInvalidValue;
    if (!aligned16(w_enc) || !aligned16(dwe_part)) return cudaErrorMisalignedAddress;
    cudaError_t err =
        cell_backward_check(xs, h0, outs, dpre, dg, dw_part, work, splits_w, phases);
    if (err != cudaSuccess) return err;
    const long long M = (long long)T * B;
    err = gemm<false>(Feats<false>{feats, F}, Mat{w_enc, D},
                                  EpiEncoder{xs, b_enc, D}, M, D, F, 1, w_enc, stream);
    if (err != cudaSuccess) return err;
    if (TWO_SUMS && (err = gemm<false>(Mat{xs, D}, Mat{w_ih, G}, EpiStore{dg, G, b}, M, G, D, 1,
                                       w_ih, stream)) != cudaSuccess)
        return err;
    if ((err = cell_backward<H, TWO_SUMS>(xs, TWO_SUMS ? dg : nullptr, h0, c0, w_ih, w_hh, b,
                                          outs, cseq, g_outs, g_hT, g_cT, dpre, xs, dh0, dc0,
                                          dw, db, dg, dw_part, db_part, work, T, B, D, splits_w,
                                          part_rows, phases, stream)) != cudaSuccess ||
        phases < BACKWARD_PHASES)
        return err;
    if ((err = gemm<true>(Feats<true>{feats, F}, Mat{dpre, D}, EpiPartial{dwe_part, F + 1, D},
                          F + 1, D, M, splits_e, w_ih, stream)) != cudaSuccess)
        return err;
    return reduce(dwe_part, dwe, splits_e, (long long)(F + 1) * D, stream);
}

// Mode XP's forward (lstm_scan, csrc/lstm_scan.cu; the archived tm,
// csrc/lstm_archive.cu), whose gates are x_proj_t + h @ W_hh: the two-sums
// forward loop (fused's) with x_proj as its slab, so no projection SGEMM,
// no scratch and no b. x_proj (T, B, 4H) in S (f32 or bf16, widened
// exactly as the loop reads it), h0, c0 (B, H), w_hh (H, 4H), f32. Runs
// steps t0 .. t1 - 1 from h0, c0, the state before step t0, to hT, cT,
// the state after step t1 - 1 (the whole forward: [0, T); tm: one step a
// call), writing those rows of outs and, unless it is null, of cseq (T,
// B, H) f32. Each sum is h @ W_hh from zero, k in order, then x_proj_t
// added: the order of lstm_scan_fused's (and of its TPU kernel's) sums.
template <int H, typename S>
cudaError_t xp_forward(const S* x_proj, const float* h0, const float* c0, const float* w_hh,
                       float* outs, float* cseq, float* hT, float* cT, int t0, int t1, int T,
                       int B, cudaStream_t stream) {
    if (t0 < 0 || t0 >= t1 || t1 > T) return cudaErrorInvalidValue;
    const size_t row = (size_t)t0 * B;
    return run_planned_forward_loop<H, true, S>(x_proj + row * 4 * H, h0, c0, w_hh, nullptr,
                                                outs + row * H, cseq ? cseq + row * H : nullptr,
                                                hT, cT, t1 - t0, B, stream);
}

constexpr int XP_BACKWARD_PHASES = 3;  // pre-pass, loop, dW_hh

// dst = src rounded to bf16, four values a thread and step (n a multiple
// of 4): dx_proj in bf16 from the f32 dgates
__global__ void round_to_bf16(const float* __restrict__ src, bf16* __restrict__ dst,
                              long long n) {
    for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
         i += 4LL * gridDim.x * blockDim.x) {
        const float4 v = *reinterpret_cast<const float4*>(src + i);
        *reinterpret_cast<uint2*>(dst + i) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
    }
}

// Mode XP's backward (lstm_scan, csrc/lstm_scan.cu; the archived tm,
// csrc/lstm_archive.cu), whose gates are x_proj_t + h_prev @ W_hh: the
// cell's backward (fused's, TWO_SUMS) with the projection given, so no
// W_ih, dx or db. x_proj (T, B, 4H) in S (f32 or bf16), h0, c0 (B, H),
// w_hh (H, 4H), outs, cseq, g_outs (T, B, H), f32; g_hT, g_cT the
// gradients that enter step t1 - 1. Runs steps t1 - 1 down to t0 (the
// whole backward: [0, T); tm: one step a call, dh/dc carried in g_hT, g_cT
// in and dh0, dc0 out). The call with t1 == T runs the pre-pass over all
// T*B rows (h_prev @ W_hh from zero, x_proj added in the epilogue: the
// forward loop's two sums, its activations' bits) into the f32 dgates slab,
// which is dx_proj itself with f32 x_proj and the scratch dg (T * B * 4H
// f32) with bf16 x_proj, and transposes W_hh into the scratch w_hh_t (4H
// * H f32); every call runs the reverse loop over its steps, which writes
// each step's dgates over its activations (no slab more); the call with t0
// == 0 rounds dg into a bf16 dx_proj, then runs dW_hh (H, 4H) = h_prev^T
// dg over all T*B rows as the split-K SGEMM (dw_part: (splits, H, 4H)),
// its partials added in split order. phases: XP_BACKWARD_PHASES runs it
// all; 1 stops after the pre-pass, 2 after the loop (to time them).
template <int H, typename S>
cudaError_t xp_backward_steps(const S* x_proj, const float* h0, const float* c0,
                              const float* w_hh, const float* outs, const float* cseq,
                              const float* g_outs, const float* g_hT, const float* g_cT,
                              S* dx_proj, float* dh0, float* dc0, float* dw_hh, float* dg,
                              float* dw_part, float* w_hh_t, int t0, int t1, int T, int B,
                              int splits, int phases, cudaStream_t stream) {
    constexpr int G = 4 * H;
    constexpr bool F32 = std::is_same<S, float>::value;
    if (phases < 1 || phases > XP_BACKWARD_PHASES || splits < 1 || !w_hh_t || (!F32 && !dg) ||
        t0 < 0 || t0 >= t1 || t1 > T)
        return cudaErrorInvalidValue;
    float* slab = F32 ? reinterpret_cast<float*>(dx_proj) : dg;
    // the SGEMMs copy these rows 16 bytes at a time; x_proj and the bf16
    // dx_proj are read and written as vectors
    for (const void* p : {(const void*)h0, (const void*)outs, (const void*)slab,
                          (const void*)dw_part, (const void*)w_hh_t, (const void*)x_proj,
                          (const void*)dx_proj})
        if (!aligned16(p)) return cudaErrorMisalignedAddress;
    const long long M = (long long)T * B;
    const XH h_prev{nullptr, h0, outs, B, 0, H};
    cudaError_t err = cudaSuccess;
    if (t1 == T) {
        if ((err = gemm<false>(h_prev, Mat{w_hh, G}, EpiActs<S>{slab, nullptr, H, x_proj}, M, G,
                               H, 1, w_hh, stream)) != cudaSuccess ||
            phases == 1)
            return err;
        if ((err = transpose_into(w_hh, w_hh_t, H, G, stream)) != cudaSuccess) return err;
    }
    // steps t0 .. t1 - 1 as a loop over t1 - t0 steps from their first
    // row: c_prev of its step 0 is cseq[t0 - 1] (c0 at t0 = 0)
    const size_t row = (size_t)t0 * B;
    float* acts = slab + row * G;
    long long tiles = 0;
    if ((err = run_planned_backward_loop<H>(acts, w_hh_t, t0 ? cseq + (row - B) * H : c0,
                                            cseq + row * H, g_outs + row * H, g_hT, g_cT, acts,
                                            dh0, dc0, nullptr, t1 - t0, B, 0, &tiles,
                                            stream)) != cudaSuccess ||
        t0 > 0)
        return err;
    if constexpr (!F32) {
        round_to_bf16<<<(int)std::min<long long>((M * G / 4 + 255) / 256, 1024), 256, 0,
                        stream>>>(dg, dx_proj, M * G);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (phases == 2) return cudaSuccess;
    if ((err = gemm<true>(h_prev, Mat{slab, G}, EpiPartial{dw_part, H, G}, H, G, M, splits,
                          w_hh, stream)) != cudaSuccess)
        return err;
    return reduce(dw_part, dw_hh, splits, (long long)H * G, stream);
}

// Registers and local (spilled) bytes per thread of the f32 kernels at
// hidden size H: the forward and backward loops at both tilings (big,
// small; at H 256 the one tiling in both places), then the cell's SGEMMs:
// the projection, the pre-pass (enc5's over [xs | h_prev]; without
// ENCODER cat's, over h_prev from the kept slab, or with TWO_SUMS fused's,
// over h_prev from zero, the kept slab added after), dx (with or without the mask: one kernel) and dW; with
// ENCODER also enc5's encoder and [dW_enc; db_enc]. Two ints a kernel:
// sixteen, or twenty
template <int H, bool ENCODER, bool TWO_SUMS = false>
cudaError_t usage(int* out) {
    using C = LoopConfigs<H>;
    const void* pre_pass;
    if constexpr (ENCODER)
        pre_pass = reinterpret_cast<const void*>(sgemm<XH, WCat, false, EpiActs<>>);
    else if constexpr (TWO_SUMS)
        pre_pass = reinterpret_cast<const void*>(sgemm<XH, Mat, false, EpiActs<>>);
    else
        pre_pass = reinterpret_cast<const void*>(sgemm<XH, Mat, false, EpiActs<>, true>);
    const void* fns[] = {
        reinterpret_cast<const void*>(forward_loop<H, C::BIG_U, C::BIG_RT, TWO_SUMS>),
        reinterpret_cast<const void*>(forward_loop<H, C::SMALL_U, C::SMALL_RT, TWO_SUMS>),
        reinterpret_cast<const void*>(backward_loop<H, C::BIG_U, C::BIG_RT>),
        reinterpret_cast<const void*>(backward_loop<H, C::SMALL_U, C::SMALL_RT>),
        reinterpret_cast<const void*>(sgemm<Mat, Mat, false, EpiStore>),
        pre_pass,
        reinterpret_cast<const void*>(sgemm<Mat, Mat, false, EpiDx>),
        reinterpret_cast<const void*>(sgemm<XH, Mat, true, EpiPartial>),
        ENCODER ? reinterpret_cast<const void*>(sgemm<Feats<false>, Mat, false, EpiEncoder>)
                : nullptr,
        ENCODER ? reinterpret_cast<const void*>(sgemm<Feats<true>, Mat, true, EpiPartial>)
                : nullptr,
    };
    for (int i = 0; i < (ENCODER ? 10 : 8); ++i) {
        cudaFuncAttributes a;
        const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
        if (err != cudaSuccess) return err;
        out[2 * i] = a.numRegs;
        out[2 * i + 1] = (int)a.localSizeBytes;
    }
    return cudaSuccess;
}

// The loops' tilings at B rows: forward then backward, each (units a
// block, rows a thread, clusters the card holds at once); six ints
template <int H, bool TWO_SUMS = false>
cudaError_t loop_plan(long long B, int* out) {
    for (int backward = 0; backward < 2; ++backward) {
        const Plan p = plan<H, TWO_SUMS>(B, backward);
        if (p.max_clusters <= 0) return cudaErrorInvalidConfiguration;
        out[3 * backward] = p.config.U;
        out[3 * backward + 1] = p.config.RT;
        out[3 * backward + 2] = p.max_clusters;
    }
    return cudaSuccess;
}

// The bodies of the f32 C functions of the two cell pairs, cat's
// (csrc/lstm_cat.cu) and, with TWO_SUMS, fused's (csrc/lstm_scan.cu), with
// the arguments of their bf16 bodies (tc::CellForward, tc::CellBackward)
// for lstm::dispatch: D == H. The forward's scratch xw is the slab it
// returns, which the backward takes again in `aux`; the backward's `pre`
// is `work` (the activations, then W_ih^T and W_hh^T).
template <int H, bool TWO_SUMS>
struct CellForward {
    static cudaError_t run(const void* x, const float* h0, const float* c0, const float* w_ih,
                           const float* w_hh, const float* b, void* outs, void* cseq, float* hT,
                           float* cT, float* xw, void*, int T, int B, int D, int phases,
                           cudaStream_t stream) {
        if (D != H) return cudaErrorInvalidValue;
        return cell_forward<H, TWO_SUMS>(static_cast<const float*>(x), h0, c0, w_ih, w_hh, b,
                                         static_cast<float*>(outs), static_cast<float*>(cseq),
                                         hT, cT, xw, T, B, D, phases, stream);
    }
};

template <int H, bool TWO_SUMS>
struct CellBackward {
    static cudaError_t run(const void* x, const float* h0, const float* c0, const float* w_ih,
                           const float* w_hh, const float* b, const void* outs,
                           const void* cseq, const void* g_outs, const float* g_hT,
                           const float* g_cT, void* dx, float* dh0, float* dc0, float* dw,
                           float* db, void* dg, float* dw_part, float* db_part, float* pre,
                           void* aux, int T, int B, int D, int splits, int part_rows,
                           int phases, cudaStream_t stream) {
        if (D != H) return cudaErrorInvalidValue;
        return cell_backward<H, TWO_SUMS>(
            static_cast<const float*>(x), static_cast<const float*>(aux), h0, c0, w_ih, w_hh, b,
            static_cast<const float*>(outs), static_cast<const float*>(cseq),
            static_cast<const float*>(g_outs), g_hT, g_cT, static_cast<float*>(dx), nullptr,
            dh0, dc0, dw, db, static_cast<float*>(dg), dw_part, db_part, pre, T, B, D, splits,
            part_rows, phases, stream);
    }
};

}  // namespace f32
}  // namespace lstm

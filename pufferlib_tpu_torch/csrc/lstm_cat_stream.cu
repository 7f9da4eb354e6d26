// LSTM time scans whose weights no block can hold whole, forward and
// backward, for Hopper (sm_90a): the second design of the cat pair and of
// the enc5 pair, for the shapes the resident-weight kernels of
// lstm_cat.cu and lstm_enc.cu refuse (hidden sizes past 128, input widths
// the tensor-core kernels refuse in bf16, any input width apart from the
// hidden size in f32, and in enc5 feature widths past the encoders'
// limits).
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/lstm_cat.py
// (lstm_scan_cat: the forward `_impl` / `_fwd_kernel`, the backward `_bwd`
// / `_bwd_kernel`) and of lstm_enc.py / lstm_enc5.py (lstm_scan_enc5: the
// forward lstm_enc.py `_impl`, the backward lstm_enc5.py `_hoisted_bwd`)
// at those shapes. The functions are those of
// pufferlib_tpu_torch.ops.cuda.lstm_cat.lstm_cat_reference /
// lstm_cat_backward_reference and lstm_enc.lstm_enc_reference /
// lstm_enc_backward_reference: gates = [x_t | h] @ [W_ih; W_hh] + b, one
// f32 sum over K = D + H on operands rounded to the compute dtype, then
// the bias; h and c carried in f32; outs, cseq, dx and the dgates operands
// in the compute dtype. cat's db comes from the unrounded dgates; enc5
// rounds the gate activations and sums db from the rounded dgates, and
// puts x = round(relu(feats @ W_enc + b_enc)) in front.
//
// Bound: at the Atari update's shape (T = 16, B = 256, D = H = 512) the
// forward does 2*T*B*(D+H)*4H = 17.2 GFLOP against 17 MB (f32 weights
// 8.4 MB, sequences 8.4 MB): bound by operations, 0.26 ms at the f32
// rate, 0.017 ms at the bf16 tensor-core rate; the backward's bound
// counts three times the operations (gate recompute, [dx | dh_prev], dW),
// though this design keeps the forward's gates and skips the first.
//
// At T 16, B 8192, D = H = 256 (enc5 on the default route at hidden 256)
// both directions do 68.7 GFLOP of recurrent product and the forward as
// much again of input product: 2.1 ms at the f32 rate, 0.07 at bf16's, so
// bf16 is bound by its bytes (0.21 ms).
//
// Design. Only h @ W_hh (forward) and dg_{t+1} @ W_hh^T (backward) depend
// on the carried state. Two schedules run the recurrence, chosen by B:
// * units (few batch rows: fewer tiles of 64 rows than half the SMs): the
//   recurrence is one cooperative launch whose blocks each hold a slice of
//   W_hh for all T steps, so that the card's SMs share the few rows'
//   work; the input products are GEMMs over all T*B rows outside it.
//   - forward: S = x @ W_ih into an f32 slab (T*B, 4H), the sum over
//     k < D; then the loop, a cooperative launch of (H/16) x RG blocks.
//     Block (u, rg) owns 16 hidden units with their four gate columns, so
//     the cell update is local, and holds that 64-column slice of W_hh,
//     rounded to the compute dtype, in shared memory for all T steps (128
//     KiB in f32 at H = 512). It walks the row tiles rg, rg + RG, ... of
//     64 batch rows; per tile the accumulators start from the tile's S
//     rows and take h_prev @ W_hh on, h_prev streaming by cp.async through
//     two shared stages as deep as the shared memory left beside W_hh
//     allows (one loads while the other is multiplied), then + b. The 256
//     threads split K in two halves (128 threads each) whose partial sums
//     meet in shared memory; each half then updates the cell for half the
//     tile's (row, unit) pairs. c lives in cT (f32), read and written by
//     the thread that owns the pair; h_prev is the stored outs[t-1] (h
//     rounded to the compute dtype is exactly what outs holds), h0 rounded
//     by the first launch. After a step the blocks of a row group (the
//     same rg) meet at a barrier on a counter in device memory, which
//     publishes outs[t]. RG is as large as the card holds every block at
//     once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at most the
//     number of row tiles; a grid that cannot be resident is refused
//     before any launch.
//   - backward: from P, the gate activations i, f, g, o of every step
//     (f32, unrounded; enc5's backward rounds them), which the forward
//     loop writes over its S slab as it makes them (the TPU kernels
//     recompute the gates; keeping the activations costs no product and no
//     transcendental, and 4 bytes a gate of memory held until the
//     backward); the reverse loop as
//     one cooperative launch of the same grid, each block holding the 16
//     rows of W_hh of its units (W_hh^T's columns): per step dh = dg_{t+1}
//     @ W_hh^T for its (row, unit) pairs (K = 4H split in two halves as
//     above, dg_{t+1} through two stages likewise), the activations
//     from P, the dh/dc chain (dc in f32, in dc0), the dgates rounded into the
//     dg slab and this tile's column sums of the dgates as a row of
//     db_part; a barrier; after step 0 one more product gives dh0.
// * rows (many batch rows): a block owns whole tiles of 64 rows with all
//   H units, so no block waits for another (an ordinary launch), and the
//   weights stream from L2 (packed by prep in the compute dtype) through a
//   3-stage cp.async ring (see "The rows schedule" below). The forward
//   folds x @ W_ih into the loop (K = D + H in one ordered f32 sum, then
//   the bias: no S slab is written or read) and writes P; the backward
//   reads each dg_{t+1} row once a step (the units schedule's H/16 unit
//   blocks each read all of it) and streams W_hh^T instead.
// * after either backward loop: dx = dg @ W_ih^T (enc5: dpre = round(x >
//   0 ? dx : 0)), dW = [x | h_prev]^T dg (split-K, partial sums added in
//   split order), enc5's dW_enc and db_enc = [feats | 1]^T dpre, and db as
//   the ordered column sums of db_part.
// * math units by dtype: bf16 runs every product on the tensor cores
//   (mma.sync m16n8k16, f32 accumulators; operands read through
//   ldmatrix); f32 stays on the FMA units (TF32 would compute another
//   function than the f32 reference). Every sum is in a fixed order and
//   no atomic touches a value, so two runs are equal bit for bit.
// Launches (units / rows): the cat forward 3 (prep, S, loop) / 2 (prep,
// loop), enc5's 4 / 3 (the encoder first); the cat backward 5 or 6 (prep,
// loop, dx, dW [+ the split sum], db), enc5's 7 to 9 (the encoder again,
// dW_enc [+ its split sum]); none depends on T.
// Shapes: any D >= 1 (and F >= 1), H a multiple of 32 up to what the
// units schedule's blocks hold (lstm_stream_limits: 800 in f32, 1472 in
// bf16; the Python launchers pad other hidden sizes with zero units), any
// B. The rows schedule also needs x's rows in whole 16-byte runs (D a
// multiple of 4 in f32, 8 in bf16, x 16-byte aligned); else the units
// schedule runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int HALF = THREADS / 2;  // threads of a K-half in the loops
constexpr int RB = 64;             // batch rows of a loop tile
constexpr int UB = 16;             // hidden units of a loop block
constexpr int NC = 4 * UB;         // its gate columns
constexpr int HIDDEN_MULTIPLE = 32;
constexpr int MAX_SMEM = 227 * 1024;

// kernels launched by this library so far (lstm_stream_kernels): a host
// count, so that a caller can show how many kernels a C call launches
long long g_kernels = 0;

cudaError_t launched() {
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++g_kernels;
    return err;
}

template <typename E>
constexpr bool is_bf16 = std::is_same<E, bf16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to the compute dtype E, carried in f32
template <typename E>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<E>(v)); }

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// a load of memory no thread writes during the kernel (the non-coherent
// path, which the compiler may move past the kernel's stores)
__device__ __forceinline__ float ld_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_ro(const bf16* p) { return __bfloat162float(__ldg(p)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int n = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums; the
// four sums by reference, so that an accumulator array stays in registers
__device__ __forceinline__ void mma16816(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    mma16816(d[0], d[1], d[2], d[3], a, b0, b1);
}

// ---------------------------------------------------------------------------
// The GEMMs around the loops: C (M, N) = sum over k of a(m, k) * b(k, n),
// k in a fixed order, the operands rounded to E by the loaders. A loader
// says with kFast whether k runs along memory, so that neighbouring
// threads read neighbouring addresses. Tiles of 128 x 128; f32 on FMA
// (8 x 8 outputs a thread, 16-deep stages), bf16 on mma.sync (eight warps
// of 64 x 32, 32-deep stages, operands fetched as 16-byte runs). The next stage is fetched into registers
// while the current one is multiplied, and two shared buffers take one
// barrier a stage. With gridDim.z > 1 each z adds its split of K and
// writes the partial sum to part; reduce_splits adds them in order.

constexpr int GB = 128;  // the output tile's rows and columns

template <typename E>
struct GemmDepth {
    static constexpr int BK = is_bf16<E> ? 32 : 16;
};

template <typename E, class LA, class LB, class Epi>
__global__ void __launch_bounds__(THREADS) gemm(LA a, LB b, Epi epi, int M, int N, int K,
                                                int per_split, float* __restrict__ part) {
    constexpr int BK = GemmDepth<E>::BK;
    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * GB, n0 = blockIdx.x * GB;
    const int kb = blockIdx.z * per_split;
    const int ke = kb + per_split < K ? kb + per_split : K;
    auto out = [&](int m, int n, float v) {
        if (m >= M || n >= N) return;
        if (gridDim.z > 1)
            part[((size_t)blockIdx.z * M + m) * N + n] = v;
        else
            epi(m, n, v);
    };
    constexpr int PER = GB * BK / THREADS;  // elements of each operand a thread stages
    // run q of a thread's share of a stage, runs of R along each operand's
    // fast index: (index along the slow side, start along the fast side)
    auto run_of = [&](bool fast_k, int R, int q, int& slow, int& fast) {
        const int v = tid + q * THREADS;
        const int per_slow = (fast_k ? BK : GB) / R;
        slow = v / per_slow;
        fast = v % per_slow * R;
    };
    if constexpr (!is_bf16<E>) {
        // staged k-major for float4 reads of 4 rows or columns; operands
        // fetched as runs of 4 (one 16-byte load where aligned)
        __shared__ __align__(16) float As[2][BK][GB + 4];
        __shared__ __align__(16) float Bs[2][BK][GB + 4];
        constexpr int RPER = PER / 4;
        float4 ra[RPER], rb[RPER];
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        auto fetch = [&](int k0) {
#pragma unroll
            for (int q = 0; q < RPER; ++q) {
                int sl, fa;
                run_of(LA::kFast, 4, q, sl, fa);
                if constexpr (LA::kFast)  // slow m, fast k
                    ra[q] = m0 + sl < M && k0 + fa < ke ? a.vec4(m0 + sl, k0 + fa, ke) : zero;
                else  // slow k, fast m
                    ra[q] = k0 + sl < ke && m0 + fa < M ? a.vec4(k0 + sl, m0 + fa, M) : zero;
                run_of(LB::kFast, 4, q, sl, fa);
                if constexpr (LB::kFast)  // slow n, fast k
                    rb[q] = n0 + sl < N && k0 + fa < ke ? b.vec4(n0 + sl, k0 + fa, ke) : zero;
                else  // slow k, fast n
                    rb[q] = k0 + sl < ke && n0 + fa < N ? b.vec4(k0 + sl, n0 + fa, N) : zero;
            }
        };
        auto stash = [&](int buf) {
#pragma unroll
            for (int q = 0; q < RPER; ++q) {
                int sl, fa;
                run_of(LA::kFast, 4, q, sl, fa);
                if constexpr (LA::kFast) {
                    As[buf][fa][sl] = ra[q].x;
                    As[buf][fa + 1][sl] = ra[q].y;
                    As[buf][fa + 2][sl] = ra[q].z;
                    As[buf][fa + 3][sl] = ra[q].w;
                } else {
                    *reinterpret_cast<float4*>(&As[buf][sl][fa]) = ra[q];
                }
                run_of(LB::kFast, 4, q, sl, fa);
                if constexpr (LB::kFast) {
                    Bs[buf][fa][sl] = rb[q].x;
                    Bs[buf][fa + 1][sl] = rb[q].y;
                    Bs[buf][fa + 2][sl] = rb[q].z;
                    Bs[buf][fa + 3][sl] = rb[q].w;
                } else {
                    *reinterpret_cast<float4*>(&Bs[buf][sl][fa]) = rb[q];
                }
            }
        };
        const int ty = tid / 16, tx = tid % 16;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        fetch(kb);
        stash(0);
        __syncthreads();
        int buf = 0;
        for (int k0 = kb; k0 < ke; k0 += BK) {
            const bool more = k0 + BK < ke;
            if (more) fetch(k0 + BK);
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
                const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
                const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
                const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
                const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
            if (more) stash(buf ^ 1);
            __syncthreads();
            buf ^= 1;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                out(m0 + (i / 4) * 64 + ty * 4 + i % 4, n0 + (j / 4) * 64 + tx * 4 + j % 4,
                    acc[i][j]);
    } else {
        // A as [m][k] (kFast) or [k][m]; B as [n][k] (kFast) or [k][n];
        // rows padded by 16 bytes so that ldmatrix is free of conflicts
        constexpr int AR = LA::kFast ? GB : BK, AC = (LA::kFast ? BK : GB) + 8;
        constexpr int BR = LB::kFast ? GB : BK, BC = (LB::kFast ? BK : GB) + 8;
        __shared__ __align__(16) bf16 As[2][AR][AC];
        __shared__ __align__(16) bf16 Bs[2][BR][BC];
        // a thread stages VPER runs of eight along each operand's fast
        // index, fetched a stage ahead
        constexpr int VPER = PER / 8;
        uint4 ra[VPER], rb[VPER];
        const uint4 zero = make_uint4(0, 0, 0, 0);
        auto fetch = [&](int k0) {
#pragma unroll
            for (int q = 0; q < VPER; ++q) {
                int sl, fa;
                run_of(LA::kFast, 8, q, sl, fa);
                if constexpr (LA::kFast)  // slow m, fast k
                    ra[q] = m0 + sl < M && k0 + fa < ke ? a.vec8(m0 + sl, k0 + fa, ke) : zero;
                else  // slow k, fast m
                    ra[q] = k0 + sl < ke && m0 + fa < M ? a.vec8(k0 + sl, m0 + fa, M) : zero;
                run_of(LB::kFast, 8, q, sl, fa);
                if constexpr (LB::kFast)  // slow n, fast k
                    rb[q] = n0 + sl < N && k0 + fa < ke ? b.vec8(n0 + sl, k0 + fa, ke) : zero;
                else  // slow k, fast n
                    rb[q] = k0 + sl < ke && n0 + fa < N ? b.vec8(k0 + sl, n0 + fa, N) : zero;
            }
        };
        auto stash = [&](int buf) {
#pragma unroll
            for (int q = 0; q < VPER; ++q) {
                int sl, fa;
                run_of(LA::kFast, 8, q, sl, fa);
                *reinterpret_cast<uint4*>(&As[buf][sl][fa]) = ra[q];
                run_of(LB::kFast, 8, q, sl, fa);
                *reinterpret_cast<uint4*>(&Bs[buf][sl][fa]) = rb[q];
            }
        };
        const int lane = tid % 32, warp = tid / 32;
        const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
        float acc[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
        fetch(kb);
        stash(0);
        __syncthreads();
        int buf = 0;
        for (int k0 = kb; k0 < ke; k0 += BK) {
            const bool more = k0 + BK < ke;
            if (more) fetch(k0 + BK);
#pragma unroll
            for (int ks = 0; ks < BK; ks += 16) {
                uint32_t af[4][4], bq[2][4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if constexpr (LA::kFast)
                        ldsm_x4(af[i], &As[buf][wm + i * 16 + lane % 16][ks + (lane / 16) * 8]);
                    else
                        ldsm_x4_t(af[i], &As[buf][ks + lane % 8 + (lane / 16) * 8]
                                             [wm + i * 16 + (lane / 8) % 2 * 8]);
                }
#pragma unroll
                for (int jb = 0; jb < 2; ++jb) {
                    if constexpr (LB::kFast)
                        ldsm_x4(bq[jb], &Bs[buf][wn + jb * 16 + (lane / 16) * 8 + lane % 8]
                                           [ks + (lane / 8) % 2 * 8]);
                    else
                        ldsm_x4_t(bq[jb], &Bs[buf][ks + lane % 8 + (lane / 8) % 2 * 8]
                                             [wn + jb * 16 + (lane / 16) * 8]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        mma16816(acc[i][j], af[i], bq[j / 2][(j % 2) * 2],
                                 bq[j / 2][(j % 2) * 2 + 1]);
            }
            if (more) stash(buf ^ 1);
            __syncthreads();
            buf ^= 1;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    out(m0 + wm + i * 16 + lane / 4 + (c / 2) * 8,
                        n0 + wn + j * 8 + (lane % 4) * 2 + c % 2, acc[i][j][c]);
    }
}

// out[i] = sum over s < S of part[s][i], in order
__global__ void reduce_splits(const float* __restrict__ part, float* __restrict__ out, int S,
                              long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int p = 0; p < S; ++p) s += part[(size_t)p * n + i];
        out[i] = s;
    }
}

// out[c] = sum over rows of part[r][c], rows in order
__global__ void column_sums(const float* __restrict__ part, float* __restrict__ out, int rows,
                            int cols) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cols) return;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += part[(size_t)r * cols + c];
    out[c] = s;
}

// Loaders. a(m, k): the A operand; b(k, n): the B operand; both rounded to
// E. vec8(fixed, j, lim): eight bf16 along the loader's fast index, j ..
// j+7 (k where kFast, else m or n) at the other index `fixed`, zeros from
// lim on: one 16-byte load where the run is whole and aligned, else
// element by element. Only the bf16 GEMM calls it.

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7]));
}

// four values of a contiguous f32 run p[0..3], those at or past n zero
__device__ __forceinline__ float4 run4(const float* p, int n) {
    if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
        return *reinterpret_cast<const float4*>(p);
    return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                       n > 3 ? p[3] : 0.f);
}

// eight values of a contiguous run p[0..7], those at or past n zero
__device__ __forceinline__ uint4 run8(const bf16* p, int n) {
    if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
        return *reinterpret_cast<const uint4*>(p);
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = q < n ? __bfloat162float(p[q]) : 0.f;
    return pack8(v);
}
__device__ __forceinline__ uint4 run8(const float* p, int n) {
    float v[8];
    if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = q < n ? p[q] : 0.f;
    }
    return pack8(v);
}

// rows of a (rows, ld) array in S: a(m, k) = p[m][k]
template <typename E, typename S>
struct Rows {
    static constexpr bool kFast = true;
    const S* p;
    int ld;
    __device__ float operator()(int m, int k) const { return rnd<E>(to_f(p[(size_t)m * ld + k])); }
    __device__ uint4 vec8(int m, int k, int lim) const {
        return run8(p + (size_t)m * ld + k, lim - k);
    }
    __device__ float4 vec4(int m, int k, int lim) const {
        return run4(p + (size_t)m * ld + k, lim - k);
    }
};

// the same array as a B operand read along its rows: b(k, n) = p[k][n]
template <typename E, typename S>
struct RowsB {
    static constexpr bool kFast = false;
    const S* p;
    int ld;
    __device__ float operator()(int k, int n) const { return rnd<E>(to_f(p[(size_t)k * ld + n])); }
    __device__ uint4 vec8(int k, int n, int lim) const {
        return run8(p + (size_t)k * ld + n, lim - n);
    }
    __device__ float4 vec4(int k, int n, int lim) const {
        return run4(p + (size_t)k * ld + n, lim - n);
    }
};

// b(k, n) = W[n][k], W (N, ld) f32: a weight transposed
template <typename E>
struct WeightT {
    static constexpr bool kFast = true;
    const float* w;
    int ld;
    __device__ float operator()(int k, int n) const { return rnd<E>(w[(size_t)n * ld + k]); }
    __device__ uint4 vec8(int n, int k, int lim) const {
        return run8(w + (size_t)n * ld + k, lim - k);
    }
    __device__ float4 vec4(int n, int k, int lim) const {
        return run4(w + (size_t)n * ld + k, lim - k);
    }
};

// [x | h_prev](r, j) for r = t * B + b: x (T*B, D), h_prev h0 (rounded) at
// t == 0, else the stored outs of step t - 1
template <typename E>
struct XH {
    const E* x;
    const float* h0;
    const E* outs;
    int B, D, H;
    __device__ float at(int r, int j) const {
        if (j < D) return to_f(x[(size_t)r * D + j]);
        j -= D;
        if (r < B) return rnd<E>(h0[(size_t)r * H + j]);
        return to_f(outs[(size_t)(r - B) * H + j]);
    }
    // j .. j+7 of row r, zeros from lim on
    __device__ uint4 run(int r, int j, int lim) const {
        const int n = lim - j;
        if (j + 8 <= D || j >= D) {
            if (j < D) return run8(x + (size_t)r * D + j, n);
            if (r < B) return run8(h0 + (size_t)r * H + j - D, n);
            return run8(outs + (size_t)(r - B) * H + j - D, n);
        }
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = q < n ? at(r, j + q) : 0.f;
        return pack8(v);
    }
    // the f32 path's runs of four (E is float: nothing to round)
    __device__ float4 run4v(int r, int j, int lim) const {
        const int n = lim - j;
        if (j + 4 <= D || j >= D) {
            if (j < D) return run4(reinterpret_cast<const float*>(x) + (size_t)r * D + j, n);
            if (r < B) return run4(h0 + (size_t)r * H + j - D, n);
            return run4(reinterpret_cast<const float*>(outs) + (size_t)(r - B) * H + j - D, n);
        }
        return make_float4(n > 0 ? at(r, j) : 0.f, n > 1 ? at(r, j + 1) : 0.f,
                           n > 2 ? at(r, j + 2) : 0.f, n > 3 ? at(r, j + 3) : 0.f);
    }
};
// a(m, k) = [x | h_prev](k, m): dW's A
template <typename E>
struct XHCols {
    static constexpr bool kFast = false;
    XH<E> o;
    __device__ float operator()(int m, int k) const { return o.at(k, m); }
    __device__ uint4 vec8(int k, int m, int lim) const { return o.run(k, m, lim); }
    __device__ float4 vec4(int k, int m, int lim) const { return o.run4v(k, m, lim); }
};

// a(m, k) = [feats | 1](k, m): dW_enc's A, whose last row sums db_enc
template <typename E>
struct FeatOnesCols {
    static constexpr bool kFast = false;
    const E* f;
    int F;
    __device__ float operator()(int m, int k) const {
        return m < F ? to_f(f[(size_t)k * F + m]) : 1.f;
    }
    __device__ uint4 vec8(int k, int m, int lim) const {
        if (m + 8 <= F) return run8(f + (size_t)k * F + m, lim - m);
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = m + q < lim ? (*this)(m + q, k) : 0.f;
        return pack8(v);
    }
    __device__ float4 vec4(int k, int m, int lim) const {
        if (m + 4 <= F) return run4(reinterpret_cast<const float*>(f) + (size_t)k * F + m, lim - m);
        return make_float4(m < lim ? (*this)(m, k) : 0.f, m + 1 < lim ? (*this)(m + 1, k) : 0.f,
                           m + 2 < lim ? (*this)(m + 2, k) : 0.f,
                           m + 3 < lim ? (*this)(m + 3, k) : 0.f);
    }
};

// Epilogues

struct StoreF32 {
    float* p;
    int ld;
    __device__ void operator()(int m, int n, float v) const { p[(size_t)m * ld + n] = v; }
};

template <typename E>
struct StoreE {
    E* p;
    int ld;
    __device__ void operator()(int m, int n, float v) const {
        p[(size_t)m * ld + n] = from_f<E>(v);
    }
};

// x = round(relu(feats @ W_enc + b_enc))
template <typename E>
struct EncodeOut {
    E* p;
    const float* b;
    int ld;
    __device__ void operator()(int m, int n, float v) const {
        const float pre = v + b[n];
        p[(size_t)m * ld + n] = from_f<E>(pre > 0.f ? pre : 0.f);
    }
};

// dpre = round(x > 0 ? dx : 0): the relu mask on the unrounded dx
template <typename E>
struct DpreOut {
    E* p;
    const E* xs;
    int ld;
    __device__ void operator()(int m, int n, float v) const {
        const size_t i = (size_t)m * ld + n;
        p[i] = from_f<E>(to_f(xs[i]) > 0.f ? v : 0.f);
    }
};

template <typename E, class LA, class LB, class Epi>
cudaError_t launch_gemm(LA a, LB b, Epi epi, int M, int N, int K, int splits, float* part,
                        float* reduced, cudaStream_t stream) {
    constexpr int BK = GemmDepth<E>::BK;
    if (splits < 1) splits = 1;
    const int per = ((K + splits - 1) / splits + BK - 1) / BK * BK;
    splits = (K + per - 1) / per;
    if (splits < 1) splits = 1;
    dim3 grid((N + GB - 1) / GB, (M + GB - 1) / GB, splits);
    gemm<E><<<grid, THREADS, 0, stream>>>(a, b, epi, M, N, K, per, part);
    cudaError_t err = launched();
    if (err != cudaSuccess || splits == 1) return err;
    const long long n = (long long)M * N;
    long long blocks = (n + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    reduce_splits<<<(int)blocks, 256, 0, stream>>>(part, reduced, splits, n);
    return launched();
}

// ---------------------------------------------------------------------------
// The persistent loops.
//
// Both stream their operand rows (h_prev, or dg_{t+1}) through two shared
// stages, each as many 16-deep chunks of both K-halves as shared memory
// holds beside the weights (cps chunks a half, chosen on the host): one
// stage loads by cp.async while the other is multiplied, so a step pays
// the L2 latency about once, not once a chunk. KCH is the chunk depth;
// rows of a stage are cps * KCH + PAD wide. f32 keeps the forward's
// slice of W_hh as [k][unit pair][gate][2] so that a thread reads its
// eight weights of a k as two float4; bf16 as [k][gate * 16 + unit],
// rows padded by 16 bytes, the B operand of ldmatrix.trans. The backward
// keeps the 16 rows of W_hh of the block's units, [unit][k], k < 4H.

constexpr int KCH = 16;
// bytes of the halves' exchange (and the backward's bias tile) that reuse
// the stages after a product
constexpr int FWD_XCH = 2 * 16 * HALF * 4;
constexpr int BWD_XCH = (2 * 4 * HALF + RB * NC) * 4;

template <typename E>
struct Loop {
    static constexpr int PAD = is_bf16<E> ? 8 : 4;
    static constexpr int WP = NC + (is_bf16<E> ? 8 : 0);  // forward W_hh slice row
    __host__ __device__ static int wtp(int H) { return 4 * H + PAD; }  // backward's
    __host__ __device__ static size_t weights(int H, bool fwd) {
        return sizeof(E) * (fwd ? (size_t)H * WP : (size_t)UB * wtp(H));
    }
    __host__ __device__ static size_t stages(int cps) {
        return sizeof(E) * 2 * 2 * RB * (size_t)(cps * KCH + PAD);
    }
    // chunks a stage holds of each half: the most that fit, at most a
    // half's K; 0 where none fits
    __host__ __device__ static int cps(int H, bool fwd) {
        const int nch = (fwd ? H / 2 : 2 * H) / KCH;
        const size_t xch = fwd ? FWD_XCH : BWD_XCH;
        for (int c = nch; c >= 1; --c) {
            const size_t ring = stages(c);
            if (ring >= xch && weights(H, fwd) + ring <= (size_t)MAX_SMEM) return c;
        }
        return 0;
    }
    __host__ __device__ static size_t smem(int H, bool fwd) {
        return weights(H, fwd) + stages(cps(H, fwd));
    }
};

// The blocks of row group rg meet: every block's stores of this step are
// visible to every other block of the group after it.
__device__ __forceinline__ void group_barrier(unsigned* count, unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(count, 1u);
        while (*reinterpret_cast<volatile unsigned*>(count) < target) {
        }
        __threadfence();
    }
    __syncthreads();
}

// k = k0 .. k0 + nk - 1 of both K-halves (half h at h * kh + k) of the rows
// r0 .. r0+63 of src (B, ld) into a stage; rows past B are zeros
template <typename E>
__device__ __forceinline__ void load_stage(E* stage, int ap, const E* src, int ld, int kh, int k0,
                                           int nk, int r0, int B) {
    constexpr int EPC = 16 / (int)sizeof(E);
    const int cpr = nk / EPC, copies = 2 * RB * cpr;
    for (int i = threadIdx.x; i < copies; i += THREADS) {
        const int h = i / (RB * cpr), rem = i % (RB * cpr), r = rem / cpr, q = rem % cpr;
        const int row = r0 + r;
        const bool ok = row < B;
        const E* s = src + (size_t)(ok ? row : 0) * ld + h * kh + k0 + q * EPC;
        cp_async16(stage + (size_t)(h * RB + r) * ap + q * EPC, s, ok);
    }
}

// The stage loop of a product over a half's kh columns: stage st covers
// k = st * cps * KCH .. of each half; compute(a_s, k0, nk) multiplies the
// thread's half of a stage that has arrived
template <typename E, class Compute>
__device__ __forceinline__ void stream_product(E* ring, int ap, int cps, const E* src, int ld,
                                               int kh, int r0, int B, Compute compute) {
    const int per = cps * KCH, nst = (kh + per - 1) / per, half = threadIdx.x / HALF;
    const size_t stage = (size_t)2 * RB * ap;
    load_stage(ring, ap, src, ld, kh, 0, per < kh ? per : kh, r0, B);
    cp_commit();
    for (int st = 0; st < nst; ++st) {
        if (st + 1 < nst) {
            const int k1 = (st + 1) * per;
            load_stage(ring + ((st + 1) % 2) * stage, ap, src, ld, kh, k1,
                       kh - k1 < per ? kh - k1 : per, r0, B);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();
        const int k0 = st * per;
        compute(ring + (st % 2) * stage + (size_t)half * RB * ap, k0, kh - k0 < per ? kh - k0 : per);
        __syncthreads();
    }
}

template <typename E>
struct FwdArgs {
    float* S;            // (T*B, 4H): the sums over k < D; the loop writes the
                         // gate activations of every step back in their place
    const E* h_first;    // (B, H): h0 rounded
    const float* c0;
    const float* w_hh;   // (H, 4H)
    const float* b;      // (4H,)
    E* outs;             // (T, B, H)
    E* cseq;             // (T, B, H) or null
    float* hT;
    float* cT;           // (B, H): also the carried c
    unsigned* count;     // a barrier counter per row group, zeroed
    int T, B, H, cps;
};

// The (row, unit) pair p (0..7) of this thread within a tile, and which
// accumulator holds its gate g. FMA: rows ty + 16 i, units 2 tx + j,
// p = 2 i + j; MMA: warp w's rows 16 (w % 4) + lane / 4 + 8 rr, units
// 8 ug + 2 (lane % 4) + j, p = 4 rr + 2 ug + j, in the mma fragments
// acc[(g * 2 + ug) * 4 + 2 rr + j]. Half h (threads 128 h ..) finalizes
// pairs 4 h .. 4 h + 3.
template <typename E>
struct FwdMap {
    __device__ static void pair(int p, int& row, int& unit) {
        const int lt = threadIdx.x % HALF;
        if (is_bf16<E>) {
            const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
            row = 16 * w4 + lane / 4 + 8 * (p / 4);
            unit = 8 * ((p / 2) % 2) + 2 * (lane % 4) + p % 2;
        } else {
            row = lt / 8 + 16 * (p / 2);
            unit = 2 * (lt % 8) + p % 2;
        }
    }
    __device__ static constexpr int idx(int p, int g) {
        return is_bf16<E> ? (g * 2 + (p / 2) % 2) * 4 + (p / 4) * 2 + p % 2 : p * 4 + g;
    }
};

// acc += a KCH-deep chunk of h_prev (rows of a_s, ap wide) @ the W_hh rows
// w_c
template <typename E>
__device__ __forceinline__ void fwd_product(float (&acc)[32], const E* a_s, int ap,
                                            const E* w_c) {
    constexpr int WP = Loop<E>::WP;
    if constexpr (is_bf16<E>) {
        const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
        uint32_t af[4];
        ldsm_x4(af, a_s + (16 * w4 + lane % 16) * ap + (lane / 16) * 8);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            uint32_t bq[4];
            ldsm_x4_t(bq, w_c + (lane % 8 + (lane / 8) % 2 * 8) * WP + g * UB + (lane / 16) * 8);
            mma16816(acc[g * 8], acc[g * 8 + 1], acc[g * 8 + 2], acc[g * 8 + 3], af, bq[0],
                     bq[1]);
            mma16816(acc[g * 8 + 4], acc[g * 8 + 5], acc[g * 8 + 6], acc[g * 8 + 7], af, bq[2],
                     bq[3]);
        }
    } else {
        const int lt = threadIdx.x % HALF, ty = lt / 8, tx = lt % 8;
#pragma unroll
        for (int kk = 0; kk < KCH; kk += 4) {
            float4 av[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                av[i] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * ap + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 w0 = *reinterpret_cast<const float4*>(w_c + (kk + q) * WP + tx * 8);
                const float4 w1 = *reinterpret_cast<const float4*>(w_c + (kk + q) * WP + tx * 8 + 4);
                // w0: (gate 0, unit 2tx), (0, 2tx+1), (1, 2tx), (1, 2tx+1); w1 gates 2, 3
                const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float a = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
                    for (int g = 0; g < 4; ++g)
#pragma unroll
                        for (int j = 0; j < 2; ++j)
                            acc[(2 * i + j) * 4 + g] =
                                fmaf(a, wv[g * 2 + j], acc[(2 * i + j) * 4 + g]);
                }
            }
        }
    }
}

template <typename E>
__global__ void __launch_bounds__(THREADS, 1) forward_loop(FwdArgs<E> p) {
    using L = Loop<E>;
    using Map = FwdMap<E>;
    constexpr int WP = L::WP;
    extern __shared__ __align__(16) unsigned char smem[];
    E* w_s = reinterpret_cast<E*>(smem);
    E* ring = w_s + (size_t)p.H * WP;
    const int H = p.H, G = 4 * H, B = p.B, tid = threadIdx.x;
    const int u0 = blockIdx.x * UB, half = tid / HALF, lt = tid % HALF;
    const int ap = p.cps * KCH + L::PAD;
    // the block's slice of W_hh, rounded once
    for (int i = tid; i < H * NC; i += THREADS) {
        const int k = i / NC, c = i % NC, g = c / UB, u = c % UB;
        const int col = is_bf16<E> ? g * UB + u : (u / 2) * 8 + g * 2 + u % 2;
        w_s[(size_t)k * WP + col] = from_f<E>(p.w_hh[(size_t)k * G + g * H + u0 + u]);
    }
    // the biases of the four pairs this thread finalizes: their units do
    // not change from tile to tile
    float bias[4][4];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
        int row, unit;
        Map::pair(half * 4 + pp, row, unit);
#pragma unroll
        for (int g = 0; g < 4; ++g) bias[pp][g] = p.b[g * H + u0 + unit];
    }
    __syncthreads();
    const int ntiles = (B + RB - 1) / RB, kh = H / 2;
    float* xbuf = reinterpret_cast<float*>(ring);
    for (int t = 0; t < p.T; ++t) {
        const E* hp = t == 0 ? p.h_first : p.outs + (size_t)(t - 1) * B * H;
        for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
            const int r0 = tile * RB;
            float acc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = 0.f;
            // half 0 starts from the sums over x, half 1 from zero
            if (half == 0) {
#pragma unroll
                for (int pp = 0; pp < 8; pp += 2) {
                    int row, unit;
                    Map::pair(pp, row, unit);
                    if (r0 + row < B) {
                        const float* s = p.S + ((size_t)t * B + r0 + row) * G + u0 + unit;
#pragma unroll
                        for (int g = 0; g < 4; ++g) {
                            const float2 v = *reinterpret_cast<const float2*>(s + g * H);
                            acc[Map::idx(pp, g)] = v.x;
                            acc[Map::idx(pp + 1, g)] = v.y;
                        }
                    }
                }
            }
            // the carried c of the pairs this thread finalizes, fetched
            // before the product
            float c_prev[4];
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                int row, unit;
                Map::pair(half * 4 + pp, row, unit);
                const size_t at = (size_t)(r0 + row) * H + u0 + unit;
                c_prev[pp] = r0 + row < B ? (t == 0 ? p.c0[at] : p.cT[at]) : 0.f;
            }
            stream_product(ring, ap, p.cps, hp, H, kh, r0, B, [&](const E* a_s, int k0, int nk) {
                for (int c = 0; c < nk; c += KCH)
                    fwd_product<E>(acc, a_s + c, ap, w_s + (size_t)(half * kh + k0 + c) * WP);
            });
            // the halves meet: each writes the sums of the pairs the other
            // finalizes (indices chosen by a select, so that acc stays in
            // registers)
#pragma unroll
            for (int q = 0; q < 16; ++q)
                xbuf[(half * 16 + q) * HALF + lt] =
                    half ? acc[Map::idx(q / 4, q % 4)] : acc[Map::idx(4 + q / 4, q % 4)];
            __syncthreads();
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                int row, unit;
                Map::pair(half * 4 + pp, row, unit);
                row += r0;
                unit += u0;
                float v[4];
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    v[g] = (half ? acc[Map::idx(4 + pp, g)] : acc[Map::idx(pp, g)]) +
                           xbuf[((1 - half) * 16 + pp * 4 + g) * HALF + lt];
                if (row >= B) continue;
                const size_t at = (size_t)row * H + unit;
#pragma unroll
                for (int g = 0; g < 4; ++g) v[g] += bias[pp][g];
                const float ig = sigm(v[0]);
                const float fg = sigm(v[1]);
                const float gg = tanhf(v[2]);
                const float og = sigm(v[3]);
                // the gate activations of this step, for the backward (each
                // element of S was read by its one owner before the halves
                // met)
                float* sg = p.S + ((size_t)t * B + row) * G + unit;
                sg[0] = ig;
                sg[H] = fg;
                sg[2 * H] = gg;
                sg[3 * H] = og;
                const float c = fg * c_prev[pp] + ig * gg;
                const float h = og * tanhf(c);
                const size_t st = (size_t)t * B * H + at;
                p.outs[st] = from_f<E>(h);
                if (p.cseq) p.cseq[st] = from_f<E>(c);
                p.cT[at] = c;
                if (t == p.T - 1) p.hT[at] = h;
            }
            __syncthreads();  // the stages are the next tile's
        }
        if (t + 1 < p.T) group_barrier(p.count + blockIdx.y, (unsigned)(t + 1) * gridDim.x);
    }
}

template <typename E>
struct BwdArgs {
    const float* P;      // (T*B, 4H): the gate activations i, f, g, o
    const E* cseq;       // (T, B, H)
    const float* c0;
    const E* g_outs;     // (T, B, H)
    const float* g_hT;
    const float* g_cT;
    const float* w_hh;   // (H, 4H)
    E* dg;               // (T, B, 4H): the rounded dgates
    float* dh0;
    float* dc0;          // (B, H): also the carried dc
    float* db_part;      // (T * ceil(B / RB), 4H)
    unsigned* count;
    int T, B, H, cps;
};

// The backward's pairs: FMA rows lt / 4 + 32 i, units lt % 4 + 4 u, p =
// 4 i + u; MMA rows 16 (w % 4) + lane / 4 + 8 rr, units 8 nt + 2 (lane %
// 4) + j, p = 4 rr + 2 nt + j, in the fragments acc[nt * 4 + 2 rr + j].
// Half h finalizes pairs 4 h .. 4 h + 3.
template <typename E>
struct BwdMap {
    __device__ static void pair(int p, int& row, int& unit) {
        const int lt = threadIdx.x % HALF;
        if (is_bf16<E>) {
            const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
            row = 16 * w4 + lane / 4 + 8 * (p / 4);
            unit = 8 * ((p / 2) % 2) + 2 * (lane % 4) + p % 2;
        } else {
            row = lt / 4 + 32 * (p / 4);
            unit = lt % 4 + 4 * (p % 4);
        }
    }
    __device__ static constexpr int idx(int p) {
        return is_bf16<E> ? ((p / 2) % 2) * 4 + (p / 4) * 2 + p % 2 : p;
    }
};

// acc += a KCH-deep chunk of dg_{t+1} (rows of a_s, ap wide) @ W_hh^T's
// rows k0 ..
template <typename E>
__device__ __forceinline__ void bwd_product(float (&acc)[8], const E* a_s, int ap,
                                            const E* wt_s, int wp, int k0) {
    if constexpr (is_bf16<E>) {
        const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
        uint32_t af[4], bq[4];
        ldsm_x4(af, a_s + (16 * w4 + lane % 16) * ap + (lane / 16) * 8);
        ldsm_x4(bq, wt_s + (size_t)((lane / 16) * 8 + lane % 8) * wp + k0 + (lane / 8) % 2 * 8);
        mma16816(acc[0], acc[1], acc[2], acc[3], af, bq[0], bq[1]);
        mma16816(acc[4], acc[5], acc[6], acc[7], af, bq[2], bq[3]);
    } else {
        const int lt = threadIdx.x % HALF, ty = lt / 4, tx = lt % 4;
#pragma unroll
        for (int kk = 0; kk < KCH; kk += 4) {
            const float4 a0 = *reinterpret_cast<const float4*>(a_s + ty * ap + kk);
            const float4 a1 = *reinterpret_cast<const float4*>(a_s + (ty + 32) * ap + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float4 w =
                    *reinterpret_cast<const float4*>(wt_s + (size_t)(tx + 4 * u) * wp + k0 + kk);
                float s0 = acc[u], s1 = acc[4 + u];
                s0 = fmaf(a0.x, w.x, s0);
                s1 = fmaf(a1.x, w.x, s1);
                s0 = fmaf(a0.y, w.y, s0);
                s1 = fmaf(a1.y, w.y, s1);
                s0 = fmaf(a0.z, w.z, s0);
                s1 = fmaf(a1.z, w.z, s1);
                s0 = fmaf(a0.w, w.w, s0);
                s1 = fmaf(a1.w, w.w, s1);
                acc[u] = s0;
                acc[4 + u] = s1;
            }
        }
    }
}

template <typename E, bool ENC5>
__global__ void __launch_bounds__(THREADS, 1) backward_loop(BwdArgs<E> p) {
    using L = Loop<E>;
    using Map = BwdMap<E>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = p.H, G = 4 * H, B = p.B, T = p.T, tid = threadIdx.x;
    const int wp = L::wtp(H), ap = p.cps * KCH + L::PAD;
    E* wt_s = reinterpret_cast<E*>(smem);
    E* ring = wt_s + (size_t)UB * wp;
    const int u0 = blockIdx.x * UB, half = tid / HALF, lt = tid % HALF;
    for (int i = tid; i < UB * G; i += THREADS) {
        const int u = i / G, k = i % G;
        wt_s[(size_t)u * wp + k] = from_f<E>(p.w_hh[(size_t)(u0 + u) * G + k]);
    }
    __syncthreads();
    const int ntiles = (B + RB - 1) / RB, kh = 2 * H;
    float* xbuf = reinterpret_cast<float*>(ring);  // 2 x 4 x 128 floats
    float* dbs = xbuf + 8 * HALF;                   // (RB, NC)
    // s = 0 .. T - 1 is the reverse step t = T - 1 - s; s = T computes dh0
    for (int s = 0; s <= T; ++s) {
        const int t = T - 1 - s;
        const E* dgn = p.dg + (size_t)(t + 1) * B * G;  // dg_{t+1}, for s > 0
        for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
            const int r0 = tile * RB;
            // what the cell needs of the pairs this thread finalizes,
            // fetched before the product: the gate activations, c_t,
            // c_{t-1}, the incoming dh (g_outs, and g_hT at the last step)
            // and the carried dc
            float act[4][4], ct[4], cp[4], dh_in[4], dc_in[4];
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                int row, unit;
                Map::pair(half * 4 + pp, row, unit);
                row += r0;
                const bool ok = row < B && s < T;
                const size_t at = (size_t)row * H + u0 + unit;
                const size_t st = (size_t)t * B * H + at;
                const float* pr = p.P + ((size_t)t * B + row) * G + u0 + unit;
#pragma unroll
                for (int g = 0; g < 4; ++g) act[pp][g] = ok ? pr[g * H] : 0.f;
                ct[pp] = ok ? to_f(p.cseq[st]) : 0.f;
                cp[pp] = ok ? (t == 0 ? p.c0[at] : to_f(p.cseq[st - (size_t)B * H])) : 0.f;
                dh_in[pp] = ok ? to_f(p.g_outs[st]) + (s == 0 ? p.g_hT[at] : 0.f) : 0.f;
                dc_in[pp] = ok ? (s == 0 ? p.g_cT[at] : p.dc0[at]) : 0.f;
            }
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (s > 0) {
                float acc[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[i] = 0.f;
                stream_product(ring, ap, p.cps, dgn, G, kh, r0, B,
                               [&](const E* a_s, int k0, int nk) {
                                   for (int c = 0; c < nk; c += KCH)
                                       bwd_product<E>(acc, a_s + c, ap, wt_s, wp,
                                                      half * kh + k0 + c);
                               });
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    xbuf[(half * 4 + q) * HALF + lt] =
                        half ? acc[Map::idx(q)] : acc[Map::idx(4 + q)];
                __syncthreads();
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    v[q] = (half ? acc[Map::idx(4 + q)] : acc[Map::idx(q)]) +
                           xbuf[((1 - half) * 4 + q) * HALF + lt];
            }
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                int row, unit;
                Map::pair(half * 4 + pp, row, unit);
                const int r = row;
                row += r0;
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                if (row < B) {
                    const size_t at = (size_t)row * H + u0 + unit;
                    if (s == T) {
                        p.dh0[at] = v[pp];
                        continue;
                    }
                    float ig = act[pp][0], fg = act[pp][1], gg = act[pp][2], og = act[pp][3];
                    if (ENC5) {
                        ig = rnd<E>(ig);
                        fg = rnd<E>(fg);
                        gg = rnd<E>(gg);
                        og = rnd<E>(og);
                    }
                    // dh = dh_prev (the product; g_hT at the last step) + g_outs[t]
                    const float dh = (s == 0 ? 0.f : v[pp]) + dh_in[pp];
                    const float tc = tanhf(ct[pp]);
                    const float dout = dh * tc;
                    const float dc = dc_in[pp] + dh * og * (1.f - tc * tc);
                    const float di = dc * gg, dgg = dc * ig, df = dc * cp[pp];
                    d[0] = di * ig * (1.f - ig);
                    d[1] = df * fg * (1.f - fg);
                    d[2] = dgg * (1.f - gg * gg);
                    d[3] = dout * og * (1.f - og);
                    p.dc0[at] = dc * fg;
                    E* dgt = p.dg + ((size_t)t * B + row) * G + u0 + unit;
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        dgt[g * H] = from_f<E>(d[g]);
                        if (ENC5) d[g] = rnd<E>(d[g]);
                    }
                }
                if (s < T) {
#pragma unroll
                    for (int g = 0; g < 4; ++g) dbs[r * NC + g * UB + unit] = d[g];
                }
            }
            if (s < T) {
                __syncthreads();
                // the tile's column sums of the dgates, rows in order
                if (tid < NC) {
                    float sum = 0.f;
                    for (int r = 0; r < RB; ++r) sum += dbs[r * NC + tid];
                    p.db_part[((size_t)t * ntiles + tile) * G + (tid / UB) * H + u0 + tid % UB] =
                        sum;
                }
            }
            __syncthreads();  // the stages are the next tile's
        }
        if (s < T) group_barrier(p.count + blockIdx.y, (unsigned)(s + 1) * gridDim.x);
    }
}

// The loop's grid: H / UB unit blocks times RG row groups, every block
// resident at once. Returns the error a launch would give, before any
// launch.
template <typename Kernel>
cudaError_t plan(Kernel kernel, size_t smem, int H, int B, dim3& grid) {
    if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
    cudaError_t err;
    // the shared memory granted and the blocks the card holds at once,
    // asked once for each kernel, shared memory size and device
    struct Seen {
        const void* kernel;
        size_t smem;
        int dev, blocks;
    };
    static Seen seen[64];
    static int nseen = 0;
    int dev = 0, blocks = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    for (int i = 0; i < nseen; ++i)
        if (seen[i].kernel == reinterpret_cast<const void*>(kernel) && seen[i].smem == smem &&
            seen[i].dev == dev)
            blocks = seen[i].blocks;
    if (blocks == 0) {
        int per_sm = 0, sms = 0;
        // the most any call may ask for, so that a smaller call after a
        // larger one does not lower it
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        MAX_SMEM)) != cudaSuccess)
            return err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                                 smem)) != cudaSuccess)
            return err;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
            return err;
        blocks = per_sm * sms;
        if (nseen < 64) seen[nseen++] = Seen{reinterpret_cast<const void*>(kernel), smem, dev,
                                             blocks};
    }
    const int units = H / UB, ntiles = (B + RB - 1) / RB;
    const int groups = blocks / units;
    if (groups < 1) return cudaErrorCooperativeLaunchTooLarge;
    grid = dim3(units, groups < ntiles ? groups : ntiles);
    return cudaSuccess;
}

template <typename Kernel, typename Args>
cudaError_t launch_loop(Kernel kernel, const Args& args, dim3 grid, size_t smem,
                        cudaStream_t stream) {
    void* params[] = {const_cast<Args*>(&args)};
    const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                        grid, dim3(THREADS), params, smem, stream);
    return err == cudaSuccess ? launched() : err;
}

// ---------------------------------------------------------------------------
// The rows schedule, for large B: a block owns whole tiles of RB batch rows
// with all H units, so its rows' recurrence needs no other block (no
// barrier, an ordinary launch of min(tiles, resident blocks) blocks, each
// walking its tiles one after another through all T steps). Every product
// is a (RB x RN) chunk of outputs over K streamed through an RSTAGES-deep
// cp.async ring of (A: RB x KS, B: KS x RN) stages, one barrier a stage;
// the ring runs on across a step's chunks, so the next chunk's first
// stages load while a chunk's last one is multiplied and its epilogue
// stores. The weights stream from L2 (prep packs them once a call in the
// compute dtype, as the chunks read them).
// * forward: gates = [x_t | h_prev] @ [W_ih; W_hh] + b, K = D + H summed in
//   order in one f32 sum, then the bias (x @ W_ih is not a GEMM of its own
//   here: no S slab is written or read); a chunk is RN / 4 units with
//   their four gates. The chunk's outputs go through a shared tile to the
//   epilogue, a thread to a unit and a quarter of the rows, coalesced.
// * backward: dh = dg_{t+1} @ W_hh^T, K = 4H, a chunk is RN units; through
//   the tile to a thread for each unit and all the tile's rows in order:
//   the cell's reverse step as the units loop's, and the unit's column
//   sums of the dgates (no sum across threads) as a row of db_part.
// Math units as the units loops': f32 on FMA (8 x 8 outputs a thread),
// bf16 on mma.sync (eight warps of 32 x 64).

constexpr int RN = 256;     // output columns of a rows-schedule chunk
constexpr int RSTAGES = 3;  // stages of its ring
constexpr int TP = RN + 4;  // row pitch of the chunk's output tile
constexpr int RFU = RN / 4; // the forward's units of a chunk

template <typename E>
struct RowsCfg {
    static constexpr int KS = is_bf16<E> ? 64 : 32;  // k depth of a stage
    static constexpr int EPC = 16 / (int)sizeof(E);  // elements of a 16-byte copy
    static constexpr int PAD = is_bf16<E> ? 8 : 4;
    static constexpr int AP = KS + PAD;              // A stage row pitch
    static constexpr int BP = RN + PAD;              // B stage row pitch
    static constexpr int STAGE = RB * AP + KS * BP;  // elements of a stage
    // the ring, then a chunk's outputs (RB x TP f32), which the epilogue
    // reads with a thread to a unit column
    static size_t smem() { return RSTAGES * (size_t)STAGE * sizeof(E) + (size_t)RB * TP * 4; }
    __host__ __device__ static int fwd_k(int D, int H) { return (D + H + KS - 1) / KS * KS; }
    // elements of the packed weights: the forward's [W_ih; W_hh] in chunks
    // of RFU units, the backward's W_hh^T in chunks of RN units
    static size_t pack(int D, int H, bool fwd) {
        return fwd ? (size_t)((H + RFU - 1) / RFU) * fwd_k(D, H) * RN
                   : (size_t)((H + RN - 1) / RN) * 4 * H * RN;
    }
};

// The packed weights: fwd w[c][k][n] = [W_ih; W_hh][k][g H + c RFU + u],
// where column n of a forward chunk holds gate g of unit u: f32 keeps a
// unit's four gates side by side (n = 128 (u / 32) + 4 (u % 32) + g: a
// thread owns units tx and tx + 32), bf16 a warp's 16 units per gate (n =
// 64 (u / 16) + 16 g + u % 16: the mma fragments' columns); bwd w[c][k][n]
// = W_hh[c RN + n][k]. Zero past H and past D + H.
template <typename E>
__device__ E packed_weight(size_t i, const float* w_ih, const float* w_hh, int D, int H,
                           bool fwd) {
    using R = RowsCfg<E>;
    const int n = (int)(i % RN);
    if (fwd) {
        const int Kp = R::fwd_k(D, H);
        const int k = (int)(i / RN % Kp), c = (int)(i / RN / Kp);
        // gate and unit of column n
        const int g = is_bf16<E> ? n % 64 / 16 : n % 4;
        const int u = is_bf16<E> ? n / 64 * 16 + n % 16 : n / 128 * 32 + n % 128 / 4;
        const int unit = c * RFU + u;
        if (unit >= H || k >= D + H) return from_f<E>(0.f);
        const size_t col = (size_t)g * H + unit;
        return from_f<E>(k < D ? w_ih[(size_t)k * 4 * H + col] : w_hh[(size_t)(k - D) * 4 * H + col]);
    }
    const int G = 4 * H;
    const int k = (int)(i / RN % G), c = (int)(i / RN / G);
    const int unit = c * RN + n;
    return from_f<E>(unit < H ? w_hh[(size_t)unit * G + k] : 0.f);
}

template <typename E>
struct PackArgs {
    const float* w_ih;  // null for the backward's W_hh^T
    const float* w_hh;
    E* w;               // null: nothing to pack
    int D, H, fwd;
};

// h0 rounded to E into h_first (the forward loop's first operand), the
// barrier counters zeroed and, for the rows schedule, the weights packed
template <typename E>
__global__ void prep(const float* __restrict__ h0, E* __restrict__ h_first, long long n,
                     unsigned* __restrict__ count, int ncount, PackArgs<E> pk, long long npack) {
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    if (i0 < ncount) count[i0] = 0u;
    if (h_first != nullptr)
        for (long long i = i0; i < n; i += stride) h_first[i] = from_f<E>(h0[i]);
    for (long long i = i0; i < npack; i += stride)
        pk.w[i] = packed_weight<E>((size_t)i, pk.w_ih, pk.w_hh, pk.D, pk.H, pk.fwd != 0);
}

template <typename E>
cudaError_t launch_prep(const float* h0, E* h_first, long long n, unsigned* count, int ncount,
                        cudaStream_t stream, PackArgs<E> pk = PackArgs<E>{}, long long npack = 0) {
    long long most = h_first ? n : 0;
    if (ncount > most) most = ncount;
    if (npack > most) most = npack;
    long long blocks = (most + THREADS - 1) / THREADS;
    if (blocks > 1024) blocks = 1024;
    if (blocks < 1) blocks = 1;
    prep<E><<<(int)blocks, THREADS, 0, stream>>>(h0, h_first, n, count, ncount, pk, npack);
    return launched();
}

// The ring: jobs 0 .. njobs-1 each load one stage (load(job, stage)) and
// multiply it (step(job, stage)), RSTAGES - 1 loads in flight ahead of the
// product. It opens with a barrier, so that whatever the block stored
// before is visible to its loads and no stage is still being read.
template <typename E, class Load, class Step>
__device__ __forceinline__ void rows_ring(E* ring, int njobs, Load load, Step step) {
    constexpr int S = RowsCfg<E>::STAGE;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RSTAGES - 1; ++j) {
        if (j < njobs) load(j, ring + j * S);
        cp_commit();
    }
    for (int j = 0; j < njobs; ++j) {
        cp_wait<RSTAGES - 2>();
        __syncthreads();
        const int nj = j + RSTAGES - 1;
        if (nj < njobs) load(nj, ring + (nj % RSTAGES) * S);
        cp_commit();
        step(j, ring + (j % RSTAGES) * S);
    }
}

// A stage's A rows: k0 .. k0 + KS - 1 of rows r0 .. r0 + RB - 1 of [a1 |
// a2] (a1 (B, n1), a2 (B, n2); a2 may be null with n2 0), zeros past
// n1 + n2 and past B. n1 is a multiple of EPC, so no 16-byte run straddles
// the two.
template <typename E>
__device__ __forceinline__ void rows_load_a(E* as, const E* a1, int n1, const E* a2, int n2, int k0,
                                            int r0, int B) {
    using R = RowsCfg<E>;
    constexpr int RUNS = R::KS / R::EPC;
    for (int i = threadIdx.x; i < RB * RUNS; i += THREADS) {
        const int r = i / RUNS, k = k0 + i % RUNS * R::EPC, row = r0 + r;
        const E* src = a1;
        bool ok = row < B;
        if (k < n1)
            src = a1 + (size_t)row * n1 + k;
        else if (k < n1 + n2)
            src = a2 + (size_t)row * n2 + (k - n1);
        else
            ok = false;
        cp_async16(as + r * R::AP + i % RUNS * R::EPC, ok ? src : a1, ok);
    }
}

// a stage's B rows: KS contiguous rows of RN packed weights
template <typename E>
__device__ __forceinline__ void rows_load_b(E* bs, const E* w) {
    using R = RowsCfg<E>;
    constexpr int RUNS = RN / R::EPC;
    for (int i = threadIdx.x; i < R::KS * RUNS; i += THREADS) {
        const int k = i / RUNS, q = i % RUNS;
        cp_async16(bs + k * R::BP + q * R::EPC, w + (size_t)k * RN + q * R::EPC, true);
    }
}

// The outputs a thread holds of a chunk, acc[64]. f32: rows ty + 8 i,
// columns 4 tx + j (j < 4) and 128 + 4 tx + j - 4, acc[8 i + j], with ty =
// 4 (warp / 4) + lane / 8 and tx = 8 (warp % 4) + lane % 8. bf16: warp
// (wm, wn) = (warp / 4, warp % 4), rows 32 wm + 16 mi + lane / 4 + 8 (q /
// 2), columns 64 wn + 8 nj + 2 (lane % 4) + q % 2, acc[4 (8 mi + nj) + q].
template <typename E>
struct RowsMap {
    __device__ static int ty() { return threadIdx.x / 128 * 4 + threadIdx.x % 32 / 8; }
    __device__ static int tx() { return threadIdx.x / 32 % 4 * 8 + threadIdx.x % 8; }
    __device__ static void at(int a, int& row, int& col) {
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        if (is_bf16<E>) {
            const int mi = a / 32, nj = a / 4 % 8, q = a % 4;
            row = 32 * (warp / 4) + 16 * mi + lane / 4 + 8 * (q / 2);
            col = 64 * (warp % 4) + 8 * nj + 2 * (lane % 4) + q % 2;
        } else {
            const int i = a / 8, j = a % 8;
            row = ty() + 8 * i;
            col = j < 4 ? 4 * tx() + j : 128 + 4 * tx() + j - 4;
        }
    }
};

// acc += the stage's A (RB x KS) @ B (KS x RN)
template <typename E>
__device__ __forceinline__ void rows_product(float (&acc)[64], const E* as, const E* bs) {
    using R = RowsCfg<E>;
    if constexpr (is_bf16<E>) {
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        const int wm = (warp / 4) * 32, wn = (warp % 4) * 64;
#pragma unroll
        for (int ks = 0; ks < R::KS; ks += 16) {
            uint32_t af[2][4], bq[4][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                ldsm_x4(af[mi], as + (wm + mi * 16 + lane % 16) * R::AP + ks + (lane / 16) * 8);
#pragma unroll
            for (int jb = 0; jb < 4; ++jb)
                ldsm_x4_t(bq[jb], bs + (ks + lane % 8 + (lane / 8) % 2 * 8) * R::BP + wn + jb * 16 +
                                      (lane / 16) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int nj = 0; nj < 8; ++nj) {
                    float* d = acc + (mi * 8 + nj) * 4;
                    mma16816(d[0], d[1], d[2], d[3], af[mi], bq[nj / 2][(nj % 2) * 2],
                             bq[nj / 2][(nj % 2) * 2 + 1]);
                }
        }
    } else {
        const int ty = RowsMap<E>::ty(), tx = RowsMap<E>::tx();
#pragma unroll
        for (int kk = 0; kk < R::KS; kk += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                a[i] = *reinterpret_cast<const float4*>(as + (ty + 8 * i) * R::AP + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 b0 = *reinterpret_cast<const float4*>(bs + (kk + q) * R::BP + 4 * tx);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(bs + (kk + q) * R::BP + 128 + 4 * tx);
                const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av, bv[j], acc[i * 8 + j]);
                }
            }
        }
    }
}

template <typename E>
struct RowsFwdArgs {
    const E* x;          // (T, B, D): the cell's input
    const E* h_first;    // (B, H): h0 rounded
    const float* c0;
    const E* w;          // the packed [W_ih; W_hh]
    const float* b;      // (4H,)
    float* gates;        // (T*B, 4H): every step's gate activations, for the backward
    E* outs;             // (T, B, H)
    E* cseq;             // (T, B, H) or null
    float* hT;
    float* cT;           // (B, H): also the carried c
    int T, B, D, H;
};

// acc into the chunk's output tile, (RB, TP) f32, at RowsMap's places
template <typename E>
__device__ __forceinline__ void store_tile(float* tile, const float (&acc)[64]) {
#pragma unroll
    for (int a = 0; a < 64; ++a) {
        int row, col;
        RowsMap<E>::at(a, row, col);
        tile[row * TP + col] = acc[a];
    }
}

template <typename E>
__global__ void __launch_bounds__(THREADS, 1) rows_forward(RowsFwdArgs<E> p) {
    using R = RowsCfg<E>;
    extern __shared__ __align__(16) unsigned char smem[];
    E* ring = reinterpret_cast<E*>(smem);
    float* tile = reinterpret_cast<float*>(ring + RSTAGES * R::STAGE);
    const int H = p.H, G = 4 * H, B = p.B, D = p.D;
    const int Kp = R::fwd_k(D, H), nks = Kp / R::KS, nch = (H + RFU - 1) / RFU;
    const int ntiles = (B + RB - 1) / RB;
    // the epilogue's thread: one unit of the chunk, every fourth row
    const int eu = threadIdx.x % RFU, er = threadIdx.x / RFU;
    constexpr int ER = RB / (THREADS / RFU);  // its rows
    // the tile's column of gate g of unit eu (packed_weight's layout)
    const int ecol = is_bf16<E> ? eu / 16 * 64 + eu % 16 : eu / 32 * 128 + eu % 32 * 4;
    const int gstep = is_bf16<E> ? 16 : 1;
    float acc[64];
    for (int tile_i = blockIdx.x; tile_i < ntiles; tile_i += gridDim.x) {
        const int r0 = tile_i * RB;
        for (int t = 0; t < p.T; ++t) {
            const E* hp = t == 0 ? p.h_first : p.outs + (size_t)(t - 1) * B * H;
            const E* xt = p.x + (size_t)t * B * D;
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.f;
            // the chunk of a job: each tile starts at another, so that the
            // blocks of a step do not all read the same weights at once
            auto chunk = [&](int job) { return (job / nks + tile_i) % nch; };
            auto load = [&](int job, E* st) {
                const int k0 = job % nks * R::KS;
                rows_load_a<E>(st, xt, D, hp, H, k0, r0, B);
                rows_load_b<E>(st + RB * R::AP, p.w + ((size_t)chunk(job) * Kp + k0) * RN);
            };
            rows_ring<E>(ring, nch * nks, load, [&](int job, const E* st) {
                rows_product<E>(acc, st, st + RB * R::AP);
                if (job % nks != nks - 1) return;
                // the chunk's epilogue, through the tile (the ring's next
                // stages keep loading meanwhile)
                store_tile<E>(tile, acc);
#pragma unroll
                for (int i = 0; i < 64; ++i) acc[i] = 0.f;
                __syncthreads();
                const int unit = chunk(job) * RFU + eu;
                if (unit < H) {
                    float bias[4], c_prev[ER];
#pragma unroll
                    for (int g = 0; g < 4; ++g) bias[g] = p.b[g * H + unit];
#pragma unroll
                    for (int i = 0; i < ER; ++i) {
                        const int row = r0 + er + 4 * i;
                        const size_t at = (size_t)row * H + unit;
                        c_prev[i] = row >= B ? 0.f : t == 0 ? p.c0[at] : p.cT[at];
                    }
#pragma unroll
                    for (int i = 0; i < ER; ++i) {
                        const int r = er + 4 * i, row = r0 + r;
                        if (row >= B) break;
                        const size_t at = (size_t)row * H + unit;
                        float v[4];
                        float* sg = p.gates + ((size_t)t * B + row) * G + unit;
#pragma unroll
                        for (int g = 0; g < 4; ++g) v[g] = tile[r * TP + ecol + g * gstep] + bias[g];
                        const float ig = sigm(v[0]);
                        const float fg = sigm(v[1]);
                        const float gg = tanhf(v[2]);
                        const float og = sigm(v[3]);
                        sg[0] = ig;
                        sg[H] = fg;
                        sg[2 * H] = gg;
                        sg[3 * H] = og;
                        const float c = fg * c_prev[i] + ig * gg;
                        const float h = og * tanhf(c);
                        const size_t st2 = (size_t)t * B * H + at;
                        p.outs[st2] = from_f<E>(h);
                        if (p.cseq) p.cseq[st2] = from_f<E>(c);
                        p.cT[at] = c;
                        if (t == p.T - 1) p.hT[at] = h;
                    }
                }
            });
        }
    }
}

template <typename E>
struct RowsBwdArgs {
    const float* P;      // (T*B, 4H): the gate activations i, f, g, o
    const E* cseq;       // (T, B, H)
    const float* c0;
    const E* g_outs;     // (T, B, H)
    const float* g_hT;
    const float* g_cT;
    const E* w;          // the packed W_hh^T
    E* dg;               // (T, B, 4H): the rounded dgates
    float* dh0;
    float* dc0;          // (B, H): also the carried dc
    float* db_part;      // (T * ceil(B / RB), 4H)
    int T, B, H;
};

template <typename E, bool ENC5>
__global__ void __launch_bounds__(THREADS, 1) rows_backward(RowsBwdArgs<E> p) {
    using R = RowsCfg<E>;
    extern __shared__ __align__(16) unsigned char smem[];
    E* ring = reinterpret_cast<E*>(smem);
    float* tile = reinterpret_cast<float*>(ring + RSTAGES * R::STAGE);
    const int H = p.H, G = 4 * H, B = p.B, T = p.T;
    const int nks = G / R::KS, nch = (H + RN - 1) / RN, ntiles = (B + RB - 1) / RB;
    constexpr int EB = 8;  // rows whose inputs the epilogue fetches at once
    float acc[64];
    for (int tile_i = blockIdx.x; tile_i < ntiles; tile_i += gridDim.x) {
        const int r0 = tile_i * RB, rows = B - r0 < RB ? B - r0 : RB;
        // s = 0 .. T - 1 is the reverse step t = T - 1 - s; s = T computes dh0
        for (int s = 0; s <= T; ++s) {
            const int t = T - 1 - s;
            // the epilogue of chunk c, a thread to a unit and all the tile's
            // rows in order: dh_prev from the tile (none at s = 0, where dh
            // is g_hT alone), the cell's reverse step, and the unit's
            // column sums of the dgates for db
            auto epilogue = [&](int c) {
                const int unit = c * RN + threadIdx.x;
                if (unit >= H) return;
                if (s == T) {
                    for (int r = 0; r < rows; ++r)
                        p.dh0[(size_t)(r0 + r) * H + unit] = tile[r * TP + threadIdx.x];
                    return;
                }
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                for (int rb = 0; rb < rows; rb += EB) {
                    float act[EB][4], ct[EB], cp[EB], dh[EB], dc_in[EB];
#pragma unroll
                    for (int i = 0; i < EB; ++i) {
                        const int row = r0 + rb + i;
                        const bool ok = rb + i < rows;
                        const size_t at = (size_t)row * H + unit;
                        const size_t st = (size_t)t * B * H + at;
                        const float* pr = p.P + ((size_t)t * B + row) * G + unit;
#pragma unroll
                        for (int g = 0; g < 4; ++g) act[i][g] = ok ? ld_ro(pr + g * H) : 0.f;
                        ct[i] = ok ? ld_ro(p.cseq + st) : 0.f;
                        cp[i] = !ok ? 0.f : t == 0 ? ld_ro(p.c0 + at) : ld_ro(p.cseq + st - (size_t)B * H);
                        dh[i] = !ok ? 0.f
                                    : (s == 0 ? 0.f : tile[(rb + i) * TP + threadIdx.x]) +
                                          (ld_ro(p.g_outs + st) + (s == 0 ? ld_ro(p.g_hT + at) : 0.f));
                        dc_in[i] = !ok ? 0.f : s == 0 ? ld_ro(p.g_cT + at) : p.dc0[at];
                    }
#pragma unroll
                    for (int i = 0; i < EB; ++i) {
                        if (rb + i >= rows) break;
                        const int row = r0 + rb + i;
                        const size_t at = (size_t)row * H + unit;
                        float ig = act[i][0], fg = act[i][1], gg = act[i][2], og = act[i][3];
                        if (ENC5) {
                            ig = rnd<E>(ig);
                            fg = rnd<E>(fg);
                            gg = rnd<E>(gg);
                            og = rnd<E>(og);
                        }
                        const float tc = tanhf(ct[i]);
                        const float dout = dh[i] * tc;
                        const float dc = dc_in[i] + dh[i] * og * (1.f - tc * tc);
                        const float di = dc * gg, dgg = dc * ig, df = dc * cp[i];
                        float d[4];
                        d[0] = di * ig * (1.f - ig);
                        d[1] = df * fg * (1.f - fg);
                        d[2] = dgg * (1.f - gg * gg);
                        d[3] = dout * og * (1.f - og);
                        p.dc0[at] = dc * fg;
                        E* dgt = p.dg + ((size_t)t * B + row) * G + unit;
#pragma unroll
                        for (int g = 0; g < 4; ++g) {
                            dgt[g * H] = from_f<E>(d[g]);
                            part[g] += ENC5 ? rnd<E>(d[g]) : d[g];
                        }
                    }
                }
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    p.db_part[((size_t)t * ntiles + tile_i) * G + g * H + unit] = part[g];
            };
            if (s == 0) {
                for (int c = 0; c < nch; ++c) epilogue(c);
                continue;
            }
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.f;
            const E* dgn = p.dg + (size_t)(t + 1) * B * G;  // dg_{t+1}
            auto load = [&](int job, E* st) {
                const int c = job / nks, k0 = job % nks * R::KS;
                rows_load_a<E>(st, dgn, G, nullptr, 0, k0, r0, B);
                rows_load_b<E>(st + RB * R::AP, p.w + ((size_t)c * G + k0) * RN);
            };
            rows_ring<E>(ring, nch * nks, load, [&](int job, const E* st) {
                rows_product<E>(acc, st, st + RB * R::AP);
                if (job % nks != nks - 1) return;
                store_tile<E>(tile, acc);
#pragma unroll
                for (int i = 0; i < 64; ++i) acc[i] = 0.f;
                __syncthreads();
                epilogue(job / nks);
            });
        }
    }
}

// The rows schedule's grid: at most one block for each tile, at most as
// many as the card holds at once (more would only wait). An ordinary
// launch: no block waits for another.
template <typename Kernel>
cudaError_t rows_grid(Kernel kernel, size_t smem, int B, dim3& grid) {
    cudaError_t err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
        cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int ntiles = (B + RB - 1) / RB;
    grid = dim3(ntiles < per_sm * sms ? ntiles : per_sm * sms);
    return cudaSuccess;
}

bool shape_ok(int T, int B, int D, int H) {
    return T > 0 && B > 0 && D > 0 && H >= HIDDEN_MULTIPLE && H % HIDDEN_MULTIPLE == 0;
}

// Whether B rows make enough tiles for the rows schedule: they fill at
// least half the card's SMs (fewer blocks leave the card idle, and the
// units schedule spreads each tile's units over many blocks instead).
bool many_tiles(int B) {
    static int sms_of[64];  // SMs of each device, asked once
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
    if (sms_of[dev] == 0 &&
        cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return false;
    return 2 * ((B + RB - 1) / RB) >= sms_of[dev];
}

// whether the rows forward can stream x's rows as 16-byte runs
template <typename E>
bool rows_reads(const E* x, int D) {
    return D % RowsCfg<E>::EPC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// The rows schedule's forward from x (the cell's input): prep (h0
// rounded, [W_ih; W_hh] packed into wpack), then the loop.
template <typename E>
cudaError_t rows_forward_call(const E* x, const float* h0, const float* c0, const float* w_ih,
                              const float* w_hh, const float* b, E* outs, E* cseq, float* hT,
                              float* cT, float* gates, E* h_first, E* wpack, int T, int B, int D,
                              int H, cudaStream_t stream) {
    using R = RowsCfg<E>;
    dim3 grid;
    const size_t smem = R::smem();
    cudaError_t err = rows_grid(rows_forward<E>, smem, B, grid);
    if (err != cudaSuccess) return err;
    if ((err = launch_prep<E>(h0, h_first, (long long)B * H, nullptr, 0, stream,
                              PackArgs<E>{w_ih, w_hh, wpack, D, H, 1},
                              (long long)R::pack(D, H, true))) != cudaSuccess)
        return err;
    RowsFwdArgs<E> args{x, h_first, c0, wpack, b, gates, outs, cseq, hT, cT, T, B, D, H};
    rows_forward<E><<<grid, THREADS, smem, stream>>>(args);
    return launched();
}

// The units schedule's forward from x: prep, S = x @ W_ih, then the loop.
template <typename E>
cudaError_t units_forward_call(const E* x, const float* h0, const float* c0, const float* w_ih,
                               const float* w_hh, const float* b, E* outs, E* cseq, float* hT,
                               float* cT, float* S, E* h_first, unsigned* count, int T, int B,
                               int D, int H, cudaStream_t stream) {
    dim3 grid;
    const size_t smem = Loop<E>::smem(H, true);
    cudaError_t err = plan(forward_loop<E>, smem, H, B, grid);
    if (err != cudaSuccess) return err;
    const int G = 4 * H;
    if ((err = launch_prep<E>(h0, h_first, (long long)B * H, count, grid.y, stream)) !=
        cudaSuccess)
        return err;
    if ((err = launch_gemm<E>(Rows<E, E>{x, D}, RowsB<E, float>{w_ih, G}, StoreF32{S, G}, T * B,
                              G, D, 1, nullptr, nullptr, stream)) != cudaSuccess)
        return err;
    FwdArgs<E> args{S, h_first, c0, w_hh, b, outs, cseq, hT, cT, count, T, B, H,
                    Loop<E>::cps(H, true)};
    return launch_loop(forward_loop<E>, args, grid, smem, stream);
}

template <typename E>
int forward(const E* x, const float* h0, const float* c0, const float* w_ih, const float* w_hh,
            const float* b, E* outs, E* cseq, float* hT, float* cT, float* S, E* h_first,
            unsigned* count, E* wpack, int T, int B, int D, int H, cudaStream_t stream) {
    if (wpack && many_tiles(B) && rows_reads(x, D))
        return (int)rows_forward_call<E>(x, h0, c0, w_ih, w_hh, b, outs, cseq, hT, cT, S, h_first,
                                         wpack, T, B, D, H, stream);
    return (int)units_forward_call<E>(x, h0, c0, w_ih, w_hh, b, outs, cseq, hT, cT, S, h_first,
                                      count, T, B, D, H, stream);
}

// The reverse loop, dx (or enc5's dpre), dW and db, from the gates P the
// forward kept. x is the cell's input (enc5: the encoded xs); dpre null for
// cat. The loop runs the rows schedule where wpack is given and B makes
// many tiles, else the units schedule.
template <typename E, bool ENC5>
cudaError_t backward_core(const E* x, const float* h0, const float* c0, const float* w_ih,
                          const float* w_hh, const E* outs, const E* cseq, const E* g_outs,
                          const float* g_hT, const float* g_cT, E* dx, E* dpre, float* dh0,
                          float* dc0, float* dw, float* db, const float* P, E* dg,
                          float* db_part, float* dw_part, unsigned* count, E* wpack, int splits,
                          int T, int B, int D, int H, cudaStream_t stream) {
    const int G = 4 * H, M = T * B;
    dim3 grid;
    cudaError_t err;
    if (wpack && many_tiles(B)) {
        using R = RowsCfg<E>;
        const size_t smem = R::smem();
        if ((err = rows_grid(rows_backward<E, ENC5>, smem, B, grid)) != cudaSuccess) return err;
        if ((err = launch_prep<E>(nullptr, nullptr, 0, nullptr, 0, stream,
                                  PackArgs<E>{nullptr, w_hh, wpack, D, H, 0},
                                  (long long)R::pack(D, H, false))) != cudaSuccess)
            return err;
        RowsBwdArgs<E> args{P, cseq, c0, g_outs, g_hT, g_cT, wpack, dg, dh0, dc0, db_part,
                            T, B, H};
        rows_backward<E, ENC5><<<grid, THREADS, smem, stream>>>(args);
        if ((err = launched()) != cudaSuccess) return err;
    } else {
        const size_t smem = Loop<E>::smem(H, false);
        if ((err = plan(backward_loop<E, ENC5>, smem, H, B, grid)) != cudaSuccess) return err;
        if ((err = launch_prep<E>(nullptr, nullptr, 0, count, grid.y, stream)) != cudaSuccess)
            return err;
        BwdArgs<E> args{P,   cseq, c0,      g_outs, g_hT, g_cT, w_hh, dg, dh0,
                        dc0, db_part, count, T, B, H, Loop<E>::cps(H, false)};
        if ((err = launch_loop(backward_loop<E, ENC5>, args, grid, smem, stream)) != cudaSuccess)
            return err;
    }
    XH<E> xh{x, h0, outs, B, D, H};
    if (ENC5)
        err = launch_gemm<E>(Rows<E, E>{dg, G}, WeightT<E>{w_ih, G}, DpreOut<E>{dpre, x, D}, M,
                             D, G, 1, nullptr, nullptr, stream);
    else
        err = launch_gemm<E>(Rows<E, E>{dg, G}, WeightT<E>{w_ih, G}, StoreE<E>{dx, D}, M, D, G,
                             1, nullptr, nullptr, stream);
    if (err != cudaSuccess) return err;
    if ((err = launch_gemm<E>(XHCols<E>{xh}, RowsB<E, E>{dg, G}, StoreF32{dw, G}, D + H, G, M,
                              splits, dw_part, dw, stream)) != cudaSuccess)
        return err;
    column_sums<<<(G + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        db_part, db, T * ((B + RB - 1) / RB), G);
    return launched();
}

template <typename E>
int backward(const E* x, const float* h0, const float* c0, const float* w_ih, const float* w_hh,
             const E* outs, const E* cseq, const E* g_outs, const float* g_hT,
             const float* g_cT, E* dx, float* dh0, float* dc0, float* dw, float* db,
             const float* P, E* dg, float* db_part, float* dw_part, unsigned* count, E* wpack,
             int splits, int T, int B, int D, int H, cudaStream_t stream) {
    return (int)backward_core<E, false>(x, h0, c0, w_ih, w_hh, outs, cseq, g_outs, g_hT, g_cT,
                                        dx, nullptr, dh0, dc0, dw, db, P, dg, db_part, dw_part,
                                        count, wpack, splits, T, B, D, H, stream);
}

// The error the loop of the schedule a call takes would give, asked before
// the call's first launch (enc5 launches its encoder before the loop)
template <typename E, bool ENC5>
cudaError_t loop_error(bool fwd, bool rows, int B, int H) {
    dim3 grid;
    if (rows)
        return fwd ? rows_grid(rows_forward<E>, RowsCfg<E>::smem(), B, grid)
                   : rows_grid(rows_backward<E, ENC5>, RowsCfg<E>::smem(), B, grid);
    return fwd ? plan(forward_loop<E>, Loop<E>::smem(H, true), H, B, grid)
               : plan(backward_loop<E, ENC5>, Loop<E>::smem(H, false), H, B, grid);
}

template <typename E>
cudaError_t encode(const E* feats, const float* w_enc, const float* b_enc, E* xs, int T, int B,
                   int F, int D, cudaStream_t stream) {
    return launch_gemm<E>(Rows<E, E>{feats, F}, RowsB<E, float>{w_enc, D},
                          EncodeOut<E>{xs, b_enc, D}, T * B, D, F, 1, nullptr, nullptr, stream);
}

template <typename E>
int enc_forward(const E* feats, const float* h0, const float* c0, const float* w_enc,
                const float* b_enc, const float* w_ih, const float* w_hh, const float* b,
                E* outs, E* cseq, float* hT, float* cT, E* xs, float* S, E* h_first,
                unsigned* count, E* wpack, int T, int B, int F, int D, int H,
                cudaStream_t stream) {
    cudaError_t err = loop_error<E, false>(true, wpack && many_tiles(B) && rows_reads(xs, D), B, H);
    if (err != cudaSuccess) return (int)err;
    if ((err = encode<E>(feats, w_enc, b_enc, xs, T, B, F, D, stream)) != cudaSuccess)
        return (int)err;
    return forward<E>(xs, h0, c0, w_ih, w_hh, b, outs, cseq, hT, cT, S, h_first, count, wpack, T,
                      B, D, H, stream);
}

template <typename E>
int enc_backward(const E* feats, const float* h0, const float* c0, const float* w_enc,
                 const float* b_enc, const float* w_ih, const float* w_hh, const E* outs,
                 const E* cseq, const E* g_outs, const float* g_hT, const float* g_cT,
                 float* dh0, float* dc0, float* dwe, float* dw, float* db, E* xs, E* dpre,
                 const float* P, E* dg, float* db_part, float* dw_part, float* dwe_part,
                 unsigned* count, E* wpack, int splits_w, int splits_e, int T, int B, int F,
                 int D, int H, cudaStream_t stream) {
    cudaError_t err = loop_error<E, true>(false, wpack && many_tiles(B), B, H);
    if (err != cudaSuccess) return (int)err;
    // x recomputed by the forward's encoder, bit for bit
    if ((err = encode<E>(feats, w_enc, b_enc, xs, T, B, F, D, stream)) != cudaSuccess)
        return (int)err;
    if ((err = backward_core<E, true>(xs, h0, c0, w_ih, w_hh, outs, cseq, g_outs, g_hT, g_cT,
                                      nullptr, dpre, dh0, dc0, dw, db, P, dg, db_part, dw_part,
                                      count, wpack, splits_w, T, B, D, H, stream)) != cudaSuccess)
        return (int)err;
    // [dW_enc; db_enc] = [feats | 1]^T dpre, (F + 1, D)
    return (int)launch_gemm<E>(FeatOnesCols<E>{feats, F}, RowsB<E, E>{dpre, D}, StoreF32{dwe, D},
                               F + 1, D, T * B, splits_e, dwe_part, dwe, stream);
}

// the largest hidden size both loops' stages and weights fit a block at
int max_hidden(bool bf16_cdt) {
    int best = 0;
    for (int H = HIDDEN_MULTIPLE; H <= 8192; H += HIDDEN_MULTIPLE) {
        const bool fits = bf16_cdt ? Loop<bf16>::cps(H, true) && Loop<bf16>::cps(H, false)
                                   : Loop<float>::cps(H, true) && Loop<float>::cps(H, false);
        if (fits) best = H;
    }
    return best;
}

bool hidden_ok(int H, int cdt_bf16) {
    return cdt_bf16 ? Loop<bf16>::cps(H, true) && Loop<bf16>::cps(H, false)
                    : Loop<float>::cps(H, true) && Loop<float>::cps(H, false);
}

}  // namespace

extern "C" {

// x: (T, B, D) in the compute dtype (bf16 when cdt_bf16, else f32); h0,
// c0: (B, H); w_ih: (D, 4H), w_hh: (H, 4H); b: (4H,), all f32. Writes outs
// and, unless it is null, cseq (T, B, H) in the compute dtype, hT and cT
// (B, H) f32, and gates (T*B*4H) f32: every step's gate activations i,
// f, g, o (unrounded), which the backward takes. Scratch: h_first (B*H) in the
// compute dtype, count (ceil(B / 64)) u32, and wpack in the compute dtype
// (lstm_stream_pack's elements; null or empty: the units schedule). H a
// multiple of 32 up to lstm_stream_limits (callers pad other hidden sizes
// with zero units), any D >= 1. Two launches on the rows schedule, three
// on the units schedule.
int lstm_cat_stream_forward(const void* x, const float* h0, const float* c0,
                            const float* w_ih, const float* w_hh, const float* b, void* outs,
                            void* cseq, float* hT, float* cT, float* gates, void* h_first,
                            unsigned* count, void* wpack, int T, int B, int D, int H,
                            int cdt_bf16, cudaStream_t stream) {
    if (!shape_ok(T, B, D, H) || !hidden_ok(H, cdt_bf16)) return (int)cudaErrorInvalidValue;
    if (cdt_bf16)
        return forward(static_cast<const bf16*>(x), h0, c0, w_ih, w_hh, b,
                       static_cast<bf16*>(outs), static_cast<bf16*>(cseq), hT, cT, gates,
                       static_cast<bf16*>(h_first), count, static_cast<bf16*>(wpack), T, B, D,
                       H, stream);
    return forward(static_cast<const float*>(x), h0, c0, w_ih, w_hh, b,
                   static_cast<float*>(outs), static_cast<float*>(cseq), hT, cT, gates,
                   static_cast<float*>(h_first), count, static_cast<float*>(wpack), T, B, D, H,
                   stream);
}

// Inputs as the forward's (but b) plus its outs, cseq and gates and the
// gradients g_outs (T, B, H, compute dtype), g_hT and g_cT (B, H, f32).
// Writes dx (T, B, D, compute dtype), dh0, dc0 (B, H), dw = [dW_ih;
// dW_hh] (D + H, 4H) and db (4H,), f32. Scratch: dg (T*B*4H) in the
// compute dtype, db_part (T * ceil(B / 64), 4H) f32, dw_part (splits,
// D + H, 4H) f32 when splits > 1, count (ceil(B / 64)) u32, wpack as the
// forward's. Five launches, six with splits > 1.
int lstm_cat_stream_backward(const void* x, const float* h0, const float* c0,
                             const float* w_ih, const float* w_hh, const void* outs,
                             const void* cseq, const float* gates, const void* g_outs,
                             const float* g_hT, const float* g_cT, void* dx, float* dh0,
                             float* dc0, float* dw, float* db, void* dg, float* db_part,
                             float* dw_part, unsigned* count, void* wpack, int splits, int T,
                             int B, int D, int H, int cdt_bf16, cudaStream_t stream) {
    if (!shape_ok(T, B, D, H) || !hidden_ok(H, cdt_bf16)) return (int)cudaErrorInvalidValue;
    if (cdt_bf16)
        return backward(static_cast<const bf16*>(x), h0, c0, w_ih, w_hh,
                        static_cast<const bf16*>(outs), static_cast<const bf16*>(cseq),
                        static_cast<const bf16*>(g_outs), g_hT, g_cT, static_cast<bf16*>(dx),
                        dh0, dc0, dw, db, gates, static_cast<bf16*>(dg), db_part, dw_part,
                        count, static_cast<bf16*>(wpack), splits, T, B, D, H, stream);
    return backward(static_cast<const float*>(x), h0, c0, w_ih, w_hh,
                    static_cast<const float*>(outs), static_cast<const float*>(cseq),
                    static_cast<const float*>(g_outs), g_hT, g_cT, static_cast<float*>(dx), dh0,
                    dc0, dw, db, gates, static_cast<float*>(dg), db_part, dw_part, count,
                    static_cast<float*>(wpack), splits, T, B, D, H, stream);
}

// enc5 on this design. feats: (T, B, F) in the compute dtype; w_enc (F, D),
// b_enc (D,) f32; the rest as lstm_cat_stream_forward's. Scratch as its,
// plus xs (T*B*D) in the compute dtype. Three launches on the rows
// schedule, four on the units schedule.
int lstm_enc_stream_forward(const void* feats, const float* h0, const float* c0,
                            const float* w_enc, const float* b_enc, const float* w_ih,
                            const float* w_hh, const float* b, void* outs, void* cseq, float* hT,
                            float* cT, void* xs, float* gates, void* h_first, unsigned* count,
                            void* wpack, int T, int B, int F, int D, int H, int cdt_bf16,
                            cudaStream_t stream) {
    if (!shape_ok(T, B, D, H) || F < 1 || !hidden_ok(H, cdt_bf16))
        return (int)cudaErrorInvalidValue;
    if (cdt_bf16)
        return enc_forward(static_cast<const bf16*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                           static_cast<bf16*>(outs), static_cast<bf16*>(cseq), hT, cT,
                           static_cast<bf16*>(xs), gates, static_cast<bf16*>(h_first), count,
                           static_cast<bf16*>(wpack), T, B, F, D, H, stream);
    return enc_forward(static_cast<const float*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                       static_cast<float*>(outs), static_cast<float*>(cseq), hT, cT,
                       static_cast<float*>(xs), gates, static_cast<float*>(h_first), count,
                       static_cast<float*>(wpack), T, B, F, D, H, stream);
}

// enc5's backward on this design, from its forward's outs, cseq and gates:
// writes dh0, dc0 (B, H), dwe = [dW_enc; db_enc] (F + 1, D), dw = [dW_ih;
// dW_hh] (D + H, 4H) and db (4H,), f32. Scratch: xs and dpre (T*B*D) in
// the compute dtype, dg, db_part, dw_part and wpack as
// lstm_cat_stream_backward's, dwe_part (splits_e, F + 1, D) f32 when
// splits_e > 1, count. Seven launches, one more for each split sum.
int lstm_enc_stream_backward(const void* feats, const float* h0, const float* c0,
                             const float* w_enc, const float* b_enc, const float* w_ih,
                             const float* w_hh, const void* outs, const void* cseq,
                             const float* gates, const void* g_outs, const float* g_hT,
                             const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw,
                             float* db, void* xs, void* dpre, void* dg, float* db_part,
                             float* dw_part, float* dwe_part, unsigned* count, void* wpack,
                             int splits_w, int splits_e, int T, int B, int F, int D, int H,
                             int cdt_bf16, cudaStream_t stream) {
    if (!shape_ok(T, B, D, H) || F < 1 || !hidden_ok(H, cdt_bf16))
        return (int)cudaErrorInvalidValue;
    if (cdt_bf16)
        return enc_backward(static_cast<const bf16*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh,
                            static_cast<const bf16*>(outs), static_cast<const bf16*>(cseq),
                            static_cast<const bf16*>(g_outs), g_hT, g_cT, dh0, dc0, dwe, dw, db,
                            static_cast<bf16*>(xs), static_cast<bf16*>(dpre), gates,
                            static_cast<bf16*>(dg), db_part, dw_part, dwe_part, count,
                            static_cast<bf16*>(wpack), splits_w, splits_e, T, B, F, D, H,
                            stream);
    return enc_backward(static_cast<const float*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh,
                        static_cast<const float*>(outs), static_cast<const float*>(cseq),
                        static_cast<const float*>(g_outs), g_hT, g_cT, dh0, dc0, dwe, dw, db,
                        static_cast<float*>(xs), static_cast<float*>(dpre), gates,
                        static_cast<float*>(dg), db_part, dw_part, dwe_part, count,
                        static_cast<float*>(wpack), splits_w, splits_e, T, B, F, D, H, stream);
}

// Not a launch: out[0] the elements of wpack that a forward (fwd) or
// backward call at (B, D, H) in bf16 (cdt_bf16) or f32 takes on the rows
// schedule, 0 where the call takes the units schedule (a forward whose x
// is not 16-byte aligned takes the units schedule and leaves it unused).
int lstm_stream_pack(int B, int D, int H, int cdt_bf16, int fwd, long long* out) {
    const bool rows = many_tiles(B) &&
                      (!fwd || D % (cdt_bf16 ? RowsCfg<bf16>::EPC : RowsCfg<float>::EPC) == 0);
    out[0] = !rows ? 0
                   : (long long)(cdt_bf16 ? RowsCfg<bf16>::pack(D, H, fwd != 0)
                                          : RowsCfg<float>::pack(D, H, fwd != 0));
    return 0;
}

// Not a launch: out[0] the largest hidden size whose loops' shared memory
// fits a block, in bf16 (cdt_bf16) or f32; out[1] the batch rows of a loop
// tile, by which the caller sizes count and db_part.
// pufferlib_tpu_torch.ops.cuda.lstm_common's STREAM_MAX_HIDDEN and
// STREAM_ROWS hold these for the checks and allocations before a launch.
int lstm_stream_limits(int cdt_bf16, int* out) {
    out[0] = max_hidden(cdt_bf16 != 0);
    out[1] = RB;
    return 0;
}

// Not a launch: the kernels this library has launched so far, a count
// kept on the host.
int lstm_stream_kernels(long long* out) {
    *out = g_kernels;
    return 0;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

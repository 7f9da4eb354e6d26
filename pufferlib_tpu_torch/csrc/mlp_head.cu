// Fused Default-MLP forward, for Hopper (sm_90a):
//
//   out = relu(x @ w1 + b1) @ w2 + b2          x (B, F), out (B, O) float32
//
// Replaces the TPU kernel pufferlib_tpu/ops/pallas/mlp.py (mlp_head_fwd /
// _fwd_kernel). Same function as the plain
// pufferlib_tpu_torch.ops.cuda.mlp.mlp_head_reference: x and the weights
// round to the compute dtype cdt (bf16 or f32), products accumulate in
// f32, the hidden layer rounds to cdt after the relu (which keeps a NaN,
// as jax.nn.relu does), biases stay f32. The (B, H) hidden activation
// never reaches device memory.
//
// Two kernels, chosen by the compute dtype and nothing else:
//
// * bf16 (the trainer's): mlp_head_tc_kernel, on the tensor cores.
//   Bound: bytes. At the trainer's shapes (F = 49, H = 128, O = 9) a row
//   is 98 bytes of bf16 x in and 36 bytes of f32 out, 17.6 MB at B =
//   131072 (5.3 us at 3.35 TB/s). Design:
//   - persistent blocks of 4 warps walk 64-row tiles; a warp owns 16 rows
//     (MT m-tiles of 16 in general), up to 4 blocks an SM;
//   - the weights are staged once per block in shared memory: every f32
//     value is copied by cp.async at once into a landing area (the x
//     buffers, free until the first tile), then rounded to bf16 into
//     copies zero-padded to Fp, Hp, Op (multiples of 16), rows padded by
//     16 bytes so that ldmatrix has no bank conflicts;
//   - x tiles move through a cp.async ring. A 64-row tile of the
//     contiguous (B, F) array is one contiguous span (6272 bytes at F =
//     49 in bf16); its rows are 98 bytes apart, which neither ldmatrix nor
//     a TMA tensor map can read in place, so the span is copied as
//     16-byte chunks from the 16-byte boundary at or below its start (one
//     chunk more; the bytes past the array's end are zero-filled), and one
//     shared-to-shared pass lays it into padded bf16 rows of Fp with zeros
//     past F (bf16 x as 32-bit words, shifted by one element where a row
//     starts on an odd one; f32 x converted element by element). x may
//     start anywhere: a view into the obs storage is read as it is;
//   - layer 1 on mma.sync m16n8k16, H in chunks of 64 columns (32 f32
//     accumulators a thread at any H), loop bounds fixed per chunk width
//     so that a step's fragments all load ahead of its products;
//   - the hidden layer stays in registers: per chunk, + b1, relu, round
//     to bf16, and the accumulator fragments of two adjacent n-tiles are
//     the A fragment of layer 2's k16 slice (the m16n8 C layout is the
//     m16k16 A layout), accumulated into layer 2's f32 sums. The relu is
//     elementwise, so chunking H changes no value; only the order of
//     layer 2's f32 sum differs from the plain version's. Outputs are
//     taken 32 columns a pass (layer 1 recomputed per pass where O > 32);
//   - + b2; a warp stages its (16, O) f32 rows in shared memory and
//     stores them as one contiguous, coalesced span of 16 * O floats.
//   Sums run in a fixed order with no atomics: two runs are bit-equal.
//   What holds it back (tools/ablate_mlp_head_torch.py): the products,
//   latency-bound on mma.sync with 16 warps an SM, and at B = 8192, one
//   tile a block, the weight staging.
//   Where the weights or the ring do not fit, a block holds fewer stages,
//   then reads its weights' fragments from L2 (f32, rounded as loaded)
//   instead of shared memory, then takes 16-row tiles (tc::CONFIGS, tried
//   in order): every (F, H, O) that the first f32 kernel served (a
//   block's shared memory holding the f32 weights, a 32-row x tile and its
//   hidden tile: mlp.fma_smem) is served, and more; beyond the last, the
//   launch is refused.
//
// * f32 (config.yaml's dtype and the exact test mode):
//   mlp_head_f32_kernel, FMA only (the tensor cores have no exact f32
//   product; no TF32). Bound: operations. At F = 49, H = 128, O = 9 a row
//   is 7424 FMAs, 1.946 GFLOP at B = 131072 (0.029 ms at 67 TFLOP/s).
//   Design, in the manner of csrc/lstm_f32.cuh's SGEMM:
//   - persistent blocks of 256 threads walk 64-row tiles, at most two
//     blocks an SM;
//   - the resident configuration: W1 (F, Hc) and W2 (Hc, Op), zero-padded
//     to Hc (whole chunks of 128 hidden units) and Op (a multiple of 4),
//     and the biases are staged once a block in shared memory by
//     cp.async (W1 16 bytes a copy where its rows allow, H % 4 == 0, else
//     4); x tiles move through a two-stage ring by the bf16
//     kernel's span copy (fetch_span: any element offset), and one pass
//     lays each into a k-major (F, 64 + 4) tile;
//   - layer 1 in chunks of 128 hidden units: each thread a register tile
//     of 4 rows x 8 units, per k one 16-byte load of x and two of W1 for
//     32 FMAs. Each hidden value is one FMA chain over k in order from
//     zero, then + b1 and the relu (keeping a NaN): the first f32
//     kernel's bits. It goes into a padded (64, 132) hidden tile in
//     shared memory; the hidden layer never reaches device memory;
//   - layer 2 from the hidden tile: warp w takes hidden units 16w ..
//     16w + 15 of each chunk (K in eight fixed parts), lane l rows l and
//     l + 32 and up to 16 outputs (one 16-byte broadcast load of W2 per
//     four outputs and k). Each part's sums stay in registers across the
//     chunks, then the parts meet in shared memory and are added in part
//     order, + b2; the tile's (64, O) rows are stored as one coalesced
//     span. Outputs past 16 take another pass, layer 1 recomputed;
//   - where the resident configuration's shared memory passes MAX_SMEM
//     (its x staging takes about 3 x 64 x F floats: at H = 128, F > 148
//     with f32 x), the streamed one moves x and W1 through shared memory
//     KC = 32 values of k at a time, per tile and 128-unit chunk, in two
//     stages (a chunk copied while the last one's products run; layer 1's
//     loop is the resident one's), and reads W2 and the biases from
//     device memory (L2). It holds 82 KB at any shape: every (F, H, O) is
//     served.
//   Sums run in a fixed order with no atomics: two runs are bit-equal.
//   What holds it back (tools/ablate_mlp_head_torch.py --dtype float32,
//   at B = 131072 on an H100): the layer-1 products, near 35 TFLOP/s, half
//   the FMA rate, as csrc/lstm_f32.cuh's SGEMMs; layer 2 about a sixth of
//   the time. 128-row tiles (8 x 8 outputs a thread, one block an SM)
//   gain nothing there and lose at B = 8192.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 227 * 1024;

// the grid: what fits on the card at once (at most max_per_sm blocks an
// SM), and no more blocks than tiles
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem, int tiles, int max_per_sm,
                            int* blocks) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                             smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (per_sm > max_per_sm) per_sm = max_per_sm;
    *blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
    return cudaSuccess;
}

// 16 bytes from gmem, of which the first n are read and the rest zero
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int n) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
                 : "memory");
}

// 4 bytes from gmem into shared memory
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// relu that keeps a NaN, as jax.nn.relu does
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// One ring slot of raw_bytes: a tile's span of x, plus the chunk that its
// unaligned start may add and one that a reader may touch past the span's
// end
__host__ __device__ inline size_t raw_bytes(int rows, int F, int x_size) {
    return (size_t)rows * F * x_size + 32;
}

// Tile `tile`'s span of x (`span` bytes from xbase + tile * span) into the
// ring slot dst (raw bytes), from the 16-byte boundary at or below its
// start; bytes past the array's end (xend) are zero-filled. x may start
// anywhere: a view into the obs storage is read as it is. One commit group
// per call, empty past the last tile.
__device__ __forceinline__ void fetch_span(unsigned char* dst, uintptr_t xbase, uintptr_t xend,
                                           size_t span, size_t raw, int tile, int tiles, int tid,
                                           int nt) {
    if (tile < tiles) {
        const uintptr_t a = (xbase + tile * span) & ~(uintptr_t)15;
        for (int c = tid; c < (int)(raw / 16); c += nt) {
            const uintptr_t src = a + 16 * (uintptr_t)c;
            const int n = src >= xend ? 0 : (xend - src >= 16 ? 16 : (int)(xend - src));
            cp_async16(dst + 16 * c, reinterpret_cast<const void*>(n ? src : a), n);
        }
    }
    cp_async_commit();
}

// element i of x as f32
__device__ __forceinline__ float load_x(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

// ---------------------------------------------------------------- f32

namespace f32 {

constexpr int THREADS = 256;
constexpr int TR = 64;              // rows a tile: a multiple of 64
constexpr int RG = TR / 64;         // layer 1: a thread's rows, in groups of 4 (64 apart)
constexpr int RL = TR / 32;         // layer 2: a lane's rows (32 apart)
constexpr int HC = 128;             // hidden units a chunk: 16 column groups of 8
constexpr int HSP = HC + 4;         // row stride of the hidden tile
constexpr int XSP = TR + 4;         // row stride (one k) of the k-major x tile
constexpr int KP = THREADS / 32;    // layer 2's parts of a chunk's hidden units: a warp each
constexpr int KPL = HC / KP;        // hidden units a part
constexpr int OC = 16;              // outputs a pass
constexpr int PRS = TR + 1;         // row stride of layer 2's partials
constexpr int STAGES = 2;           // x ring
constexpr int KC = 32;              // streamed: k a chunk of x and W1
constexpr int KS = 2;               // streamed: chunk stages
// blocks an SM: the resident configuration at the trainer's shapes holds
// 105 KB of shared memory a block, the streamed one 82 KB
constexpr int MAX_PER_SM = 2;
constexpr int HS_FLOATS = TR * HSP;  // the hidden tile, then the partials
static_assert(KP * OC * PRS <= HS_FLOATS, "layer 2's partials fit the hidden tile");
static_assert(KPL % 4 == 0 && TR % 64 == 0, "the tiling");

// Hc: H padded to whole chunks; Op: O padded to a multiple of 4
struct Geo {
    int F, H, O, Hc, Op;
    __host__ __device__ Geo(int F_, int H_, int O_)
        : F(F_), H(H_), O(O_), Hc((H_ + HC - 1) / HC * HC), Op((O_ + 3) / 4 * 4) {}
};

// Shared memory of a block: the hidden tile and, resident (RES), W1 (F,
// Hc), b1 (Hc), W2 (Hc, Op), b2 (Op), the k-major x tile (F, XSP) and the
// ring; streamed, KS stages of chunks of W1 (KC, HC) and x (KC, XSP).
inline size_t smem_bytes(const Geo& g, int x_size, bool res) {
    if (!res) return 4 * (size_t)(HS_FLOATS + KS * KC * (HC + XSP));
    const size_t floats = HS_FLOATS + (size_t)g.F * g.Hc + g.Hc + (size_t)g.Hc * g.Op + g.Op +
                          (size_t)g.F * XSP;
    return 4 * floats + STAGES * raw_bytes(TR, g.F, x_size);
}

// the configuration: 0, resident, where its shared memory fits; else 1,
// streamed
inline int config(int F, int H, int O, int x_size) {
    return smem_bytes(Geo(F, H, O), x_size, true) <= (size_t)MAX_SMEM ? 0 : 1;
}

// Tile row of a thread's layer-1 row i (< 4 RG): groups of 4 rows 64 apart
__device__ __forceinline__ int row_of(int i, int ty) { return i / 4 * 64 + ty * 4 + i % 4; }

// Layer 1's products over k = 0 .. K - 1 in order: thread (ty, tx) adds
// x[k][row_of(i, ty)] * w[k][tx*4 + j] and w[k][64 + tx*4 + j] (j < 4) to
// acc[i][j] and acc[i][4 + j], from the k-major x rows xs (stride XSP) and
// the W1 rows w (stride ws) in shared memory. Per k a thread loads 4 RG +
// 8 values, as 16-byte loads, for 32 RG FMAs.
__device__ __forceinline__ void products(float (&acc)[4 * RG][8], const float* xs, const float* w,
                                         int ws, int K, int ty, int tx) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        float xv[4 * RG], wv[8];
#pragma unroll
        for (int q = 0; q < RG; ++q) {
            const float4 a = *reinterpret_cast<const float4*>(xs + k * XSP + q * 64 + ty * 4);
            xv[4 * q] = a.x, xv[4 * q + 1] = a.y, xv[4 * q + 2] = a.z, xv[4 * q + 3] = a.w;
        }
        const float* wk = w + (size_t)k * ws + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(wk);
        const float4 b1 = *reinterpret_cast<const float4*>(wk + 64);
        wv[0] = b0.x, wv[1] = b0.y, wv[2] = b0.z, wv[3] = b0.w;
        wv[4] = b1.x, wv[5] = b1.y, wv[6] = b1.z, wv[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 4 * RG; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
}

// One element of x into shared memory: f32 by cp.async, bf16 converted
__device__ __forceinline__ void stage_x(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void stage_x(float* dst, const __nv_bfloat16* src) {
    *dst = __bfloat162float(*src);
}

// Streamed: rows k0 .. k0 + KC - 1 of the tile's x (k-major, stride XSP)
// and of W1's columns h0 .. h0 + HC - 1 (stride HC) into one stage of the
// chunk buffers, zero past B, F and H. One commit group.
template <typename Tin>
__device__ __forceinline__ void stage_chunk(float* xk, float* wk, const Tin* x, const float* w1,
                                            const Geo& g, int B, int row0, int h0, int k0,
                                            int tid) {
    for (int i = tid; i < TR * KC; i += THREADS) {
        const int r = i / KC, kk = i - r * KC, k = k0 + kk;
        float* dst = xk + kk * XSP + r;
        if (row0 + r < B && k < g.F) stage_x(dst, x + (size_t)(row0 + r) * g.F + k);
        else *dst = 0.f;
    }
    for (int i = tid; i < KC * HC; i += THREADS) {
        const int kk = i / HC, c = i - kk * HC, k = k0 + kk;
        if (k < g.F && h0 + c < g.H) cp_async4(wk + i, w1 + (size_t)k * g.H + h0 + c);
        else wk[i] = 0.f;
    }
    cp_async_commit();
}

// Layer 1 of chunk h0 for the tile of rows row0 ..: thread (ty, tx) sums
// rows row_of(i, ty) (i < 4 RG) of hidden units h0 + tx*4 + j and h0 + 64
// + tx*4 + j (j < 4), each one FMA chain over k in order from zero.
// Resident (RES): x from the k-major tile xs, W1 from w1s (rows of Hc,
// zero past H). Streamed: xs and w1s are KS stages of chunk buffers
// that KC values of k at a time move through, the next KS - 1 chunks
// copied while this one's products run.
template <typename Tin, bool RES>
__device__ __forceinline__ void layer1(float (&acc)[4 * RG][8], float* xs, const Tin* x,
                                       int row0, int B, float* w1s, const float* w1,
                                       const Geo& g, int h0, int tid) {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 4 * RG; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if constexpr (RES) {
        products(acc, xs, w1s + h0, g.Hc, g.F, ty, tx);
    } else {
        // chunk c in stage c % KS; one commit group a chunk (empty past
        // the last)
        const int chunks = (g.F + KC - 1) / KC;
        auto stage = [&](int c) {
            if (c < chunks)
                stage_chunk(xs + c % KS * KC * XSP, w1s + c % KS * KC * HC, x, w1, g, B, row0,
                            h0, c * KC, tid);
            else
                cp_async_commit();
        };
        for (int c = 0; c < KS - 1; ++c) stage(c);
        for (int c = 0; c < chunks; ++c) {
            // chunk c has landed, with every thread's stores to it, and
            // every thread is done with chunk c - 1, whose stage the chunk
            // KS - 1 ahead takes
            cp_async_wait<KS - 2>();
            __syncthreads();
            stage(c + KS - 1);
            products(acc, xs + c % KS * KC * XSP, w1s + c % KS * KC * HC, HC,
                     min(KC, g.F - c * KC), ty, tx);
        }
    }
}

// Layer 2 of chunk h0, outputs o0 .. o0 + 4 NQ - 1: warp `warp` takes the
// chunk's hidden units warp*KPL .. + KPL - 1, lane l rows l + 32 r (r <
// RL) of the hidden tile; each part's sums continue over the chunks in
// order.
// RES: W2 from w2s (Hc, Op), zero past H and O; else from device
// memory. A part wholly past H adds nothing.
template <bool RES, int NQ>
__device__ __forceinline__ void layer2(float (&acc2)[RL][4 * NQ], const float* hs,
                                       const float* w2s, const float* w2, const Geo& g, int h0,
                                       int o0, int warp, int lane) {
    const int kb = h0 + warp * KPL;
    if (kb >= g.H) return;
    const float* ha = hs + lane * HSP + warp * KPL;
#pragma unroll
    for (int k4 = 0; k4 < KPL; k4 += 4) {
        float hv[RL][4];
#pragma unroll
        for (int r = 0; r < RL; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(ha + 32 * r * HSP + k4);
            hv[r][0] = v.x, hv[r][1] = v.y, hv[r][2] = v.z, hv[r][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int k = kb + k4 + kk;
            float wv[4 * NQ];
            if constexpr (RES) {
#pragma unroll
                for (int q = 0; q < NQ; ++q) {
                    const float4 w =
                        *reinterpret_cast<const float4*>(w2s + (size_t)k * g.Op + o0 + 4 * q);
                    wv[4 * q] = w.x, wv[4 * q + 1] = w.y, wv[4 * q + 2] = w.z, wv[4 * q + 3] = w.w;
                }
            } else {
#pragma unroll
                for (int o = 0; o < 4 * NQ; ++o)
                    wv[o] = k < g.H && o0 + o < g.O ? __ldg(w2 + (size_t)k * g.O + o0 + o) : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RL; ++r)
#pragma unroll
                for (int o = 0; o < 4 * NQ; ++o) acc2[r][o] = fmaf(hv[r][kk], wv[o], acc2[r][o]);
        }
    }
}

// One pass of the tile: outputs o0 .. o0 + 4 NQ - 1 of rows row0 .. row0
// + rows - 1, every chunk's layer 1 and layer 2, then the parts added in
// order, + b2, stored.
template <typename Tin, bool RES, int NQ>
__device__ __forceinline__ void tile_pass(float* xs, const Tin* x, float* w1s,
                                          const float* w1, const float* b1v, const float* w2s,
                                          const float* w2, const float* b2v, float* hs,
                                          float* out, const Geo& g, int B, int row0, int rows,
                                          int o0) {
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, warp = tid / 32, lane = tid % 32;
    float acc2[RL][4 * NQ];
#pragma unroll
    for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int o = 0; o < 4 * NQ; ++o) acc2[r][o] = 0.f;
    for (int h0 = 0; h0 < g.Hc; h0 += HC) {
        float acc[4 * RG][8];
        layer1<Tin, RES>(acc, xs, x, row0, B, w1s, w1, g, h0, tid);
        // every thread is done with the hidden tile: the last chunk's
        // layer 2, or the last pass's partials
        __syncthreads();
        // + b1, relu
#pragma unroll
        for (int i = 0; i < 4 * RG; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int c = half * 64 + tx * 4;
                float v[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int h = h0 + c + q;
                    float bias;
                    if constexpr (RES) bias = b1v[h];
                    else bias = h < g.H ? __ldg(b1v + h) : 0.f;
                    v[q] = relu(acc[i][half * 4 + q] + bias);
                }
                *reinterpret_cast<float4*>(hs + row_of(i, ty) * HSP + c) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
        __syncthreads();
        layer2<RES, NQ>(acc2, hs, w2s, w2, g, h0, o0, warp, lane);
    }
    // every read of the hidden tile done: it takes the parts' partials,
    // (KP, OC, PRS)
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int o = 0; o < 4 * NQ; ++o) hs[(warp * OC + o) * PRS + lane + 32 * r] = acc2[r][o];
    __syncthreads();
    const int on = min(4 * NQ, g.O - o0);
    for (int i = tid; i < rows * on; i += THREADS) {
        const int r = i / on, o = i - r * on;
        float s = hs[o * PRS + r];
#pragma unroll
        for (int p = 1; p < KP; ++p) s += hs[(p * OC + o) * PRS + r];
        float bias;
        if constexpr (RES) bias = b2v[o0 + o];
        else bias = __ldg(b2v + o0 + o);
        out[(size_t)(row0 + r) * g.O + o0 + o] = s + bias;
    }
}

template <typename Tin, bool RES>
__global__ void __launch_bounds__(THREADS, MAX_PER_SM) mlp_head_f32_kernel(
        const Tin* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
        const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out,
        int B, int F, int H, int O) {
    const Geo g(F, H, O);
    // resident: hs | w1s | b1s | w2s | b2s | xs | ring; streamed: hs |
    // w1s | xs, KS stages of W1 and x chunks each
    extern __shared__ __align__(16) unsigned char smem[];
    float* hs = reinterpret_cast<float*>(smem);
    float* w1s = hs + HS_FLOATS;
    float* b1s = w1s + (size_t)F * g.Hc;
    float* w2s = b1s + g.Hc;
    float* b2s = w2s + (size_t)g.Hc * g.Op;
    float* xs = RES ? b2s + g.Op : w1s + KS * KC * HC;
    unsigned char* ring = reinterpret_cast<unsigned char*>(xs + (size_t)F * XSP);
    const int tid = threadIdx.x;
    const int tiles = (B + TR - 1) / TR;
    const size_t span = (size_t)TR * F * sizeof(Tin), RAW = raw_bytes(TR, F, sizeof(Tin));
    const uintptr_t xbase = reinterpret_cast<uintptr_t>(x);
    const uintptr_t xend = xbase + (size_t)B * F * sizeof(Tin);
    if constexpr (RES) {
        // the weights and biases by cp.async (in the first tile's commit
        // group), the padding as zeros; W1 in 16-byte pieces where its
        // rows allow
        if (H % 4 == 0 && (reinterpret_cast<uintptr_t>(w1) & 15) == 0) {
            const int q = g.Hc / 4;
            for (int i = tid; i < F * q; i += THREADS) {
                const int k = i / q, c = (i - k * q) * 4;
                float* dst = w1s + (size_t)k * g.Hc + c;
                if (c < H) cp_async16(dst, w1 + (size_t)k * H + c, 16);
                else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
        } else {
            for (int i = tid; i < F * g.Hc; i += THREADS) {
                const int k = i / g.Hc, c = i - k * g.Hc;
                if (c < H) cp_async4(w1s + i, w1 + (size_t)k * H + c);
                else w1s[i] = 0.f;
            }
        }
        for (int i = tid; i < g.Hc * g.Op; i += THREADS) {
            const int k = i / g.Op, o = i - k * g.Op;
            if (k < H && o < O) cp_async4(w2s + i, w2 + (size_t)k * O + o);
            else w2s[i] = 0.f;
        }
        for (int i = tid; i < g.Hc; i += THREADS) {
            if (i < H) cp_async4(b1s + i, b1 + i);
            else b1s[i] = 0.f;
        }
        for (int i = tid; i < g.Op; i += THREADS) {
            if (i < O) cp_async4(b2s + i, b2 + i);
            else b2s[i] = 0.f;
        }
        for (int s = 0; s < STAGES; ++s)
            fetch_span(ring + s * RAW, xbase, xend, span, RAW, blockIdx.x + s * gridDim.x, tiles,
                       tid, THREADS);
    }
    int slot = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile * TR, rows = min(TR, B - row0);
        if constexpr (RES) {
            // this tile's span has landed (and the weights), and every
            // thread is done with the last tile's x
            cp_async_wait<STAGES - 1>();
            __syncthreads();
            const Tin* src = reinterpret_cast<const Tin*>(ring + slot * RAW) +
                             ((xbase + tile * span) & 15) / sizeof(Tin);
            for (int i = tid; i < TR * F; i += THREADS) {
                const int r = i % TR, k = i / TR;
                xs[k * XSP + r] = r < rows ? load_x(src, (size_t)r * F + k) : 0.f;
            }
            // the k-major tile complete, and the slot free for the tile
            // STAGES ahead
            __syncthreads();
            fetch_span(ring + slot * RAW, xbase, xend, span, RAW, tile + STAGES * gridDim.x,
                       tiles, tid, THREADS);
            slot = slot + 1 == STAGES ? 0 : slot + 1;
        }
        const float* b1v = RES ? b1s : b1;
        const float* b2v = RES ? b2s : b2;
        for (int o0 = 0; o0 < O; o0 += OC) {
            switch (min(OC, g.Op - o0) / 4) {
            case 4:
                tile_pass<Tin, RES, 4>(xs, x, w1s, w1, b1v, w2s, w2, b2v, hs, out, g, B, row0,
                                       rows, o0);
                break;
            case 3:
                tile_pass<Tin, RES, 3>(xs, x, w1s, w1, b1v, w2s, w2, b2v, hs, out, g, B, row0,
                                       rows, o0);
                break;
            case 2:
                tile_pass<Tin, RES, 2>(xs, x, w1s, w1, b1v, w2s, w2, b2v, hs, out, g, B, row0,
                                       rows, o0);
                break;
            default:
                tile_pass<Tin, RES, 1>(xs, x, w1s, w1, b1v, w2s, w2, b2v, hs, out, g, B, row0,
                                       rows, o0);
            }
        }
    }
    if constexpr (RES) cp_async_wait<0>();
}

template <typename Tin, bool RES>
int launch(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
           float* out, int B, int F, int H, int O, cudaStream_t stream) {
    auto kernel = mlp_head_f32_kernel<Tin, RES>;
    const size_t smem = smem_bytes(Geo(F, H, O), sizeof(Tin), RES);
    int blocks = 0;
    cudaError_t err =
        persistent_grid(kernel, THREADS, smem, (B + TR - 1) / TR, MAX_PER_SM, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, THREADS, smem, stream>>>(static_cast<const Tin*>(x), w1, b1, w2, b2, out, B,
                                              F, H, O);
    return (int)cudaGetLastError();
}

template <typename Tin>
int forward(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
            float* out, int B, int F, int H, int O, cudaStream_t stream) {
    if (config(F, H, O, sizeof(Tin)) == 0)
        return launch<Tin, true>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    return launch<Tin, false>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
}

}  // namespace f32

// ---------------------------------------------------------------- bf16

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int HC = 64;  // hidden units per chunk: 8 n-tiles of layer 1
constexpr int OC = 32;  // outputs per pass: 4 n-tiles of layer 2
// blocks an SM: the products wait on shared-memory loads and on each
// other, so more warps an SM hide more of that latency (at B = 131072, 4
// blocks an SM took 0.030 ms, 2 0.034, 1 0.052 on an H100)
constexpr int MAX_PER_SM = 4;

// (warps, m-tiles of 16 rows a warp, ring stages, weights resident in
// shared memory), tried in order
struct Config {
    int warps, mt, stages;
    bool resident;
};
constexpr Config CONFIGS[] = {
    {4, 1, 3, true}, {4, 1, 1, true}, {4, 1, 1, false}, {1, 1, 1, false}};
constexpr int NCONFIGS = 4;

struct Geo {
    int F, H, O, Fp, Hp, Op;
    int XS, W1S, W2S;  // padded row lengths (bf16): x tile, w1 (Fp x Hp), w2 (Hp x Op)
    __host__ __device__ Geo(int F_, int H_, int O_)
        : F(F_), H(H_), O(O_), Fp((F_ + 15) / 16 * 16), Hp((H_ + 15) / 16 * 16),
          Op((O_ + 15) / 16 * 16), XS(Fp + 8), W1S(Hp + 8), W2S(Op + 8) {}
};

// Shared memory of a block: the padded x tile, the ring, and where the
// weights are resident, w1, w2, the biases and the output rows.
inline size_t smem_bytes(const Geo& g, int x_size, const Config& c) {
    const int rows = 16 * c.mt * c.warps;
    size_t b = (size_t)rows * g.XS * 2 + c.stages * raw_bytes(rows, g.F, x_size);
    if (c.resident)
        b += (size_t)g.Fp * g.W1S * 2 + (size_t)g.Hp * g.W2S * 2 + 4 * (size_t)(g.Hp + g.Op) +
             (size_t)rows * g.O * 4;
    return b;
}

inline int config(int F, int H, int O, int x_size) {
    const Geo g(F, H, O);
    for (int i = 0; i < NCONFIGS; ++i)
        if (smem_bytes(g, x_size, CONFIGS[i]) <= (size_t)MAX_SMEM) return i;
    return -1;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// the bf16 bits of element i of a staged f32 x span, rounded
__device__ __forceinline__ uint32_t bits(const float* p, int i) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(p[i]));
}

// element (k, n) of a row-major (K, N) f32 array, 0 past its edges
__device__ __forceinline__ float at(const float* w, int k, int n, int K, int N) {
    return k < K && n < N ? __ldg(w + (size_t)k * N + n) : 0.f;
}

// A (K, N) f32 weight and its padded bf16 copy in shared memory, in rows
// of S (unused where the weights are not resident)
struct Staged {
    const float* w;
    bf16* dst;
    int K, N, S;
};

// Round flat elements j0 .. j1 - 1 of m, landed at land[0 ..], into its
// padded copy; (k, n) = divmod(j, N) advances by divmod(nt, N), with no
// division in the loop
__device__ __forceinline__ void land_to_bf16(const Staged m, const float* land, int j0, int j1,
                                             int tid, int nt) {
    int j = j0 + tid, k = j / m.N, n = j % m.N;
    const int dk = nt / m.N, dn = nt % m.N;
    for (; j < j1; j += nt) {
        m.dst[(size_t)k * m.S + n] = __float2bfloat16_rn(land[j - j0]);
        k += dk;
        n += dn;
        if (n >= m.N) {
            n -= m.N;
            ++k;
        }
    }
}

// w1 and w2 into their padded bf16 copies (zeros past their edges):
// every f32 value is copied at once into the landing area `land` (cap
// floats; in as many passes as it takes) by cp.async, with no registers
// held and one wait a pass, then rounded to bf16 in shared memory.
__device__ __forceinline__ void stage_weights(const Staged m1, const Staged m2, int padded,
                                              float* land, int cap, int tid, int nt) {
    uint4* z = reinterpret_cast<uint4*>(m1.dst);
    for (int i = tid; i < padded / 16; i += nt) z[i] = make_uint4(0u, 0u, 0u, 0u);
    const int n1 = m1.K * m1.N, n = n1 + m2.K * m2.N;
    for (int base = 0; base < n; base += cap) {
        const int end = min(base + cap, n);
        for (int j = base + tid; j < end; j += nt)
            cp_async4(land + (j - base), j < n1 ? m1.w + j : m2.w + (j - n1));
        cp_async_commit();
        cp_async_wait<0>();
        // the copies have landed, and the padding is zero
        __syncthreads();
        if (base < n1) land_to_bf16(m1, land, base, min(end, n1), tid, nt);
        if (end > n1)
            land_to_bf16(m2, land + (max(base, n1) - base), max(base, n1) - n1, end - n1, tid, nt);
        // the landing area is free again
        __syncthreads();
    }
}

// The B fragments of two adjacent n-tiles (n0 .. n0 + 15) at depth k0 ..
// k0 + 15 of a (K, N) weight: b[0], b[1] for the first, b[2], b[3] for
// the second. Resident: ldmatrix.trans of the padded bf16 rows in shared
// memory. Else from the f32 array (L2), rounded as loaded.
template <bool RES>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const bf16* ws, int S, const float* w,
                                        int K, int N, int k0, int n0, int lane) {
    if constexpr (RES) {
        ldsm_x4_trans(b, ws + (size_t)(k0 + lane % 8 + lane / 8 % 2 * 8) * S + n0 + lane / 16 * 8);
    } else {
        const int k = k0 + lane % 4 * 2, n = n0 + lane / 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int kq = k + q % 2 * 8, nq = n + q / 2 * 8;
            b[q] = pack2(at(w, kq, nq, K, N), at(w, kq + 1, nq, K, N));
        }
    }
}

// Lay row rr's columns f .. f + 7 of the staged span (element e of the
// slot is row rr's column f) into eight bf16, zeros past F. bf16: as
// 32-bit words, shifted by one element where e is odd; f32: element by
// element, rounded.
__device__ __forceinline__ uint4 row_octet(const unsigned char* slot, int e, int f, int F,
                                           const bf16*) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(slot) + (e >> 1);
    uint32_t w[4];
    if (e & 1) {
        uint32_t v[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) v[q] = p[q];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = __byte_perm(v[q], v[q + 1], 0x5432);
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = p[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (f + 2 * q >= F) w[q] = 0u;
        else if (f + 2 * q + 1 >= F) w[q] &= 0xffffu;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 row_octet(const unsigned char* slot, int e, int f, int F,
                                           const float*) {
    const float* p = reinterpret_cast<const float*>(slot) + e;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t lo = f + 2 * q < F ? bits(p, 2 * q) : 0u;
        const uint32_t hi = f + 2 * q + 1 < F ? bits(p, 2 * q + 1) : 0u;
        w[q] = lo | hi << 16;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// One chunk of 16 * NJP hidden units (h0 ..) of a warp's MT m-tiles of 16
// rows, accumulated into layer 2's outputs o0 .. o0 + 16 * NOP. Each B
// fragment feeds MT products. The loop bounds are constants, so that the
// scheduler can put every load of a step ahead of its products: the
// chunk's b1 and layer-2 B fragments before layer 1, a step's A and B
// fragments before its products.
template <bool RES, int MT, int NJP, int NOP>
__device__ __forceinline__ void hidden_chunk(float (&acc2)[MT][4][4], const bf16* xa, int mstride,
                                             int Fp, const Staged m1, const Staged m2,
                                             const float* b1v, int h0, int o0, int lane) {
    float acc1[MT][2 * NJP][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2 * NJP; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc1[mt][j][c] = 0.f;
    float bias[NJP][4];
    uint32_t w2f[NJP][NOP][4];
#pragma unroll
    for (int s = 0; s < NJP; ++s) {
        const int n = h0 + 16 * s + lane % 4 * 2;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int nq = n + q / 2 * 8 + q % 2;
            if constexpr (RES) bias[s][q] = b1v[nq];
            else bias[s][q] = nq < m1.N ? __ldg(b1v + nq) : 0.f;
        }
#pragma unroll
        for (int jp = 0; jp < NOP; ++jp)
            b_frags<RES>(w2f[s][jp], m2.dst, m2.S, m2.w, m2.K, m2.N, h0 + 16 * s, o0 + 16 * jp,
                         lane);
    }
#pragma unroll 2
    for (int ks = 0; ks < Fp; ks += 16) {
        uint32_t a[MT][4], b[NJP][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], xa + mt * mstride + ks);
#pragma unroll
        for (int jp = 0; jp < NJP; ++jp)
            b_frags<RES>(b[jp], m1.dst, m1.S, m1.w, m1.K, m1.N, ks, h0 + 16 * jp, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int jp = 0; jp < NJP; ++jp) {
                mma(acc1[mt][2 * jp], a[mt], b[jp][0], b[jp][1]);
                mma(acc1[mt][2 * jp + 1], a[mt], b[jp][2], b[jp][3]);
            }
    }
    // + b1, relu, bf16: n-tiles 2s and 2s + 1 are the A fragment of
    // layer 2's k16 slice s
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int s = 0; s < NJP; ++s) {
            uint32_t a2[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float* c = acc1[mt][2 * s + q / 2];
                a2[q] = pack2(relu(c[q % 2 * 2] + bias[s][q / 2 * 2]),
                              relu(c[q % 2 * 2 + 1] + bias[s][q / 2 * 2 + 1]));
            }
#pragma unroll
            for (int jp = 0; jp < NOP; ++jp) {
                mma(acc2[mt][2 * jp], a2, w2f[s][jp][0], w2f[s][jp][1]);
                mma(acc2[mt][2 * jp + 1], a2, w2f[s][jp][2], w2f[s][jp][3]);
            }
        }
}

template <bool RES, int MT, int NJP>
__device__ __forceinline__ void hidden_chunk(int nop, float (&acc2)[MT][4][4], const bf16* xa,
                                             int mstride, int Fp, const Staged m1,
                                             const Staged m2, const float* b1v, int h0, int o0,
                                             int lane) {
    if (nop == 2) hidden_chunk<RES, MT, NJP, 2>(acc2, xa, mstride, Fp, m1, m2, b1v, h0, o0, lane);
    else hidden_chunk<RES, MT, NJP, 1>(acc2, xa, mstride, Fp, m1, m2, b1v, h0, o0, lane);
}

template <typename Tin, int WARPS, int MT, int STAGES, bool RES>
__global__ void __launch_bounds__(WARPS * 32) mlp_head_tc_kernel(
        const Tin* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
        const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out,
        int B, int F, int H, int O) {
    constexpr int TR = 16 * MT * WARPS;  // rows a tile
    constexpr int NT = 32 * WARPS;
    const Geo g(F, H, O);
    // [w1s | w2s | b1s | b2s] where resident, then xs | ring | rows_s; the
    // weights land in xs | ring | rows_s while they are staged
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* w1s = reinterpret_cast<bf16*>(smem);
    bf16* w2s = w1s + (size_t)g.Fp * g.W1S;
    float* b1s = reinterpret_cast<float*>(w2s + (size_t)g.Hp * g.W2S);
    float* b2s = b1s + g.Hp;
    bf16* xs = RES ? reinterpret_cast<bf16*>(b2s + g.Op) : reinterpret_cast<bf16*>(smem);
    unsigned char* ring = reinterpret_cast<unsigned char*>(xs) + (size_t)TR * g.XS * 2;
    const size_t RAW = raw_bytes(TR, F, sizeof(Tin));
    float* rows_s = reinterpret_cast<float*>(ring + STAGES * RAW);  // (TR, O) f32
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tiles = (B + TR - 1) / TR;
    const size_t span = (size_t)TR * F * sizeof(Tin);
    const uintptr_t xbase = reinterpret_cast<uintptr_t>(x);
    const uintptr_t xend = xbase + (size_t)B * F * sizeof(Tin);

    auto fetch = [&](int tile, int slot) {
        fetch_span(ring + slot * RAW, xbase, xend, span, RAW, tile, tiles, tid, NT);
    };

    const Staged m1{w1, w1s, F, H, g.W1S};
    const Staged m2{w2, w2s, H, O, g.W2S};
    if constexpr (RES) {
        for (int i = tid; i < g.Hp; i += NT) b1s[i] = i < H ? b1[i] : 0.f;
        for (int i = tid; i < g.Op; i += NT) b2s[i] = i < O ? b2[i] : 0.f;
        const size_t land = (size_t)TR * g.XS * 2 + STAGES * RAW + (size_t)TR * O * 4;
        stage_weights(m1, m2, (g.Fp * g.W1S + g.Hp * g.W2S) * 2, reinterpret_cast<float*>(xs),
                      (int)(land / 4), tid, NT);
    }
    for (int s = 0; s < STAGES; ++s) fetch(blockIdx.x + s * gridDim.x, s);

    int slot = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        // this tile's span has landed, the weights are staged, and every
        // warp is done with the previous tile's padded rows
        cp_async_wait<STAGES - 1>();
        __syncthreads();
        const int row0 = tile * TR, rows = min(TR, B - row0);
        {
            const unsigned char* r = ring + slot * RAW;
            const int off = (int)(((xbase + tile * span) & 15) / sizeof(Tin));
            const int groups = g.Fp / 8;
            for (int i = tid; i < TR * groups; i += NT) {
                const int rr = i / groups, f = i % groups * 8;
                *reinterpret_cast<uint4*>(xs + rr * g.XS + f) =
                    rr < rows && f < F ? row_octet(r, off + rr * F + f, f, F, x)
                                       : make_uint4(0u, 0u, 0u, 0u);
            }
        }
        // the padded rows are complete, and the slot is free for the tile
        // STAGES ahead
        __syncthreads();
        fetch(tile + STAGES * gridDim.x, slot);
        slot = slot + 1 == STAGES ? 0 : slot + 1;

        const int wr = warp * 16 * MT, wrows = min(16 * MT, rows - wr);
        if (wrows <= 0) continue;
        const bf16* xa = xs + (wr + lane % 16) * g.XS + lane / 16 * 8;
        const float* b1v = RES ? b1s : b1;
        for (int o0 = 0; o0 < g.Op; o0 += OC) {
            const int ont = min(OC, g.Op - o0) / 8;  // n-tiles of this pass, even
            float acc2[MT][4][4] = {};
            for (int h0 = 0; h0 < g.Hp; h0 += HC) {
                const int nop = ont / 2;
                switch (min(HC, g.Hp - h0) / 16) {
                case 4:
                    hidden_chunk<RES, MT, 4>(nop, acc2, xa, 16 * g.XS, g.Fp, m1, m2, b1v, h0,
                                              o0, lane);
                    break;
                case 3:
                    hidden_chunk<RES, MT, 3>(nop, acc2, xa, 16 * g.XS, g.Fp, m1, m2, b1v, h0,
                                              o0, lane);
                    break;
                case 2:
                    hidden_chunk<RES, MT, 2>(nop, acc2, xa, 16 * g.XS, g.Fp, m1, m2, b1v, h0,
                                              o0, lane);
                    break;
                default:
                    hidden_chunk<RES, MT, 1>(nop, acc2, xa, 16 * g.XS, g.Fp, m1, m2, b1v, h0, o0,
                                             lane);
                }
            }
            // + b2: into the warp's output rows in shared memory, or
            // (weights not resident) straight to device memory
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (j < ont) {
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const int r = wr + 16 * mt + lane / 4 + c / 2 * 8;
                            const int o = o0 + 8 * j + lane % 4 * 2 + c % 2;
                            if (o < O) {
                                if constexpr (RES) {
                                    rows_s[r * O + o] = acc2[mt][j][c] + b2s[o];
                                } else if (r < rows) {
                                    out[(size_t)(row0 + r) * O + o] =
                                        acc2[mt][j][c] + __ldg(b2 + o);
                                }
                            }
                        }
                    }
                }
        }
        if constexpr (RES) {
            // the warp's rows are one contiguous span of out
            __syncwarp();
            float* dst = out + (size_t)(row0 + wr) * O;
            const float* src = rows_s + wr * O;
            for (int i = lane; i < wrows * O; i += 32) dst[i] = src[i];
        }
    }
    cp_async_wait<0>();
}

template <typename Tin, int C>
int launch(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
           float* out, int B, int F, int H, int O, cudaStream_t stream) {
    constexpr Config c = CONFIGS[C];
    auto kernel = mlp_head_tc_kernel<Tin, c.warps, c.mt, c.stages, c.resident>;
    const size_t smem = smem_bytes(Geo(F, H, O), sizeof(Tin), c);
    const int rows = 16 * c.mt * c.warps, threads = 32 * c.warps;
    int blocks = 0;
    cudaError_t err = persistent_grid(kernel, threads, smem, (B + rows - 1) / rows,
                                      MAX_PER_SM, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, threads, smem, stream>>>(static_cast<const Tin*>(x), w1, b1, w2, b2, out,
                                              B, F, H, O);
    return (int)cudaGetLastError();
}

template <typename Tin>
int forward(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
            float* out, int B, int F, int H, int O, cudaStream_t stream) {
    switch (config(F, H, O, sizeof(Tin))) {
    case 0: return launch<Tin, 0>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    case 1: return launch<Tin, 1>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    case 2: return launch<Tin, 2>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    case 3: return launch<Tin, 3>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace tc

}  // namespace

extern "C" {

// x: (B, F) row-major, bfloat16 when x_bf16 else float32, any element
// offset. w1: (F, H), b1: (H,), w2: (H, O), b2: (O,), all float32; out:
// (B, O) float32. cdt_bf16 selects the compute dtype and with it the
// kernel: bf16 on the tensor cores, f32 on FMA; each takes the
// configuration that its *_config function below gives.
int mlp_head_forward(const void* x, int x_bf16, const float* w1,
                     const float* b1, const float* w2, const float* b2,
                     float* out, int B, int F, int H, int O, int cdt_bf16,
                     cudaStream_t stream) {
    if (B <= 0 || F <= 0 || H <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
    if (cdt_bf16) {
        if (x_bf16)
            return tc::forward<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
        return tc::forward<float>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    }
    if (x_bf16)
        return f32::forward<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    return f32::forward<float>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
}

// The configuration (index into tc::CONFIGS) that the bf16 kernel takes
// for (F, H, O) with x in bf16 (x_bf16) or f32, or -1 where none fits:
// what ops/cuda/mlp.py's tc_config copies for its check before a launch.
int mlp_head_tc_config(int F, int H, int O, int x_bf16) {
    if (F <= 0 || H <= 0 || O <= 0) return -1;
    return tc::config(F, H, O, x_bf16 ? 2 : 4);
}

// The configuration that the f32 kernel takes for (F, H, O) with x in
// bf16 (x_bf16) or f32 (f32::config: 0 resident, 1 streamed), or -1 for
// a shape no kernel takes.
int mlp_head_f32_config(int F, int H, int O, int x_bf16) {
    if (F <= 0 || H <= 0 || O <= 0) return -1;
    return f32::config(F, H, O, x_bf16 ? 2 : 4);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

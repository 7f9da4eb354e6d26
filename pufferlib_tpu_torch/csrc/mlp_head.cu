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
//   in order): every (F, H, O) that the f32 kernel serves is served, and
//   more; beyond the last, the launch is refused.
//
// * f32 (the exact test mode): mlp_head_kernel, plain FMA loops (the
//   tensor cores have no exact f32 product). Weights staged once per
//   block in shared memory; per 32-row tile the x tile, the hidden tile
//   (one thread a hidden unit, a warp on one row) and the outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 227 * 1024;

// ---------------------------------------------------------------- f32

constexpr int THREADS = 256;
constexpr int ROWS = 32;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

template <typename Tin>
__global__ void __launch_bounds__(THREADS) mlp_head_kernel(
        const Tin* __restrict__ x, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float* __restrict__ out,
        int B, int F, int H, int O) {
    extern __shared__ float smem[];
    float* w1s = smem;              // F * H
    float* w2s = w1s + F * H;       // H * O
    float* b1s = w2s + H * O;       // H
    float* b2s = b1s + H;           // O
    float* xs = b2s + O;            // ROWS * F
    float* hs = xs + ROWS * F;      // ROWS * H

    for (int i = threadIdx.x; i < F * H; i += THREADS) w1s[i] = w1[i];
    for (int i = threadIdx.x; i < H * O; i += THREADS) w2s[i] = w2[i];
    for (int i = threadIdx.x; i < H; i += THREADS) b1s[i] = b1[i];
    for (int i = threadIdx.x; i < O; i += THREADS) b2s[i] = b2[i];

    const int tiles = (B + ROWS - 1) / ROWS;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        // weights staged, and the previous tile's xs/hs fully consumed
        __syncthreads();
        const size_t row0 = (size_t)tile * ROWS;
        const int rows = min(ROWS, B - (int)row0);
        for (int i = threadIdx.x; i < ROWS * F; i += THREADS)
            xs[i] = i < rows * F ? load(x, row0 * F + i) : 0.f;
        __syncthreads();

        for (int i = threadIdx.x; i < rows * H; i += THREADS) {
            const int r = i / H;
            const int j = i - r * H;
            const float* xr = xs + r * F;
            float acc = 0.f;
            for (int k = 0; k < F; ++k) acc = fmaf(xr[k], w1s[k * H + j], acc);
            acc += b1s[j];
            // relu that keeps a NaN, as jax.nn.relu does
            hs[i] = acc < 0.f ? 0.f : acc;
        }
        __syncthreads();

        for (int i = threadIdx.x; i < rows * O; i += THREADS) {
            const int r = i / O;
            const int o = i - r * O;
            const float* hr = hs + r * H;
            float acc = 0.f;
            for (int j = 0; j < H; ++j) acc = fmaf(hr[j], w2s[j * O + o], acc);
            out[row0 * O + i] = acc + b2s[o];
        }
    }
}

size_t smem_bytes(int F, int H, int O) {
    return sizeof(float) *
        ((size_t)F * H + (size_t)H * O + H + O + (size_t)ROWS * F + (size_t)ROWS * H);
}

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

template <typename Tin>
int launch_fma(const void* x, const float* w1, const float* b1, const float* w2,
               const float* b2, float* out, int B, int F, int H, int O,
               cudaStream_t stream) {
    auto kernel = mlp_head_kernel<Tin>;
    const size_t smem = smem_bytes(F, H, O);
    int blocks = 0;
    cudaError_t err = persistent_grid(kernel, THREADS, smem, (B + ROWS - 1) / ROWS, 1 << 30,
                                      &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, THREADS, smem, stream>>>(
        static_cast<const Tin*>(x), w1, b1, w2, b2, out, B, F, H, O);
    return (int)cudaGetLastError();
}

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

// one ring slot: a tile's span of x, plus the chunk that its unaligned
// start may add and one that the re-layout's word reads may touch past
// the span's end
__host__ __device__ inline size_t raw_bytes(int rows, int F, int x_size) {
    return (size_t)rows * F * x_size + 32;
}

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

// 16 bytes from gmem, of which the first n are read and the rest zero
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int n) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// the bf16 bits of element i of a staged f32 x span, rounded
__device__ __forceinline__ uint32_t bits(const float* p, int i) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(p[i]));
}

// relu that keeps a NaN, as jax.nn.relu does
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

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

// 4 bytes from gmem into shared memory
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

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

    // tile's span into ring slot `slot`, from the 16-byte boundary at or
    // below its start; bytes past the array's end are zero-filled. One
    // commit group per call, empty past the last tile.
    auto fetch = [&](int tile, int slot) {
        if (tile < tiles) {
            const uintptr_t a = (xbase + tile * span) & ~(uintptr_t)15;
            unsigned char* dst = ring + slot * RAW;
            for (int c = tid; c < (int)(RAW / 16); c += NT) {
                const uintptr_t src = a + 16 * (uintptr_t)c;
                const int n = src >= xend ? 0 : (xend - src >= 16 ? 16 : (int)(xend - src));
                cp_async16(dst + 16 * c, reinterpret_cast<const void*>(n ? src : a), n);
            }
        }
        cp_async_commit();
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
// kernel: bf16 on the tensor cores, f32 on FMA.
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
    if (smem_bytes(F, H, O) > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (x_bf16)
        return launch_fma<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    return launch_fma<float>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
}

// The configuration (index into tc::CONFIGS) that the bf16 kernel takes
// for (F, H, O) with x in bf16 (x_bf16) or f32, or -1 where none fits:
// what ops/cuda/mlp.py's tc_config copies for its check before a launch.
int mlp_head_tc_config(int F, int H, int O, int x_bf16) {
    if (F <= 0 || H <= 0 || O <= 0) return -1;
    return tc::config(F, H, O, x_bf16 ? 2 : 4);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
